"""Each configuration's reference, a file of its own: ``<arch>.py`` for
the configuration's ``arch``.  A file gives

- ``build(config) -> {"generator", "student", "teacher"}``: the models,
  their leaves named as the program's, so that both sides take the same
  seeded tensors by name;
- ``loss(models, batch, gen) -> tensor``: the training step's loss,
  drawing from ``gen`` in the program's order (``gen`` None: no draws);
- ``sr(models, lr) -> tensor``: the SR images, the models in eval mode.

Layers that more than one arch uses stay in ``nets``, the steps' common
parts (clipping, Adam) in ``steps``.  A new configuration's reference is
a new file here, found by :func:`load`.
"""

from __future__ import annotations

import importlib.util
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def load(arch: str):
    """The module of ``<arch>.py``, loaded by its path once a process."""
    name = f"{__name__}.{arch}"
    if name not in sys.modules:
        path = os.path.join(HERE, f"{arch}.py")
        if not os.path.isfile(path):
            raise ValueError(f"the reference has no arch {arch!r}: there is no {path}")
        spec = importlib.util.spec_from_file_location(name, path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        sys.modules[name] = module
    return sys.modules[name]
