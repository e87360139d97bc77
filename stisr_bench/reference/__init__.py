"""The benchmark's plain reference of each configuration, frozen: its
arch's file ``archs/<arch>.py`` (generator, loss, SR) on the layers of
``nets`` and the steps of ``steps``.

Plain PyTorch and NumPy only: no kernel of the port, no cache, no
batching tricks.  The recurrences are Python loops over time steps under
autograd, and the steps are written out in full (losses, per-model
clipping, Adam).  It imports nothing of the measured package
(``tatt_tpu_torch``) nor of the JAX package beside it, so a change to the
program cannot change what the program is held against.

Parameter names follow the reference PyTorch layout (``model/tsrn.py``,
``model/crnn/crnn.py``), the same ``state_dict`` keys the port uses, so
the benchmark hands both sides the same tensors by name.

Runs in float32 with TF32 off (:func:`full_precision`); the control of the
correctness check runs it with TF32 on (:func:`tf32`).
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def precision(allow_tf32: bool):
    """cuDNN and cuBLAS float32 contractions in full float32
    (``allow_tf32=False``) or in TF32, restored on exit."""
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = allow_tf32
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def full_precision():
    return precision(False)


def tf32():
    return precision(True)
