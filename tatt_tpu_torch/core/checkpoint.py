"""Checkpoints of the port (counterpart of ``tatt_tpu/core/checkpoint.py``).

A checkpoint is one ``torch.save`` file, written to ``path + ".tmp"`` and
then renamed over ``path``.  It holds the format marker :data:`FORMAT`,
the generator's and the student's ``state_dict`` (parameters and BN
buffers), the Adam ``state_dict``, ``iters``, the ``info`` dict,
``best_history_res`` and ``converge`` (plain types only), and is read with
``torch.load(..., weights_only=True)``.  The trainer keeps the JAX
package's file names under ``<TRAIN.ckpt_dir>/<vis_dir>/``:
``checkpoint.ckpt`` every ``saveInterval`` and ``model_best_acc_0.ckpt``
on a new best sum-accuracy.

Three kinds of file reach ``--resume``: a port checkpoint (a torch zip
with the marker), a reference ``.pth`` (a torch zip or a legacy pickle
without it) and a JAX-package checkpoint (msgpack, which the port cannot
read and refuses by name).
"""

from __future__ import annotations

import os
import sys
import zipfile
from typing import Any, Optional

import numpy as np
import torch
from torch import nn

from tatt_tpu_torch.core.convert import CHECKPOINT_FORMAT as FORMAT
from tatt_tpu_torch.core.convert import is_jax_checkpoint, load_reference_pth, load_weights


def _plain(x: Any) -> Any:
    """Nested dicts / lists / tuples of Python scalars and numpy scalars ->
    plain Python types (what ``weights_only`` loading accepts)."""
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, np.generic):
        return x.item()
    return x


def save_checkpoint(
    path: str,
    generator: nn.Module,
    student: nn.Module,
    optimizer: torch.optim.Optimizer,
    iters: int,
    info: Optional[dict] = None,
    best_history: Optional[dict] = None,
    converge: Optional[list] = None,
) -> None:
    payload = {
        "format": FORMAT,
        "generator": generator.state_dict(),
        "student": student.state_dict(),
        "optimizer": optimizer.state_dict(),
        "iters": int(iters),
        "info": _plain(info or {}),
        "best_history_res": _plain(best_history or {}),
        "converge": _plain(converge or []),
    }
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def load_checkpoint(path: str) -> Optional[dict]:
    """The payload of a port checkpoint, or None for a reference ``.pth``.
    Raises ``ValueError`` for a JAX-package checkpoint."""
    if is_jax_checkpoint(path):
        raise ValueError(f"{path} is a checkpoint of the JAX package tatt_tpu (msgpack); "
                         "the port reads its own checkpoints and reference .pth files")
    if not zipfile.is_zipfile(path):
        return None  # a legacy-pickle reference .pth
    blob = torch.load(path, map_location="cpu", weights_only=True)
    return blob if isinstance(blob, dict) and blob.get("format") == FORMAT else None


def restore_checkpoint(
    payload: dict,
    generator: nn.Module,
    student: nn.Module,
    optimizer: Optional[torch.optim.Optimizer] = None,
) -> None:
    """Load a :func:`load_checkpoint` payload into the models (every entry
    of each model must be present; entries it lacks, such as the STN head
    of a training checkpoint in an eval model without ``--STN``, are left
    out) and, when given, the optimizer, whose parameters must be those it
    was saved with, in the same order."""
    load_weights(generator, payload["generator"])
    load_weights(student, payload["student"])
    if optimizer is not None:
        optimizer.load_state_dict(payload["optimizer"])


def resume_models(
    path: str,
    generator: nn.Module,
    student: nn.Module,
    optimizer: Optional[torch.optim.Optimizer] = None,
) -> Optional[dict]:
    """``--resume``: resolve ``path`` (:func:`resolve_resume_path`), then
    load a port checkpoint into the models and, when given, the optimizer,
    and return its payload; or load a reference ``.pth`` (the generator,
    and the student from ``recognizer_best_acc_0.pth`` beside it, as
    ``loop.py:454-535`` of the JAX package does) and return None: the
    reference saves no optimizer state, so Adam starts afresh."""
    path = resolve_resume_path(path)
    payload = load_checkpoint(path)
    if payload is not None:
        restore_checkpoint(payload, generator, student, optimizer)
        return payload
    unused = load_weights(generator, load_reference_pth(path))
    print(
        f"generator from {path} ({len(unused)} checkpoint entries unused); "
        "note: reference TATT checkpoints were trained under the batch_first "
        "query-GRU quirk (TATT(query_gru_mode='reference') reproduces it)",
        file=sys.stderr,
    )
    rec = os.path.join(os.path.dirname(path), "recognizer_best_acc_0.pth")
    if os.path.exists(rec):
        load_weights(student, load_reference_pth(rec))
    return None


def resolve_resume_path(path: str) -> str:
    """``--resume`` takes a file or a run directory.  In a directory:
    ``model_best_acc_0.ckpt``, then ``checkpoint.ckpt``, then the
    lowest-numbered ``model_best_acc_<i>.pth``, then ``checkpoint.pth``
    (the JAX package's order, ``checkpoint.py:135``)."""
    if not os.path.isdir(path):
        return path
    names = set(os.listdir(path))
    for pick in ("model_best_acc_0.ckpt", "checkpoint.ckpt"):
        if pick in names:
            return os.path.join(path, pick)

    def number(name: str) -> int:
        try:
            return int(name[len("model_best_acc_") : -len(".pth")])
        except ValueError:
            return 1 << 30

    best = [f for f in names if f.startswith("model_best_acc_") and f.endswith(".pth")]
    if best:
        return os.path.join(path, min(best, key=number))
    if "checkpoint.pth" in names:
        return os.path.join(path, "checkpoint.pth")
    raise FileNotFoundError(f"no checkpoint found under {path}")
