"""Checkpoints of the port (counterpart of ``tatt_tpu/core/checkpoint.py``).

A checkpoint is one ``torch.save`` file, written to ``path + ".tmp"`` and
then renamed over ``path``.  It holds the format marker :data:`FORMAT`,
the ``state_dict`` (parameters and BN buffers) of every generator copy and
of every student copy (one each, or ``stu_iter`` where ``--sr_share`` /
``--tpg_share`` is off), the Adam ``state_dict`` over all of them,
``iters``, the ``info`` dict, ``best_history_res`` and ``converge`` (plain
types only), and is read with ``torch.load(..., weights_only=True)``.  As
the JAX package's one ``TrainState`` file, it holds every copy; the
trainer keeps that package's file names under
``<TRAIN.ckpt_dir>/<vis_dir>/``: ``checkpoint.ckpt`` every
``saveInterval`` and ``model_best_acc_0.ckpt`` on a new best
sum-accuracy.  A file of the earlier format (one ``state_dict`` per model)
still loads.

The students are CRNNs or, under ``--tpg OPT``, TPG models: a checkpoint
of one kind does not load into a run of the other (``restore_checkpoint``
raises, naming both).

Three kinds of file reach ``--resume``: a port checkpoint (a torch zip
with the marker), a reference ``.pth`` (a torch zip or a legacy pickle
without it) and a JAX-package checkpoint (msgpack, which the port cannot
read and refuses by name).
"""

from __future__ import annotations

import os
import sys
import zipfile
from typing import Any, Optional, Sequence

import numpy as np
import torch
from torch import nn

from tatt_tpu_torch.core.convert import CHECKPOINT_FORMAT as FORMAT
from tatt_tpu_torch.core.convert import (
    CHECKPOINT_FORMATS, is_jax_checkpoint, load_reference_pth, load_weights,
)


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
    generators: Sequence[nn.Module],
    students: Sequence[nn.Module],
    optimizer: torch.optim.Optimizer,
    iters: int,
    info: Optional[dict] = None,
    best_history: Optional[dict] = None,
    converge: Optional[list] = None,
) -> None:
    """``generators`` / ``students``: the copies of each model."""
    payload = {
        "format": FORMAT,
        "generator": [m.state_dict() for m in generators],
        "student": [m.state_dict() for m in students],
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
    """The payload of a port checkpoint (``generator`` / ``student``: a
    list of ``state_dict``, one per copy), or None for a reference
    ``.pth``.  Raises ``ValueError`` for a JAX-package checkpoint."""
    if is_jax_checkpoint(path):
        raise ValueError(f"{path} is a checkpoint of the JAX package tatt_tpu (msgpack); "
                         "the port reads its own checkpoints and reference .pth files")
    if not zipfile.is_zipfile(path):
        return None  # a legacy-pickle reference .pth
    blob = torch.load(path, map_location="cpu", weights_only=True)
    if not (isinstance(blob, dict) and blob.get("format") in CHECKPOINT_FORMATS):
        return None
    for key in ("generator", "student"):  # the earlier format: one state_dict
        if isinstance(blob[key], dict):
            blob[key] = [blob[key]]
    return blob


def recognizer_kind(state_dict) -> str:
    """``"TPG"`` (``--tpg OPT``'s ``TPGModel``), ``"CRNN"`` or ``"other"``
    by the top-level names of a student's ``state_dict``."""
    heads = {k.split(".")[0] for k in state_dict}
    return "TPG" if "FeatureExtraction" in heads else "CRNN" if "cnn" in heads else "other"


def restore_checkpoint(
    payload: dict,
    generators: Sequence[nn.Module],
    students: Sequence[nn.Module],
    optimizer: Optional[torch.optim.Optimizer] = None,
) -> None:
    """Load a :func:`load_checkpoint` payload into the models, as many
    copies of each as the payload holds (every entry of each model must be
    present; entries it lacks, such as the STN head of a training
    checkpoint in an eval model without ``--STN``, are left out) and, when
    given, the optimizer, whose parameters must be those it was saved
    with, in the same order."""
    if payload["student"] and students:
        have, want = recognizer_kind(payload["student"][0]), recognizer_kind(students[0].state_dict())
        if have != want:
            raise ValueError(f"the checkpoint's students are {have} recognizers, the run's "
                             f"are {want} (--tpg {'OPT' if want == 'TPG' else 'CRNN'})")
    for what, models in (("generator", generators), ("student", students)):
        saved = payload[what]
        if len(models) != len(saved):
            raise ValueError(f"the checkpoint holds {len(saved)} {what} copies, "
                             f"the run has {len(models)}")
        for model, sd in zip(models, saved):
            load_weights(model, sd)
    if optimizer is not None:
        optimizer.load_state_dict(payload["optimizer"])


def resume_models(
    path: str,
    generators: Sequence[nn.Module],
    students: Sequence[nn.Module],
    optimizer: Optional[torch.optim.Optimizer] = None,
) -> Optional[dict]:
    """``--resume``: resolve ``path`` (:func:`resolve_resume_path`), then
    load a port checkpoint into the models and, when given, the optimizer,
    and return its payload; or load a reference ``.pth`` and return None:
    generator copy i from ``model_best_acc_<i>.pth`` beside it where that
    exists (the reference names its best files per copy), else from the
    file itself, and student copy i from ``recognizer_best_acc_<i>.pth``
    beside it, as ``loop.py:454-535`` of the JAX package does.  The
    reference saves no optimizer state, so Adam starts afresh."""
    path = resolve_resume_path(path)
    payload = load_checkpoint(path)
    if payload is not None:
        restore_checkpoint(payload, generators, students, optimizer)
        return payload
    here = os.path.dirname(path)
    for i, generator in enumerate(generators):
        sibling = os.path.join(here, f"model_best_acc_{i}.pth")
        src = sibling if os.path.exists(sibling) else path
        unused = load_weights(generator, load_reference_pth(src))
        print(
            f"generator {i} from {src} ({len(unused)} checkpoint entries unused); "
            "note: reference TATT checkpoints were trained under the batch_first "
            "query-GRU quirk (TATT(query_gru_mode='reference') reproduces it)",
            file=sys.stderr,
        )
    for i, student in enumerate(students):
        rec = os.path.join(here, f"recognizer_best_acc_{i}.pth")
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
