"""The numbers that decide ``correct``, each held against its limit.

Training (the program's first three steps in set-up, through the
window's own ``Trainer.train`` and loader, against the reference's three
steps from the same weights on the same rows and draws):

- ``loss_gap``: the largest relative gap of a step's total loss;
- ``grad_gap``: by the worst leaf, the gap between the norms of the
  first step's gradient as Adam got it (the program's worked out from
  Adam's first moment after one step, m / (1 - beta1)) and the
  reference's, over the reference's norm of that leaf or of the median
  leaf, whichever is larger;
- ``update_gap``: the same of the norms of each leaf's change after three
  steps, over the leaves whose reference gradient is at least a
  thousandth of the median leaf's (the others move by round-off alone);
- ``rows_off``: rows of the three batches the program stepped on that
  differ from the rows the reference reads.

Evaluation (the first pass of the window against the reference's pass
over the same sets):

- ``sr_gap``: the largest absolute gap of an SR pixel in the sampled
  batches;
- ``psnr_gap`` / ``ssim_gap``: the largest gap of a set's average;
- ``logit_gap``: the largest absolute gap of the judge's logits on the
  sampled batches' SR, LR and HR readings;
- ``strings_off``: sampled readings whose string is not the greedy CTC
  decode of the program's own logits.
"""

from __future__ import annotations

import math
import statistics

import numpy as np
import torch


def leaf_norms(tensors: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.float())) for k, v in tensors.items()}


def gap_by_leaf(got: dict, want: dict, keys) -> float:
    """max over ``keys`` of |got - want| / max(want, the median want); a
    leaf the program did not give reads 0."""
    keys = list(keys)
    if not keys:
        return math.nan
    med = statistics.median(want[k] for k in keys)
    return max(abs(got.get(k, 0.0) - want[k]) / max(want[k], med) for k in keys) if med > 0 else math.nan


def update_diagnosis(prog: dict, ref: dict) -> dict:
    """What lies behind ``update_gap``: the leaf that sets it, and the gap
    of the median leaf's change (the leaves the reference moves)."""
    med = statistics.median(ref["grad"].values())
    moved = [k for k, g in ref["grad"].items() if g >= 1e-3 * med]
    umed = statistics.median(ref["update"][k] for k in moved)
    worst = max(moved, key=lambda k: abs(prog["update"].get(k, 0.0) - ref["update"][k])
                / max(ref["update"][k], umed))
    pmed = statistics.median(prog["update"].get(k, 0.0) for k in moved)
    return {"worst_leaf": worst, "median_change_gap": abs(pmed - umed) / umed}


def train_numbers(prog: dict, ref: dict) -> dict:
    """``prog`` / ``ref``: ``losses`` [3], ``grad`` and ``update`` {leaf:
    norm}; ``prog`` also ``rows_off``."""
    loss_gap = max(abs(p - r) / abs(r) for p, r in zip(prog["losses"], ref["losses"]))
    med = statistics.median(ref["grad"].values())
    moved = [k for k, g in ref["grad"].items() if g >= 1e-3 * med]
    return {"loss_gap": loss_gap,
            "grad_gap": gap_by_leaf(prog["grad"], ref["grad"], ref["grad"]),
            "update_gap": gap_by_leaf(prog["update"], ref["update"], moved),
            "rows_off": float(prog["rows_off"])}


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(every number finite and within its limit, {name: {value, limit}})."""
    checks = {k: {"value": v, "limit": limits.get(k, math.nan)} for k, v in numbers.items()}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    return ok, checks


def rows_differ(got: np.ndarray, want: np.ndarray) -> int:
    """Rows (axis 0) of two uint8 stacks that are not equal."""
    if got.shape != want.shape:
        return max(len(got), len(want))
    return int((got.reshape(len(got), -1) != want.reshape(len(want), -1)).any(axis=1).sum())
