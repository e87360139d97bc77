"""The port's bf16 TATT step (``--dtype bfloat16``) under every flag set of
``--arch=tatt`` against the JAX package's bf16 step, on the CPU.

The cases: the six flag sets of ``tests/test_torch_flags.py`` (``FLAG_SETS``),
``--stu_iter=2`` with shared copies and ``--stu_iter=2`` with separate
copies and ``--for_cascading`` (``tests/test_torch_cascade.py``).  Each runs
``make_train_step`` in float32 and in bfloat16 and the port's
``train_step`` in both, from the same weights and batch (the helpers of
``tests/test_torch_flags.py``: small widths, rotation pinned, dropout off,
SGD at lr 1 so that an update is the clipped gradient), and is held by the
two-way criterion of ``tests/test_torch_bf16_step.py``, with its
tolerances:

(a) the losses within 2e-3 relative of JAX's bf16 step, and each gradient
    entry (every copy) within JAX's own bf16 error there (|JAX bf16 - JAX
    f32|) plus 5e-2 of the model's largest f32 gradient entry (measured:
    generator 1.8e-3-7.8e-3, student up to 2.1e-2 with
    ``--for_cascading``);
(b) the port's bf16-vs-f32 gap (||g_bf16 - g_f32|| / ||g_f32|| over all
    the leaves of a model's copies) not zero, below 5e-2, and no larger
    than JAX's own (measured, port / JAX: generator 9.5e-3-3.0e-2 /
    0.33-0.40, student 1.8e-2-3.9e-2 / 9.2e-2-0.105); a model that no loss
    reaches (the students without distillation) has zero gradients in all
    four steps.

Under ``--use_label`` ``loss_distill`` and ``loss_total`` read ~1e30 (the
spread labels' CTC, ROADMAP C.4); they are held by the same relative
tolerance and gate nothing else.
"""

import math

import pytest
import torch

from test_torch_bf16_step import GAP_MAX, GRAD_TOL, LOSS_RTOL
from test_torch_cascade import CASCADES
from test_torch_flags import FLAG_SETS, jax_step, make_batch, make_variables, port_step
from tatt_tpu.train.steps import StepConfig as JStepConfig
from tatt_tpu_torch.train.steps import StepConfig

# name -> (flags, generator copies, student copies)
CASES = {**{name: (flags, 1, 1) for name, flags in FLAG_SETS.items()},
         "stu_iter_2_shared": CASCADES["shared"],
         "stu_iter_2_for_cascading": CASCADES["separate_for_cascading"]}
LOSSES = ("loss_total", "loss_sr", "loss_distill", "loss_tssim", "loss_ssim")


@pytest.fixture(scope="module", params=sorted(CASES))
def steps(request):
    """name -> {(package, dtype): (metrics, {part: [grads per copy]})}."""
    flags, n_sr, n_stu = CASES[request.param]
    srs, stus, teacher = make_variables(11, n_sr, n_stu)
    batch = make_batch(3, rotate=flags.get("rotate_train", 5.0) != 0.0)
    out = {}
    for dt in ("float32", "bfloat16"):
        cfg = dict(flags, compute_dtype=dt)
        out["jax", dt] = jax_step(JStepConfig(**cfg), srs, stus, teacher, batch)[:2]
        out["port", dt] = port_step(StepConfig(**cfg), srs, stus, teacher, batch)[:2]
    return request.param, out


def _leaves(grads: list) -> dict:
    """The leaves of every copy of a model, keyed (copy, name), as float64."""
    return {(i, k): v.double() for i, g in enumerate(grads) for k, v in g.items()}


def gap(a: dict, b: dict) -> float:
    """||a - b|| / ||b|| over all the leaves; 0 where b is all zeros."""
    den = math.sqrt(sum(v.norm().item() ** 2 for v in b.values()))
    num = math.sqrt(sum((a[k] - v).norm().item() ** 2 for k, v in b.items()))
    return num / den if den else num


def test_bf16_flag_step_matches_jax_bf16_step(steps):
    """(a): losses, and every gradient entry beyond JAX's own bf16 error."""
    name, out = steps
    (m_j, g_j), (m_t, g_t) = out["jax", "bfloat16"], out["port", "bfloat16"]
    _, g_j32 = out["jax", "float32"]
    assert sorted(m_t) == sorted(m_j)
    for key in LOSSES:
        if key in m_j:
            assert math.isfinite(m_t[key]), (name, key)
            assert abs(m_t[key] - m_j[key]) <= LOSS_RTOL * abs(m_j[key]), (name, key, m_t[key], m_j[key])
    for part in ("sr", "student"):
        want, got, f32 = _leaves(g_j[part]), _leaves(g_t[part]), _leaves(g_j32[part])
        assert sorted(got) == sorted(want)
        scale = max(max(v.abs().max().item() for v in f32.values()), 1e-30)
        worst = 0.0
        for key, w in want.items():
            excess = ((got[key] - w).abs() - (w - f32[key]).abs()).max().item()
            worst = max(worst, excess / scale)
            assert excess <= GRAD_TOL * scale, (name, part, key, excess, scale)
        print(f"[bf16-flags] {name} {part}: excess {worst:.3e}")


def test_bf16_flag_step_gap_is_no_larger_than_jax(steps):
    """(b): bf16 moves the port's gradients from its f32 step, by less
    than 5e-2 and no further than it moves JAX's."""
    name, out = steps
    for part in ("sr", "student"):
        port32, port16 = (_leaves(out["port", dt][1][part]) for dt in ("float32", "bfloat16"))
        jax32, jax16 = (_leaves(out["jax", dt][1][part]) for dt in ("float32", "bfloat16"))
        if not any(v.abs().max() > 0 for v in jax32.values()):  # no loss reaches it
            assert not any(v.abs().max() > 0 for d in (port32, port16, jax16) for v in d.values())
            continue
        port, jax_gap = gap(port16, port32), gap(jax16, jax32)
        print(f"[bf16-flags] {name} {part}: port gap {port:.3e}, JAX gap {jax_gap:.3e}")
        assert 0.0 < port <= min(GAP_MAX, jax_gap), (name, part, port, jax_gap)
