"""One train step of the port against ``make_train_step`` for each flag set
of the TATT step beyond the canonical recipe (CPU, small widths).

The recipe itself is held in ``test_torch_train.py``; here the flags:
``--use_label`` (CTC of the teacher's HR logits on the spread labels, with
its 1e30 entries), ``--learning_STN``, ``--training_stablize`` with
``--ssim_loss``, ``--y_domain``, ``--rotate_train=0`` and none of
``--use_distill`` / ``--gradient`` / ``--tssim_loss``.  The helpers serve
``test_torch_cascade.py`` too (``--stu_iter=2``).  Weights come from
``random_variables`` through ``from_jax``, inputs from the JAX collate of
seeded synthetic crops, the rotation pinned, dropout off, SGD at lr 1 so
that an update is the (clipped) gradient.

Tolerances are those of ``test_torch_train.py`` (losses and metrics rtol
1e-5; gradients within 1e-4 of the model's largest entry; updated
parameters and BN statistics rtol 1e-4 / atol 1e-6) but for two families
of leaves of the float32 step, measured at these inputs:
- the generator's STN head (``stn_head.*``, and its ``gnorm/stn_head``
  and the ``grad_norm_sr`` it enters): one output of the head's fc1
  BatchNorm1d (feature 205 of sample 6 under the recipe's flags) reads
  1.1e-5 in the port's float32 step and -2.0e-6 in its float64 step, so
  the ReLU after it passes that entry's gradient in one and not in the
  other; JAX's float32 step falls on the float64 side.  The two float32
  steps then differ there by up to 2.8e-4 of the model's largest entry
  (5-8 % of the head's conv leaves, 0.66 % of its norm, 1.4e-5 of
  ``grad_norm_sr``), so these leaves are held within 1e-3 of that entry,
  ``gnorm/stn_head`` within 2e-2 and ``grad_norm_sr`` within 1e-4;
- the students' convolutions (``cnn.*``): the port's float32 and float64
  steps agree there within 3e-7 of the largest entry, and both differ from
  JAX by up to 2.2e-4 of it, at the overlapping max pools (stride 1 along
  the width), where the two route a gradient among equal inputs
  differently; held within 1e-3 of that entry.  The students' BiLSTM
  leaves keep 1e-4.
So every step is also run in float64 on the port (:func:`check_step`),
and there every gradient leaf, the STN head's included, is held within
1e-4 of the model's largest entry (measured: within 5.5e-6), but the
students' convolutions (1e-3, the tie above); its metrics within rtol
1e-5, ``gnorm/stn_head`` within 1e-4 (measured: 3.3e-5, JAX's float32
rounding).  A fault in a flag's branch that reaches the STN head (such
as ``--learning_STN``'s term) shows there.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_models import random_variables
from tatt_tpu.data.collate import collate as jcollate
from tatt_tpu.data.synthetic import SyntheticTextDataset as JSynthetic
from tatt_tpu.models import stn as jstn
from tatt_tpu.models.recognizers.crnn import CRNN as JCRNN
from tatt_tpu.models.tsrn import TATT as JTATT
from tatt_tpu.train.state import TrainState
from tatt_tpu.train.steps import StepConfig as JStepConfig
from tatt_tpu.train.steps import make_train_step
from tatt_tpu_torch.core.convert import from_jax, from_jax_copies
from tatt_tpu_torch.models.recognizers.crnn import CRNN
from tatt_tpu_torch.models.tsrn import TATT
from tatt_tpu_torch.train.steps import StepConfig, train_step

SMALL = dict(srb_nums=1, hidden_units=4, out_text_channels=8)
TINY_CRNN = dict(nh=16, nm=(8, 8, 16, 16, 32, 32, 32))
# metrics and gradient leaves held at other tolerances (reasons above)
METRIC_RTOL = {"gnorm/stn_head": 2e-2, "grad_norm_sr": 1e-4}
LEAF_TOL = {("sr", "stn_head."): 1e-3, ("student", "cnn."): 1e-3}
# the port's float64 step against JAX (reasons above)
METRIC_RTOL_F64 = {"gnorm/stn_head": 1e-4}
LEAF_TOL_F64 = {("student", "cnn."): 1e-3}
# the JAX collate's fields that the step reads
BATCH_KEYS = ("images_hr", "images_lr", "images_hr_y", "images_lr_y", "ctc_targets",
              "ctc_lengths", "weighted_tics")


def make_variables(seed: int, n_sr: int = 1, n_stu: int = 1):
    """(sr variables per copy, student variables per copy, teacher
    variables), each copy its own draw; the STN head starts near its
    identity border grid, as its init does."""
    rng = np.random.default_rng(seed)
    sr_model, crnn = JTATT(stn=True, dropout=0.0, **SMALL), JCRNN(**TINY_CRNN)
    srs = []
    for _ in range(n_sr):
        v = random_variables(sr_model, rng, jnp.zeros((2, 4, 16, 64)), jnp.zeros((2, 37, 1, 26)),
                             train=True)
        stn = v["params"]["stn_head"]
        stn["fc2_kernel"] = stn["fc2_kernel"] * 0.1
        stn["fc2_bias"] = (jstn.build_output_control_points(20, (0.01, 0.01)).reshape(-1)
                           + rng.normal(0, 0.01, 40)).astype(np.float32)
        srs.append(v)
    stus = [random_variables(crnn, rng, jnp.zeros((2, 1, 32, 100))) for _ in range(n_stu)]
    return srs, stus, random_variables(crnn, rng, jnp.zeros((2, 1, 32, 100)))


def make_batch(seed: int, rotate: bool = True, n: int = 8) -> dict:
    """The JAX host collate of ``n`` synthetic crops, ``YCbCr`` fields and
    labels included, as numpy; the rotation pinned when ``rotate``."""
    ds = JSynthetic(n=n, seed=seed)
    arrays = jcollate([ds[i] for i in range(n)], y_domain=True).device_arrays()
    batch = {k: np.asarray(arrays[k]) for k in BATCH_KEYS}
    if rotate:
        rng = np.random.default_rng(seed)
        batch["rot_arc"] = (rng.uniform(-1, 1, n) * 5.0 / 180.0 * math.pi).astype(np.float32)
        batch["rot_offs"] = rng.uniform(0, 1, n).astype(np.float32)
    return batch


def jax_step(jcfg: JStepConfig, srs, stus, teacher, batch):
    """``make_train_step`` under ``jcfg`` -> (metrics, {"sr": [grads per
    copy], "student": [...]}, {"sr": [state_dict per copy], ...})."""
    sr_model, crnn = JTATT(stn=True, dropout=0.0, **SMALL), JCRNN(**TINY_CRNN)
    fused_model = sr_model.clone(bn_copies=2)

    def sr_apply(variables, lr, prior, train, rngs=None, mutable=False):
        return sr_model.apply(variables, lr, prior, train=train, rngs=rngs, mutable=mutable)

    def sr_apply_fused(variables, lr, prior, train, rngs=None, mutable=False):
        return fused_model.apply(variables, lr, prior, train=train, rngs=rngs, mutable=mutable)

    def crnn_apply(variables, luma, train, mutable=False):
        return crnn.apply(variables, luma, train=train, mutable=mutable)

    fused = jcfg.tssim_loss and jcfg.fused_tssim
    step = jax.jit(make_train_step(sr_apply, crnn_apply, crnn_apply, jcfg,
                                   sr_apply_fused=sr_apply_fused if fused else None))
    state = TrainState.create(srs, stus, optax.sgd(1.0))
    new, metrics = step(state, teacher, {k: jnp.asarray(v) for k, v in batch.items()},
                        jax.random.PRNGKey(0))
    host = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
    grads = {
        part: [from_jax({"params": jax.tree_util.tree_map(lambda a, b: np.asarray(a) - np.asarray(b),
                                                          old, upd)})
               for old, upd in zip(getattr(state, f"{part}_params"), getattr(new, f"{part}_params"))]
        for part in ("sr", "student")
    }
    states = {part: from_jax_copies(host(getattr(new, f"{part}_params")),
                                    host(getattr(new, f"{part}_batch_stats")))
              for part in ("sr", "student")}
    return {k: float(v) for k, v in metrics.items()}, grads, states


def port_step(cfg: StepConfig, srs, stus, teacher_vars, batch, dtype=torch.float32):
    """:func:`train_step` under ``cfg`` on the same variables and batch,
    on the CPU, models and float inputs in ``dtype``; returns what
    :func:`jax_step` returns."""
    generators = [TATT(stn=True, dropout=0.0, **SMALL) for _ in srs]
    students = [CRNN(**TINY_CRNN) for _ in stus]
    for model, sd in zip(generators + students, from_jax_copies(
            [v["params"] for v in srs + stus], [v["batch_stats"] for v in srs + stus])):
        model.load_state_dict(sd)
    teacher = CRNN(**TINY_CRNN)
    teacher.load_state_dict(from_jax(teacher_vars))
    for m in generators + students + [teacher]:
        m.to(dtype)
    params = [p for m in generators + students for p in m.parameters()]
    opt = torch.optim.SGD(params, lr=1.0)
    tb = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    tb = {k: v.to(dtype) if v.dtype == torch.float32 else v for k, v in tb.items()}
    metrics = train_step([m.train() for m in generators], [m.train() for m in students],
                         teacher.eval(), opt, tb, cfg, torch.Generator().manual_seed(0))
    grads = {"sr": [{k: p.grad for k, p in m.named_parameters()} for m in generators],
             "student": [{k: p.grad for k, p in m.named_parameters()} for m in students]}
    states = {"sr": [m.state_dict() for m in generators], "student": [m.state_dict() for m in students]}
    return {k: v.item() for k, v in metrics.items()}, grads, states


def _leaf_tol(part: str, name: str, table=LEAF_TOL) -> float:
    return next((t for (p, pre), t in table.items() if p == part and name.startswith(pre)), 1e-4)


def _grad_scale(grads: dict) -> float:
    return max(max(np.abs(w.numpy()).max() for w in grads.values()), 1e-30)


def assert_steps_match(want, got) -> None:
    (m_j, g_j, s_j), (m_t, g_t, s_t) = want, got
    assert sorted(m_t) == sorted(m_j)
    for key, value in m_j.items():
        np.testing.assert_allclose(m_t[key], value, rtol=METRIC_RTOL.get(key, 1e-5), atol=1e-7,
                                   err_msg=key)
    for part in ("sr", "student"):
        assert len(g_t[part]) == len(g_j[part]) == len(s_t[part]) == len(s_j[part])
        for gt, gj, st, sj in zip(g_t[part], g_j[part], s_t[part], s_j[part]):
            assert sorted(gt) == sorted(gj) and sorted(st) == sorted(sj)
            scale = _grad_scale(gj)
            for name, w in gj.items():
                err = np.abs(gt[name].numpy() - w.numpy()).max()
                assert err <= _leaf_tol(part, name) * scale, (part, name, err, scale)
            for name, w in sj.items():
                # a parameter after SGD at lr 1 moves by its gradient: a leaf
                # of a family above carries that family's gradient tolerance
                atol = _leaf_tol(part, name) * scale if name in gj and _leaf_tol(part, name) > 1e-4 else 1e-6
                np.testing.assert_allclose(st[name].numpy(), w.numpy(), rtol=1e-4, atol=atol,
                                           err_msg=f"{part} {name}")


def assert_float64_step_matches(want, got64) -> None:
    """The port's float64 step against JAX's float32 step: metrics and
    every gradient leaf at the float64 tolerances (module docstring)."""
    (m_j, g_j, _), (m_t, g_t, _) = want, got64
    for key, value in m_j.items():
        np.testing.assert_allclose(m_t[key], value, rtol=METRIC_RTOL_F64.get(key, 1e-5), atol=1e-7,
                                   err_msg=f"float64 {key}")
    for part in ("sr", "student"):
        for gt, gj in zip(g_t[part], g_j[part]):
            scale = _grad_scale(gj)
            for name, w in gj.items():
                err = np.abs(gt[name].double().numpy() - w.numpy()).max()
                assert err <= _leaf_tol(part, name, LEAF_TOL_F64) * scale, (part, name, err, scale)


def check_step(flags: dict, srs, stus, teacher, batch):
    """One step under ``flags`` in JAX and in the port (float32, then
    float64), each held as the module docstring says; returns the port's
    float32 step."""
    want = jax_step(JStepConfig(**flags), srs, stus, teacher, batch)
    got = port_step(StepConfig(**flags), srs, stus, teacher, batch)
    assert_steps_match(want, got)
    assert_float64_step_matches(want, port_step(StepConfig(**flags), srs, stus, teacher, batch,
                                                torch.float64))
    return got


# each: the flags on top of the JAX StepConfig's defaults (the recipe)
FLAG_SETS = {
    "use_label": dict(use_label=True),
    "learning_STN": dict(learning_STN=True),
    "stablize_ssim": dict(training_stablize=True, ssim_loss=True),
    "y_domain": dict(y_domain=True),
    "rotate_0": dict(rotate_train=0.0),
    "no_distill_gradient_tssim": dict(use_distill=False, gradient=False, tssim_loss=False),
}


@pytest.fixture(scope="module")
def variables():
    return make_variables(11)


@pytest.mark.parametrize("name", sorted(FLAG_SETS))
def test_train_step_flags_match_make_train_step(variables, name):
    flags = FLAG_SETS[name]
    srs, stus, teacher = variables
    batch = make_batch(3, rotate=flags.get("rotate_train", 5.0) != 0.0)
    got = check_step(flags, srs, stus, teacher, batch)
    if name == "use_label":
        # the spread labels run 24-26 symbols for 26 frames, blanks among
        # them: most words have no alignment, so the term reads ~1e29-1e30
        # on both sides (and carries no gradient: the teacher is frozen)
        assert got[0]["loss_distill"] > 1e28
    if name == "no_distill_gradient_tssim":
        # no loss reaches the student: it steps with zero gradients
        assert all(float(g.abs().max()) == 0.0 for g in got[1]["student"][0].values())
