"""The port's bf16 TATT step (``--dtype bfloat16``) against the JAX
package's ``make_train_step(compute_dtype="bfloat16")``, on the CPU.

One recipe step at a small width (one SRB, hidden 4, tiny CRNNs) from the
same seeded weights (``random_variables`` through ``from_jax``) and numpy
inputs, rotation pinned, dropout off, SGD at lr 1 so that the update is the
(clipped) gradient.  JAX's CPU step runs its scan recurrences, which carry
h in bf16 (``tatt_tpu/kernels/rnn.py:85, 128``); the port runs its plain
twins of the bf16 kernels, which carry h in f32 as the TPU kernels do.
And XLA:CPU sums a bias's gradient over the batch and pixels in bf16: JAX's
bf16 step moves the final conv's bias gradient by 0.94 of the generator's
largest gradient entry from its own f32 step (the student's conv2 bias by
0.14), where the port's bf16 step moves no entry by more than 5.4e-3 /
2.8e-2 of it (oneDNN sums in f32).  So the port is held two ways:

(a) the losses within 2e-3 relative of JAX's bf16 step (measured 5.7e-4),
    and each gradient entry within JAX's own bf16 error there (|JAX bf16 -
    JAX f32|) plus 5e-2 of the model's largest f32 gradient entry
    (measured: 2.1e-2 generator, 1.6e-2 student);
(b) the port's bf16-vs-f32 gap (||g_bf16 - g_f32|| / ||g_f32|| over a
    model's leaves) not zero, below 5e-2, and no larger than JAX's own
    (measured: port / JAX generator 1.15e-2 / 0.47, student 2.5e-2 /
    0.11).

Forward hooks assert that every conv, dense and recurrence of the
generator, the student and the teacher takes and returns bf16 under the
flag: the guard against a float32 parameter promoting activations back to
float32.  ``--go_test --dtype bfloat16`` evaluates in float32, as JAX does.
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
from tatt_tpu_torch.core.convert import from_jax
from tatt_tpu_torch.kernels.rnn import BiGRU, BiLSTM
from tatt_tpu_torch.models.common import Conv2d, ConvTranspose2d, Dense
from tatt_tpu_torch.models.recognizers.crnn import CRNN
from tatt_tpu_torch.models.tsrn import TATT
from tatt_tpu_torch.train.steps import StepConfig, train_step

SMALL = dict(srb_nums=1, hidden_units=4, out_text_channels=8)
TINY_CRNN = dict(nh=16, nm=(8, 8, 16, 16, 32, 32, 32))
LOSS_RTOL, GRAD_TOL, GAP_MAX = 2e-3, 5e-2, 5e-2
LOSSES = ("loss_total", "loss_sr", "loss_distill", "loss_tssim")
SHRINK = ["--srb", "1", "--hd_u", "4", "--tiny_tpg", "--device", "cpu"]


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(15)
    sr_model, crnn = JTATT(stn=True, dropout=0.0, **SMALL), JCRNN(**TINY_CRNN)
    sr_vars = random_variables(sr_model, rng, jnp.zeros((2, 4, 16, 64)), jnp.zeros((2, 37, 1, 26)),
                               train=True)
    stn = sr_vars["params"]["stn_head"]  # near its identity border grid, as its init is
    stn["fc2_kernel"] = stn["fc2_kernel"] * 0.1
    stn["fc2_bias"] = (jstn.build_output_control_points(20, (0.01, 0.01)).reshape(-1)
                       + rng.normal(0, 0.01, 40)).astype(np.float32)
    stu_vars = random_variables(crnn, rng, jnp.zeros((2, 1, 32, 100)))
    teacher_vars = random_variables(crnn, rng, jnp.zeros((2, 1, 32, 100)))
    ds = JSynthetic(n=8)
    batch = jcollate([ds[i] for i in range(8)]).device_arrays()
    batch = {k: batch[k] for k in ("images_hr", "images_lr")}
    batch["rot_arc"] = (rng.uniform(-1, 1, 8) * 5.0 / 180.0 * math.pi).astype(np.float32)
    batch["rot_offs"] = rng.uniform(0, 1, 8).astype(np.float32)
    runs = {dt: (_jax_step(sr_model, crnn, sr_vars, stu_vars, teacher_vars, batch, dt),
                 _port_step(sr_vars, stu_vars, teacher_vars, batch, dt))
            for dt in ("float32", "bfloat16")}
    return runs


def _jax_step(sr_model, crnn, sr_vars, stu_vars, teacher_vars, batch, dtype):
    fused_model = sr_model.clone(bn_copies=2)

    def apply(model):
        return lambda v, lr, prior, train, rngs=None, mutable=False: model.apply(
            v, lr, prior, train=train, rngs=rngs, mutable=mutable)

    def crnn_apply(variables, luma, train, mutable=False):
        return crnn.apply(variables, luma, train=train, mutable=mutable)

    cfg = JStepConfig(tssim_loss=True, rotate_train=5.0, use_distill=True, gradient=True,
                      compute_dtype=dtype)
    step = jax.jit(make_train_step(apply(sr_model), crnn_apply, crnn_apply, cfg,
                                   sr_apply_fused=apply(fused_model)))
    state = TrainState.create([sr_vars], [stu_vars], optax.sgd(1.0))
    new_state, metrics = step(state, teacher_vars, {k: jnp.asarray(v) for k, v in batch.items()},
                              jax.random.PRNGKey(0))
    grads = {}
    for name, old, new in (("sr", state.sr_params[0], new_state.sr_params[0]),
                           ("student", state.student_params[0], new_state.student_params[0])):
        delta = jax.tree_util.tree_map(lambda a, b: np.asarray(a) - np.asarray(b), old, new)
        grads[name] = {k: v.double() for k, v in from_jax({"params": delta}).items()}
    return {k: float(v) for k, v in metrics.items()}, grads


def _port_step(sr_vars, stu_vars, teacher_vars, batch, dtype, hooks=None):
    generator = TATT(stn=True, dropout=0.0, **SMALL)
    generator.load_state_dict(from_jax(sr_vars))
    student, teacher = CRNN(**TINY_CRNN), CRNN(**TINY_CRNN)
    student.load_state_dict(from_jax(stu_vars))
    teacher.load_state_dict(from_jax(teacher_vars))
    handles = [] if hooks is None else [
        m.register_forward_hook(hooks) for model in (generator, student, teacher)
        for m in model.modules() if isinstance(m, (Conv2d, ConvTranspose2d, Dense, BiGRU, BiLSTM))]
    opt = torch.optim.SGD(list(generator.parameters()) + list(student.parameters()), lr=1.0)
    metrics = train_step(
        [generator.train()], [student.train()], teacher.eval(), opt,
        {k: torch.tensor(np.asarray(v)) for k, v in batch.items()},
        StepConfig(compute_dtype=dtype), torch.Generator().manual_seed(0))
    for h in handles:
        h.remove()
    grads = {"sr": {k: p.grad.double() for k, p in generator.named_parameters()},
             "student": {k: p.grad.double() for k, p in student.named_parameters()}}
    return {k: v.item() for k, v in metrics.items()}, grads


def _gap(a: dict, b: dict) -> float:
    """||a - b|| / ||b|| over all the leaves of a model."""
    num = math.sqrt(sum((a[k] - v).norm().item() ** 2 for k, v in b.items()))
    return num / math.sqrt(sum(v.norm().item() ** 2 for v in b.values()))


@pytest.mark.parametrize("arch", ["tatt"])
def test_bf16_step_matches_jax_bf16_step(setup, arch):
    """(a): the port's bf16 step against JAX's, the losses and every
    gradient entry (beyond JAX's own bf16 error in that entry)."""
    (m_j, g_j), (m_t, g_t) = setup["bfloat16"]
    _, g_j32 = setup["float32"][0]
    for key in LOSSES:
        assert math.isfinite(m_t[key])
        assert abs(m_t[key] - m_j[key]) <= LOSS_RTOL * abs(m_j[key]), (key, m_t[key], m_j[key])
    for part in ("sr", "student"):
        assert sorted(g_t[part]) == sorted(g_j[part])
        scale = max(v.abs().max().item() for v in g_j32[part].values())
        for name, want in g_j[part].items():
            own = (want - g_j32[part][name]).abs()
            excess = ((g_t[part][name] - want).abs() - own).max().item()
            assert excess <= GRAD_TOL * scale, (part, name, excess, scale)


@pytest.mark.parametrize("arch", ["tatt"])
def test_bf16_gap_is_no_larger_than_jax(setup, arch):
    """(b): bf16 moves the port's gradients from its own f32 step, by
    less than a stated bound and no further than it moves JAX's."""
    (_, g_j32), (_, g_t32) = setup["float32"]
    (_, g_j16), (_, g_t16) = setup["bfloat16"]
    for part in ("sr", "student"):
        port, jax_gap = _gap(g_t16[part], g_t32[part]), _gap(g_j16[part], g_j32[part])
        assert 0.0 < port <= min(GAP_MAX, jax_gap), (part, port, jax_gap)


def test_every_layer_runs_in_bf16(setup):
    """Forward hooks on every Conv2d, ConvTranspose2d, Dense, BiGRU and
    BiLSTM of the generator, the student and the teacher: each takes and
    returns bf16 under the flag (and float32 without it)."""
    for dtype, want in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
        seen, bad = [], []

        def hook(module, inputs, output):
            outs = output if isinstance(output, tuple) else (output,)
            for t in [a for a in inputs if torch.is_tensor(a)][:1] + [o for o in outs if torch.is_tensor(o)]:
                seen.append(type(module).__name__)
                if t.dtype != want:
                    bad.append((type(module).__name__, t.dtype))

        rng = np.random.default_rng(3)
        sr_vars = random_variables(JTATT(stn=True, dropout=0.0, **SMALL), rng, jnp.zeros((2, 4, 16, 64)),
                                   jnp.zeros((2, 37, 1, 26)), train=True)
        crnn_vars = random_variables(JCRNN(**TINY_CRNN), rng, jnp.zeros((2, 1, 32, 100)))
        ds = JSynthetic(n=4)
        batch = jcollate([ds[i] for i in range(4)]).device_arrays()
        batch = {k: batch[k] for k in ("images_hr", "images_lr")}
        _port_step(sr_vars, crnn_vars, crnn_vars, batch, dtype, hooks=hook)
        assert not bad, (dtype, bad[:5])
        assert {"Conv2d", "Dense", "BiGRU", "BiLSTM"} <= set(seen), set(seen)


def _go_test(dtype: str) -> dict:
    import ast
    import contextlib
    import io

    from tatt_tpu_torch.cli import main as cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert cli.main(["--go_test", "--synthetic", "8", "--mask", "--batch_size", "4",
                         "--dtype", dtype] + SHRINK) == 0
    summaries = {}
    for line in buf.getvalue().splitlines():
        if line.startswith("["):
            name, text = line.split(" ", 1)
            summaries[name] = ast.literal_eval(text)
            summaries[name].pop("fps")  # a timing
    return summaries


def test_go_test_evaluates_in_float32(capsys):
    """``--go_test --dtype bfloat16`` gives ``--dtype float32``'s summary to
    the bit (all but the timed fps), and says so on stderr."""
    want = _go_test("float32")
    assert want and _go_test("bfloat16") == want
    assert "acts in the TATT train step only; evaluation runs in float32" in capsys.readouterr().err


def test_cli_trains_tatt_in_bf16_and_refuses_the_archs_not_held(capsys):
    """The recipe under ``--dtype bfloat16`` trains (the step in bf16), and
    so does ``--tpg OPT``; a TATT-step arch that no bf16 case holds, whose
    prior runs through InfoGen's ``ConvTranspose2d``, is refused with the
    JAX package's reason (its bf16 step fails there); a plain-step arch
    trains in float32, as in JAX, with a warning."""
    from tatt_tpu_torch.cli import main as cli

    recipe = ["--arch=tatt", "--STN", "--mask", "--use_distill", "--gradient", "--sr_share",
              "--rotate_train=5.0", "--tssim_loss", "--batch_size", "4", "--max_iters", "1",
              "--synthetic", "8", "--dtype", "bfloat16"] + SHRINK
    for extra in ([], ["--tpg", "OPT"]):
        code, trainer = cli.run(recipe + extra)
        assert code == 0 and trainer.step_cfg.compute_dtype == "bfloat16", extra
    with pytest.raises(SystemExit, match="--dtype bfloat16 with --arch=tsrn_tl_cascade: .*"
                                         "tatt_tpu/models/common.py:300"):
        cli.main(recipe + ["--arch=tsrn_tl_cascade"])
    code, trainer = cli.run(["--arch=tsrn", "--mask", "--batch_size", "4", "--max_iters", "1",
                             "--synthetic", "8", "--dtype", "bfloat16"] + SHRINK)
    assert code == 0
    assert "--arch=tsrn's plain step runs in float32" in capsys.readouterr().err
