"""The port's train steps on D = 2 ``gloo`` ranks (CPU) against the JAX
package's step at the global batch, and against the port's own step in one
process.

JAX's step over a D-device mesh computes the step of the global batch:
sync-BN reduces each copy's statistics over the whole batch, and
``set_bn_replicas(D)`` splits each copy into D contiguous groups
(``tatt_tpu/models/common.py:317-330``), whatever the arrays' placement.
So the JAX side runs the jitted step at the global batch of 16 under
``set_bn_replicas(1)`` or ``(D)`` (reset after each use), and the port
replays the same step on D ranks of 16 / D rows each
(``train/replay.py``): the canonical recipe's flags, fused and with two
forwards, sync-BN and ``--bn_per_replica``; with ``--training_stablize``,
whose top-70 % threshold is the global batch's; and the plain step
(``tsrn``).  Weights come from ``random_variables`` through
``from_jax``, inputs from the JAX collate of seeded synthetic crops, the
rotation pinned, dropout off, two steps of SGD on one batch, at lr 0.01:
an update is then 0.01 times the (clipped) gradient, and the second step
starts from parameters that the first step's rounding moved 100 times less
than at lr 1 (at lr 1 the second step of one process's port already
differs from JAX's by 2.5e-5 of a gradient norm).  Tolerances: those of
``test_torch_flags.assert_steps_match`` (losses and metrics rtol 1e-5;
gradients within 1e-4 of the model's largest entry, the STN head's and
the students' convolutions within 1e-3 for the reasons given there;
parameters and BN statistics rtol 1e-4 / atol 1e-6), but for the SR
output's statistics after an update: ``sr_mean`` / ``sr_min`` /
``sr_max`` of the second step read a forward of parameters that are
themselves held at rtol 1e-4, and are held at the module tolerance (rtol
1e-4, atol 1e-5).  One process's port at the global batch misses rtol
1e-5 there too: ``sr_max`` of the second ``--training_stablize`` step is
1.140e-5 of its value from JAX's in one process, 1.375e-5 on 2 ranks
(``tests/ddp_metric_gaps.py``).  After each step every rank's models are bitwise the others'.

The trainer's Adam is held in ``test_torch_ddp_adam.py`` with this
file's helpers (``adam=True``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from functools import partial

from test_torch_ddp import replay
from test_torch_flags import SMALL, TINY_CRNN, assert_steps_match, make_batch, make_variables
from test_torch_models import random_variables
from test_torch_plain_step import _jax_rotation
from tatt_tpu.losses.image import image_loss as jimage_loss
from tatt_tpu.models import common as jcommon
from tatt_tpu.models import tsrn as jtsrn
from tatt_tpu.models.recognizers.crnn import CRNN as JCRNN
from tatt_tpu.models.tsrn import TATT as JTATT
from tatt_tpu.train.state import TrainState
from tatt_tpu.train.state import make_optimizer as jmake_optimizer
from tatt_tpu.train.steps import StepConfig as JStepConfig
from tatt_tpu.train.steps import make_plain_train_step, make_train_step
from tatt_tpu_torch.core.config import Config, Flags
from tatt_tpu_torch.core.convert import from_jax, from_jax_copies
from tatt_tpu_torch.models import tsrn as ttsrn
from tatt_tpu_torch.models.recognizers.crnn import CRNN
from tatt_tpu_torch.models.tsrn import TATT
from tatt_tpu_torch.train.replay import run_cases
from tatt_tpu_torch.train.steps import StepConfig

BATCH, STEPS, LR = 16, 2, 0.01
ADAM_LR, BETA1 = 1e-3, 0.5  # the trainer's Adam, one step
TRUNK = dict(srb_nums=1, hidden_units=4)
# name -> (step flags over the StepConfig defaults, per replica, the plain step)
CASES_2 = {
    "fused sync": (dict(fused_tssim=True), False, False),
    "fused per-replica": (dict(fused_tssim=True), True, False),
    "two forwards sync": (dict(fused_tssim=False), False, False),
    "two forwards per-replica": (dict(fused_tssim=False), True, False),
    "training_stablize": (dict(training_stablize=True), False, False),
    "plain tsrn": (dict(tssim_loss=True, rotate_train=5.0), False, True),
}


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _variables(plain: bool):
    """(sr variables, student variables, teacher variables) of the case's
    models; the plain step's generator is a ``tsrn``."""
    if not plain:
        (sr,), (stu,), teacher = make_variables(11)
        return sr, stu, teacher
    rng = np.random.default_rng(21)
    sr = random_variables(jtsrn.TSRN(**TRUNK), rng, jnp.zeros((2, 4, 16, 64)), train=True)
    stu = random_variables(JCRNN(**TINY_CRNN), rng, jnp.zeros((2, 1, 32, 100)))
    return sr, stu, stu


def _batch(plain: bool, n: int) -> dict:
    """The global batch of ``n``, the rotation pinned: the JAX plain step
    draws its own (at ``PRNGKey(0)``, every step), which the port's batch
    pins."""
    batch = make_batch(3, n=n)
    batch = {k: batch[k] for k in ("images_hr", "images_lr", "rot_arc", "rot_offs")}
    if plain:
        arc, offs = _jax_rotation(n, 5.0)
        batch.update(rot_arc=arc.astype(np.float32), rot_offs=offs.astype(np.float32))
    return batch


def jax_steps(flags: dict, world: int, per_replica: bool, plain: bool, adam: bool = False) -> list:
    """JAX's jitted step at the global batch, ``STEPS`` times on one batch
    (with ``adam``: one step of the trainer's Adam), under
    ``set_bn_replicas(replicas)`` -> per step (metrics, the clipped
    gradients the optimizer applied, new states) in the port's names."""
    sr_vars, stu_vars, teacher = _variables(plain)
    jcfg = JStepConfig(**flags)
    if plain:
        model = jtsrn.TSRN(**TRUNK)

        def sr_apply_plain(variables, lr, train, rngs=None, mutable=False):
            sr, mut = model.apply(variables, lr, train=train, rngs=rngs, mutable=mutable)
            return (sr[0] if isinstance(sr, tuple) else sr), mut

        criterion = partial(jimage_loss, gradient=jcfg.gradient, loss_weight=(1.0, 1e-4))
        step = make_plain_train_step(sr_apply_plain, criterion, jcfg, 4, ssim_variant="ssim")
        call = lambda state, batch, key: step(state, batch, key)  # noqa: E731
    else:
        sr_model, crnn = JTATT(stn=True, dropout=0.0, **SMALL), JCRNN(**TINY_CRNN)
        fused_model = sr_model.clone(bn_copies=2)

        def sr_apply(variables, lr, prior, train, rngs=None, mutable=False):
            return sr_model.apply(variables, lr, prior, train=train, rngs=rngs, mutable=mutable)

        def sr_apply_fused(variables, lr, prior, train, rngs=None, mutable=False):
            return fused_model.apply(variables, lr, prior, train=train, rngs=rngs, mutable=mutable)

        def crnn_apply(variables, luma, train, mutable=False):
            return crnn.apply(variables, luma, train=train, mutable=mutable)

        step = make_train_step(sr_apply, crnn_apply, crnn_apply, jcfg,
                               sr_apply_fused=sr_apply_fused if jcfg.fused_tssim else None)
        call = lambda state, batch, key: step(state, teacher, batch, key)  # noqa: E731
    jcommon.set_bn_replicas(world if per_replica else 1)
    try:
        jitted = jax.jit(call)
        # SGD whose state keeps the (clipped) gradient it applied: trace
        # with decay 0 holds exactly the last gradient; Adam's first moment
        # after one step is (1 - beta1) times it
        tx = (jmake_optimizer(ADAM_LR, BETA1) if adam
              else optax.chain(optax.trace(decay=0.0), optax.scale(-LR)))
        state = TrainState.create([sr_vars], [stu_vars], tx)
        batch = {k: jnp.asarray(v) for k, v in _batch(plain, BATCH).items()}
        out = []
        for i in range(1 if adam else STEPS):
            new, metrics = jitted(state, batch, jax.random.PRNGKey(0 if plain else i))
            applied = (jax.tree_util.tree_map(lambda m: m / (1 - BETA1), new.opt_state.inner_state[0].mu)
                       if adam else new.opt_state[0].trace)
            grads = {part: [from_jax({"params": _host(applied[part][0])})] for part in ("sr", "student")}
            states = {part: from_jax_copies(_host(getattr(new, f"{part}_params")),
                                            _host(getattr(new, f"{part}_batch_stats")))
                      for part in ("sr", "student")}
            out.append(({k: float(v) for k, v in metrics.items()}, grads, states))
            state = new
    finally:
        jcommon.set_bn_replicas(1)
    return out


def step_case(path, flags: dict, world: int, per_replica: bool, plain: bool,
              dropout: float = 0.0, adam: bool = False) -> str:
    """A replay case of the port's step on the JAX side's weights and batch
    (with ``dropout`` > 0: TATT's dropout on and the rotation drawn; with
    ``adam``: one step of the trainer's Adam)."""
    sr_vars, stu_vars, teacher_vars = _variables(plain)
    if plain:
        generator = ttsrn.TSRN(**TRUNK)
        generator.load_state_dict(from_jax(_host(sr_vars)))
    else:
        generator = TATT(stn=True, dropout=dropout, **SMALL)
        generator.load_state_dict(from_jax_copies([sr_vars["params"]], [sr_vars["batch_stats"]])[0])
    student, teacher = CRNN(**TINY_CRNN), CRNN(**TINY_CRNN)
    student.load_state_dict(from_jax(_host(stu_vars)))
    teacher.load_state_dict(from_jax(_host(teacher_vars)))
    batch = {k: torch.from_numpy(np.array(v)) for k, v in _batch(plain, BATCH).items()}
    if dropout:
        batch = {k: v for k, v in batch.items() if not k.startswith("rot_")}
    args = Flags(arch="tsrn" if plain else "tatt", mask=True, gradient=True)
    torch.save({"kind": "step", "cfg": Config(args=args), "step_cfg": StepConfig(**flags),
                "generators": [generator], "students": [student], "teacher": teacher,
                "batch": batch, "steps": 1 if adam else STEPS, "seed": 0,
                "optimizer": ("adam", ADAM_LR, BETA1) if adam else ("sgd", LR),
                "bn_replicas": world if per_replica else 1}, path)
    return str(path)


def assert_matches_jax(want: tuple, got: tuple, step: int) -> None:
    """``assert_steps_match``, but for the SR output's statistics
    (``sr_mean``, ``sr_min``, ``sr_max``) after an update (``step`` > 0),
    held at the module tolerance (rtol 1e-4, atol 1e-5; module
    docstring)."""
    stats = [k for k in want[0] if k.startswith("sr_")] if step else []
    for k in stats:
        np.testing.assert_allclose(got[0][k], want[0][k], rtol=1e-4, atol=1e-5, err_msg=k)
    assert_steps_match(({k: v for k, v in want[0].items() if k not in stats}, *want[1:]),
                       ({k: v for k, v in got[0].items() if k not in stats}, *got[1:]))


def as_step(result: dict) -> tuple:
    """A replayed step as ``assert_steps_match`` reads it (one generator,
    one student)."""
    (g_sr, g_stu), (s_sr, s_stu) = result["grads"], result["state"]
    return result["metrics"], {"sr": [g_sr], "student": [g_stu]}, {"sr": [s_sr], "student": [s_stu]}


def assert_ranks_equal(ranks: list) -> None:
    """Every rank's models after each step are rank 0's, bit for bit."""
    for other in ranks[1:]:
        for mine, theirs in zip(ranks[0], other):
            for a, b in zip(mine["state"], theirs["state"]):
                assert all(torch.equal(a[k], b[k]) for k in a)


def run_world(cases: dict, world: int, tmp_path_factory, extra=()) -> dict:
    """name -> per rank, per step, the replayed result: one launch."""
    tmp = tmp_path_factory.mktemp(f"steps{world}")
    names = list(cases) + [name for name, _ in extra]
    paths = [step_case(tmp / f"{i}.case", flags, world, rep, plain)
             for i, (flags, rep, plain) in enumerate(cases.values())]
    paths += [make(tmp / f"x{i}.case") for i, (_, make) in enumerate(extra)]
    return dict(zip(names, replay(paths, world))), dict(zip(names, paths))


@pytest.fixture(scope="module")
def ranks_2(tmp_path_factory):
    dropout = ("dropout", lambda p: step_case(p, {}, 2, False, False, dropout=0.1))
    return run_world(CASES_2, 2, tmp_path_factory, extra=[dropout])


def check_against_jax(runs, cases: dict, case: str, world: int) -> None:
    flags, per_replica, plain = cases[case]
    want = jax_steps(flags, world, per_replica, plain)
    ranks = runs[0][case]
    assert_ranks_equal(ranks)
    for i in range(STEPS):
        assert_matches_jax(want[i], as_step(ranks[0][i]), i)


@pytest.mark.parametrize("case", list(CASES_2))
def test_step_on_two_ranks_matches_jax(ranks_2, case):
    check_against_jax(ranks_2, CASES_2, case, 2)


def test_two_ranks_draw_what_one_process_draws(ranks_2):
    """Dropout on, the rotation drawn: 2 ranks against the same replay in
    this process at the global batch."""
    ranks, path = ranks_2[0]["dropout"], ranks_2[1]["dropout"]
    assert_ranks_equal(ranks)
    run_cases(0, 1, torch.device("cpu"), [path])
    one = torch.load(f"{path}.rank0.pt", weights_only=False)
    for i in range(STEPS):
        assert_steps_match(as_step(one[i]), as_step(ranks[0][i]))

