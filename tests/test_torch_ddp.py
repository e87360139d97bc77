"""Data parallelism of the port on the CPU (``gloo`` ranks) against the JAX
package's mesh: BatchNorm, the layout helpers, the process group, the CLI
and checkpoints across world sizes.

The port's ranks are processes that ``tatt_tpu_torch.cli.launch.launch``
spawns; each replays saved cases (``train/replay.py``) or runs the CLI's
training worker.  Every launch gets a process-group timeout of
``GROUP_TIMEOUT_S`` and a deadline of ``DEADLINE_S``, so that a hang
fails the test in minutes.  The JAX side is the package's BatchNorm under
``set_bn_replicas(D)`` (reset after each use, as
``tests/test_bn_per_replica.py`` does) and its ``core/mesh.py`` on the
8-device virtual CPU mesh.  Module tolerance atol 1e-5 / rtol 1e-4 (the
repo's f32 one); each other tolerance is stated where it is used.
"""

import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tatt_tpu.cli.main import build_parser as jax_parser
from tatt_tpu.core import mesh as jmesh
from tatt_tpu.models import common as jcommon
from tatt_tpu_torch.cli import launch
from tatt_tpu_torch.cli import main as cli
from tatt_tpu_torch.core import distributed, mesh
from tatt_tpu_torch.models import common as tcommon
from tatt_tpu_torch.train.loop import BATCH_REFUSAL
from tatt_tpu_torch.train.replay import run_cases

TOL = dict(atol=1e-5, rtol=1e-4)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GROUP_TIMEOUT_S, DEADLINE_S = 60.0, 300.0
SHRUNK = ["--srb", "1", "--hd_u", "4", "--tiny_tpg", "--device", "cpu"]
RECIPE = ["--arch=tatt", "--STN", "--mask", "--use_distill", "--gradient", "--sr_share",
          "--stu_iter=1", "--rotate_train=5.0", "--tssim_loss"]


def spawn(fn, world: int, *args) -> None:
    """``fn`` on ``world`` gloo ranks on the CPU, bounded in time."""
    launch.launch(fn, world, args, devices=["cpu"] * world, timeout_s=GROUP_TIMEOUT_S,
                  deadline_s=DEADLINE_S)


def replay(paths, world: int) -> list:
    """Each case file replayed on ``world`` ranks -> per case, per rank,
    the result."""
    spawn(run_cases, world, [str(p) for p in paths])
    return [[torch.load(f"{p}.rank{r}.pt", weights_only=False) for r in range(world)]
            for p in paths]


def unshard(parts, copies: int) -> np.ndarray:
    """Ranks' rows (in rank order) back in the global batch's order: each
    copy's block holds rank 0's rows, then rank 1's, ..."""
    blocks = [torch.as_tensor(p).chunk(copies) for p in parts]
    return torch.cat([b[c] for c in range(copies) for b in blocks]).numpy()


def dp_plan_matches_jax(argv, monkeypatch) -> None:
    """``parse_config`` accepts ``argv``, and :func:`mesh.resolve_dp` plans
    the device count that JAX's ``make_mesh`` takes from the visible
    devices (the 8 virtual CPU devices here, 8 cards on CUDA), or as many
    CPU ranks as asked (at least 1); nothing is spawned."""
    cfg, _ = cli.parse_config(argv)
    n = cfg.args.dp_devices
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    assert mesh.resolve_dp(n, "cuda") == len(jmesh.make_mesh(n).devices.ravel())
    assert mesh.resolve_dp(n, "cpu") == max(n, 1)


# ---- BatchNorm across ranks ------------------------------------------------

BN_ITEMS = [(dim, copies) for dim in (1, 2) for copies in (1, 2)]
BN_MODES = ("sync", "replica", "fault")  # fault: sync with the moments' gradient local


def _bn_inputs(dim: int, copies: int, world: int):
    """A shard-skewed global batch: group g = (copy c, rank r), g = c * world
    + r, drawn around g + 1 with spread 0.5 + 0.1 g, so that per-replica
    statistics differ from sync ones; its cotangent and BN variables."""
    rng = np.random.default_rng(100 * world + 10 * dim + copies)
    shape = (3, 5) if dim == 1 else (3, 5, 3, 4)
    x = np.concatenate([(g + 1.0) + (0.5 + 0.1 * g) * rng.standard_normal(shape)
                        for g in range(copies * world)]).astype(np.float32)
    dy = rng.standard_normal(x.shape).astype(np.float32)
    params = {k: v.astype(np.float32) for k, v in (
        ("scale", rng.uniform(0.8, 1.2, 5)), ("bias", rng.normal(0, 0.1, 5)),
        ("mean", rng.normal(0, 0.1, 5)), ("var", rng.uniform(0.5, 1.5, 5)))}
    return x, dy, params


def _jax_bn(dim: int, copies: int, replicas: int, x, dy, p) -> dict:
    """JAX's training forward and its VJP under ``set_bn_replicas``."""
    jcommon.set_bn_replicas(replicas)
    try:
        bn = (jcommon.BatchNorm1d if dim == 1 else jcommon.BatchNorm2d)(copies=copies)
        stats = {"mean": jnp.asarray(p["mean"]), "var": jnp.asarray(p["var"])}

        def f(scale, bias, x):
            return bn.apply({"params": {"scale": scale, "bias": bias}, "batch_stats": stats}, x,
                            True, mutable=["batch_stats"])

        y, vjp, mut = jax.vjp(f, jnp.asarray(p["scale"]), jnp.asarray(p["bias"]), jnp.asarray(x),
                              has_aux=True)
        dscale, dbias, dx = vjp(jnp.asarray(dy))
    finally:
        jcommon.set_bn_replicas(1)
    return {k: np.asarray(v) for k, v in (
        ("y", y), ("dx", dx), ("dweight", dscale), ("dbias", dbias),
        ("running_mean", mut["batch_stats"]["mean"]), ("running_var", mut["batch_stats"]["var"]))}


def _port_bn(dim: int, p: dict):
    bn = (tcommon.BatchNorm1d if dim == 1 else tcommon.BatchNorm2d)(5)
    bn.load_state_dict({k: torch.from_numpy(p[j]) for k, j in (
        ("weight", "scale"), ("bias", "bias"), ("running_mean", "mean"), ("running_var", "var"))})
    return bn


@pytest.fixture(scope="module")
def bn_runs(tmp_path_factory):
    """world -> mode -> [per item, per rank, the result]: one launch per
    world size replays the three modes' cases."""
    out = {}
    for world in (2, 4):
        tmp = tmp_path_factory.mktemp(f"bn{world}")
        paths = []
        for mode in BN_MODES:
            items = []
            for dim, copies in BN_ITEMS:
                x, dy, p = _bn_inputs(dim, copies, world)
                items.append({"module": _port_bn(dim, p), "x": torch.from_numpy(x),
                              "dy": torch.from_numpy(dy), "copies": copies})
            paths.append(tmp / f"{mode}.pt")
            torch.save({"kind": "bn", "bn_replicas": world if mode == "replica" else 1,
                        "fault": "local_grad" if mode == "fault" else None, "items": items},
                       paths[-1])
        results = replay(paths, world)
        out[world] = {mode: [[results[m][r][i] for r in range(world)] for i in range(len(BN_ITEMS))]
                      for m, mode in enumerate(BN_MODES)}
    return out


@pytest.mark.parametrize("mode", ["sync", "replica"])
@pytest.mark.parametrize("dim,copies", BN_ITEMS)
@pytest.mark.parametrize("world", [2, 4])
def test_batchnorm_across_ranks_matches_jax(bn_runs, world, dim, copies, mode):
    """Outputs, input gradients, the scale's and bias's gradients (summed
    over the ranks: the loss is a sum) and running statistics of D ranks
    against JAX's BatchNorm over the global batch, sync-BN or
    ``set_bn_replicas(D)``.  Sync: every rank folds the same global
    statistics, bit for bit.  Per replica: rank 0's running statistics are
    JAX's (its replica-0 groups).  The batch is skewed by shard, so that the
    two modes' outputs differ by more than 0.5; and a plain (not
    differentiable) all-reduce of the moments gives JAX's output but misses
    its input gradient."""
    x, dy, p = _bn_inputs(dim, copies, world)
    want = _jax_bn(dim, copies, world if mode == "replica" else 1, x, dy, p)
    ranks = bn_runs[world][mode][BN_ITEMS.index((dim, copies))]
    for key in ("y", "dx"):
        np.testing.assert_allclose(unshard([r[key] for r in ranks], copies), want[key],
                                   err_msg=key, **TOL)
    for key in ("dweight", "dbias"):
        np.testing.assert_allclose(sum(r[key] for r in ranks).numpy(), want[key], err_msg=key, **TOL)
    for key in ("running_mean", "running_var"):
        np.testing.assert_allclose(ranks[0][key].numpy(), want[key], err_msg=key, **TOL)
    other = "replica" if mode == "sync" else "sync"
    y_other = unshard([r["y"] for r in bn_runs[world][other][BN_ITEMS.index((dim, copies))]], copies)
    assert np.abs(y_other - want["y"]).max() > 0.5
    if mode == "sync":
        for r in ranks[1:]:
            assert torch.equal(r["running_mean"], ranks[0]["running_mean"])
            assert torch.equal(r["running_var"], ranks[0]["running_var"])
        fault = bn_runs[world]["fault"][BN_ITEMS.index((dim, copies))]
        np.testing.assert_allclose(unshard([r["y"] for r in fault], copies), want["y"], **TOL)
        miss = np.abs(unshard([r["dx"] for r in fault], copies) - want["dx"]).max()
        assert miss > 0.05 * np.abs(want["dx"]).max(), miss


# ---- the layout and the draws ---------------------------------------------


@pytest.mark.parametrize("world", [1, 2, 4, 8])
def test_shard_and_pad_match_the_jax_mesh(world):
    """Rank r's rows are the shard JAX's ``shard_batch`` puts on device r of
    ``make_mesh(world)``; ``pad_to_multiple`` pads as JAX's does."""
    rng = np.random.default_rng(world)
    batch = {"a": rng.standard_normal((16, 3)).astype(np.float32),
             "b": rng.integers(0, 9, (16, 2, 2)).astype(np.int32)}
    placed = jmesh.shard_batch(jmesh.make_mesh(world), batch)
    devices = list(jmesh.make_mesh(world).devices.ravel())
    for key, arr in placed.items():
        for shard in arr.addressable_shards:
            r = devices.index(shard.device)
            np.testing.assert_array_equal(mesh.shard_batch(batch[key], r, world), np.asarray(shard.data))
            np.testing.assert_array_equal(
                mesh.shard_batch(torch.from_numpy(batch[key]), r, world).numpy(), np.asarray(shard.data))
    part = {k: v[:13] for k, v in batch.items()}
    want, n_want = jmesh.pad_to_multiple(part, world)
    got, n_got = mesh.pad_to_multiple(part, world)
    assert n_got == n_want == 13
    for key in part:
        np.testing.assert_array_equal(got[key], want[key])
    if world > 1:
        with pytest.raises(ValueError, match="not divisible"):
            mesh.shard_batch(part["a"], 0, world)


@pytest.mark.parametrize("copies", [1, 2])
@pytest.mark.parametrize("world", [2, 4])
def test_rank_draws_are_rows_of_the_global_draw(monkeypatch, world, copies):
    """``rand_rows`` of D ranks at the local shape, put back in the global
    order, is one process's draw at the global shape (per copy under
    ``packed_copies``), and each rank's generator ends where that one's
    does; the rotation angles of ``steps._rotation`` follow."""
    from tatt_tpu_torch.train.steps import _rotation

    local = (copies * 3, 2, 5)
    want_gen = torch.Generator().manual_seed(7)
    want = torch.rand((local[0] * world, *local[1:]), generator=want_gen)
    parts, gens = [], []
    for r in range(world):
        monkeypatch.setattr(distributed, "rank", lambda r=r: r)
        monkeypatch.setattr(distributed, "world", lambda: world)
        gen = torch.Generator().manual_seed(7)
        with distributed.packed_copies(copies):
            parts.append(distributed.rand_rows(local, gen, "cpu"))
        gens.append(gen)
    np.testing.assert_array_equal(unshard(parts, copies), want.numpy())
    for gen in gens:
        assert torch.equal(gen.get_state(), want_gen.get_state())
    arcs = []
    for r in range(world):
        monkeypatch.setattr(distributed, "rank", lambda r=r: r)
        arcs.append(_rotation({"images_lr": torch.zeros(3)}, 3, 5.0, torch.Generator().manual_seed(3))[0])
    monkeypatch.setattr(distributed, "world", lambda: 1)
    monkeypatch.setattr(distributed, "rank", lambda: 0)
    whole = _rotation({"images_lr": torch.zeros(3)}, 3 * world, 5.0, torch.Generator().manual_seed(3))[0]
    np.testing.assert_array_equal(torch.cat(arcs).numpy(), whole.numpy())


def test_collectives_are_the_identity_without_a_process_group():
    """One process: every reduction returns its input, bit for bit."""
    assert not torch.distributed.is_initialized()
    assert (distributed.rank(), distributed.world()) == (0, 1)
    assert distributed.local_batch_slice(8) == (8, 0)
    x = torch.randn(4, 3, requires_grad=True)
    assert distributed.mean_over_ranks(x) is x
    assert distributed.gather_rows(x) is x
    m = {"loss_sr": torch.tensor(2.0), "sr_min": torch.tensor(-1.0)}
    assert distributed.reduce_metrics(m) is m
    p = torch.nn.Parameter(torch.randn(3))
    p.grad = torch.randn(3)
    g = p.grad.clone()
    distributed.average_grads([p])
    assert torch.equal(p.grad, g)


def test_cuda_flags_autotune_unless_deterministic():
    """``set_cuda_flags`` autotunes cuDNN, but not under deterministic
    algorithms, whose autotuned choice a rank may time otherwise."""
    from tatt_tpu_torch.core.device import set_cuda_flags

    before = (torch.backends.cudnn.benchmark, torch.backends.cudnn.allow_tf32,
              torch.backends.cuda.matmul.allow_tf32)
    try:
        torch.use_deterministic_algorithms(True, warn_only=True)
        set_cuda_flags()
        assert not torch.backends.cudnn.benchmark
        torch.use_deterministic_algorithms(False)
        set_cuda_flags()
        assert torch.backends.cudnn.benchmark
    finally:
        torch.use_deterministic_algorithms(False)
        (torch.backends.cudnn.benchmark, torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = before


# ---- the process group ------------------------------------------------------

_INIT_WORKER = r"""
import os, sys
import torch
import torch.distributed as dist
from tatt_tpu_torch.core import distributed
pid = int(sys.argv[1])
if pid == 0:  # explicit arguments: process_id=0 must win over PROCESS_ID=1
    distributed.initialize(os.environ["COORDINATOR_ADDRESS"], 2, 0, device="cpu", timeout_s=60)
else:  # all from the environment
    distributed.initialize(device="cpu", timeout_s=60)
assert dist.get_backend() == "gloo"
assert (distributed.rank(), distributed.world()) == (pid, 2)
t = torch.tensor([pid + 1.0])
dist.all_reduce(t)
assert t.item() == 3.0
assert distributed.local_batch_slice(8) == (4, 4 * pid)
dist.destroy_process_group()
print(f"proc {pid} OK")
"""


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_initialize_two_processes_from_arguments_and_environment(monkeypatch):
    """The counterpart of ``tests/test_distributed.py``: process 0 joins by
    explicit arguments (``process_id=0`` over an environment that says 1),
    process 1 from ``COORDINATOR_ADDRESS`` / ``NUM_PROCESSES`` /
    ``PROCESS_ID``; an all-reduce and ``local_batch_slice`` follow.  No
    coordinator: nothing is initialized."""
    env = {**os.environ, "COORDINATOR_ADDRESS": f"127.0.0.1:{_free_port()}", "NUM_PROCESSES": "2",
           "PROCESS_ID": "1", "PYTHONPATH": REPO}
    procs = [subprocess.Popen([sys.executable, "-c", _INIT_WORKER, str(pid)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for pid in (0, 1)]
    try:
        outs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"proc {pid} OK" in out, out
    monkeypatch.delenv("COORDINATOR_ADDRESS", raising=False)
    distributed.initialize(device="cpu")
    assert not torch.distributed.is_initialized()


_HOST = r"""
import sys
from tatt_tpu_torch.cli.launch import launch
from tatt_tpu_torch.train.replay import run_cases
launch(run_cases, 1, ([sys.argv[1]],), devices=["cpu"], timeout_s=60, deadline_s=120)
print("host OK")
"""


def test_launch_across_hosts_takes_global_ranks(bn_runs, tmp_path):
    """Two hosts (processes here) with ``COORDINATOR_ADDRESS``,
    ``NUM_PROCESSES=2`` and ``PROCESS_ID`` 0 / 1 each launch one rank: host
    h's rank is global rank h of 2, as JAX's multi-host ``initialize``
    numbers processes.  They replay the sync BatchNorm case of the 2-rank
    ``file://`` launch, and each writes what that launch's rank h wrote,
    bit for bit."""
    items = []
    for dim, copies in BN_ITEMS:
        x, dy, p = _bn_inputs(dim, copies, 2)
        items.append({"module": _port_bn(dim, p), "x": torch.from_numpy(x),
                      "dy": torch.from_numpy(dy), "copies": copies})
    path = tmp_path / "sync.pt"
    torch.save({"kind": "bn", "bn_replicas": 1, "fault": None, "items": items}, path)
    env = {**os.environ, "COORDINATOR_ADDRESS": f"127.0.0.1:{_free_port()}", "NUM_PROCESSES": "2",
           "PYTHONPATH": REPO}
    procs = [subprocess.Popen([sys.executable, "-c", _HOST, str(path)],
                              env={**env, "PROCESS_ID": str(h)}, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for h in (0, 1)]
    try:
        outs = [p.communicate(timeout=180)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0 and "host OK" in out, out
    for r in range(2):
        got = torch.load(f"{path}.rank{r}.pt", weights_only=False)
        for i in range(len(BN_ITEMS)):
            want = bn_runs[2]["sync"][i][r]
            assert sorted(got[i]) == sorted(want)
            for key in want:
                assert torch.equal(got[i][key], want[key]), (r, BN_ITEMS[i], key)


# ---- the CLI ---------------------------------------------------------------


def test_parsers_have_the_same_options():
    """The port's options are the JAX CLI's, and ``--device``."""
    def options(parser):
        return {o for a in parser._actions for o in a.option_strings}

    assert options(cli.build_parser()) == options(jax_parser()) | {"--device"}


def test_cli_trains_on_two_cpu_ranks(tmp_path):
    """``python -m tatt_tpu_torch.cli.main --dp_devices 2 --device cpu``:
    two ranks train one step at the global batch 4 and the CLI exits 0;
    rank 0 alone prints.  The run is bounded by the subprocess's timeout
    (a rank outliving it gets the parent's death signal from ``spawn``)."""
    argv = RECIPE + SHRUNK + ["--batch_size", "4", "--max_iters", "1", "--synthetic", "8",
                              "--dp_devices", "2", "--steps_per_dispatch", "1"]
    env = {k: v for k, v in os.environ.items() if k != "COORDINATOR_ADDRESS"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-m", "tatt_tpu_torch.cli.main", *argv], cwd=tmp_path,
                          env=env, capture_output=True, text=True, timeout=DEADLINE_S)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    assert "[dp] 2 data-parallel ranks on cpu" in proc.stdout
    assert proc.stdout.count("[train] iters 1 ") == 1


def test_a_failing_rank_ends_the_launch(tmp_path):
    """A batch that D does not divide is refused with JAX's reason in every
    rank, and the launch raises."""
    argv = RECIPE + SHRUNK + ["--batch_size", "3", "--max_iters", "1", "--synthetic", "8"]
    with pytest.raises(Exception, match="does not split over 2 data-parallel ranks"):
        spawn(launch.train_worker, 2, [argv])
    assert "shard_batch refuses it too" in BATCH_REFUSAL


def test_steps_per_dispatch_above_one_is_refused_as_tpu_dispatch():
    for k in ("2", "4"):
        with pytest.raises(SystemExit, match="TPU dispatch") as err:
            cli.parse_config(["--steps_per_dispatch", k])
        assert "not ported yet" not in str(err.value)
    cfg, _ = cli.parse_config(["--steps_per_dispatch", "1", "--dp_devices", "3", "--bn_per_replica"])
    assert (cfg.args.steps_per_dispatch, cfg.args.dp_devices, cfg.args.bn_per_replica) == (1, 3, True)


# ---- checkpoints across world sizes -----------------------------------------

# a small lr: Adam moves an entry whose gradient is rounding noise (a conv
# bias ahead of a training-mode BatchNorm) by up to lr in that noise's
# direction, which differs between 1 and 2 ranks; at 1e-7 such moves stay
# inside the parameters' atol
CKPT_LR = 1e-7


def _ckpt_argv(yaml: str, vis: str, resume=None) -> list:
    argv = RECIPE + SHRUNK + ["--synthetic", "8", "--config", yaml, "--lr", str(CKPT_LR),
                              "--vis_dir", vis, "--max_iters", "2"]
    return argv + (["--resume", resume] if resume else [])


def _trainer_state(trainer) -> dict:
    return launch.state_of(trainer.generators + trainer.students, trainer.optimizer)


def _assert_equal_states(got: dict, want: dict) -> None:
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def _resumed_step_case(argv: list, path: str, out) -> str:
    """A replay case: the CLI's models and Adam resumed from the checkpoint
    at ``path``, one step on a fixed batch and dropout seed."""
    from tatt_tpu_torch.core.checkpoint import resume_models
    from tatt_tpu_torch.data.collate import collate
    from tatt_tpu_torch.data.synthetic import SyntheticTextDataset
    from tatt_tpu_torch.train.loop import step_config
    from tatt_tpu_torch.train.state import make_optimizer

    cfg, _ = cli.parse_config(argv)
    generators, students, teacher = cli.build_models(cfg, "")
    opt = make_optimizer([p for m in generators + students for p in m.parameters()], CKPT_LR)
    resume_models(path, generators, students, opt)
    ds = SyntheticTextDataset(n=4, seed=9)
    b = collate([ds[i] for i in range(4)])
    torch.save({"kind": "step", "cfg": cfg, "step_cfg": step_config(cfg.args),
                "generators": generators, "students": students, "teacher": teacher,
                "batch": {k: torch.from_numpy(getattr(b, k)) for k in ("images_hr", "images_lr")},
                "steps": 1, "seed": 5, "optimizer": ("adam", CKPT_LR, 0.5),
                "optimizer_state": opt.state_dict(), "bn_replicas": 1}, out)
    return str(out)


def test_checkpoints_cross_world_sizes(tmp_path):
    """A 1-rank run saves at step 2 and a 2-rank run resumes it; a 2-rank
    run saves and a 1-rank run resumes.  The format is one: the resumed
    models and Adam state are the saver's, bit for bit, on every rank.
    Then one step on a fixed batch and dropout seed from each file, on 1
    and on 2 ranks: the two agree (models, BN statistics, Adam's moments and
    step counts within rtol 1e-4 / atol 1e-6; losses within rtol 1e-5),
    as the resumed step equals the uninterrupted one in one process
    (``test_torch_checkpoint.py``).  Each run restarts its loader at epoch
    0, as the JAX trainer does, so the runs' later batches are not
    compared."""
    yaml = tmp_path / "cfg.yaml"
    yaml.write_text("TRAIN:\n  batch_size: 4\n  saveInterval: 2\n"
                    f"  ckpt_dir: '{tmp_path / 'ckpt'}'\n"
                    "  VAL:\n    valInterval: 0\n    crnn_pretrained: ''\n")
    ckpt = lambda vis: str(tmp_path / "ckpt" / vis / "checkpoint.ckpt")  # noqa: E731
    code, saver1 = cli.run(_ckpt_argv(str(yaml), "a1"))
    assert code == 0 and saver1.iters == 2
    out = tmp_path / "ranks"
    out.mkdir()
    spawn(launch.train_worker, 2, [_ckpt_argv(str(yaml), "a2"),
                                   _ckpt_argv(str(yaml), "r2", ckpt("a1"))], str(out))
    (saver2, rank1_saver2), (resumed2, rank1_resumed2) = (
        [torch.load(out / f"rank{r}.{i}.pt", weights_only=False)["state"] for r in range(2)]
        for i in range(2))
    _assert_equal_states(rank1_saver2, saver2)  # both ranks hold one state
    _assert_equal_states(rank1_resumed2, resumed2)
    _assert_equal_states(resumed2, _trainer_state(saver1))
    code, resumed1 = cli.run(_ckpt_argv(str(yaml), "r1", ckpt("a2")))
    assert code == 0 and resumed1.iters == 2
    _assert_equal_states(_trainer_state(resumed1), saver2)

    paths = [_resumed_step_case(_ckpt_argv(str(yaml), "c"), ckpt(vis), tmp_path / f"{vis}.case")
             for vis in ("a1", "a2")]
    two = replay(paths, 2)
    for path, ranks in zip(paths, two):
        run_cases(0, 1, torch.device("cpu"), [path])
        (one,) = torch.load(f"{path}.rank0.pt", weights_only=False)
        (got,) = ranks[0]
        for key, value in one["metrics"].items():
            if key.startswith("loss_"):
                np.testing.assert_allclose(got["metrics"][key], value, rtol=1e-5, err_msg=key)
        want = launch.state_of(one["state"], one["optimizer"])
        have = launch.state_of(got["state"], got["optimizer"])
        assert sorted(have) == sorted(want)
        for k in want:
            np.testing.assert_allclose(have[k].numpy(), want[k].numpy(), rtol=1e-4, atol=1e-6,
                                       err_msg=k)
