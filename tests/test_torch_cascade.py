"""``--stu_iter=2`` in the port against the JAX package (CPU, small widths):
one train step without and with sharing (per-copy generators and students
under one optimizer, the student at iteration 1 reading the detached SR,
``for_cascading``), the eval step's cascade, a checkpoint and ``--resume``
round trip of a two-copy run, and the CLI's flags.

The step helpers and their tolerances are ``test_torch_flags.py``'s; the
eval step is held at the module tolerance of ``test_torch_models.py``
(atol 1e-5 / rtol 1e-4); checkpoints and resumed steps are bitwise.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_flags import (
    SMALL, TINY_CRNN, check_step, make_batch, make_variables,
)
from tatt_tpu.models.recognizers.crnn import CRNN as JCRNN
from tatt_tpu.models.tsrn import TATT as JTATT
from tatt_tpu.train.steps import make_eval_step
from tatt_tpu_torch.core.checkpoint import load_checkpoint
from tatt_tpu_torch.core.config import Config, Flags
from tatt_tpu_torch.core.convert import from_jax_copies
from tatt_tpu_torch.data.collate import collate
from tatt_tpu_torch.data.synthetic import SyntheticTextDataset
from tatt_tpu_torch.models.common import init_parameters
from tatt_tpu_torch.models.recognizers.crnn import CRNN
from tatt_tpu_torch.models.tsrn import TATT
from tatt_tpu_torch.train.loop import Trainer, step_batch, step_config
from tatt_tpu_torch.train.steps import eval_step, train_step

CPU = torch.device("cpu")
# (flags, generator copies, student copies)
CASCADES = {
    "separate_for_cascading": (dict(stu_iter=2, sr_share=False, tpg_share=False,
                                    for_cascading=True), 2, 2),
    "shared": (dict(stu_iter=2, sr_share=True, tpg_share=True), 1, 1),
    "separate_generators_shared_student": (dict(stu_iter=2, sr_share=False, tpg_share=True), 2, 1),
}


@pytest.mark.parametrize("name", sorted(CASCADES))
def test_stu_iter_2_step_matches_make_train_step(name):
    flags, n_sr, n_stu = CASCADES[name]
    srs, stus, teacher = make_variables(21, n_sr, n_stu)
    batch = make_batch(4)
    got = check_step(flags, srs, stus, teacher, batch)
    if n_sr == 2:  # the second copy trains on iteration 1's loss, weighted 1.5
        assert all(float(g.abs().max()) > 0 for g in got[1]["sr"][1].values()
                   if g.dim() > 1)


def test_eval_step_for_cascading_matches_make_eval_step():
    """Two iterations with a generator and a student per iteration; the
    generator at iteration 1 reads the previous SR resized to LR, clamped
    and averaged with LR."""
    srs, stus, _ = make_variables(31, 2, 2)
    sr_model, crnn = JTATT(stn=True, dropout=0.0, **SMALL), JCRNN(**TINY_CRNN)
    step = make_eval_step(
        lambda v, lr, prior, train: sr_model.apply(v, lr, prior, train=train),
        lambda v, luma, train: crnn.apply(v, luma, train=train),
        stu_iter=2, sr_share=False, tpg_share=False, for_cascading=True,
    )
    state = types.SimpleNamespace(
        sr_params=tuple(v["params"] for v in srs), sr_batch_stats=tuple(v["batch_stats"] for v in srs),
        student_params=tuple(v["params"] for v in stus),
        student_batch_stats=tuple(v["batch_stats"] for v in stus),
    )
    images_lr = make_batch(5, rotate=False)["images_lr"]
    want, _ = step(state, {"images_lr": jnp.asarray(images_lr)})
    generators = [TATT(stn=True, dropout=0.0, **SMALL) for _ in srs]
    students = [CRNN(**TINY_CRNN) for _ in stus]
    for model, sd in zip(generators + students, from_jax_copies(
            [v["params"] for v in srs + stus], [v["batch_stats"] for v in srs + stus])):
        model.load_state_dict(sd)
    got, _ = eval_step([m.eval() for m in generators], [m.eval() for m in students],
                       torch.from_numpy(images_lr), stu_iter=2, for_cascading=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-4)
    plain, _ = eval_step(generators, students, torch.from_numpy(images_lr), stu_iter=2)
    assert not torch.allclose(plain, got)  # the cascade input changes the SR


def _cfg(tmp_path, **flags) -> Config:
    """A two-copy run's flags (``--stu_iter=2 --for_cascading``, no
    sharing), overridden by ``flags``."""
    base = dict(STN=True, mask=True, use_distill=True, gradient=True, tssim_loss=True,
                rotate_train=5.0, stu_iter=2, for_cascading=True, batch_size=4, vis_dir="v")
    cfg = Config(args=Flags(**{**base, **flags}))
    cfg.TRAIN.ckpt_dir = str(tmp_path / "ckpt")
    cfg.TRAIN.saveInterval, cfg.TRAIN.VAL.valInterval = 2, 0
    return cfg


def _trainer(cfg, seed) -> Trainer:
    generators = [init_parameters(TATT(stn=True, mask=True, **SMALL), seed + i) for i in range(2)]
    students = [init_parameters(CRNN(**TINY_CRNN), seed + 10 + i) for i in range(2)]
    return Trainer(cfg, generators, students, init_parameters(CRNN(**TINY_CRNN), 99),
                   SyntheticTextDataset(n=12, seed=1), CPU)


def test_two_copy_checkpoint_and_resume_round_trip(tmp_path):
    """Two steps of a ``--stu_iter=2`` run with separate copies save every
    copy and the Adam state over all four models; a trainer from other
    weights resumes them bitwise, and its next step equals the
    uninterrupted run's."""
    run = _trainer(_cfg(tmp_path), 0)
    run.train(max_iters=2)
    payload = load_checkpoint(str(tmp_path / "ckpt" / "v" / "checkpoint.ckpt"))
    assert len(payload["generator"]) == len(payload["student"]) == 2
    assert len(payload["optimizer"]["state"]) == sum(
        len(list(m.parameters())) for m in run.generators + run.students)
    resumed = _trainer(_cfg(tmp_path), 5)
    resumed.resume(str(tmp_path / "ckpt" / "v"))
    assert resumed.iters == 2
    for a, b in zip(run.generators + run.students, resumed.generators + resumed.students):
        for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
            assert torch.equal(va, vb), k
    ds = SyntheticTextDataset(n=4, seed=9)
    batch = step_batch(collate([ds[i] for i in range(4)]), CPU, run.step_cfg)
    losses = [train_step([m.train() for m in t.generators], [m.train() for m in t.students],
                         t.teacher.eval(), t.optimizer, batch, t.step_cfg,
                         torch.Generator().manual_seed(3))["loss_total"].item()
              for t in (run, resumed)]
    assert losses[0] == losses[1]
    with pytest.raises(ValueError, match="copies"):  # one copy cannot take two
        one = Trainer(_cfg(tmp_path, sr_share=True, tpg_share=True),
                      [init_parameters(TATT(stn=True, mask=True, **SMALL), 0)],
                      [init_parameters(CRNN(**TINY_CRNN), 1)], init_parameters(CRNN(**TINY_CRNN), 2),
                      SyntheticTextDataset(n=12, seed=1), CPU)
        one.resume(str(tmp_path / "ckpt" / "v"))


def test_step_config_from_flags_matches_the_jax_trainer():
    """``loop.step_config`` sets sharing as the JAX trainer does: one copy
    is shared whatever the flag (``loop.py:168-174``)."""
    args = Flags(stu_iter=1, use_label=True, y_domain=True, rotate_train=0.0)
    cfg = step_config(args)
    assert cfg.sr_share and cfg.tpg_share and cfg.use_label and cfg.y_domain
    assert cfg.rotate_train == 0.0 and not cfg.use_distill
    cfg = step_config(Flags(stu_iter=2, tpg_share=True))
    assert (cfg.stu_iter, cfg.sr_share, cfg.tpg_share) == (2, False, True)


CLI_BASE = ["--srb", "1", "--hd_u", "4", "--tiny_tpg", "--batch_size", "4", "--max_iters", "1",
            "--synthetic", "8", "--device", "cpu"]


@pytest.mark.parametrize("argv,copies", [
    (["--STN", "--mask", "--use_distill", "--gradient", "--tssim_loss", "--rotate_train=5.0",
      "--stu_iter=2", "--for_cascading", "--use_label"], (2, 2)),
    (["--mask", "--y_domain", "--learning_STN", "--STN", "--training_stablize", "--ssim_loss",
      "--stu_iter=2", "--tpg_share"], (2, 1)),
    (["--rotate_train=0", "--tssim_loss", "--no-fused_tssim"], (1, 1)),
    # flags of the plain step: accepted, and no-ops in the TATT step
    (["--mask", "--tssim_loss", "--color_loss", "--mse_fuse"], (1, 1)),
])
def test_cli_accepts_the_step_flags(argv, copies, capsys):
    from tatt_tpu_torch.cli import main as cli

    code, trainer = cli.run(argv + CLI_BASE)
    assert code == 0
    assert (len(trainer.generators), len(trainer.students)) == copies
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("[train] iters 1 ") and "sr_mean" in line and "gnorm/srb2" in line


# --color_loss and --mse_fuse are served now (the plain step; no-ops in the
# TATT step, as in JAX), the zoo, --tpg OPT and --dtype bfloat16: their
# cases hold other refusals (--dp_devices for --tpg OPT, --bn_per_replica
# for --badset, which is served now, --steps_per_dispatch for bf16)
@pytest.mark.parametrize("flag", [["--arch=srcnn", "--bn_per_replica"], ["--dp_devices", "2"],
                                  ["--steps_per_dispatch", "2"]])
def test_cli_still_refuses_what_waits(flag):
    from tatt_tpu_torch.cli import main as cli

    with pytest.raises(SystemExit, match="not ported yet"):
        cli.main(flag + CLI_BASE)


def test_a_checkpoint_of_the_one_copy_format_still_loads(tmp_path):
    """A file written before checkpoints held a list per model (format
    v1: one ``state_dict`` each) restores into a one-copy run."""
    cfg = _cfg(tmp_path, stu_iter=1)
    src = Trainer(cfg, [init_parameters(TATT(stn=True, mask=True, **SMALL), 3)],
                  [init_parameters(CRNN(**TINY_CRNN), 4)], init_parameters(CRNN(**TINY_CRNN), 5),
                  SyntheticTextDataset(n=12, seed=1), CPU)
    path = str(tmp_path / "v1.ckpt")
    torch.save({"format": "tatt_tpu_torch.checkpoint.v1", "generator": src.generators[0].state_dict(),
                "student": src.students[0].state_dict(), "optimizer": src.optimizer.state_dict(),
                "iters": 3, "info": {}, "best_history_res": {}, "converge": []}, path)
    dst = Trainer(cfg, [init_parameters(TATT(stn=True, mask=True, **SMALL), 6)],
                  [init_parameters(CRNN(**TINY_CRNN), 7)], init_parameters(CRNN(**TINY_CRNN), 8),
                  SyntheticTextDataset(n=12, seed=1), CPU)
    dst.resume(path)
    assert dst.iters == 3
    for a, b in zip(src.generators + src.students, dst.generators + dst.students):
        for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
            assert torch.equal(va, vb), k
