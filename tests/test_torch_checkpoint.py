"""The port's checkpoints, ``--resume`` and Adam bridge (CPU).

A save / restore round trip and a resumed step are bitwise (the same
tensors, the same CPU arithmetic); ``resolve_resume_path`` makes the JAX
package's pick; the Adam state of an optax run carries across with
``adam_from_jax`` and a third step agrees with optax to rtol 1e-6 / atol
1e-7 (the tolerance of ``test_adam_matches_optax``: the same f32 update in
another order).
"""

import itertools
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_models import random_variables
from tatt_tpu.core import checkpoint as jcheckpoint
from tatt_tpu.models.recognizers.crnn import CRNN as JCRNN
from tatt_tpu.models.tsrn import TATT as JTATT
from tatt_tpu.models.tsrn import TSRN as JTSRN
from tatt_tpu.train.state import TrainState
from tatt_tpu.train.state import make_optimizer as jmake_optimizer
from tatt_tpu_torch.core.checkpoint import (
    load_checkpoint, resolve_resume_path, restore_checkpoint, save_checkpoint,
)
from tatt_tpu_torch.core.config import Config, Flags
from tatt_tpu_torch.core.convert import adam_from_jax, from_jax, load_reference_pth
from tatt_tpu_torch.data.collate import collate
from tatt_tpu_torch.data.synthetic import SyntheticTextDataset
from tatt_tpu_torch.models.common import init_parameters
from tatt_tpu_torch.models.recognizers.crnn import CRNN
from tatt_tpu_torch.models.tsrn import TATT
from tatt_tpu_torch.train.loop import Trainer, to_device
from tatt_tpu_torch.train.state import make_optimizer
from tatt_tpu_torch.train.steps import StepConfig, train_step

SMALL = dict(srb_nums=1, hidden_units=4, out_text_channels=8)
TINY_CRNN = dict(nh=16, nm=(8, 8, 16, 16, 32, 32, 32))
CPU = torch.device("cpu")


def make_cfg(tmp_path, lr=1e-3, **train) -> Config:
    """The recipe's flags at batch 4, no validation, a save every 2 steps."""
    cfg = Config(args=Flags(STN=True, mask=True, use_distill=True, gradient=True, sr_share=True,
                            tssim_loss=True, rotate_train=5.0, batch_size=4, lr=lr, vis_dir="v"))
    cfg.TRAIN.ckpt_dir = str(tmp_path / "ckpt")
    cfg.TRAIN.saveInterval = 2
    cfg.TRAIN.VAL.valInterval = 0
    for k, v in train.items():
        setattr(cfg.TRAIN, k, v)
    return cfg


def make_trainer(cfg, seed=0, val_datasets=None) -> Trainer:
    generator = init_parameters(TATT(stn=True, mask=True, **SMALL), seed)
    student = init_parameters(CRNN(**TINY_CRNN), seed + 1)
    teacher = init_parameters(CRNN(**TINY_CRNN), 99)
    return Trainer(cfg, [generator], [student], teacher, SyntheticTextDataset(n=12, seed=1), CPU,
                   val_datasets)


def assert_state_equal(a: Trainer, b: Trainer) -> None:
    """Models (parameters and BN buffers) and Adam state, bit for bit."""
    for ma, mb in zip(a.generators + a.students, b.generators + b.students):
        sa, sb = ma.state_dict(), mb.state_dict()
        assert sorted(sa) == sorted(sb)
        for k in sa:
            assert torch.equal(sa[k], sb[k]), k
    oa, ob = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert sorted(oa["state"]) == sorted(ob["state"])
    for i, st in oa["state"].items():
        for k, v in st.items():
            assert torch.equal(v, ob["state"][i][k]), (i, k)


def test_round_trip_is_bitwise(tmp_path):
    t1 = make_trainer(make_cfg(tmp_path))
    t1.train(max_iters=2)
    path = str(tmp_path / "run" / "x.ckpt")
    info = {"arch": "tatt", "iters": np.int64(2), "epochs": 0}
    best = {"easy": {"psnr_avg": np.float32(20.5), "accuracy": 0.25, "images": 8}}
    converge = [{"iterator": 2, "results": best}]
    save_checkpoint(path, t1.generators, t1.students, t1.optimizer, 2, info, best, converge)
    assert os.listdir(tmp_path / "run") == ["x.ckpt"]  # no .tmp left

    t2 = make_trainer(make_cfg(tmp_path), seed=5)
    payload = load_checkpoint(path)
    restore_checkpoint(payload, t2.generators, t2.students, t2.optimizer)
    assert_state_equal(t1, t2)
    assert any(s["exp_avg"].abs().max() > 0 for s in t2.optimizer.state.values())
    assert payload["iters"] == 2
    assert payload["info"] == {"arch": "tatt", "iters": 2, "epochs": 0}
    assert type(payload["info"]["iters"]) is int
    assert payload["best_history_res"] == {"easy": {"psnr_avg": 20.5, "accuracy": 0.25, "images": 8}}
    assert payload["converge"] == [{"iterator": 2, "results": payload["best_history_res"]}]


def test_finetune_resume_new_lr(tmp_path):
    """The counterpart of ``test_finetune_resume_new_lr``: the stage-2
    resume keeps the Adam moments and step counts, runs at the new lr (the
    saved ``param_groups`` hold the old one) and counts on from the
    restored ``iters``."""
    t1 = make_trainer(make_cfg(tmp_path))
    t1.train(max_iters=2)  # saves checkpoint.ckpt at 2
    saved = {i: {k: v.clone() for k, v in s.items()} for i, s in t1.optimizer.state_dict()["state"].items()}
    t2 = make_trainer(make_cfg(tmp_path, lr=2e-4), seed=5)
    t2.resume(str(tmp_path / "ckpt" / "v"))
    assert t2.iters == 2
    assert [g["lr"] for g in t2.optimizer.param_groups] == [2e-4]
    for i, s in t2.optimizer.state_dict()["state"].items():
        for k, v in s.items():
            assert torch.equal(v, saved[i][k]), (i, k)
    before = {k: p.detach().clone() for k, p in t2.generators[0].named_parameters()}
    assert t2.train(max_iters=3)["iters"] == 3
    assert all(float(s["step"]) == 3.0 for s in t2.optimizer.state.values())
    # the same resumed step at the saved lr moves the weights 5x as far
    # (each move read as a difference of two f32 weights, exact to half an
    # ulp of the weight: ~1e-3 of a move of 2e-4 at |w| ~ 4, far less in
    # the norm over all weights)
    t3 = make_trainer(make_cfg(tmp_path, lr=1e-3), seed=5)
    t3.resume(str(tmp_path / "ckpt" / "v"))
    t3.train(max_iters=3)
    norm = lambda t: torch.sqrt(sum(((p - before[k]) ** 2).sum()  # noqa: E731
                                    for k, p in t.generators[0].named_parameters())).item()
    np.testing.assert_allclose(norm(t3) / norm(t2), 5.0, rtol=1e-4)


def test_step_after_resume_is_bitwise_the_uninterrupted_step(tmp_path):
    """One step on a fixed batch and dropout seed after a resume equals the
    same step of the run that was never interrupted, for the whole state."""
    run = make_trainer(make_cfg(tmp_path))
    run.train(max_iters=2)
    resumed = make_trainer(make_cfg(tmp_path), seed=5)
    resumed.resume(str(tmp_path / "ckpt" / "v" / "checkpoint.ckpt"))
    assert_state_equal(run, resumed)
    ds = SyntheticTextDataset(n=4, seed=9)
    hr, lr = to_device(collate([ds[i] for i in range(4)]), CPU, True)
    losses = []
    for t in (run, resumed):
        m = train_step([t.generators[0].train()], [t.students[0].train()], t.teacher.eval(), t.optimizer,
                       {"images_hr": hr, "images_lr": lr}, StepConfig(),
                       torch.Generator().manual_seed(5))
        losses.append(m["loss_total"].item())
    assert losses[0] == losses[1]
    assert_state_equal(run, resumed)


LAYOUTS = [
    (["model_best_acc_0.ckpt", "checkpoint.ckpt", "model_best_acc_0.pth"], "model_best_acc_0.ckpt"),
    (["checkpoint.ckpt", "model_best_acc_1.pth"], "checkpoint.ckpt"),
    (["model_best_acc_10.pth", "model_best_acc_2.pth", "checkpoint.pth"], "model_best_acc_2.pth"),
    (["model_best_acc_x.pth", "model_best_acc_3.pth"], "model_best_acc_3.pth"),
    (["checkpoint.pth", "recognizer_best_acc_0.pth"], "checkpoint.pth"),
    (["recognizer_best_acc_0.pth"], None),
]


@pytest.mark.parametrize("names,want", LAYOUTS)
def test_resolve_resume_path_matches_the_jax_package(tmp_path, names, want):
    for name in names:
        (tmp_path / name).write_bytes(b"")
    if want is None:
        for fn in (resolve_resume_path, jcheckpoint.resolve_resume_path):
            with pytest.raises(FileNotFoundError):
                fn(str(tmp_path))
        return
    got = resolve_resume_path(str(tmp_path))
    assert got == jcheckpoint.resolve_resume_path(str(tmp_path)) == str(tmp_path / want)
    assert resolve_resume_path(got) == got  # a file resolves to itself


def test_reference_pth_still_resumes(tmp_path):
    """A reference run directory: the generator from ``model_best_acc_0.pth``
    (``module.`` prefixes), the student from ``recognizer_best_acc_0.pth``
    beside it; Adam starts afresh at iteration 0."""
    gen = init_parameters(TATT(stn=True, mask=True, **SMALL), 7)
    stu = init_parameters(CRNN(**TINY_CRNN), 8)
    torch.save({"state_dict_G": {f"module.{k}": v for k, v in gen.state_dict().items()}},
               str(tmp_path / "model_best_acc_0.pth"))
    torch.save({"state_dict": stu.state_dict()}, str(tmp_path / "recognizer_best_acc_0.pth"))
    t = make_trainer(make_cfg(tmp_path))
    t.resume(str(tmp_path))
    for src, dst in ((gen, t.generators[0]), (stu, t.students[0])):
        for k, v in src.state_dict().items():
            assert torch.equal(dst.state_dict()[k], v), k
    assert t.iters == 0 and not t.optimizer.state
    assert t.train(max_iters=1)["iters"] == 1


def test_foreign_checkpoints_are_refused_by_name(tmp_path):
    """A JAX-package msgpack checkpoint is named as such (not an unpickling
    error), and a port checkpoint given where a reference .pth is expected
    is named too (not a confusing "lacks")."""
    model = JTSRN(srb_nums=1, hidden_units=4)
    variables = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 4, 16, 64)))
    state = TrainState.create([variables], [{"params": {}}], jmake_optimizer(1e-3))
    jax_path = str(tmp_path / "checkpoint.ckpt")
    jcheckpoint.save_checkpoint(jax_path, state, info={"iters": 0})
    t = make_trainer(make_cfg(tmp_path))
    for call in (lambda: t.resume(jax_path), lambda: t.resume(str(tmp_path)),
                 lambda: load_reference_pth(jax_path)):
        with pytest.raises(ValueError, match="JAX package"):
            call()
    port_path = str(tmp_path / "port.ckpt")
    save_checkpoint(port_path, t.generators, t.students, t.optimizer, 0)
    with pytest.raises(ValueError, match="checkpoint of the port"):
        load_reference_pth(port_path)


def test_adam_from_jax_carries_optax_state():
    """Two optax Adam steps over a TATT(stn=True) and a CRNN, carried into
    the port's Adam; a third step on both sides agrees."""
    rng = np.random.default_rng(3)
    sr_vars = random_variables(JTATT(stn=True, **SMALL), rng, jnp.zeros((2, 4, 16, 64)),
                               jnp.zeros((2, 37, 1, 26)), train=True)
    stu_vars = random_variables(JCRNN(**TINY_CRNN), rng, jnp.zeros((2, 1, 32, 100)))
    params = {"sr": (sr_vars["params"],), "student": (stu_vars["params"],)}
    tx = jmake_optimizer(1e-3, 0.5)
    opt_state = tx.init(params)

    def grads():
        return jax.tree_util.tree_map(
            lambda p: rng.standard_normal(np.shape(p)).astype(np.float32), params)

    for _ in range(2):
        updates, opt_state = tx.update(grads(), opt_state, params)
        params = optax.apply_updates(params, updates)
    adam = opt_state.inner_state[0]
    host = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731

    gen, stu = TATT(stn=True, **SMALL), CRNN(**TINY_CRNN)
    for model, p, v in ((gen, params["sr"][0], sr_vars), (stu, params["student"][0], stu_vars)):
        model.load_state_dict(from_jax({"params": host(p), "batch_stats": v["batch_stats"]}))
    opt = make_optimizer(itertools.chain(gen.parameters(), stu.parameters()), 1e-3)
    order = [[k for k, _ in m.named_parameters()] for m in (gen, stu)]
    opt.load_state_dict(adam_from_jax(
        [host(adam.mu["sr"][0]), host(adam.mu["student"][0])],
        [host(adam.nu["sr"][0]), host(adam.nu["student"][0])], int(adam.count), order, 1e-3))

    g3 = grads()
    updates, opt_state = tx.update(g3, opt_state, params)
    params = optax.apply_updates(params, updates)
    for model, g, want in ((gen, g3["sr"][0], params["sr"][0]),
                           (stu, g3["student"][0], params["student"][0])):
        g_sd, want_sd = from_jax({"params": host(g)}), from_jax({"params": host(want)})
        for k, p in model.named_parameters():
            p.grad = g_sd[k]
    opt.step()
    for model, want in ((gen, params["sr"][0]), (stu, params["student"][0])):
        want_sd = from_jax({"params": host(want)})
        for k, p in model.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), want_sd[k].numpy(), rtol=1e-6, atol=1e-7,
                                       err_msg=k)
