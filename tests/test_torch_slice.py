"""The real-data training path as a whole (CPU), against the JAX package.

* Checkpoint bookkeeping: the port's ``Trainer`` and the JAX ``Trainer``
  with the same tiny config, ``saveInterval`` and ``valInterval``, and
  ``evaluate`` replaced on both sides by the same scripted accuracies,
  write the same files at the same iterations, pick the same best
  iteration and record the same ``converge`` iterators and ``info``.
  Exact: no arithmetic of the models is compared.
* ``--go_test`` on a TextZoom LMDB: the JAX ``Trainer.evaluate`` against
  the port's CLI, from the JAX weights carried across by ``from_jax`` in a
  port checkpoint and a reference-format teacher ``.pth``: PSNR within
  0.01 dB, SSIM within 1e-3, accuracies, NED and image count equal (the
  bar of ``test_torch_eval.py``).
"""

import ast
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from test_torch_lmdb import write_textzoom
from test_torch_models import random_variables
from tatt_tpu.core.config import Config as JConfig
from tatt_tpu.data import lmdb_dataset as jlmdb_dataset
from tatt_tpu.data.lmdb_dataset import LmdbTextDataset as JLmdbText
from tatt_tpu.data.synthetic import SyntheticTextDataset as JSynthetic
from tatt_tpu.models.recognizers.crnn import CRNN as JCRNN
from tatt_tpu.train import loop as jloop
from tatt_tpu_torch.core.checkpoint import load_checkpoint, save_checkpoint
from tatt_tpu_torch.core.config import Config, Flags
from tatt_tpu_torch.core.convert import from_jax
from tatt_tpu_torch.data.synthetic import SyntheticTextDataset
from tatt_tpu_torch.models.common import init_parameters
from tatt_tpu_torch.models.recognizers.crnn import CRNN
from tatt_tpu_torch.models.tsrn import TATT
from tatt_tpu_torch.train import loop
from tatt_tpu_torch.train.state import make_optimizer

SMALL = dict(srb_nums=1, hidden_units=4, out_text_channels=8)
TINY_CRNN = dict(nh=16, nm=(8, 8, 16, 16, 32, 32, 32))
# accuracy of val sets "a" and "b" at iterations 2, 4, 6: sums 0.3, 0.8
# (the best), 0.6
SCRIPT = [0.2, 0.1, 0.5, 0.3, 0.4, 0.2]


def jax_cfg(ckpt_dir: str) -> JConfig:
    """Tiny, batch 8 (divisible by the 8-device test mesh), no TRI-SSIM
    and no rotation, so that the JAX step compiles quickly."""
    cfg = JConfig()
    cfg.args.tiny_tpg = True
    cfg.args.log_dir = ""
    cfg.args.mask = True
    cfg.args.batch_size = 8
    cfg.args.srb, cfg.args.hd_u = 1, 4
    cfg.args.vis_dir = "v"
    cfg.TRAIN.ckpt_dir = ckpt_dir
    return cfg


def scripted(record: list):
    it = iter(SCRIPT)

    def evaluate(ds, batch_size=None):
        acc = next(it)
        record.append(acc)
        return {"psnr_avg": 10.0 + acc, "ssim_avg": acc / 2, "accuracy": acc}

    return evaluate


def recording(save, saves: list, iters_of):
    def wrapper(path, *args, **kwargs):
        saves.append((os.path.basename(path), iters_of(args, kwargs)))
        return save(path, *args, **kwargs)

    return wrapper


def test_checkpoint_bookkeeping_matches_the_jax_trainer(tmp_path, monkeypatch):
    val_names = ("a", "b")
    jsaves, saves, jevals, evals = [], [], [], []
    monkeypatch.setattr(jloop, "save_checkpoint", recording(
        jloop.save_checkpoint, jsaves, lambda a, kw: kw["info"]["iters"]))
    monkeypatch.setattr(loop, "save_checkpoint", recording(
        loop.save_checkpoint, saves, lambda a, kw: a[3]))

    cfg = jax_cfg(str(tmp_path / "jax"))
    cfg.TRAIN.saveInterval, cfg.TRAIN.VAL.valInterval = 3, 2
    jtrainer = jloop.Trainer(cfg, JSynthetic(n=16), {n: None for n in val_names},
                             log_fn=lambda s: None)
    jtrainer.evaluate = scripted(jevals)
    jtrainer.train(max_iters=6)

    pcfg = Config(args=Flags(STN=True, mask=True, use_distill=True, gradient=True, sr_share=True,
                             tssim_loss=True, rotate_train=5.0, batch_size=8, vis_dir="v"))
    pcfg.TRAIN.ckpt_dir = str(tmp_path / "port")
    pcfg.TRAIN.saveInterval, pcfg.TRAIN.VAL.valInterval = 3, 2
    trainer = loop.Trainer(
        pcfg, [init_parameters(TATT(stn=True, mask=True, **SMALL), 0)],
        [init_parameters(CRNN(**TINY_CRNN), 1)], init_parameters(CRNN(**TINY_CRNN), 2),
        SyntheticTextDataset(n=16), torch.device("cpu"), {n: None for n in val_names},
    )
    trainer.evaluate = scripted(evals)
    trainer.train(max_iters=6)

    assert evals == jevals == SCRIPT
    assert saves == jsaves == [("model_best_acc_0.ckpt", 2), ("checkpoint.ckpt", 3),
                               ("model_best_acc_0.ckpt", 4), ("checkpoint.ckpt", 6)]
    assert trainer.best_sum_acc == pytest.approx(jtrainer.best_sum_acc)
    assert trainer.best_history == jtrainer.best_history
    iterators = lambda conv: [c["iterator"] for c in conv]  # noqa: E731
    assert iterators(trainer.converge_list) == iterators(jtrainer.converge_list) == [2, 4, 6]
    assert sorted(os.listdir(tmp_path / "port" / "v")) == sorted(os.listdir(tmp_path / "jax" / "v"))
    for name, iters in (("model_best_acc_0.ckpt", 4), ("checkpoint.ckpt", 6)):
        with open(tmp_path / "jax" / "v" / name, "rb") as fh:
            jpayload = serialization.msgpack_restore(fh.read())
        payload = load_checkpoint(str(tmp_path / "port" / "v" / name))
        assert payload["info"] == jpayload["info"]
        assert payload["info"]["iters"] == payload["iters"] == iters
        assert iterators(payload["converge"]) == iterators(jpayload["converge"])
    best = load_checkpoint(str(tmp_path / "port" / "v" / "model_best_acc_0.ckpt"))
    assert best["best_history_res"] == trainer.best_history


def test_go_test_on_an_lmdb_matches_the_jax_trainer(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(jlmdb_dataset, "_cv2", None)  # PIL decode, as test_torch_lmdb says why
    root = write_textzoom(str(tmp_path / "val"), 12, seed=5)
    cfg = jax_cfg(str(tmp_path / "ckpt"))
    teacher = random_variables(JCRNN(**TINY_CRNN), np.random.default_rng(0), jnp.zeros((2, 1, 32, 100)))
    jtrainer = jloop.Trainer(cfg, JSynthetic(n=8), teacher_variables=teacher, log_fn=lambda s: None)
    want = jtrainer.evaluate(JLmdbText(root))

    host = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
    st = jtrainer.state
    generator, student = TATT(mask=True, **SMALL), CRNN(**TINY_CRNN)
    generator.load_state_dict(from_jax(host({"params": st.sr_params[0], "batch_stats": st.sr_batch_stats[0]})))
    student.load_state_dict(from_jax(host({"params": st.student_params[0],
                                           "batch_stats": st.student_batch_stats[0]})))
    ckpt = str(tmp_path / "port" / "model_best_acc_0.ckpt")
    save_checkpoint(ckpt, [generator], [student],
                    make_optimizer(list(generator.parameters()) + list(student.parameters()), 1e-3), 0)
    crnn_pth = str(tmp_path / "crnn.pth")
    torch.save(from_jax(host(teacher)), crnn_pth)
    yaml = tmp_path / "cfg.yaml"
    yaml.write_text(f"TRAIN:\n  train_data_dir: ['{root}']\n  VAL:\n    val_data_dir: ['{root}/']\n")

    from tatt_tpu_torch.cli import main as cli

    assert cli.main(["--go_test", "--mask", "--srb", "1", "--hd_u", "4", "--tiny_tpg",
                     "--batch_size", "8", "--device", "cpu", "--config", str(yaml),
                     "--resume", ckpt, "--crnn_pretrained", crnn_pth]) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("[val] {"), line
    got = ast.literal_eval(line[len("[val] "):])
    for key in ("psnr_avg", "psnr_avg_lr"):
        assert abs(got[key] - want[key]) <= 0.01, (key, got[key], want[key])
    for key in ("ssim_avg", "ssim_avg_lr"):
        assert abs(got[key] - want[key]) <= 1e-3, (key, got[key], want[key])
    for key in ("accuracy", "accuracy_lr", "accuracy_hr", "ned", "images"):
        assert got[key] == want[key], (key, got[key], want[key])
    assert got["images"] == 12
