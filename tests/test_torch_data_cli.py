"""The data long tail through the port's CLI (CPU, shrunk width): ``--syn``
and ``--mixed`` train on TextZoom LMDBs, ``--go_test --badset`` /
``--ic15sr`` evaluate those corpora's folders, ``--device_collate`` and
``--test_data_dir`` are accepted with a warning, and under
``--synthetic`` the reader flags act on nothing and say so, as the JAX
CLI wires each of them (``tatt_tpu/cli/main.py:195-231``)."""

import ast
import math

import pytest

from test_torch_cli import RECIPE, SHRUNK
from test_torch_lmdb import write_textzoom
from test_torch_variants import _badset, _ic15_textsr
from tatt_tpu_torch.cli import main as cli
from tatt_tpu_torch.data.lmdb_dataset import MixDataset


def _yaml(tmp_path, val_dir: str) -> str:
    train = write_textzoom(str(tmp_path / "train"), 9, seed=1)
    path = tmp_path / "cfg.yaml"
    path.write_text(
        "TRAIN:\n"
        f"  train_data_dir: ['{train}']\n"
        "  batch_size: 4\n  workers: 2\n  saveInterval: 0\n"
        f"  ckpt_dir: '{tmp_path / 'ckpt'}'\n"
        f"  VAL:\n    val_data_dir: ['{val_dir}']\n    valInterval: 0\n"
        "    crnn_pretrained: ''\n"
    )
    return str(path)


@pytest.mark.parametrize("flags", [["--syn"], ["--mixed"],
                                   ["--syn", "--mixed", "--device_collate", "--test_data_dir", "x"]])
def test_syn_and_mixed_train_through_the_cli(tmp_path, capsys, flags):
    cfg = _yaml(tmp_path, write_textzoom(str(tmp_path / "val"), 5, seed=2))
    code, trainer = cli.run(RECIPE + SHRUNK + flags + ["--config", cfg, "--max_iters", "2"])
    out, err = capsys.readouterr()
    assert code == 0 and trainer.iters == 2 and "[train] iters 2 " in out
    syn, mixed = "--syn" in flags, "--mixed" in flags
    assert trainer.loader.syn == syn
    assert all(isinstance(d, MixDataset) == mixed for d in trainer.loader.dataset.datasets)
    batch = next(iter(trainer.loader))
    # no train step reads --syn's pseudo-LR crops: the train loader skips them
    assert batch.images_pseudo_lr is None and batch.images_lr.shape == (4, 16, 64, 3)
    assert ("--device_collate changes nothing" in err) == ("--device_collate" in flags)
    assert ("--test_data_dir is parsed by the JAX CLI" in err) == ("--test_data_dir" in flags)


@pytest.mark.parametrize("kind", ["badset", "ic15sr"])
def test_go_test_over_badset_and_ic15sr(tmp_path, capsys, kind):
    val = _badset(tmp_path) if kind == "badset" else _ic15_textsr(tmp_path)
    cfg = _yaml(tmp_path, val)
    assert cli.main(["--arch=tatt", "--mask", "--go_test", f"--{kind}", "--config", cfg] + SHRUNK) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    name, summary = line.split(" ", 1)
    assert name == ("[bad]" if kind == "badset" else "[ic15]")
    summary = ast.literal_eval(summary)
    # the badset folder holds 3 readable crops of its 5 files (a broken one
    # and one under 2 px read the next); the IC15 tree 3 pairs
    assert summary["images"] == (5 if kind == "badset" else 3)
    assert math.isfinite(summary["psnr_avg"]) and math.isfinite(summary["ssim_avg"])


def test_reader_flags_under_synthetic_warn_and_change_nothing(capsys):
    assert cli.main(["--go_test", "--synthetic", "8", "--mask", "--badset", "--mixed", "--ic15sr",
                     "--batch_size", "4"] + SHRUNK) == 0
    out, err = capsys.readouterr()
    assert out.startswith("[easy] {") and "'images': 8" in out
    for flag in ("--mixed", "--badset", "--ic15sr"):
        assert f"{flag} has no effect with --synthetic" in err
