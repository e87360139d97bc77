"""The port's CLI on the real-data path (CPU, shrunk width): training from
a ``--config`` YAML over TextZoom-layout LMDBs writes both checkpoints, a
``--resume`` of the run directory with a new ``--lr`` continues, and
``--go_test --resume`` of the best checkpoint prints each val set's
summary; without data, or with a missing teacher file, the CLI exits with
code 2."""

import ast

import pytest

from test_torch_lmdb import write_textzoom
from tatt_tpu_torch.cli import main as cli
from tatt_tpu_torch.core.checkpoint import load_checkpoint

SHRUNK = ["--srb", "1", "--hd_u", "4", "--tiny_tpg", "--device", "cpu"]
RECIPE = ["--arch=tatt", "--STN", "--mask", "--use_distill", "--gradient", "--sr_share",
          "--stu_iter=1", "--rotate_train=5.0", "--tssim_loss", "--test_model=CRNN"]


@pytest.fixture
def run_config(tmp_path):
    """Two train LMDBs of 9 and 7 samples, two val LMDBs, batch 4, two
    worker threads, a save and a validation every 2 steps."""
    data = [write_textzoom(str(tmp_path / name), n, seed=k)
            for k, (name, n) in enumerate((("train1", 9), ("train2", 7), ("easy", 6), ("hard", 5)))]
    path = tmp_path / "cfg.yaml"
    path.write_text(
        "TRAIN:\n"
        f"  train_data_dir: ['{data[0]}', '{data[1]}']\n"
        "  batch_size: 4\n  workers: 2\n  saveInterval: 2\n  displayInterval: 1\n"
        f"  ckpt_dir: '{tmp_path / 'ckpt'}'\n"
        f"  VAL:\n    val_data_dir: ['{data[2]}', '{data[3]}']\n    valInterval: 2\n"
        "    crnn_pretrained: ''\n"
    )
    return str(path), tmp_path / "ckpt" / "vis_t"


def test_train_resume_and_go_test_through_the_cli(run_config, capsys):
    cfg, run_dir = run_config
    argv = RECIPE + SHRUNK + ["--config", cfg, "--vis_dir", "vis_t"]
    assert cli.main(argv + ["--max_iters", "4"]) == 0
    assert sorted(p.name for p in run_dir.iterdir()) == ["checkpoint.ckpt", "model_best_acc_0.ckpt"]
    saved = load_checkpoint(str(run_dir / "checkpoint.ckpt"))
    assert saved["iters"] == 4 and [c["iterator"] for c in saved["converge"]] == [2, 4]
    assert sorted(saved["converge"][0]["results"]) == ["easy", "hard"]
    capsys.readouterr()

    code, trainer = cli.run(argv + ["--max_iters", "6", "--resume", str(run_dir), "--lr", "2e-4"])
    out = capsys.readouterr().out
    assert code == 0 and trainer.iters == 6
    assert "resumed from" in out and "[train] iters 6 " in out
    assert [g["lr"] for g in trainer.optimizer.param_groups] == [2e-4]
    later = load_checkpoint(str(run_dir / "checkpoint.ckpt"))
    assert later["iters"] == 6 and later["optimizer"]["param_groups"][0]["lr"] == 2e-4
    assert [c["iterator"] for c in later["converge"]][-2:] == [4, 6]

    best = load_checkpoint(str(run_dir / "model_best_acc_0.ckpt"))
    assert cli.main(["--arch=tatt", "--mask", "--go_test", "--vis_dir", "vis_t", "--config", cfg,
                     "--resume", str(run_dir / "model_best_acc_0.ckpt")] + SHRUNK) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    got = {ln.split(" ", 1)[0]: ast.literal_eval(ln.split(" ", 1)[1]) for ln in lines[-2:]}
    assert sorted(got) == ["[easy]", "[hard]"]
    for name, summary in got.items():
        want = best["best_history_res"][name[1:-1]]
        assert summary["images"] == want["images"]
        # the same CPU arithmetic on the same weights and batches
        for key in ("psnr_avg", "ssim_avg", "accuracy", "ned"):
            assert summary[key] == want[key], (name, key)


def test_no_data_or_missing_teacher_exits_2(tmp_path, capsys):
    empty = tmp_path / "empty.yaml"
    empty.write_text("TRAIN:\n  batch_size: 4\n")
    assert cli.main(RECIPE + SHRUNK + ["--config", str(empty)]) == 2
    assert "no data" in capsys.readouterr().err
    assert cli.main(["--go_test", "--mask"] + SHRUNK) == 2
    assert cli.main(["--go_test", "--mask", "--synthetic", "8", "--crnn_pretrained",
                     str(tmp_path / "absent.pth")] + SHRUNK) == 2
    assert "not found" in capsys.readouterr().err
