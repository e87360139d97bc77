"""The port's CLI on the real-data path (CPU, shrunk width): training from
a ``--config`` YAML over TextZoom-layout LMDBs writes both checkpoints, a
``--resume`` of the run directory with a new ``--lr`` continues, and
``--go_test --resume`` of the best checkpoint prints each val set's
summary; without data, or with a missing teacher file, the CLI exits with
code 2.  The TSRN family: ``--arch=tsrn`` trains through the plain step
with ``--color_loss --mse_fuse`` and ``--go_test`` of its checkpoint gives
the saved summary; each other arch of the family trains.  The zoo: its
archs train through the step that ``ABLATION_SET`` picks, ``tranSR_v4``
exits with code 2 as the JAX parser does, and ``bicubic`` is refused with
its reason."""

import ast
import math

import pytest

from test_torch_lmdb import write_textzoom
from tatt_tpu_torch.cli import main as cli
from tatt_tpu_torch.core.checkpoint import load_checkpoint
from tatt_tpu_torch.models.factory import ABLATION_SET

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


PLAIN_RECIPE = ["--mask", "--gradient", "--rotate_train=5.0", "--tssim_loss", "--batch_size", "4",
                "--synthetic", "8"] + SHRUNK


def _train_metrics(out: str) -> dict:
    line = out.strip().splitlines()[-1]
    assert line.startswith("[train] iters 2 "), line
    words = line.split()[3:]
    return {k: float(v) for k, v in zip(words[::2], words[1::2])}


def test_tsrn_trains_and_go_test_reads_its_checkpoint(tmp_path, capsys):
    """``--arch=tsrn`` takes the plain step (``--color_loss`` and
    ``--mse_fuse`` add their terms) and checkpoints it; ``--go_test`` of
    the best checkpoint builds a TSRN and gives the summary saved with it."""
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text("TRAIN:\n  saveInterval: 2\n  displayInterval: 1\n"
                   f"  ckpt_dir: '{tmp_path / 'ckpt'}'\n  VAL:\n    valInterval: 2\n")
    argv = ["--arch=tsrn", "--config", str(cfg), "--vis_dir", "vis_tsrn"] + PLAIN_RECIPE
    code, trainer = cli.run(argv + ["--color_loss", "--mse_fuse", "--max_iters", "2"])
    assert code == 0 and type(trainer.generators[0]).__name__ == "TSRN"
    values = _train_metrics(capsys.readouterr().out)
    assert set(values) == {"loss_sr", "loss_color", "loss_tssim", "loss_mse_fuse", "loss_total"}
    best_path = tmp_path / "ckpt" / "vis_tsrn" / "model_best_acc_0.ckpt"
    best = load_checkpoint(str(best_path))
    assert best["info"]["arch"] == "tsrn"
    assert cli.main(argv + ["--go_test", "--resume", str(best_path)]) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    name, summary = line.split(" ", 1)
    assert name == "[easy]"
    summary, want = ast.literal_eval(summary), best["best_history_res"]["easy"]
    for key in ("images", "psnr_avg", "ssim_avg", "accuracy", "ned"):
        assert summary[key] == want[key], key


@pytest.mark.parametrize("arch", ["tsrn_tl_cascade", "tsrn_tl_cascade_sft", "tsrn_c2f", "sem_tsrn"])
def test_tsrn_family_archs_train(arch, capsys):
    """Two steps of each arch of the family on the CPU print finite losses:
    the TL archs (in ``ABLATION_SET``) through the TATT step, with its
    distillation and ``gnorm/<module>`` metrics, the others through the
    plain step."""
    code, trainer = cli.run([f"--arch={arch}", "--STN", "--use_distill", "--sr_share",
                             "--max_iters", "2"] + PLAIN_RECIPE)
    assert code == 0
    values = _train_metrics(capsys.readouterr().out)
    assert all(math.isfinite(v) for v in values.values()), values
    tl = arch.startswith("tsrn_tl")
    assert ("loss_distill" in values) == ("gnorm/infoGen" in values) == tl
    assert (arch in ABLATION_SET) == tl


@pytest.mark.parametrize("arch", ["srcnn", "pcan", "pcan_tl", "tbsrn_tl"])
def test_zoo_archs_train(arch, capsys):
    """Two steps of zoo archs on the CPU print finite losses, through the
    step that ``ABLATION_SET`` picks: the TATT step (distillation, the
    ``gnorm/<module>`` metrics) for the ``_tl`` archs, the plain step with
    the arch's criterion for the others."""
    code, trainer = cli.run([f"--arch={arch}", "--use_distill", "--max_iters", "2"] + PLAIN_RECIPE)
    assert code == 0
    values = _train_metrics(capsys.readouterr().out)
    assert all(math.isfinite(v) for v in values.values()), values
    tl = arch.endswith("_tl")
    assert (arch in ABLATION_SET) == tl
    assert ("loss_distill" in values) == ("gnorm/infoGen" in values) == tl
    assert "loss_tssim" in values


def test_transr_v4_is_not_a_cli_choice(capsys):
    """The factory builds ``tranSR_v4``; the JAX CLI does not offer it, and
    the port's parser refuses it as argparse does (exit code 2)."""
    with pytest.raises(SystemExit) as exc:
        cli.main(["--arch=tranSR_v4"] + PLAIN_RECIPE)
    assert exc.value.code == 2
    assert "invalid choice: 'tranSR_v4'" in capsys.readouterr().err


def test_bicubic_is_refused_with_its_reason():
    """BICUBIC has no parameters: the CLI refuses it in every mode and the
    Trainer refuses a generator without parameters (ROADMAP C.4)."""
    from tatt_tpu_torch.core.config import Config, Flags
    from tatt_tpu_torch.data.synthetic import SyntheticTextDataset
    from tatt_tpu_torch.models.recognizers.crnn import CRNN
    from tatt_tpu_torch.models.zoo.simple import BICUBIC
    from tatt_tpu_torch.train.loop import Trainer

    for mode in ([], ["--go_test"]):
        with pytest.raises(SystemExit, match="bicubic: BICUBIC has no parameters"):
            cli.main(["--arch=bicubic"] + mode + PLAIN_RECIPE)
    cfg = Config(args=Flags(arch="bicubic", batch_size=4))
    with pytest.raises(ValueError, match="no parameters to train"):
        Trainer(cfg, [BICUBIC()], [CRNN(nh=16, nm=(8, 8, 16, 16, 32, 32, 32))],
                CRNN(nh=16, nm=(8, 8, 16, 16, 32, 32, 32)), SyntheticTextDataset(n=4), "cpu")
