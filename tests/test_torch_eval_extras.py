"""The evaluation protocol's extras in tatt_tpu_torch (CPU) against
tatt_tpu (JAX, CPU): ``Evaluator`` with the CRNN, ASTER and MORAN judges
and LPIPS against JAX ``Trainer.evaluate`` on the same weights (PSNR
within 0.01 dB, SSIM within 1e-3, identical readings, LPIPS within 1e-5
relative), the ``--vis`` files, ``run_demo``, the trainer's TensorBoard
scalars read back, ``train/observe.py``, and the CLI's ``--test --rec``,
``--go_test --test_model``, ``--demo``, ``--vis``, ``--log_dir``, LPIPS
flags, dead-flag warnings and weightless judges.  Every test that writes
relative paths (``demo/``, ``demo_out/``) runs in its own ``tmp_path``.
"""

import argparse
import ast
import os
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from test_torch_lpips import weights  # noqa: F401  (a fixture)
from test_torch_models import random_variables
from tatt_tpu.core.charset import AsterInfo as JAsterInfo
from tatt_tpu.core.config import Config as JConfig
from tatt_tpu.data.synthetic import SyntheticTextDataset as JSynthetic
from tatt_tpu.losses.perceptual import import_lpips as j_import_lpips
from tatt_tpu.models.recognizers.aster import AsterRecognizer as JAster
from tatt_tpu.models.recognizers.moran import MORAN as JMORAN
from tatt_tpu.train.demo import run_demo as j_run_demo
from tatt_tpu.train.judge import make_judge as j_make_judge
from tatt_tpu.train.loop import Trainer as JTrainer
from tatt_tpu_torch.cli import main as cli
from tatt_tpu_torch.core.config import Config, Flags
from tatt_tpu_torch.core.convert import from_jax
from tatt_tpu_torch.data.synthetic import SyntheticTextDataset
from tatt_tpu_torch.losses.perceptual import import_lpips, lpips_vgg
from tatt_tpu_torch.models.common import init_parameters
from tatt_tpu_torch.models.recognizers.aster import AsterRecognizer
from tatt_tpu_torch.models.recognizers.crnn import CRNN
from tatt_tpu_torch.models.recognizers.moran import MORAN
from tatt_tpu_torch.models.tsrn import TATT
from tatt_tpu_torch.train import observe
from tatt_tpu_torch.train.demo import run_demo
from tatt_tpu_torch.train.judge import make_judge
from tatt_tpu_torch.train.loop import Evaluator, Trainer, make_summary_writer
from tatt_tpu_torch.train.steps import eval_step

SMALL = dict(srb_nums=1, hidden_units=4, out_text_channels=8)
TINY_CRNN = dict(nh=16, nm=(8, 8, 16, 16, 32, 32, 32))
CPU = torch.device("cpu")
N_VAL = 8  # one batch (test_torch_eval.py holds a tail batch)
SHRUNK = ["--srb", "1", "--hd_u", "4", "--tiny_tpg", "--device", "cpu", "--batch_size", "4"]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port(module, params, stats):
    module.load_state_dict(from_jax(_np({"params": params, "batch_stats": stats})))
    return module.eval()


@pytest.fixture(scope="module")
def pair(weights):  # noqa: F811
    """A shrunk JAX trainer with LPIPS and the port's models, LPIPS and
    ASTER / MORAN weights, all from the same numbers."""
    cfg = JConfig()
    cfg.args.tiny_tpg, cfg.args.mask, cfg.args.log_dir = True, True, ""
    cfg.args.srb, cfg.args.hd_u = 1, 4
    cfg.args.val_batch_size = 8
    sd, lp = weights
    j_lpips = j_import_lpips({k: v.numpy() for k, v in sd.items()}, {k: v.numpy() for k, v in lp.items()})
    trainer = JTrainer(cfg, JSynthetic(n=8), lpips_variables=j_lpips)
    s = trainer.state
    gen = _port(TATT(mask=True, **SMALL), s.sr_params[0], s.sr_batch_stats[0])
    stu = _port(CRNN(**TINY_CRNN), s.student_params[0], s.student_batch_stats[0])
    teacher = CRNN(**TINY_CRNN)
    teacher.load_state_dict(from_jax(_np(trainer.teacher_vars)))
    vgg, lin = import_lpips(sd, lp)
    info = JAsterInfo("all")
    judges = {"CRNN": (trainer._judge_fn, teacher.eval())}
    for name, jmod, tmod, shape in (
        ("ASTER", JAster(num_classes=info.rec_num_classes), AsterRecognizer(info.rec_num_classes),
         (2, 3, 32, 100)),
        ("MORAN", JMORAN(), MORAN(), (2, 1, 32, 100)),
    ):
        v = jax.tree_util.tree_map(jnp.asarray, random_variables(
            jmod, np.random.default_rng(len(name)), jnp.zeros(shape)))
        tmod.load_state_dict(from_jax(_np(v)))
        judges[name] = (j_make_judge(name, v, "all"), make_judge(name, tmod.eval(), "all"))
    return trainer, gen, stu, teacher, (vgg, lin), judges


def _evaluator(pair, judge, **kw):
    _, gen, stu, _, (vgg, lin), _ = pair
    return Evaluator([gen], [stu], judge, CPU, batch_size=8, mask=True,
                     lpips=lambda a, b: lpips_vgg(vgg, lin, a, b), **kw)


@pytest.mark.parametrize("test_model", ["CRNN", "ASTER", "MORAN"])
def test_evaluator_matches_jax_trainer(pair, test_model):
    trainer = pair[0]
    j_judge, t_judge = pair[5][test_model]
    trainer._judge_fn = j_judge
    want = trainer.evaluate(JSynthetic(n=N_VAL, seed=5))
    ev = _evaluator(pair, t_judge)
    got = ev.evaluate(SyntheticTextDataset(n=N_VAL, seed=5))
    for key in ("psnr_avg", "psnr_avg_lr"):
        assert abs(got[key] - want[key]) <= 0.01, (key, got[key], want[key])
    for key in ("ssim_avg", "ssim_avg_lr"):
        assert abs(got[key] - want[key]) <= 1e-3, (key, got[key], want[key])
    for key in ("accuracy", "accuracy_lr", "accuracy_hr", "ned", "images"):
        assert got[key] == want[key], (key, got[key], want[key])
    for key in ("lpips_vgg_sr", "lpips_vgg_lr"):
        assert abs(got[key] - want[key]) <= 1e-5 * abs(want[key]), (key, got[key], want[key])
    # reading for reading on the val crops (HR and LR)
    for hr, lr, _ in ev.batches(SyntheticTextDataset(n=N_VAL, seed=5)):
        for im in (hr, lr):
            assert ev.decode(im) == j_judge(jnp.asarray(im.numpy()))


def test_vis_writes_what_jax_writes(pair, tmp_path, monkeypatch):
    """``--vis``: the same triptych and ``att_`` file names under
    ``demo/<vis_dir>`` (relative to the working directory, as JAX)."""
    monkeypatch.chdir(tmp_path)
    trainer = pair[0]
    j_judge, t_judge = pair[5]["CRNN"]
    trainer._judge_fn = j_judge
    trainer.cfg.args.vis, trainer.cfg.args.vis_dir, trainer.cfg.TRAIN.VAL.n_vis = True, "jax", 3
    try:
        trainer.evaluate(JSynthetic(n=N_VAL, seed=6))
    finally:
        trainer.cfg.args.vis = False
    _evaluator(pair, t_judge, n_vis=3, vis_root=os.path.join("demo", "port")).evaluate(
        SyntheticTextDataset(n=N_VAL, seed=6))
    want, got = (sorted(os.listdir(tmp_path / "demo" / d)) for d in ("jax", "port"))
    assert got == want and len(got) == 6 and sum(f.startswith("att_") for f in got) == 3
    for name in got:
        with Image.open(tmp_path / "demo" / "port" / name) as im, \
                Image.open(tmp_path / "demo" / "jax" / name) as jm:
            assert im.size == jm.size and im.mode == jm.mode, name
            if not name.startswith("att_"):  # the LR third is the same bicubic upscale
                a, b = (np.asarray(x)[:32].astype(int) for x in (im, jm))
                assert np.abs(a - b).max() <= 1, name


def test_run_demo_matches_jax(pair, tmp_path):
    """The same SR function and judge through both ``run_demo``: the same
    readings and the same saved images."""
    _, gen, stu, teacher, _, _ = pair
    src = tmp_path / "in"
    src.mkdir()
    ds = SyntheticTextDataset(n=3, seed=7)
    for i in range(3):  # an HR crop, an LR crop and an odd size
        ds[i][i % 2].resize((100 + 9 * i, 30)).save(src / f"w{i}.png")
    (src / "notes.txt").write_text("not an image")
    judge = make_judge("CRNN", teacher)

    def sr_fn(lr):
        with torch.no_grad():
            return eval_step([gen], [stu], lr)[0]

    lines = []
    got = run_demo(str(src), sr_fn, judge, str(tmp_path / "port"), CPU, log=lines.append)
    want = j_run_demo(str(src), lambda lr: sr_fn(torch.from_numpy(np.asarray(lr))).numpy(),
                      lambda im: judge(torch.as_tensor(np.asarray(im))), str(tmp_path / "jax"),
                      log=lambda s: None)
    assert got["results"] == want["results"] and len(got["results"]) == 3
    assert len(lines) == 4 and lines[-1].startswith("demo: 3 images, fps=")
    for i in range(3):
        assert (tmp_path / "port" / f"w{i}.png").read_bytes() == (tmp_path / "jax" / f"w{i}.png").read_bytes()


def _scalars(log_dir):
    """{tag: {step: value}} from the TFRecord event files of ``log_dir``."""
    from tensorboardX.proto.event_pb2 import Event

    out = {}
    for name in os.listdir(log_dir):
        data = open(os.path.join(log_dir, name), "rb").read()
        pos = 0
        while pos < len(data):
            (n,) = struct.unpack("<Q", data[pos: pos + 8])
            event = Event.FromString(data[pos + 12: pos + 12 + n])
            pos += 12 + n + 4
            for v in event.summary.value:
                out.setdefault(v.tag, {})[event.step] = v.simple_value
    return out


def test_trainer_scalars_read_back(tmp_path):
    """``loss/<name>`` every 5 steps and ``eval/*_<set>`` at each validation,
    under ``<log_dir>/<vis_dir>``, after old event files are wiped."""
    run_dir = tmp_path / "tb" / "run"
    run_dir.mkdir(parents=True)
    (run_dir / "events.out.tfevents.1.old").write_bytes(b"stale")
    cfg = Config(args=Flags(mask=True, batch_size=4, log_dir=str(tmp_path / "tb"), vis_dir="run"))
    cfg.TRAIN.VAL.valInterval, cfg.TRAIN.saveInterval, cfg.TRAIN.ckpt_dir = 5, 0, str(tmp_path)
    gen = init_parameters(TATT(mask=True, **SMALL), 1)
    trainer = Trainer(cfg, [gen], [init_parameters(CRNN(**TINY_CRNN), 2)],
                      init_parameters(CRNN(**TINY_CRNN), 3), SyntheticTextDataset(n=16, seed=1), CPU,
                      {"easy": SyntheticTextDataset(n=4, seed=2)})
    assert not (run_dir / "events.out.tfevents.1.old").exists()
    history = trainer.train(max_iters=10)["metrics"]
    trainer.writer.close()  # tensorboardX writes its queue out
    tags = _scalars(run_dir)
    assert sorted(tags["loss/total"]) == [5, 10] and sorted(tags["eval/psnr_easy"]) == [5, 10]
    for key, values in history.items():
        tag = f"loss/{key.replace('loss_', '')}"
        assert tags[tag][5] == pytest.approx(values[4], rel=1e-6), tag
    for key in ("ssim_easy", "accuracy_easy"):
        assert sorted(tags[f"eval/{key}"]) == [5, 10]
    assert tags["eval/psnr_easy"][10] == pytest.approx(trainer.converge_list[-1]["results"]["easy"]["psnr_avg"])


def test_summary_writer_without_tensorboardx(monkeypatch, capsys, tmp_path):
    import builtins

    from tatt_tpu_torch.train import loop

    real_import = builtins.__import__

    def fake_import(name, *args, **kwargs):
        if name == "tensorboardX":
            raise ImportError("No module named 'tensorboardX'")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", fake_import)
    monkeypatch.setattr(loop, "_warned_no_tensorboard", False)
    assert make_summary_writer(str(tmp_path), "a") is None
    assert make_summary_writer(str(tmp_path), "b") is None
    err = capsys.readouterr().err
    assert err.count("tensorboardX is not installed") == 1 and "disabled" in err


def test_observe(tmp_path):
    conv = torch.nn.Conv2d(3, 8, 3, padding=1)
    x = torch.zeros(2, 3, 16, 16)
    lines = []
    out = observe.audit_model("conv", conv, conv, x, log=lines.append)
    assert out["params"] == observe.param_count(conv) == 8 * 3 * 9 + 8
    assert out["flops"] == 2 * 2 * 8 * 16 * 16 * 3 * 9 and "GFLOPs" in lines[0]
    with observe.trace(str(tmp_path)):
        conv(x)
    assert any(f.endswith(".json") for f in os.listdir(tmp_path))
    timer = observe.StepTimer()
    timer.update(64)
    assert timer.images == 64 and timer.rate() > 0


@pytest.fixture
def judge_files(tmp_path):
    """Seeded ASTER weights as a reference-style ``.pth.tar`` and MORAN's as
    a bare ``.pth``."""
    aster = str(tmp_path / "aster_demo.pth.tar")
    sd = init_parameters(AsterRecognizer(JAsterInfo("all").rec_num_classes), 5).state_dict()
    torch.save({"state_dict": {f"module.{k}": v for k, v in sd.items()}, "epoch": 3,
                "options": argparse.Namespace(arch="ResNet_ASTER")}, aster)
    moran = str(tmp_path / "moran.pth")
    torch.save(init_parameters(MORAN(), 6).state_dict(), moran)
    return aster, moran


def _summary(out: str, name: str = "easy") -> dict:
    lines = [ln for ln in out.splitlines() if ln.startswith(f"[{name}] ")]
    return ast.literal_eval(lines[-1][len(name) + 3:])


def test_cli_test_rec_aster_matches_the_evaluator(judge_files, tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    aster, _ = judge_files
    assert cli.main(["--test", "--rec=aster", "--rec_pretrained", aster, "--synthetic", "8", "--mask"]
                    + SHRUNK) == 0
    got = _summary(capsys.readouterr().out)
    cfg, args = cli.parse_config(["--mask"] + SHRUNK)
    gens, stus, _ = cli.build_models(cfg, "")
    want = Evaluator([m.eval() for m in gens], [m.eval() for m in stus],
                     cli.load_judge("ASTER", aster, "all", CPU), CPU, batch_size=4,
                     mask=True).evaluate(SyntheticTextDataset(n=8, seed=2))
    assert got["images"] == 8
    for key in ("psnr_avg", "ssim_avg", "accuracy", "accuracy_lr", "accuracy_hr", "ned"):
        assert got[key] == want[key], key


def test_cli_go_test_moran_vis_and_lpips(judge_files, weights, tmp_path, monkeypatch, capsys):  # noqa: F811
    monkeypatch.chdir(tmp_path)
    _, moran = judge_files
    sd, lp = weights
    torch.save(sd, "vgg16.pth")
    torch.save(lp, "vgg.pth")
    assert cli.main(["--go_test", "--test_model=MORAN", "--moran_pretrained", moran, "--vis",
                     "--vis_dir", "v", "--vgg16_pretrained", "vgg16.pth", "--lpips_pretrained",
                     "vgg.pth", "--synthetic", "8", "--mask"] + SHRUNK) == 0
    got = _summary(capsys.readouterr().out)
    assert got["images"] == 8 and got["lpips_vgg_sr"] > 0 and got["lpips_vgg_lr"] > 0
    files = os.listdir(tmp_path / "demo" / "v")  # n_vis 10 > 8 images: all of them
    assert len(files) == 16 and sum(f.startswith("att_") for f in files) == 8


def test_cli_demo_and_dead_flags(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    os.mkdir("crops")
    ds = SyntheticTextDataset(n=2, seed=3)
    for i in range(2):
        ds[i][1].save(f"crops/c{i}.png")
    dead = ["--text_focus", "--BiSR", "--results_rotate", "--prob_insert", "0.5", "--rotate_test", "2",
            "--test_distorted_fusing", "1"]
    assert cli.main(["--demo", "--demo_dir", "crops", "--vis_dir", "d", "--mask"] + dead + SHRUNK
                    + ["--synthetic", "8"]) == 0
    captured = capsys.readouterr()
    lines = captured.out.splitlines()
    assert [ln.split(":")[0] for ln in lines[:2]] == ["c0.png", "c1.png"] and "LR='" in lines[0]
    assert lines[2].startswith("demo: 2 images, fps=")
    assert sorted(os.listdir(tmp_path / "demo_out" / "d")) == ["c0.png", "c1.png"]
    for flag in ("--text_focus", "--BiSR", "--results_rotate", "--prob_insert", "--rotate_test",
                 "--test_distorted_fusing"):
        assert f"WARNING: {flag} is dead code in the reference" in captured.err, flag


def test_cli_log_dir_takes_the_trainer_scalars(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    code, trainer = cli.run(["--arch=tatt", "--mask", "--synthetic", "8", "--max_iters", "5",
                             "--log_dir", "tb", "--vis_dir", "r"] + SHRUNK)
    assert code == 0 and trainer.writer is not None
    trainer.writer.close()
    tags = _scalars(tmp_path / "tb" / "r")
    assert sorted(tags["loss/total"]) == [5] and "loss/sr" in tags


def test_cli_judges_need_weights(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    base = ["--go_test", "--synthetic", "8", "--mask"] + SHRUNK
    with pytest.raises(SystemExit, match="--test_model=ASTER requires judge weights"):
        cli.main(base + ["--test_model=ASTER"])
    with pytest.raises(SystemExit, match="--rec=moran requires MORAN weights"):
        cli.main(["--test", "--rec=moran"] + base[1:])
    assert cli.main(base + ["--test_model=MORAN", "--moran_pretrained", "missing.pth"]) == 2
    # --tpg OPT, --badset, --syn, --test_data_dir and --dtype bfloat16 are
    # served now: the flags that still wait hold their places
    for argv in (["--bn_per_replica"], ["--dp_devices", "2"], ["--steps_per_dispatch", "2"]):
        with pytest.raises(SystemExit, match="not ported yet"):
            cli.main(base + argv)
