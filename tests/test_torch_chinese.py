"""The Chinese path (``--CHNSR --tpg OPT``) of tatt_tpu_torch (CPU) against
tatt_tpu (JAX, CPU), at small widths (TATT ``srb 1``, ``hidden 4``; the
``--tiny_tpg`` TPG: ``output_channel`` 64, hidden 32, 3965 classes).

- the 3965-character table is byte-identical to the JAX package's, and
  ``str_filt(., "chinese")`` and the CTC decode over blank + the table
  agree with JAX on a fixed list of strings;
- the collate's label fields over that alphabet equal JAX's ``collate``;
- one whole TATT train step under the recipe's flags, with the TPG as
  teacher and student through ``parse_opt_input``, against
  ``make_train_step(parse_fn=parse_opt_input)``, the port's float32 and
  float64 steps: metrics rtol 1e-5 (as ``tests/test_torch_flags.py``,
  ``gnorm/stn_head`` 2e-2, and for the float64 step ``gnorm/infoGen``
  1e-4: JAX's float32 rounding, measured 2.1e-5), every gradient leaf
  within 1e-4 of its model's largest entry but the STN head's (1e-3, as
  there) and the student's (below), and BatchNorm running statistics;
- ``Evaluator`` (the teacher TPG as judge, the ``chinese`` filter) against
  JAX ``Trainer.evaluate`` on the same weights: PSNR within 0.01 dB, SSIM
  within 1e-3, accuracy and NED equal;
- the CLI trains, saves and ``--go_test``s the path, refuses the
  combinations the JAX package fails on with its reason, and a TPG
  checkpoint does not load into a CRNN run, nor the reverse.

The student's gradient is held within 3e-2 of its largest entry: it comes
from the distillation loss, whose margin term |teacher - student| has the
gradient sign(teacher - student), and over 3965 classes both seeded
recognizers give near-uniform probabilities (~2.5e-4), so that sign flips
where the two differ by less than float32 rounding (the head's gradient
moves 3.3e-4 to 1.1e-3).  Through train-mode BatchNorm the extractor's
gradient is also ill-conditioned on these inputs: JAX's own jitted and
eager float32 gradients of its first stages differ by up to 1.3e-2 of the
largest entry, the port's float32 and float64 ones by 5.3e-3, the port's
from JAX's by 0.8-1.7e-2 (in eval mode, on a smooth loss, all agree within
2.7e-6: ``tests/test_torch_tpg.py`` holds the TPG's gradients).
"""

import hashlib
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_models import random_variables
from tatt_tpu.core import charset as jcharset
from tatt_tpu.data.collate import collate as jcollate
from tatt_tpu.models import stn as jstn
from tatt_tpu.models.recognizers.tpg import TPGModel as JTPG
from tatt_tpu.models.recognizers.tpg import parse_opt_input as jparse_opt
from tatt_tpu.models.tsrn import TATT as JTATT
from tatt_tpu.train.state import TrainState
from tatt_tpu.train.steps import StepConfig as JStepConfig
from tatt_tpu.train.steps import make_train_step
from tatt_tpu_torch.cli import main as cli
from tatt_tpu_torch.core import charset
from tatt_tpu_torch.core.checkpoint import load_checkpoint
from tatt_tpu_torch.core.config import Config, Flags
from tatt_tpu_torch.core.convert import from_jax, from_jax_copies
from tatt_tpu_torch.data.collate import collate
from tatt_tpu_torch.data.synthetic import SyntheticTextDataset
from tatt_tpu_torch.models.factory import recognizer_spec
from tatt_tpu_torch.models.recognizers.tpg import TPGModel, parse_opt_input
from tatt_tpu_torch.models.tsrn import TATT
from tatt_tpu_torch.train.loop import Evaluator
from tatt_tpu_torch.train.steps import StepConfig, train_step

HERE = os.path.dirname(os.path.abspath(__file__))
TABLE = charset.voc_table("chinese")
N_CLASS = len(TABLE)  # 3965
SMALL = dict(srb_nums=1, hidden_units=4, out_text_channels=8)
TINY_TPG = dict(num_class=N_CLASS, output_channel=64, hidden_size=32)
SHRUNK = ["--srb", "1", "--hd_u", "4", "--tiny_tpg", "--batch_size", "4", "--device", "cpu",
          "--log_dir", ""]
RECIPE = ["--arch=tatt", "--STN", "--mask", "--use_distill", "--gradient", "--sr_share",
          "--stu_iter=1", "--rotate_train=5.0", "--tssim_loss"]
STRINGS = ["中国abc!@#", "ABC中文123", "  空 格\t", "日本語テキスト", "Hello, 世界!", "",
           "龥一乙", "龦x䷿", "ＡＢＣ全角", "深度学习 2024"]
GRAD_TOL = 1e-4
# (module docstring) the STN head's leaves, as tests/test_torch_flags.py;
# the student's
LEAF_TOL = {("sr", "stn_head."): 1e-3, ("student", ""): 3e-2}
METRIC_RTOL = {"gnorm/stn_head": 2e-2, "grad_norm_sr": 1e-4}  # as tests/test_torch_flags.py
METRIC_RTOL_F64 = {"gnorm/stn_head": 1e-4, "gnorm/infoGen": 1e-4}


def chinese_dataset(n: int, seed: int) -> SyntheticTextDataset:
    """Synthetic crops labelled from a slice of the table, as
    ``tests/test_chinese_path.py`` makes them."""
    return SyntheticTextDataset(n=n, seed=seed, charset=TABLE[200:264])


def test_table_is_the_jax_packages_byte_for_byte():
    with open(os.path.join(HERE, "..", "tatt_tpu_torch", "data", "al_chinese.txt"), "rb") as fh:
        ours = fh.read()
    with open(os.path.join(HERE, "..", "tatt_tpu", "data", "al_chinese.txt"), "rb") as fh:
        theirs = fh.read()
    assert ours == theirs and len(ours) == 11705
    assert TABLE == jcharset.voc_table("chinese") and N_CLASS == 3965
    assert hashlib.sha256(ours).hexdigest() == (
        "d0d2aae88a563d27650536b3f61eec828ea5d9811248c0d0ef78459741a30fec")


@pytest.mark.parametrize("text", STRINGS)
def test_str_filt_matches_jax(text):
    for mode in ("chinese", "lower", "all"):
        assert charset.str_filt(text, mode) == jcharset.str_filt(text, mode), mode


def test_ctc_decode_over_the_table_matches_jax():
    """Blank + table, the CTCLabelConverter shift; the 3965-class head
    cannot emit the table's last character (kept reference quirk)."""
    alphabet = "-" + TABLE
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((129, 6, N_CLASS)).astype(np.float32)
    ids = [alphabet.index("中"), 0, alphabet.index("国"), alphabet.index("国"), 0, alphabet.index("国")]
    logits[: len(ids), 0] = -10.0
    logits[np.arange(len(ids)), 0, ids] = 10.0
    got = charset.ctc_greedy_decode(logits, alphabet)
    assert got == jcharset.ctc_greedy_decode(logits, alphabet)
    assert got[0].startswith("中国国")


def test_collate_label_fields_match_jax():
    ds = chinese_dataset(6, 3)
    samples = [ds[i] for i in range(6)]
    alphabet = "-" + TABLE
    ours, theirs = collate(samples, alphabet=alphabet), jcollate(samples, alphabet=alphabet)
    # the table holds '-' (index 13), so the blank-first alphabet maps 3965
    # distinct symbols, '-' to the table's (14), as in JAX and the reference
    assert ours.label_vecs.shape == (6, N_CLASS, 1, 26)
    for field in ("label_vecs", "ctc_ids", "weighted_tics"):
        np.testing.assert_array_equal(getattr(ours, field), getattr(theirs, field), err_msg=field)
    arrays = theirs.device_arrays()
    for field in ("ctc_targets", "ctc_lengths"):
        np.testing.assert_array_equal(getattr(ours, field), np.asarray(arrays[field]),
                                      err_msg=field)
    assert ours.label_vecs[:, 1:].sum() > 0  # the labels' characters are in the table


def _variables(seed: int):
    """(TATT variables, student TPG variables, teacher TPG variables)."""
    rng = np.random.default_rng(seed)
    sr = random_variables(JTATT(stn=True, dropout=0.0, text_emb=N_CLASS, **SMALL), rng,
                          jnp.zeros((2, 4, 16, 64)), jnp.zeros((2, N_CLASS, 1, 129)), train=True)
    stn = sr["params"]["stn_head"]
    stn["fc2_kernel"] = stn["fc2_kernel"] * 0.1
    stn["fc2_bias"] = (jstn.build_output_control_points(20, (0.01, 0.01)).reshape(-1)
                       + rng.normal(0, 0.01, 40)).astype(np.float32)
    luma = jnp.zeros((2, 1, 32, 512))
    return sr, random_variables(JTPG(**TINY_TPG), rng, luma), random_variables(JTPG(**TINY_TPG),
                                                                                rng, luma)


def _batch(n: int = 4) -> dict:
    ds = chinese_dataset(n, 5)
    arrays = jcollate([ds[i] for i in range(n)], alphabet="-" + TABLE).device_arrays()
    rng = np.random.default_rng(5)
    return {"images_hr": np.asarray(arrays["images_hr"]),
            "images_lr": np.asarray(arrays["images_lr"]),
            "rot_arc": (rng.uniform(-1, 1, n) * 5.0 / 180.0 * math.pi).astype(np.float32),
            "rot_offs": rng.uniform(0, 1, n).astype(np.float32)}


def _jax_step(sr, stu, teacher, batch):
    sr_model = JTATT(stn=True, dropout=0.0, text_emb=N_CLASS, **SMALL)
    fused_model, tpg = sr_model.clone(bn_copies=2), JTPG(**TINY_TPG)

    def sr_apply(model):
        return lambda v, lr, prior, train, rngs=None, mutable=False: model.apply(
            v, lr, prior, train=train, rngs=rngs, mutable=mutable)

    def tpg_apply(variables, luma, train, mutable=False):
        return tpg.apply(variables, luma, train=train, mutable=mutable)

    step = jax.jit(make_train_step(sr_apply(sr_model), tpg_apply, tpg_apply, JStepConfig(),
                                   parse_fn=jparse_opt, sr_apply_fused=sr_apply(fused_model)))
    state = TrainState.create([sr], [stu], optax.sgd(1.0))
    new, metrics = step(state, teacher, {k: jnp.asarray(v) for k, v in batch.items()},
                        jax.random.PRNGKey(0))
    grads = {part: from_jax({"params": jax.tree_util.tree_map(
        lambda a, b: np.asarray(a) - np.asarray(b), getattr(state, f"{part}_params")[0],
        getattr(new, f"{part}_params")[0])}) for part in ("sr", "student")}
    host = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
    stats = {part: from_jax_copies(host(getattr(new, f"{part}_params")),
                                   host(getattr(new, f"{part}_batch_stats")))[0]
             for part in ("sr", "student")}
    return {k: float(v) for k, v in metrics.items()}, grads, stats


def _port_step(sr, stu, teacher_vars, batch, dtype):
    generator = TATT(stn=True, dropout=0.0, text_emb=N_CLASS, **SMALL)
    student, teacher = TPGModel(**TINY_TPG), TPGModel(**TINY_TPG)
    generator.load_state_dict(from_jax(sr))
    student.load_state_dict(from_jax(stu))
    teacher.load_state_dict(from_jax(teacher_vars))
    for m in (generator, student, teacher):
        m.to(dtype)
    opt = torch.optim.SGD([*generator.parameters(), *student.parameters()], lr=1.0)
    tb = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    tb = {k: v.to(dtype) if v.dtype == torch.float32 else v for k, v in tb.items()}
    with torch.backends.mkldnn.flags(enabled=False):  # as tests/test_torch_tpg.py
        metrics = train_step([generator.train()], [student.train()], teacher.eval(), opt, tb,
                             StepConfig(), torch.Generator().manual_seed(0), parse_opt_input)
    grads = {"sr": {k: p.grad for k, p in generator.named_parameters()},
             "student": {k: p.grad for k, p in student.named_parameters()}}
    stats = {"sr": generator.state_dict(), "student": student.state_dict()}
    return {k: v.item() for k, v in metrics.items()}, grads, stats


@pytest.fixture(scope="module")
def steps():
    sr, stu, teacher = _variables(13)
    batch = _batch()
    return (_jax_step(sr, stu, teacher, batch), _port_step(sr, stu, teacher, batch, torch.float32),
            _port_step(sr, stu, teacher, batch, torch.float64))


def _grad_errors(want: dict, got: dict) -> dict:
    scale = max(max(float(np.abs(w.numpy()).max()) for w in want.values()), 1e-30)
    assert sorted(got) == sorted(want)
    return {k: float(np.abs(got[k].double().numpy() - w.numpy()).max()) / scale
            for k, w in want.items()}


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_chnsr_opt_train_step_matches_make_train_step(steps, dtype):
    (m_j, g_j, s_j), got32, got64 = steps
    m_t, g_t, s_t = got32 if dtype == "float32" else got64
    rtol = METRIC_RTOL if dtype == "float32" else METRIC_RTOL_F64
    assert sorted(m_t) == sorted(m_j)
    for key, value in m_j.items():
        np.testing.assert_allclose(m_t[key], value, rtol=rtol.get(key, 1e-5), atol=1e-7,
                                   err_msg=key)
    for part in ("sr", "student"):
        errs = _grad_errors(g_j[part], g_t[part])
        tol = {k: next((t for (p, pre), t in LEAF_TOL.items() if p == part and k.startswith(pre)),
                       GRAD_TOL) for k in errs}
        bad = {k: e for k, e in errs.items() if e > tol[k]}
        assert not bad, (part, bad)
    for part in ("sr", "student"):  # BatchNorm running statistics after the step
        for name, value in s_j[part].items():
            if "running" in name:
                np.testing.assert_allclose(s_t[part][name].double().numpy(), value.numpy(),
                                           rtol=1e-4, atol=1e-5, err_msg=f"{part} {name}")


def test_evaluator_matches_jax_trainer_evaluate():
    from tatt_tpu.core.config import Config as JConfig
    from tatt_tpu.data.synthetic import SyntheticTextDataset as JSynthetic
    from tatt_tpu.train.loop import Trainer as JTrainer

    jcfg = JConfig()
    for key, value in dict(CHNSR=True, tpg="OPT", tiny_tpg=True, log_dir="", tssim_loss=False,
                           rotate_train=0.0, batch_size=8, hd_u=4, srb=1, mask=True).items():
        setattr(jcfg.args, key, value)
    jcfg.TRAIN.batch_size, jcfg.TRAIN.VAL.valInterval = 8, 0
    jcfg.MODEL.srb_nums, jcfg.MODEL.hidden_units, jcfg.MODEL.out_text_channels = 1, 4, 8
    val_j = JSynthetic(n=16, seed=2, charset=TABLE[200:264])
    trainer = JTrainer(jcfg, val_j, {"val": val_j})
    want = trainer.evaluate(val_j, batch_size=8)

    st = trainer.state
    generator = TATT(mask=True, text_emb=N_CLASS, **SMALL)
    generator.load_state_dict(from_jax({"params": st.sr_params[0],
                                        "batch_stats": st.sr_batch_stats[0]}))
    student, teacher = TPGModel(**TINY_TPG), TPGModel(**TINY_TPG)
    student.load_state_dict(from_jax({"params": st.student_params[0],
                                      "batch_stats": st.student_batch_stats[0]}))
    teacher.load_state_dict(from_jax(jax.tree_util.tree_map(np.asarray, trainer.teacher_vars)))
    spec = recognizer_spec(Config(args=Flags(CHNSR=True, tpg="OPT")))
    assert spec.parse_fn is parse_opt_input and spec.alphabet == "-" + TABLE
    ev = Evaluator([generator.eval()], [student.eval()], teacher.eval(), torch.device("cpu"),
                   batch_size=8, mask=True, spec=spec)
    got = ev.evaluate(chinese_dataset(16, 2))
    for key in ("psnr_avg", "psnr_avg_lr"):
        assert abs(got[key] - want[key]) <= 0.01, (key, got[key], want[key])
    for key in ("ssim_avg", "ssim_avg_lr"):
        assert abs(got[key] - want[key]) <= 1e-3, (key, got[key], want[key])
    for key in ("accuracy", "accuracy_lr", "accuracy_hr", "images"):
        assert got[key] == want[key], (key, got[key], want[key])
    assert got["ned"] == pytest.approx(want["ned"], abs=1e-12)


def _yaml(tmp_path) -> str:
    path = tmp_path / "chnsr.yaml"
    path.write_text(f"TRAIN:\n  voc_type: chinese\n  saveInterval: 1\n"
                    f"  ckpt_dir: '{tmp_path / 'ckpt'}'\n  VAL:\n    valInterval: 1\n"
                    f"    crnn_pretrained: ''\n")
    return str(path)


def test_cli_trains_and_go_tests_the_chinese_path(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    argv = RECIPE + ["--CHNSR", "--tpg", "OPT", "--synthetic", "8", "--config", _yaml(tmp_path),
                     "--vis_dir", "v"] + SHRUNK
    code, trainer = cli.run(argv + ["--max_iters", "1"])
    assert code == 0 and recognizer_spec(trainer.cfg).num_class == N_CLASS
    assert isinstance(trainer.teacher, TPGModel) and trainer.evaluator.spec.filter_mode == "chinese"
    best = tmp_path / "ckpt" / "v" / "model_best_acc_0.ckpt"
    saved = load_checkpoint(str(best))["best_history_res"]["easy"]
    capsys.readouterr()
    assert cli.main(argv + ["--go_test", "--resume", str(best)]) == 0
    line = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("[easy] ")][-1]
    got = eval(line[len("[easy] "):])  # noqa: S307  (the CLI's own dict repr)
    for key in ("accuracy", "accuracy_lr", "accuracy_hr", "ned", "images"):
        assert got[key] == saved[key], key
    assert abs(got["psnr_avg"] - saved["psnr_avg"]) <= 1e-4


@pytest.mark.parametrize("argv, reason", [
    (["--CHNSR"], "--CHNSR needs --tpg OPT"),
    (["--CHNSR", "--tpg", "OPT", "--arch=tsrn_tl_cascade"], "not ported yet"),
    (["--tpg", "OPT", "--crnn_pretrained", "{crnn}"], "--tpg OPT with a teacher file"),
])
def test_cli_refuses_what_jax_cannot_run(tmp_path, argv, reason):
    crnn = tmp_path / "crnn.pth"
    from tatt_tpu_torch.models.recognizers.crnn import CRNN

    torch.save(CRNN(nh=16, nm=(8, 8, 16, 16, 32, 32, 32)).state_dict(), crnn)
    argv = [a.replace("{crnn}", str(crnn)) for a in argv]
    with pytest.raises(SystemExit, match=reason):
        cli.main(RECIPE[1:] + argv + ["--synthetic", "8", "--max_iters", "1"] + SHRUNK)


@pytest.mark.parametrize("saved_tpg", [True, False], ids=["tpg-into-crnn", "crnn-into-tpg"])
def test_a_checkpoint_of_the_other_recognizer_is_refused(tmp_path, monkeypatch, saved_tpg):
    monkeypatch.chdir(tmp_path)
    opt = ["--CHNSR", "--tpg", "OPT"]
    base = RECIPE + ["--synthetic", "8", "--config", _yaml(tmp_path), "--vis_dir", "v"] + SHRUNK
    code, _ = cli.run(base + (opt if saved_tpg else []) + ["--max_iters", "1"])
    assert code == 0
    best = str(tmp_path / "ckpt" / "v" / "checkpoint.ckpt")
    with pytest.raises(ValueError, match="students are (TPG|CRNN) recognizers, the run's are"):
        cli.main(base + ([] if saved_tpg else opt) + ["--go_test", "--resume", best])
