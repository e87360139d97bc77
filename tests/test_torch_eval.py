"""The whole eval slice of tatt_tpu_torch (CPU) against tatt_tpu (JAX, CPU).

JAX ``make_eval_step`` plus the metric and judge pipeline of
``Trainer.evaluate`` against the port's ``eval_step`` and ``Evaluator``
from the same converted weights: PSNR within 0.01 dB, SSIM within 1e-3
and identical decoded strings (the bar of test_eval_protocol_parity.py).
"""

import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_models import random_variables
from tatt_tpu.core.charset import ctc_greedy_decode
from tatt_tpu.core.checkpoint import load_variables_npz
from tatt_tpu.data.collate import collate as jcollate
from tatt_tpu.kernels.resize import resize_bicubic
from tatt_tpu.losses.ssim import psnr as jpsnr
from tatt_tpu.losses.ssim import ssim as jssim
from tatt_tpu.models.recognizers.crnn import CRNN as JCRNN
from tatt_tpu.models.recognizers.crnn import parse_crnn_input as jparse
from tatt_tpu.models.tsrn import TATT as JTATT
from tatt_tpu.train.metrics import EvalAccumulator as JAccumulator
from tatt_tpu.train.steps import make_eval_step
from tatt_tpu_torch.core.convert import from_jax, load_npz
from tatt_tpu_torch.data.synthetic import SyntheticTextDataset
from tatt_tpu_torch.models.recognizers.crnn import CRNN
from tatt_tpu_torch.models.tsrn import TATT
from tatt_tpu_torch.train.loop import Evaluator
from tatt_tpu_torch.train.steps import eval_step

ASSET = os.path.join(os.path.dirname(__file__), "assets", "fixture_crnn.npz")
SMALL = dict(srb_nums=1, hidden_units=4, out_text_channels=8)
TINY_NM = (8, 8, 16, 16, 32, 32, 32)


def _port(module, variables):
    module.load_state_dict(from_jax(variables))
    return module.eval()


def test_eval_path_matches_jax():
    rng = np.random.default_rng(11)
    gen_j = JTATT(**SMALL)
    gen_v = random_variables(gen_j, rng, jnp.zeros((2, 4, 16, 64)), jnp.zeros((2, 37, 1, 26)))
    stu_j = JCRNN(nh=16, nm=TINY_NM)
    stu_v = random_variables(stu_j, rng, jnp.zeros((2, 1, 32, 100)))
    judge_v, meta = load_variables_npz(ASSET)
    judge_j = JCRNN(nh=int(meta["nh"]), nm=tuple(int(v) for v in meta["nm"]))

    state = types.SimpleNamespace(
        sr_params=(gen_v["params"],), sr_batch_stats=(gen_v["batch_stats"],),
        student_params=(stu_v["params"],), student_batch_stats=(stu_v["batch_stats"],),
    )
    step = make_eval_step(
        lambda v, lr, prior, train: gen_j.apply(v, lr, prior, train=train),
        lambda v, luma, train: stu_j.apply(v, luma, train=train),
    )
    j_eval = jax.jit(lambda lr: step(state, {"images_lr": lr}))
    j_judge = jax.jit(lambda im: judge_j.apply(judge_v, jparse(im[:, :3]), train=False))

    ds = SyntheticTextDataset(n=16, seed=2)
    acc = JAccumulator()
    j_srs, j_strings = [], []
    for start in (0, 8):
        b = jcollate([ds[i] for i in range(start, start + 8)], mask=True)
        hr, lr = b.images_hr, b.images_lr
        sr, _ = j_eval(jnp.asarray(lr))
        sr = np.asarray(sr)
        lr_up = np.asarray(resize_bicubic(jnp.asarray(lr), 32, 128))
        preds = [ctc_greedy_decode(np.asarray(j_judge(jnp.asarray(im)))) for im in (sr, lr, hr)]
        acc.add_batch(
            float(jpsnr(sr, hr)), float(jssim(jnp.asarray(sr), jnp.asarray(hr))), *preds,
            b.label_strs, psnr_lr=float(jpsnr(lr_up, hr)),
            ssim_lr=float(jssim(jnp.asarray(lr_up), jnp.asarray(hr))), n_real=8,
        )
        j_srs.append(sr)
        j_strings.append(preds)
    want = acc.summary()

    judge = _port(CRNN(nh=int(meta["nh"]), nm=tuple(int(v) for v in meta["nm"])), judge_v)
    ev = Evaluator(
        [_port(TATT(**SMALL), gen_v)], [_port(CRNN(nh=16, nm=TINY_NM), stu_v)], judge,
        torch.device("cpu"), batch_size=8, mask=True,
    )
    got = ev.evaluate(ds)
    for key in ("psnr_avg", "psnr_avg_lr"):
        assert abs(got[key] - want[key]) <= 0.01, (key, got[key], want[key])
    for key in ("ssim_avg", "ssim_avg_lr"):
        assert abs(got[key] - want[key]) <= 1e-3, (key, got[key], want[key])
    for key in ("accuracy", "accuracy_lr", "accuracy_hr", "ned", "images"):
        assert got[key] == want[key], (key, got[key], want[key])
    assert want["accuracy_hr"] > 0.5  # the judge reads real text here

    # the stu_iter cascade: at iteration 2 the student reads the first SR
    step2 = make_eval_step(
        lambda v, lr, prior, train: gen_j.apply(v, lr, prior, train=train),
        lambda v, luma, train: stu_j.apply(v, luma, train=train),
        stu_iter=2,
    )
    lr0 = next(ev.batches(ds))[1]
    want2, _ = jax.jit(lambda lr: step2(state, {"images_lr": lr}))(jnp.asarray(lr0.numpy()))
    got2, _ = eval_step(ev.generators, ev.students, lr0, stu_iter=2)
    np.testing.assert_allclose(got2.numpy(), np.asarray(want2), atol=1e-4, rtol=1e-4)

    # string-for-string decode parity and SR parity, batch by batch
    for (hr, lr, labels), sr_j, strings_j in zip(ev.batches(ds), j_srs, j_strings):
        sr, _ = eval_step(ev.generators, ev.students, lr)
        np.testing.assert_allclose(sr.numpy(), sr_j, atol=1e-4, rtol=1e-4)
        assert [ev.decode(im) for im in (sr, lr, hr)] == strings_j


def test_fixture_judge_reads_hr_on_the_port():
    """The port's copy of test_fixture_judge: the trained judge, converted
    with from_jax, reads held-out clean HR crops at > 0.85 and far better
    than LR."""
    from tatt_tpu_torch.core.charset import ctc_greedy_decode as decode, str_filt
    from tatt_tpu_torch.models.recognizers.crnn import parse_crnn_input

    variables, meta = load_npz(ASSET)
    judge = _port(CRNN(nh=int(meta["nh"]), nm=tuple(int(v) for v in meta["nm"])), variables)
    ds = SyntheticTextDataset(n=64, seed=20260818)
    labels = [ds[i][2] for i in range(64)]

    def word_acc(k):
        imgs = np.stack([np.asarray(ds[i][k].convert("RGB"), np.float32) / 255.0 for i in range(64)])
        with torch.no_grad():
            logits = judge(parse_crnn_input(torch.from_numpy(imgs.transpose(0, 3, 1, 2))))
        preds = decode(logits.numpy())
        return np.mean([str_filt(p, "lower") == str_filt(t, "lower") for p, t in zip(preds, labels)])

    acc_hr, acc_lr = word_acc(0), word_acc(1)
    assert acc_hr > 0.85, acc_hr
    assert acc_hr > acc_lr + 0.2, (acc_hr, acc_lr)


def test_cli_go_test_on_cpu(capsys):
    """The CLI's --go_test path at full width on a few CPU images."""
    from tatt_tpu_torch.cli import main as cli

    assert cli.main(["--go_test", "--synthetic", "8", "--mask", "--device", "cpu",
                     "--batch_size", "4"]) == 0
    out = capsys.readouterr().out
    assert out.startswith("[easy] {") and "'images': 8" in out


@pytest.mark.parametrize(
    "argv",
    # the TSRN family, --color_loss, --mse_fuse, the zoo, --tpg OPT,
    # --CHNSR, the data flags of data/variants.py and --dtype bfloat16 are
    # served now: their cases hold the flags that still wait (DDP's and
    # --steps_per_dispatch) and a zoo arch with the recipe's flags and a
    # multi-device flag
    [["--synthetic", "8", "--steps_per_dispatch", "4"], ["--arch=srcnn", "--go_test", "--dp_devices", "2"],
     ["--synthetic", "8", "--bn_per_replica"], ["--go_test", "--dp_devices", "2"],
     # a zoo arch with a text prior under --bn_per_replica, and the recipe
     # under --dp_devices (in the Chinese path's place)
     ["--STN", "--mask", "--use_distill", "--gradient", "--sr_share", "--rotate_train=5.0",
      "--arch=tbsrn_tl", "--bn_per_replica", "--synthetic", "8"],
     ["--STN", "--mask", "--use_distill", "--gradient", "--sr_share", "--tssim_loss",
      "--rotate_train=3.0", "--dp_devices", "2", "--synthetic", "8"]],
)
def test_cli_refuses_what_is_not_ported(argv):
    from tatt_tpu_torch.cli import main as cli

    with pytest.raises(SystemExit, match="not ported yet"):
        cli.main(argv + ["--device", "cpu"])
