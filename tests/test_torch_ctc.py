"""The port's CTC loss, label encoding, collate label and ``YCbCr`` fields
and colour conversions against the JAX package (CPU).

``ctc_loss`` values and gradients (through ``log_softmax``, against
``jax.grad``) within rtol 1e-5, each sample's gradient also within 1e-5
of its largest entry, the 1e30 entries of infeasible targets equal; the
encoders and the collate's fields equal; colour within 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from tatt_tpu.core import charset as jcharset
from tatt_tpu.data.collate import collate as jcollate
from tatt_tpu.data.synthetic import SyntheticTextDataset as JSynthetic
from tatt_tpu.kernels.color import rgb_to_yuv as jrgb_to_yuv
from tatt_tpu.kernels.color import yuv_to_rgb as jyuv_to_rgb
from tatt_tpu.kernels.ctc import ctc_loss as jctc_loss
from tatt_tpu.train.pretrain import encode_ctc_targets as jencode_ctc_targets
from tatt_tpu_torch.core import charset
from tatt_tpu_torch.data.collate import collate
from tatt_tpu_torch.data.device_pipeline import host_normalize_u8
from tatt_tpu_torch.kernels.color import rgb_to_yuv, yuv_to_rgb
from tatt_tpu_torch.kernels.ctc import ctc_loss
from tatt_tpu_torch.train.pretrain import encode_ctc_targets

ALPHABET = charset.CRNN_ALPHABET
# words the encoders meet: empty, one character, repeats, upper case and
# characters outside the alphabet, and longer than the 26 slots
WORDS = ["ab", "hello", "street", "a", "x1234567890abcdefghijklm", "", "Hello, World!", "aaa",
         "ZZ-top", "abcdefghijklmnopqrstuvwxyz0123"]


def _ctc_case(name: str):
    """(log-prob logits [T, B, C], targets [B, S], input_lengths,
    target_lengths) of one case."""
    rng = np.random.default_rng(sum(map(ord, name)))
    t, c = 26, 37
    if name == "spread":
        # the collate's spread targets: blanks inside, 24-26 symbols long
        blank = (Image.new("RGB", (128, 32)), Image.new("RGB", (64, 16)))
        batch = collate([(*blank, w) for w in WORDS])
        targets, tlens = batch.ctc_targets, batch.ctc_lengths
        ilens = np.full(len(WORDS), t)
    else:
        b, s = 6, 16
        targets = rng.integers(1, c, (b, s))
        tlens = rng.integers(1, s + 1, b)
        ilens = np.full(b, t)
        if name == "repeats":  # runs of one label need a blank between each
            targets[:, :8] = np.repeat(rng.integers(1, c, (b, 4)), 2, axis=1)
            tlens = np.array([8, 8, 10, 12, 13, 16])
        elif name == "zero_length":
            tlens[[1, 4]] = 0
        elif name == "short_inputs":  # frozen once t reaches the input length
            ilens = np.array([26, 20, 13, 7, 1, 16])
            tlens = np.array([5, 4, 3, 7, 1, 16])
    logits = rng.standard_normal((t, len(tlens), c)).astype(np.float32) * 2
    return logits, targets.astype(np.int32), ilens.astype(np.int32), np.asarray(tlens, np.int32)


@pytest.mark.parametrize("name", ["random", "repeats", "zero_length", "short_inputs", "spread"])
def test_ctc_loss_values_and_gradients_match(name):
    logits, targets, ilens, tlens = _ctc_case(name)

    def jloss(x):
        return jctc_loss(jax.nn.log_softmax(x, -1), jnp.asarray(targets), jnp.asarray(ilens),
                         jnp.asarray(tlens))

    want = np.asarray(jloss(jnp.asarray(logits)))
    # a weighted sum, so that each sample's gradient carries its own weight
    weights = np.linspace(0.5, 1.5, len(tlens)).astype(np.float32)
    want_grad = np.asarray(jax.grad(lambda x: (jloss(x) * weights).sum())(jnp.asarray(logits)))
    x = torch.tensor(logits, requires_grad=True)
    got = ctc_loss(torch.log_softmax(x, -1), torch.tensor(targets), torch.tensor(ilens),
                   torch.tensor(tlens))
    (got * torch.tensor(weights)).sum().backward()
    got, grad = got.detach().numpy(), x.grad.numpy()

    infeasible = want >= 1e29
    np.testing.assert_array_equal(got[infeasible], want[infeasible])
    np.testing.assert_allclose(got, want, rtol=1e-5)
    per_sample = np.abs(want_grad).max(axis=(0, 2), keepdims=True)
    excess = np.abs(grad - want_grad) - 1e-5 * (np.abs(want_grad) + per_sample)
    assert excess.max() <= 0, excess.max()
    assert np.isfinite(grad).all()
    if name == "spread":
        # half the spread words have no alignment in 26 frames: the 1e30
        # trap of --use_label ('a' and the empty word have one)
        assert infeasible.sum() == 5 and not infeasible[3] and not infeasible[5]


def test_label_encoders_match():
    for word in WORDS:
        for n in (26, 10):
            assert charset.spread_label(word, n) == jcharset.spread_label(word, n)
    for kw in (dict(), dict(eval_perturb=True), dict(spread=False), dict(max_len=10)):
        for got, want in zip(charset.encode_label_vecs(WORDS, ALPHABET, **kw),
                             jcharset.encode_label_vecs(WORDS, ALPHABET, **kw)):
            np.testing.assert_array_equal(got, want)
    for max_len in (16, 4):
        for got, want in zip(encode_ctc_targets(WORDS, ALPHABET, max_len),
                             jencode_ctc_targets(WORDS, ALPHABET, max_len)):
            np.testing.assert_array_equal(got, want)


def test_collate_label_and_ycbcr_fields_match():
    """The port's uint8 collate, normalized as the step normalizes it,
    against the JAX host collate with ``y_domain``: images (RGB and
    ``YCbCr``, crops of other sizes resized) bit-equal, label fields
    equal."""
    ds = JSynthetic(n=8, seed=6)
    samples = []
    for i in range(8):
        hr, lr, label = ds[i]
        if i % 3 == 1:
            hr, lr = hr.resize((120, 30)), lr.resize((70, 18))
        samples.append((hr, lr, WORDS[i]))
    want = jcollate(samples, y_domain=True)
    got = collate(samples, y_domain=True)
    for key in ("images_hr", "images_lr", "images_hr_y", "images_lr_y"):
        np.testing.assert_array_equal(host_normalize_u8(getattr(got, key), True),
                                      getattr(want, key), err_msg=key)
    for key in ("label_vecs", "ctc_ids", "ctc_targets", "ctc_lengths", "weighted_tics"):
        np.testing.assert_array_equal(getattr(got, key), getattr(want, key), err_msg=key)
    assert got.label_strs == want.label_strs
    assert collate(samples).images_hr_y is None


def test_color_conversions_match():
    rng = np.random.default_rng(8)
    x = rng.uniform(0, 1, (2, 5, 3, 7, 9)).astype(np.float32)
    for port, ref in ((rgb_to_yuv, jrgb_to_yuv), (yuv_to_rgb, jyuv_to_rgb)):
        np.testing.assert_allclose(port(torch.tensor(x)).numpy(), np.asarray(ref(jnp.asarray(x))),
                                   atol=1e-6)
    back = yuv_to_rgb(rgb_to_yuv(torch.tensor(x)))
    np.testing.assert_allclose(back.numpy(), x, atol=2e-3)  # kornia's rounded coefficients
