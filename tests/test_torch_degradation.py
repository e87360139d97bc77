"""The port's image operations (``tatt_tpu_torch.data.imgproc``, numpy and
scipy, no OpenCV) against ``cv2``, and its degradation pipeline, ``--syn``
collate and seeded loader against the JAX package, which calls ``cv2``
(CPU, seeded inputs).

What each operation is held to (``imgproc``'s docstring says why):
exact, value for value: ``gaussian_blur`` (uint8; float32 on 64- and
128-wide crops), ``box_blur``, ``median_blur``, ``filter2d`` on uint8,
``mean_shift_filter``, ``rgb_to_lab`` and ``rgb_to_gray`` over all 2^24
colours, ``canny``, ``dilate``, ``slic_segments``; ``bilateral_filter``
within 1 level on at most 1e-4 of the values.  The compositions
(``manmade_degradation``, ``blur_ensemble``, ``_superpixels``) are exact when
``cv2``'s primitives are swapped in for the port's: the same draws in the
same order.
"""

import importlib.util
import json
import os
import random

import cv2
import numpy as np
import pytest
from PIL import Image

from tatt_tpu.data import degradation as jdeg
from tatt_tpu.data.collate import collate as jcollate
from tatt_tpu.data.lmdb_dataset import LmdbTextDataset as JLmdbText
from tatt_tpu.data.loader import DataLoader as JDataLoader
from tatt_tpu_torch.data import degradation as deg
from tatt_tpu_torch.data import imgproc as ip
from tatt_tpu_torch.data.collate import collate
from tatt_tpu_torch.data.device_pipeline import host_normalize_u8
from tatt_tpu_torch.data.lmdb_dataset import LmdbTextDataset
from tatt_tpu_torch.data.loader import DataLoader
from tatt_tpu_torch.data.synthetic import SyntheticTextDataset
from test_torch_lmdb import pil_decode_in_jax, write_textzoom  # noqa: F401  (a fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _crops(seed: int, n: int, hr: bool = False) -> list:
    """Text crops (LR 16x64 or HR 32x128, uint8 RGB) and, every third, noise."""
    ds = SyntheticTextDataset(n=n, seed=seed)
    out = []
    for i in range(n):
        a = np.asarray(ds[i][0 if hr else 1].convert("RGB"))
        if i % 3 == 2:
            a = np.random.RandomState(seed * 100 + i).randint(0, 256, a.shape).astype(np.uint8)
        out.append(a)
    return out


@pytest.fixture(scope="module")
def lr_crops():
    return _crops(3, 6)


@pytest.fixture(scope="module")
def hr_crops():
    return _crops(4, 6, hr=True)


CV2_PRIMITIVES = {
    "gaussian_blur": lambda a, k, s: cv2.GaussianBlur(a, (k, k), s),
    "box_blur": lambda a, k: cv2.blur(a, (k, k)),
    "median_blur": cv2.medianBlur,
    "bilateral_filter": cv2.bilateralFilter,
    "filter2d": lambda a, kernel: cv2.filter2D(a, -1, kernel),
    "mean_shift_filter": lambda a, sp, sr: cv2.pyrMeanShiftFiltering(a, sp, sr),
    "rgb_to_lab": lambda a: cv2.cvtColor(a, cv2.COLOR_RGB2LAB),
    "rgb_to_gray": lambda a: cv2.cvtColor(a, cv2.COLOR_RGB2GRAY),
    "canny": cv2.Canny,
    "dilate": lambda a, k: cv2.dilate(a, np.ones((k, k), np.uint8)),
}


@pytest.fixture
def cv2_primitives(monkeypatch):
    """``cv2`` in place of each ``imgproc`` operation, so that a
    composition is compared with its primitives' rounding taken out."""
    for name, fn in CV2_PRIMITIVES.items():
        monkeypatch.setattr(ip, name, fn)


def _gap(want, got) -> tuple[float, float]:
    d = np.abs(np.asarray(want, np.float64) - np.asarray(got, np.float64))
    return float(d.max()), float((d > 0).mean())


# ---- imgproc against cv2 -------------------------------------------------

@pytest.mark.parametrize("k,sigma", [(3, 1.0), (5, 1.0), (5, 1e-6), (5, 2.9), (3, 0.3), (7, 1.3)])
def test_gaussian_blur_uint8_is_exact(lr_crops, hr_crops, k, sigma):
    for a in lr_crops + hr_crops:
        np.testing.assert_array_equal(ip.gaussian_blur(a, k, sigma), cv2.GaussianBlur(a, (k, k), sigma))
    gray = cv2.cvtColor(hr_crops[0], cv2.COLOR_RGB2GRAY)  # 2-D, as canny_weight_mask blurs
    np.testing.assert_array_equal(ip.gaussian_blur(gray, k, sigma), cv2.GaussianBlur(gray, (k, k), sigma))


@pytest.mark.parametrize("k", [3, 5])
def test_gaussian_blur_float32_is_exact_on_the_data_paths_widths(lr_crops, hr_crops, k):
    """Exact at 64 and 128 wide (every float32 blur of the data path);
    at 63 wide OpenCV sums the row's last columns in another order: 1 ulp."""
    rs = np.random.RandomState(k)
    for a in lr_crops + hr_crops:
        f, sigma = a.astype(np.float32), rs.uniform(2.0, 6.0)
        np.testing.assert_array_equal(ip.gaussian_blur(f, k, sigma), cv2.GaussianBlur(f, (k, k), sigma))
    odd = hr_crops[0][:, :63].astype(np.float32)
    np.testing.assert_allclose(ip.gaussian_blur(odd, k, 5.5), cv2.GaussianBlur(odd, (k, k), 5.5),
                               rtol=1.2e-7, atol=0)


@pytest.mark.parametrize("k", [1, 3, 5])
def test_box_blur_is_exact(lr_crops, k):
    for a in lr_crops:
        np.testing.assert_array_equal(ip.box_blur(a, k), cv2.blur(a, (k, k)))


@pytest.mark.parametrize("k", [3, 5, 7])
def test_median_blur_is_exact(lr_crops, k):
    for a in lr_crops:
        np.testing.assert_array_equal(ip.median_blur(a, k), cv2.medianBlur(a, k))


def test_bilateral_filter_within_one_level(lr_crops, hr_crops):
    """Over 48 draws of (d, sigma_color, sigma_space) as the ensemble and
    the manmade chain draw them: at most 1 level off on at most 1e-4 of
    the values (measured: 15 of 1.8 M values over 300 draws)."""
    rs = np.random.RandomState(0)
    worst, differ, total = 0.0, 0, 0
    for a in (lr_crops + hr_crops) * 4:
        d = int(rs.choice([3, 5, 7, 9]))
        sc, ss = rs.uniform(10, 250, 2)
        diff = np.abs(ip.bilateral_filter(a, d, sc, ss).astype(int) - cv2.bilateralFilter(a, d, sc, ss))
        worst, differ, total = max(worst, diff.max()), differ + (diff > 0).sum(), total + diff.size
    assert worst <= 1 and differ <= 1e-4 * total, (worst, differ, total)


def test_filter2d_motion_kernels_are_exact(lr_crops):
    for angle in range(0, 181):
        kernel = deg.motion_kernel(3, float(angle))
        for a in lr_crops[:3]:
            np.testing.assert_array_equal(ip.filter2d(a, kernel), cv2.filter2D(a, -1, kernel))


@pytest.mark.parametrize("shape", [(3, 3), (5, 5), (1, 5), (3, 1)])
def test_filter2d_dense_kernels_are_exact(lr_crops, shape):
    """Dense normalized kernels up to 5x5, on colour and grey crops."""
    rs = np.random.RandomState(shape[0] * 10 + shape[1])
    for a in lr_crops + [cv2.cvtColor(lr_crops[0], cv2.COLOR_RGB2GRAY)]:
        kernel = rs.uniform(0, 1, shape).astype(np.float32)
        kernel /= kernel.sum()
        np.testing.assert_array_equal(ip.filter2d(a, kernel), cv2.filter2D(a, -1, kernel))


@pytest.mark.parametrize("shape", [(16, 64), (15, 63), (32, 128)])
def test_mean_shift_filter_is_exact(shape):
    ds = SyntheticTextDataset(n=4, seed=9)
    rs = np.random.RandomState(shape[1])
    for i in range(4 if shape[0] < 32 else 2):
        a = np.asarray(ds[i][1].convert("RGB").resize(shape[::-1], Image.BICUBIC))
        if i == 3:
            a = rs.randint(0, 256, shape + (3,)).astype(np.uint8)
        sp, sr = rs.uniform(5, 40), rs.uniform(5, 40)
        np.testing.assert_array_equal(ip.mean_shift_filter(a, sp, sr),
                                      cv2.pyrMeanShiftFiltering(a, sp, sr), err_msg=f"{i} {sp} {sr}")


def test_lab_and_gray_are_exact_over_every_colour():
    for red in range(0, 256, 64):  # 64 reds at a time: 4.2 M colours
        c = np.arange(red << 16, (red + 64) << 16, dtype=np.uint32)
        img = np.stack([c >> 16, (c >> 8) & 255, c & 255], -1).astype(np.uint8).reshape(1024, 4096, 3)
        np.testing.assert_array_equal(ip.rgb_to_lab(img), cv2.cvtColor(img, cv2.COLOR_RGB2LAB))
        np.testing.assert_array_equal(ip.rgb_to_gray(img), cv2.cvtColor(img, cv2.COLOR_RGB2GRAY))


@pytest.mark.parametrize("low,high", [(20, 150), (50, 100), (150, 20)])
def test_canny_and_dilate_are_exact(lr_crops, hr_crops, low, high):
    for a in lr_crops + hr_crops:
        gray = cv2.cvtColor(a, cv2.COLOR_RGB2GRAY)
        edges = cv2.Canny(gray, low, high)
        np.testing.assert_array_equal(ip.canny(gray, low, high), edges)
        np.testing.assert_array_equal(ip.dilate(edges, 5), cv2.dilate(edges, np.ones((5, 5), np.uint8)))


# ---- the degradation pipeline against the JAX package ---------------------

def test_canny_weight_mask_is_exact(hr_crops):
    from tatt_tpu.data.variants import canny_weight_mask as jmask
    from tatt_tpu_torch.data.variants import canny_weight_mask

    for a in hr_crops:
        np.testing.assert_array_equal(canny_weight_mask(a), jmask(Image.fromarray(a)))


@pytest.mark.parametrize("n_segments", [1, 3, 6])
def test_slic_and_superpixels_are_exact(lr_crops, monkeypatch, n_segments):
    """With the port's own Lab (exact) and with cv2's swapped in: the same
    labels and the same segments replaced, from the same draws."""
    for swap in (False, True):
        if swap:
            monkeypatch.setattr(ip, "rgb_to_lab", CV2_PRIMITIVES["rgb_to_lab"])
        for s, a in enumerate(lr_crops):
            np.testing.assert_array_equal(deg.slic_segments(a, n_segments), jdeg.slic_segments(a, n_segments))
            r1, r2 = random.Random(s), random.Random(s)
            np.testing.assert_array_equal(deg._superpixels(a, n_segments, 0.4, r1),
                                          jdeg._superpixels(a, n_segments, 0.4, r2))
            assert r1.random() == r2.random()  # the same number of draws


def _manmade_pair(a, seed):
    np.random.seed(seed)
    want = np.asarray(jdeg.manmade_degradation(Image.fromarray(a), random.Random(seed)))
    got = np.asarray(deg.manmade_degradation(Image.fromarray(a), random.Random(seed),
                                             np.random.RandomState(seed)))
    return want, got


def test_manmade_degradation_exact_with_cv2_primitives(hr_crops, cv2_primitives):
    for seed in range(24):
        want, got = _manmade_pair(hr_crops[seed % len(hr_crops)], seed)
        np.testing.assert_array_equal(got, want, err_msg=str(seed))


def test_manmade_degradation_with_the_ports_primitives(hr_crops):
    """Exact but where the bilateral branch (30 % of draws) meets its rare
    1-level rounding, which the unsharp mask's gain of 3-4 amplifies:
    measured up to 5 levels on up to 6 of 12,288 values (40 draws)."""
    for seed in range(24):
        worst, share = _gap(*_manmade_pair(hr_crops[seed % len(hr_crops)], seed))
        assert worst <= 8 and share <= 1e-3, (seed, worst, share)


@pytest.mark.parametrize("p", [1.0, 0.2])
def test_blur_ensemble_matches(lr_crops, monkeypatch, p):
    """Exact with cv2's primitives; with the port's, within the bilateral
    filter's 1 level (measured exact over 80 draws)."""
    for swap in (False, True):
        if swap:
            for name, fn in CV2_PRIMITIVES.items():
                monkeypatch.setattr(ip, name, fn)
        for seed in range(8):
            a = lr_crops[seed % len(lr_crops)]
            r1, r2 = random.Random(seed), random.Random(seed)
            want = np.asarray(jdeg.blur_ensemble(Image.fromarray(a), r2, p))
            got = np.asarray(deg.blur_ensemble(Image.fromarray(a), r1, p))
            assert r1.random() == r2.random()
            if swap:
                np.testing.assert_array_equal(got, want, err_msg=str(seed))
            else:
                worst, share = _gap(want, got)
                assert worst <= 1 and share <= 1 / 3072, (seed, worst, share)


# ---- the --syn collate and the seeded loader -------------------------------

def _assert_batches_equal(b, jb, mask: bool = True, pseudo_lr: bool = True):
    """The port's uint8 batch, normalized as the card does, bit for bit
    the JAX host collate's float batch; the label fields equal.  Without
    ``pseudo_lr`` (the train loader's batches) the port's batch has no
    pseudo-LR crops where JAX's has them."""
    for name in ("images_hr", "images_lr", "images_pseudo_lr"):
        ours, theirs = getattr(b, name), getattr(jb, name)
        if name == "images_pseudo_lr" and not pseudo_lr:
            assert ours is None and theirs is not None
            continue
        assert (ours is None) == (theirs is None), name
        if ours is not None:
            np.testing.assert_array_equal(host_normalize_u8(ours, mask), theirs, err_msg=name)
    assert b.label_strs == jb.label_strs
    for name in ("label_vecs", "ctc_ids", "ctc_targets", "ctc_lengths", "weighted_tics"):
        np.testing.assert_array_equal(getattr(b, name), getattr(jb, name), err_msg=name)


@pytest.mark.parametrize("seed", [11, 29])
def test_syn_collate_matches_the_jax_collate(seed):
    ds = SyntheticTextDataset(n=6, seed=5)
    samples = [ds[i] for i in range(6)]
    b = collate(samples, syn=True, seed=seed)
    jb = jcollate(samples, syn=True, seed=seed)
    assert b.images_pseudo_lr.shape == (6, 16, 64, 3) and b.images_pseudo_lr.dtype == np.uint8
    _assert_batches_equal(b, jb)
    assert collate(samples).images_pseudo_lr is None


@pytest.mark.parametrize("workers", [1, 4])
def test_seeded_syn_loader_matches_the_jax_loader(tmp_path, pil_decode_in_jax, workers):  # noqa: F811
    """Two shuffled epochs of ``--syn`` batches over an LMDB (odd sizes,
    a corrupt record): the per-batch collate seed of (seed, epoch, batch
    index) gives the JAX loader's batches for any worker count, but for
    the pseudo-LR crops, which the port's train loader does not build."""
    root = write_textzoom(str(tmp_path / "tz"), 10, seed=2)
    ours = DataLoader(LmdbTextDataset(root), 4, seed=7, num_workers=workers, syn=True)
    theirs = JDataLoader(JLmdbText(root), 4, seed=7, collate_kwargs=dict(syn=True))
    for _ in range(2):
        got, want = list(ours), list(theirs)
        assert len(got) == len(want) == 2
        for b, jb in zip(got, want):
            _assert_batches_equal(b, jb, pseudo_lr=False)


# ---- the golden file the card's machine compares with --------------------

def _golden_module():
    spec = importlib.util.spec_from_file_location(
        "torch_cv2_golden", os.path.join(REPO, "scripts", "torch_cv2_golden.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_golden_file_is_what_the_script_writes_now():
    """``tests/torch_cv2_golden.npz`` holds OpenCV's outputs on its stored
    inputs: remade from those inputs now, every array and case is equal,
    so the file cannot go stale against the JAX package or cv2."""
    g = _golden_module()
    stored = np.load(os.path.join(REPO, "tests", "torch_cv2_golden.npz"))
    assert os.path.getsize(os.path.join(REPO, "tests", "torch_cv2_golden.npz")) <= 200_000
    fresh = g.make_golden({k: stored[k] for k in ("lr", "hr")})
    assert sorted(fresh) == sorted(stored.files)
    assert json.loads(str(stored["cases"])) == json.loads(str(fresh["cases"]))
    for k in fresh:
        np.testing.assert_array_equal(stored[k], fresh[k], err_msg=k)


def test_the_port_is_within_the_golden_files_tolerances():
    g = _golden_module()
    stored = np.load(os.path.join(REPO, "tests", "torch_cv2_golden.npz"))
    rows = g.compare(stored, g.port_outputs(stored))
    assert len(rows) == len(json.loads(str(stored["cases"]))) >= 30
    bad = [r for r in rows if not r[-1]]
    assert not bad, bad
