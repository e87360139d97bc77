"""OpenCV's outputs on the data path's image operations, kept in
``tests/torch_cv2_golden.npz`` so that ``tatt_tpu_torch.data.imgproc`` and
``tatt_tpu_torch.data.degradation`` can be held against OpenCV on a machine
that has none (the CUDA card's): ``chip_smoke.py`` phase 17 compares the
port there, ``tests/test_torch_degradation.py`` compares it here and checks
that the file still equals what this script writes.

  python scripts/torch_cv2_golden.py            # rewrites tests/torch_cv2_golden.npz

Writing needs ``cv2`` and the JAX package (``tatt_tpu.data.degradation``
for the manmade degradation and the blur ensemble, which call OpenCV);
:func:`port_outputs` and :func:`compare` need only the port.  The inputs
are text crops of ``SyntheticTextDataset(seed=7)`` stored in the file (a
crop depends on the fonts of the machine that renders it).  Each case
names its operation, input and parameters, and the largest level gap and
share of differing values the port may show: 0 and 0 where it is exact.
"""

from __future__ import annotations

import json
import os
import random
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "..", "tests", "torch_cv2_golden.npz")

# (name, operation, input, parameters, largest gap, largest share)
CASES = [
    ("gauss_u8_3_1.0", "gaussian_blur", "lr", [3, 1.0], 0, 0),
    ("gauss_u8_5_1.0", "gaussian_blur", "lr", [5, 1.0], 0, 0),
    ("gauss_u8_5_2.7", "gaussian_blur", "lr", [5, 2.7], 0, 0),
    ("gauss_f32_3_5.3", "gaussian_blur", "lr_f32", [3, 5.3], 0, 0),
    ("gauss_f32_5_5.8", "gaussian_blur", "lr_f32", [5, 5.8], 0, 0),
    ("box_1", "box_blur", "lr", [1], 0, 0),
    ("box_3", "box_blur", "lr", [3], 0, 0),
    ("box_5", "box_blur", "lr", [5], 0, 0),
    ("median_3", "median_blur", "lr", [3], 0, 0),
    ("median_5", "median_blur", "lr", [5], 0, 0),
    ("median_7", "median_blur", "lr", [7], 0, 0),
    # 1 level on ~1e-5 of the values (imgproc's docstring): at most 1 of
    # the 3,072 values of a crop
    ("bilateral_3", "bilateral_filter", "lr", [3, 50.0, 50.0], 1, 1 / 3072),
    ("bilateral_7", "bilateral_filter", "lr", [7, 75.0, 75.0], 1, 1 / 3072),
    ("bilateral_9", "bilateral_filter", "lr", [9, 200.0, 30.0], 1, 1 / 3072),
    ("motion_10", "motion", "lr", [10.0], 0, 0),
    ("motion_45", "motion", "lr", [45.0], 0, 0),
    ("motion_100", "motion", "lr", [100.0], 0, 0),
    ("meanshift_10_20", "mean_shift_filter", "lr", [10.0, 20.0], 0, 0),
    ("meanshift_25_35", "mean_shift_filter", "lr", [25.0, 35.0], 0, 0),
    ("meanshift_39_8", "mean_shift_filter", "lr", [39.0, 8.0], 0, 0),
    ("lab", "rgb_to_lab", "lr", [], 0, 0),
    ("gray", "rgb_to_gray", "hr", [], 0, 0),
    ("canny", "canny", "hr", [20, 150], 0, 0),
    ("dilate_canny", "dilate", "hr", [5], 0, 0),
    ("canny_weight_mask", "canny_weight_mask", "hr", [], 0, 0),
    ("slic_4", "slic_segments", "lr", [4], 0, 0),
] + [
    # the composition: exact where its primitives are; the bilateral branch's
    # rare 1-level rounding, amplified by the unsharp mask's gain 3-4, may
    # show as up to 5 levels on a few values
    (f"manmade_{s}", "manmade_degradation", "hr", [s], 8, 0.001) for s in range(4)
] + [(f"ensemble_{s}", "blur_ensemble", "lr", [s], 1, 1 / 3072) for s in range(4)]


def inputs() -> dict:
    """The stored inputs: an LR crop (16x64) and an HR crop (32x128)."""
    sys.path.insert(0, os.path.join(HERE, ".."))
    from tatt_tpu_torch.data.synthetic import SyntheticTextDataset

    hr, lr, _ = SyntheticTextDataset(n=1, seed=7)[0]
    return {"lr": np.asarray(lr.convert("RGB")), "hr": np.asarray(hr.convert("RGB"))}


def _input(data: dict, key: str) -> np.ndarray:
    return data["lr"].astype(np.float32) if key == "lr_f32" else data[key]


def make_golden(data: dict | None = None) -> dict:
    """The inputs (``data``, else :func:`inputs`), the cases (JSON) and
    OpenCV's output for each case."""
    import cv2

    sys.path.insert(0, os.path.join(HERE, ".."))
    from tatt_tpu.data import degradation as jdeg
    from tatt_tpu.data.variants import canny_weight_mask
    from tatt_tpu_torch.data.degradation import motion_kernel

    data = inputs() if data is None else data
    ops = {
        "gaussian_blur": lambda a, k, s: cv2.GaussianBlur(a, (k, k), s),
        "box_blur": lambda a, k: cv2.blur(a, (k, k)),
        "median_blur": lambda a, k: cv2.medianBlur(a, k),
        "bilateral_filter": lambda a, d, sc, ss: cv2.bilateralFilter(a, d, sc, ss),
        "motion": lambda a, ang: cv2.filter2D(a, -1, motion_kernel(3, ang)),
        "mean_shift_filter": lambda a, sp, sr: cv2.pyrMeanShiftFiltering(a, sp, sr),
        "rgb_to_lab": lambda a: cv2.cvtColor(a, cv2.COLOR_RGB2LAB),
        "rgb_to_gray": lambda a: cv2.cvtColor(a, cv2.COLOR_RGB2GRAY),
        "canny": lambda a, lo, hi: cv2.Canny(cv2.cvtColor(a, cv2.COLOR_RGB2GRAY), lo, hi),
        "dilate": lambda a, k: cv2.dilate(cv2.Canny(cv2.cvtColor(a, cv2.COLOR_RGB2GRAY), 20, 150),
                                          np.ones((k, k), np.uint8)),
        "canny_weight_mask": canny_weight_mask,
        "slic_segments": jdeg.slic_segments,
        "manmade_degradation": lambda a, s: _seeded_manmade(jdeg.manmade_degradation, a, s),
        "blur_ensemble": lambda a, s: np.asarray(jdeg.blur_ensemble(a, random.Random(s), p=1.0)),
    }
    out = dict(data, cases=np.array(json.dumps(CASES)))
    for name, op, key, params, _, _ in CASES:
        out[name] = np.asarray(ops[op](_input(data, key), *params))
    return out


def _seeded_manmade(fn, a, seed):
    """The JAX function draws its noise from numpy's global state."""
    np.random.seed(seed)
    return np.asarray(fn(a, random.Random(seed)))


def port_outputs(golden) -> dict:
    """The port's output for each case of ``golden`` (a loaded file)."""
    from tatt_tpu_torch.data import degradation as deg
    from tatt_tpu_torch.data import imgproc as ip
    from tatt_tpu_torch.data.variants import canny_weight_mask

    ops = {
        "gaussian_blur": ip.gaussian_blur, "box_blur": ip.box_blur, "median_blur": ip.median_blur,
        "bilateral_filter": ip.bilateral_filter,
        "motion": lambda a, ang: ip.filter2d(a, deg.motion_kernel(3, ang)),
        "mean_shift_filter": ip.mean_shift_filter, "rgb_to_lab": ip.rgb_to_lab,
        "rgb_to_gray": ip.rgb_to_gray,
        "canny": lambda a, lo, hi: ip.canny(ip.rgb_to_gray(a), lo, hi),
        "dilate": lambda a, k: ip.dilate(ip.canny(ip.rgb_to_gray(a), 20, 150), k),
        "canny_weight_mask": canny_weight_mask, "slic_segments": deg.slic_segments,
        "manmade_degradation": lambda a, s: np.asarray(deg.manmade_degradation(
            a, random.Random(s), np.random.RandomState(s))),
        "blur_ensemble": lambda a, s: np.asarray(deg.blur_ensemble(a, random.Random(s), p=1.0)),
    }
    data = {k: golden[k] for k in ("lr", "hr")}
    return {name: np.asarray(ops[op](_input(data, key), *params))
            for name, op, key, params, _, _ in json.loads(str(golden["cases"]))}


def compare(golden, outputs) -> list:
    """(name, largest gap, share of differing values, allowed gap, allowed
    share, within) for each case."""
    rows = []
    for name, _, _, _, gap, share in json.loads(str(golden["cases"])):
        want, got = golden[name], outputs[name]
        diff = np.abs(want.astype(np.float64) - got.astype(np.float64)) if want.shape == got.shape \
            else np.full(1, np.inf)
        worst, frac = float(diff.max()), float((diff > 0).mean())
        rows.append((name, worst, frac, gap, share, worst <= gap and frac <= share))
    return rows


if __name__ == "__main__":
    golden = make_golden()
    np.savez_compressed(GOLDEN, **golden)
    print(f"wrote {len(CASES)} cases to {os.path.normpath(GOLDEN)} "
          f"({os.path.getsize(GOLDEN)} bytes)")
