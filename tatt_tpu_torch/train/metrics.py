"""Eval metric aggregation — the reference's judge protocol (copied from
``tatt_tpu/train/metrics.py``: PSNR/SSIM per batch averaged over batches,
word accuracy after ``str_filt(., 'lower')``, NED)."""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from tatt_tpu_torch.core.charset import levenshtein, str_filt


@dataclass
class EvalAccumulator:
    psnr: list = field(default_factory=list)
    ssim: list = field(default_factory=list)
    batch_sizes: list = field(default_factory=list)
    psnr_lr: list = field(default_factory=list)
    ssim_lr: list = field(default_factory=list)
    n_images: int = 0
    n_correct_sr: int = 0
    n_correct_lr: int = 0
    n_correct_hr: int = 0
    ned_sr: list = field(default_factory=list)
    infer_time: float = 0.0

    def add_batch(
        self,
        psnr: float,
        ssim: float,
        preds_sr: list[str],
        preds_lr: list[str],
        preds_hr: list[str],
        labels: list[str],
        filter_mode: str = "lower",
        psnr_lr: float | None = None,
        ssim_lr: float | None = None,
        n_real: int | None = None,
    ) -> None:
        self.psnr.append(float(psnr))
        self.ssim.append(float(ssim))
        self.batch_sizes.append(int(n_real) if n_real is not None else len(labels))
        if psnr_lr is not None:
            self.psnr_lr.append(float(psnr_lr))
        if ssim_lr is not None:
            self.ssim_lr.append(float(ssim_lr))
        for p_sr, p_lr, p_hr, label in zip(preds_sr, preds_lr, preds_hr, labels):
            self.n_images += 1
            gt = str_filt(label, filter_mode)
            ps = str_filt(p_sr, filter_mode)
            self.n_correct_sr += ps == gt
            self.n_correct_lr += str_filt(p_lr, filter_mode) == gt
            self.n_correct_hr += str_filt(p_hr, filter_mode) == gt
            self.ned_sr.append(levenshtein(ps, gt) / float(max(len(ps), len(gt)) + 1e-10))

    def summary(self) -> dict:
        n = max(self.n_images, 1)
        nb = max(len(self.psnr), 1)
        # per-batch average, as the reference aggregates
        # (super_resolution.py:1627-1652); *_weighted weight by samples
        w = np.asarray(self.batch_sizes[: len(self.psnr)], np.float64)
        wsum = float(w.sum()) or 1.0
        out = {
            "psnr_avg": float(np.sum(self.psnr)) / nb,
            "ssim_avg": float(np.sum(self.ssim)) / nb,
            "psnr_avg_weighted": float(np.dot(self.psnr, w)) / wsum,
            "ssim_avg_weighted": float(np.dot(self.ssim, w)) / wsum,
            "accuracy": round(self.n_correct_sr / n, 4),
            "accuracy_lr": round(self.n_correct_lr / n, 4),
            "accuracy_hr": round(self.n_correct_hr / n, 4),
            "ned": float(np.mean(self.ned_sr)) if self.ned_sr else 0.0,
            "images": self.n_images,
        }
        if self.psnr_lr:
            out["psnr_avg_lr"] = float(np.sum(self.psnr_lr)) / len(self.psnr_lr)
        if self.ssim_lr:
            out["ssim_avg_lr"] = float(np.sum(self.ssim_lr)) / len(self.ssim_lr)
        if self.infer_time > 0:
            out["fps"] = self.n_images / self.infer_time
        return out
