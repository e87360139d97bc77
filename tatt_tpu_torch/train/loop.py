"""Evaluation loop (counterpart of ``tatt_tpu/train/loop.py:Trainer.evaluate``).

For each batch: the eval step (student prior -> TATT), PSNR/SSIM of SR
and of the bicubic-upscaled LR against HR, and the judge CRNN's greedy
CTC decode of SR, LR and HR, accumulated by :class:`EvalAccumulator`.
Visualisation and LPIPS are not ported yet.
"""

from __future__ import annotations

import time
from typing import Sequence

import torch
from torch import nn

from tatt_tpu_torch.core.charset import CRNN_ALPHABET, ctc_greedy_decode
from tatt_tpu_torch.data.collate import collate
from tatt_tpu_torch.data.device_pipeline import device_normalize
from tatt_tpu_torch.kernels.resize import resize_bicubic
from tatt_tpu_torch.losses.ssim import psnr, ssim
from tatt_tpu_torch.models.recognizers.crnn import parse_crnn_input
from tatt_tpu_torch.train.metrics import EvalAccumulator
from tatt_tpu_torch.train.steps import eval_step


class Evaluator:
    """The ``--go_test`` protocol over a dataset of (HR, LR, label)
    samples at the default geometry (HR 128x32, LR 64x16), one
    ``stu_iter``.  Models must already sit on ``device`` in eval mode."""

    def __init__(
        self,
        generators: Sequence[nn.Module],
        students: Sequence[nn.Module],
        judge: nn.Module,
        device: torch.device,
        batch_size: int = 64,
        mask: bool = True,
    ):
        self.generators = list(generators)
        self.students = list(students)
        self.judge = judge
        self.device = torch.device(device)
        self.batch_size = batch_size
        self.mask = mask

    @torch.no_grad()
    def decode(self, images: torch.Tensor) -> list[str]:
        """Judge CRNN reading of NCHW images in [0, 1]."""
        logits = self.judge(parse_crnn_input(images[:, :3]))
        return ctc_greedy_decode(logits.cpu().numpy(), CRNN_ALPHABET)

    def batches(self, dataset):
        """(HR, LR, labels) per batch, images normalized on the device."""
        for start in range(0, len(dataset), self.batch_size):
            samples = [dataset[i] for i in range(start, min(start + self.batch_size, len(dataset)))]
            b = collate(samples)
            hr = device_normalize(torch.from_numpy(b.images_hr).to(self.device), self.mask)
            lr = device_normalize(torch.from_numpy(b.images_lr).to(self.device), self.mask)
            yield hr, lr, b.label_strs

    @torch.no_grad()
    def evaluate(self, dataset) -> dict:
        acc = EvalAccumulator()
        t0 = time.perf_counter()
        for hr, lr, labels in self.batches(dataset):
            sr, _ = eval_step(self.generators, self.students, lr)
            lr_up = resize_bicubic(lr, hr.shape[-2], hr.shape[-1])
            acc.add_batch(
                psnr(sr, hr).item(),
                ssim(sr, hr).item(),
                self.decode(sr),
                self.decode(lr),
                self.decode(hr),
                labels,
                psnr_lr=psnr(lr_up, hr).item(),
                ssim_lr=ssim(lr_up, hr).item(),
                n_real=len(labels),
            )
        acc.infer_time = time.perf_counter() - t0
        return acc.summary()
