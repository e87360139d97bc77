"""Evaluation and training loops (counterpart of ``tatt_tpu/train/loop.py``).

:class:`Evaluator` is ``Trainer.evaluate``: for each batch the eval step
(student prior -> TATT), PSNR/SSIM of SR and of the bicubic-upscaled LR
against HR, and the judge CRNN's greedy CTC decode of SR, LR and HR.
Visualisation and LPIPS are not ported yet.

:class:`Trainer` is ``Trainer.train`` (``loop.py:546-673``) for the
canonical recipe: seeded shuffled batches, one :func:`train_step` each with
a generator seeded from the run's seed and the step number, a log line
every ``display_interval`` steps and validation every ``val_interval``.
Checkpoints (``saveInterval``, the best model) are not ported yet.
"""

from __future__ import annotations

import itertools
import time
from typing import Optional, Sequence

import torch
from torch import nn

from tatt_tpu_torch.core.charset import CRNN_ALPHABET, ctc_greedy_decode
from tatt_tpu_torch.data.device_pipeline import device_normalize
from tatt_tpu_torch.data.loader import DataLoader
from tatt_tpu_torch.kernels.resize import resize_bicubic
from tatt_tpu_torch.losses.ssim import psnr, ssim
from tatt_tpu_torch.models.recognizers.crnn import parse_crnn_input
from tatt_tpu_torch.train.metrics import EvalAccumulator
from tatt_tpu_torch.train.state import make_optimizer
from tatt_tpu_torch.train.steps import StepConfig, eval_step, train_step


def to_device(batch, device: torch.device, mask: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """(HR, LR) of a uint8 batch, normalized on the device."""
    return tuple(
        device_normalize(torch.from_numpy(a).to(device), mask) for a in (batch.images_hr, batch.images_lr)
    )


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
        for b in DataLoader(dataset, self.batch_size, shuffle=False, drop_last=False):
            yield (*to_device(b, self.device, self.mask), b.label_strs)

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


class Trainer:
    """Trains ``generator`` and ``student`` (one Adam over both) against the
    frozen ``teacher``, which is also the validation judge (the JAX
    package's CRNN judge without dedicated weights, ``loop.py:353-355``).
    The models must already sit on ``device``."""

    def __init__(
        self,
        generator: nn.Module,
        student: nn.Module,
        teacher: nn.Module,
        train_dataset,
        device: torch.device,
        cfg: StepConfig = StepConfig(),
        *,
        batch_size: int = 64,
        lr: float = 1e-3,
        epochs: int = 500,
        seed: int = 1234,
        display_interval: int = 50,
        val_interval: int = 400,
        val_datasets: Optional[dict] = None,
        mask: bool = True,
    ):
        self.generator, self.student, self.teacher = generator, student, teacher
        self.device = torch.device(device)
        self.cfg = cfg
        self.optimizer = make_optimizer(itertools.chain(generator.parameters(), student.parameters()), lr)
        self.loader = DataLoader(train_dataset, batch_size, shuffle=True, drop_last=True, seed=seed)
        self.evaluator = Evaluator([generator], [student], teacher, device, batch_size, mask)
        self.epochs, self.seed, self.mask = epochs, seed, mask
        self.display_interval, self.val_interval = display_interval, val_interval
        self.val_datasets = val_datasets or {}
        self.iters = 0

    def validate(self) -> dict:
        self.generator.eval()
        self.student.eval()
        results = {name: self.evaluator.evaluate(ds) for name, ds in self.val_datasets.items()}
        for name, s in results.items():
            print(
                f"eval[{name}] psnr {s['psnr_avg']:.3f} ssim {s['ssim_avg']:.4f} "
                f"acc {s['accuracy']:.4f}"
            )
        return results

    def train(self, max_iters: Optional[int] = None) -> dict:
        """Steps until ``max_iters`` (counted over every call) or the last
        epoch.  Returns ``iters`` and the per-step metrics of this call,
        as lists of floats (read from the device once, at the end)."""
        history = []
        self.teacher.eval()
        t0 = time.perf_counter()
        done = max_iters is not None and self.iters >= max_iters
        for epoch in range(self.epochs):
            if done:
                break
            for batch in self.loader:
                self.generator.train()
                self.student.train()
                hr, lr = to_device(batch, self.device, self.mask)
                # seeded from the run's seed and the step number, as the JAX
                # loop keys each step with PRNGKey(iters) (loop.py:599)
                gen = torch.Generator(device=self.device).manual_seed(self.seed * 1_000_003 + self.iters)
                metrics = train_step(
                    self.generator, self.student, self.teacher, self.optimizer,
                    {"images_hr": hr, "images_lr": lr}, self.cfg, gen,
                )
                history.append(metrics)
                self.iters += 1
                if self.iters % self.display_interval == 0:
                    ips = len(history) * lr.shape[0] / (time.perf_counter() - t0)
                    print(
                        f"[epoch {epoch}] iter {self.iters} "
                        + " ".join(f"{k} {v.item():.3f}" for k, v in metrics.items())
                        + f" ({ips:.1f} img/s)"
                    )
                if self.val_interval > 0 and self.iters % self.val_interval == 0:
                    self.validate()
                if max_iters is not None and self.iters >= max_iters:
                    done = True
                    break
        keys = history[0].keys() if history else ()
        return {
            "iters": self.iters,
            "metrics": {k: torch.stack([m[k] for m in history]).tolist() for k in keys},
        }
