"""CTC pretraining of the CRNN recognizer (counterpart of
``tatt_tpu/train/pretrain.py``).

The reference never trains its recognizers: its CRNN arrives as a
pretrained ``crnn.pth`` download, which this repo does not ship.  This
trains one in place with CTC on the HR crops of any dataset with the
``(img_HR, img_lr, label)`` sample contract, so that the port has a
teacher that reads text and a judge for ``--go_test``.  The module's
``state_dict`` has the reference layout: ``torch.save`` it as a ``.pth``
and hand that to ``--crnn_pretrained`` (the JAX package's ``import_crnn``
reads the same file).

Each step: a batch of the uint8 HR crops (cached on the host and copied
to the card once, with their targets, so that no step waits for the
card), on the card the photometric
augmentation (a separable Gaussian blur with a per-sample sigma, noise,
brightness and contrast), the 32x100 luma, the CRNN forward in training
mode, :func:`~tatt_tpu_torch.kernels.ctc.ctc_loss` over its 26 frames,
and an Adam step (optax's defaults, betas 0.9 / 0.999) at the learning
rate of optax's ``warmup_cosine_decay_schedule`` (:func:`lr_at`).  Batch
indices come from ``np.random.default_rng(seed)`` as in the JAX function,
so both see the same batches; the augmentation's draws come from a
``torch.Generator`` seeded with ``seed`` (:func:`draw_augment`).

  python -m tatt_tpu_torch.train.pretrain --out crnn.pth
"""

from __future__ import annotations

import argparse
import math
import sys
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from tatt_tpu_torch.core.charset import CRNN_ALPHABET, ctc_greedy_decode, str_filt
from tatt_tpu_torch.core.device import resolve_device, set_cuda_flags
from tatt_tpu_torch.data.collate import batch_u8
from tatt_tpu_torch.kernels.ctc import ctc_loss
from tatt_tpu_torch.models.recognizers.crnn import parse_crnn_input

T_LOGIT = 26  # the CRNN emits [26, B, C] (model/crnn/crnn.py:76-92)
# the HR crops' size, whatever the YAML's TRAIN geometry: JAX's pretraining
# stacks the dataset's crops as they come (tatt_tpu/train/pretrain.py:115-128),
# which are 128x32; the CRNN reads a 32x100 resize of any size
HR_SIZE = (128, 32)


def encode_ctc_targets(labels, alphabet: str = CRNN_ALPHABET, max_len: int = 16):
    """Labels -> padded ids [B, max_len] int32 and lengths [B]: characters
    of ``alphabet`` lowercased, the blank (id 0) never a target
    (``pretrain.py:35-51``)."""
    a2d = {ch: i for i, ch in enumerate(alphabet)}
    out = np.zeros((len(labels), max_len), dtype=np.int32)
    lens = np.zeros((len(labels),), dtype=np.int32)
    for b, word in enumerate(labels):
        ids = [a2d[ch] for ch in word.lower() if ch in a2d and a2d[ch] != 0][:max_len]
        out[b, : len(ids)] = ids
        lens[b] = len(ids)
    return out, lens


def gaussian_taps(sigma: torch.Tensor, radius: int) -> torch.Tensor:
    """Per-sample 1-D Gaussian taps [B, 2r+1]; sigma ~0 -> the identity tap."""
    x = torch.arange(-radius, radius + 1, dtype=torch.float32, device=sigma.device)
    w = torch.exp(-0.5 * (x[None, :] / sigma[:, None].clamp(min=1e-3)) ** 2)
    return w / w.sum(dim=1, keepdim=True)


def draw_augment(gen: torch.Generator, shape, max_sigma: float = 1.0) -> dict:
    """The random draws of :func:`augment_images` for images of ``shape``
    [B, C, H, W], from ``gen`` (on the images' device), with the JAX
    function's ranges (``pretrain.py:70-88``)."""
    b, dev = shape[0], gen.device
    u = lambda *s: torch.rand(*s, generator=gen, device=dev)  # noqa: E731
    return {
        "sigma": u(b) * max_sigma,
        "noise_sigma": u(b, 1, 1, 1) * (8.0 / 255.0),
        "noise": torch.randn(*shape, generator=gen, device=dev),
        "bright": u(b, 1, 1, 1) * 0.3 - 0.15,
        "contrast": u(b, 1, 1, 1) * 0.3 + 0.85,
    }


def augment_images(images: torch.Tensor, draws: dict, max_sigma: float = 1.0) -> torch.Tensor:
    """[B, C, H, W] in [0, 1] -> blurred (separable Gaussian with edge
    padding, radius ``max(ceil(3 max_sigma), 1)``), noised, brightness and
    contrast jittered, clipped to [0, 1]; a pure function of ``draws``
    (``augment_images``, ``pretrain.py:62-89``)."""
    radius = max(int(math.ceil(3 * max_sigma)), 1)
    k = 2 * radius + 1
    taps = gaussian_taps(draws["sigma"], radius)
    x = F.pad(images, (radius, radius, 0, 0), mode="replicate")
    x = torch.einsum("bchwk,bk->bchw", x.unfold(3, k, 1), taps)
    x = F.pad(x, (0, 0, radius, radius), mode="replicate")
    x = torch.einsum("bchwk,bk->bchw", x.unfold(2, k, 1), taps)
    x = x + draws["noise_sigma"] * draws["noise"]
    return ((x - 0.5) * draws["contrast"] + 0.5 + draws["bright"]).clamp(0.0, 1.0)


def lr_at(count: int, lr: float, steps: int) -> float:
    """``optax.warmup_cosine_decay_schedule(init_value=0.1 lr,
    peak_value=lr, warmup_steps=min(200, steps // 10), decay_steps=steps,
    end_value=0.05 lr)`` at optax's update count (0 for the first update;
    ``pretrain.py:139-145``)."""
    warm = min(200, steps // 10)
    if count < warm:
        return (0.1 * lr - lr) * (1.0 - count / warm) + lr
    k = min(count - warm, steps - warm)
    cosine = 0.5 * (1.0 + math.cos(math.pi * k / (steps - warm)))
    return lr * (0.95 * cosine + 0.05)


def hr_crops(dataset, n: Optional[int] = None) -> np.ndarray:
    """The first ``n`` HR crops of a dataset as [N, 32, 128, 3] uint8 (a
    crop of another size resized with PIL bicubic, as the collate does)."""
    n = len(dataset) if n is None else n
    return batch_u8([dataset[i][0].convert("RGB") for i in range(n)], HR_SIZE)


@torch.no_grad()
def word_accuracy(crnn, images_u8: np.ndarray, labels, alphabet: str = CRNN_ALPHABET,
                  chunk: int = 256) -> float:
    """Share of ``labels`` that ``crnn`` (in eval mode) reads exactly from
    the [N, H, W, 3] uint8 crops, after the 'lower' vocabulary filter."""
    dev = next(crnn.parameters()).device
    hits = 0
    for lo in range(0, len(labels), chunk):
        imgs = torch.from_numpy(images_u8[lo : lo + chunk]).to(dev).float().div(255.0)
        logits = crnn(parse_crnn_input(imgs.permute(0, 3, 1, 2)))
        preds = ctc_greedy_decode(logits.cpu().numpy(), alphabet)
        hits += sum(str_filt(p, "lower") == str_filt(t, "lower")
                    for p, t in zip(preds, labels[lo : lo + chunk]))
    return hits / max(len(labels), 1)


@dataclass
class PretrainResult:
    history: list = field(default_factory=list)  # {"step", "loss", "acc"} per evaluation
    final_accuracy: float = 0.0


def pretrain_recognizer(
    crnn,
    dataset,
    *,
    steps: int = 3000,
    batch_size: int = 128,
    lr: float = 1e-3,
    seed: int = 0,
    alphabet: str = CRNN_ALPHABET,
    target_max_len: int = 16,
    augment: bool = True,
    max_sigma: float = 1.0,
    eval_dataset=None,
    eval_every: int = 500,
    log_fn: Optional[Callable[[str], None]] = print,
    device=None,
) -> PretrainResult:
    """Train ``crnn`` in place with CTC on the HR crops of ``dataset``
    (``dataset[i] -> (img_HR, img_lr, label)``; HR and label are read).

    Every ``eval_every`` steps and at the last, word accuracy on the first
    512 samples of ``eval_dataset`` (else ``dataset``) and the mean loss
    since the last evaluation go into ``history`` and the log line.  The
    module moves to ``device`` (the card unless ``"cpu"``)."""
    dev = resolve_device(device)
    crnn.to(dev).train()
    rng = np.random.default_rng(seed)
    n = len(dataset)
    hr_cache = torch.from_numpy(hr_crops(dataset)).to(dev)
    targets_all, lens_all = (torch.from_numpy(a).to(dev) for a in encode_ctc_targets(
        [dataset[i][2] for i in range(n)], alphabet, target_max_len))
    input_lengths = torch.full((batch_size,), T_LOGIT, device=dev)
    optimizer = torch.optim.Adam(crnn.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)
    gen = torch.Generator(device=dev).manual_seed(seed)
    ev = eval_dataset if eval_dataset is not None else dataset
    ev_n = min(len(ev), 512)
    history = []
    t0 = time.time()
    loss_sum, loss_n = torch.zeros((), device=dev), 0
    for step in range(1, steps + 1):
        idx = torch.from_numpy(rng.integers(0, n, size=batch_size)).to(dev, non_blocking=True)
        images = hr_cache[idx].float().div(255.0).permute(0, 3, 1, 2)
        if augment:
            images = augment_images(images, draw_augment(gen, images.shape, max_sigma), max_sigma)
        logp = torch.log_softmax(crnn(parse_crnn_input(images)).float(), dim=-1)
        loss = ctc_loss(logp, targets_all[idx], input_lengths, lens_all[idx]).mean()
        optimizer.zero_grad(set_to_none=False)
        loss.backward()
        for group in optimizer.param_groups:
            group["lr"] = lr_at(step - 1, lr, steps)
        optimizer.step()
        loss_sum += loss.detach()
        loss_n += 1
        if step % eval_every == 0 or step == steps:
            crnn.eval()
            acc = word_accuracy(crnn, hr_crops(ev, ev_n), [ev[i][2] for i in range(ev_n)], alphabet)
            crnn.train()
            mean = loss_sum.item() / loss_n
            history.append({"step": step, "loss": mean, "acc": acc})
            if log_fn:
                log_fn(f"[pretrain] step {step}/{steps} loss {mean:.4f} word-acc {acc:.4f} "
                       f"({time.time() - t0:.0f}s)")
            loss_sum, loss_n = torch.zeros((), device=dev), 0
    return PretrainResult(history=history, final_accuracy=history[-1]["acc"] if history else 0.0)


def main(argv=None) -> int:
    """Pretrain a CRNN on synthetic crops (seed 7; word accuracy on 256
    held-out crops of seed 991) with the recipe of
    ``experiments/train_fixture_judge.py`` (batch 128, lr 1e-3, seed 0)
    and write its ``state_dict`` as a ``.pth`` for ``--crnn_pretrained``."""
    from tatt_tpu_torch.data.synthetic import SyntheticTextDataset
    from tatt_tpu_torch.models.common import init_parameters
    from tatt_tpu_torch.models.recognizers.crnn import CRNN

    ap = argparse.ArgumentParser(description="CTC pretraining of the CRNN (tatt_tpu_torch)")
    ap.add_argument("--out", required=True, help="the .pth to write")
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--nh", type=int, default=256)
    ap.add_argument("--nm", type=int, nargs=7, default=(64, 128, 256, 256, 512, 512, 512))
    ap.add_argument("--synthetic", type=int, default=16384, metavar="N", help="training crops")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    set_cuda_flags()
    crnn = init_parameters(CRNN(nh=args.nh, nm=tuple(args.nm)), 0)
    result = pretrain_recognizer(
        crnn, SyntheticTextDataset(n=args.synthetic, seed=7), steps=args.steps,
        eval_dataset=SyntheticTextDataset(n=256, seed=991), device=args.device,
    )
    torch.save({k: v.cpu() for k, v in crnn.state_dict().items()}, args.out)
    print(f"wrote {args.out}; held-out word accuracy {result.final_accuracy:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
