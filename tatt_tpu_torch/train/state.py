"""Optimizer and gradient clipping (counterpart of ``tatt_tpu/train/state.py``).

One Adam over every copy of the SR model and of the student (``stu_iter``
copies of each where ``--sr_share`` / ``--tpg_share`` is off,
``state.py:23-49``), betas (beta1, 0.999) as the reference configures it
(``base.py:527-528``; beta1 0.5), the same update as ``optax.adam`` there;
each SR copy's gradients are clipped at 0.25 on their own and the
students' are not (``super_resolution.py:1083-1084``, ``state.py:58-69``).
"""

from __future__ import annotations

from typing import Iterable

import torch


BETA1 = 0.5  # TRAIN.beta1 (tatt_tpu/core/config.py:50)


def make_optimizer(params: Iterable[torch.nn.Parameter], lr: float, beta1: float = BETA1):
    """``torch.optim.Adam(params, lr, betas=(beta1, 0.999), eps=1e-8)``."""
    return torch.optim.Adam(list(params), lr=lr, betas=(beta1, 0.999), eps=1e-8)


@torch.no_grad()
def grad_norm(params: Iterable[torch.nn.Parameter]) -> torch.Tensor:
    """Global L2 norm of the gradients of ``params`` (a device scalar)."""
    return torch.sqrt(sum((p.grad.float() ** 2).sum() for p in params if p.grad is not None))


@torch.no_grad()
def clip_grads_per_model(models: Iterable[torch.nn.Module], max_norm: float = 0.25) -> None:
    """torch ``clip_grad_norm_(model.parameters(), max_norm)`` for each
    model separately: gradients scaled by min(1, max_norm / (norm + 1e-6)),
    as ``clip_grads_per_model`` (``state.py:58-69``)."""
    for model in models:
        params = [p for p in model.parameters() if p.grad is not None]
        scale = torch.clamp(max_norm / (grad_norm(params) + 1e-6), max=1.0)
        for p in params:
            p.grad.mul_(scale)
