"""CTC loss: the log-semiring forward algorithm as a plain PyTorch loop over
time (counterpart of ``tatt_tpu/kernels/ctc.py``, a ``lax.scan`` in plain
XLA there, so no hand-written kernel).

It keeps the JAX function's conventions, which are not
``F.ctc_loss``'s: float32 throughout; ``NEG_INF = -1e30`` instead of
``-inf``, so a target with no feasible alignment in the frames gives a
loss of 1e30 (not ``inf``); alpha frozen once ``t`` reaches
``input_lengths``; and blanks allowed inside the targets, as the
``--use_label`` path's spread labels carry them.

The forward runs the loop without a graph (``torch.logaddexp`` computes
JAX's ``max + log1p(exp(-|x1 - x2|))``), and the gradient is the reverse
of the loop written out by hand in one ``autograd.Function``: one
autograd node where the loop would make ~20 a step, on a loss whose time
on the card is the host's time to launch its small ops.  It is the
derivative ``jax.grad`` takes of the JAX function, term by term:
``logaddexp`` with JAX's derivative
(``exp(x - out)`` for each input; on an unreachable node, where ``-1e30 +
log 2`` rounds back to ``-1e30``, each input gets a weight of 1 where
torch's ``logaddexp`` gives 0.5, and the gradient of a 1e30 loss carries
that), ``where`` passing the gradient to the branch it took, and the
gathers of the emissions and of the final alpha as scatter-adds.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

NEG_INF = -1e30


class _CTC(torch.autograd.Function):
    """The loss of :func:`ctc_loss` with JAX's derivative.  Alpha is kept
    with two ``NEG_INF`` columns in front ([.., L + 2]), so that its shifts
    by one and two symbols are views; the backward's weights come from the
    saved forward values for every step at once, and the reverse walk is
    then six ops a step."""

    @staticmethod
    def forward(ctx, log_probs, ext, allow_skip, ext_valid, active, target_lengths):
        """``log_probs`` [T, B, C]; ``ext`` [B, L] the blank-interleaved
        targets; ``allow_skip`` / ``ext_valid`` [B, L]; ``active`` [T, B];
        returns the per-sample loss [B]."""
        t_max = log_probs.shape[0]
        emit = log_probs.gather(2, ext.expand(t_max, -1, -1))  # [T, B, L]
        neg = torch.full_like(emit[0], NEG_INF)
        has_label = target_lengths > 0
        alphas = torch.full_like(F.pad(emit, (2, 0)), NEG_INF)  # [T, B, 2 + L]
        alphas[0, :, 2] = emit[0, :, 0]
        alphas[0, :, 3] = torch.where(has_label, emit[0, :, 1], NEG_INF)
        o1s, o2s, s2s = (torch.empty_like(emit[1:]) for _ in range(3))
        for t in range(1, t_max):
            prev = alphas[t - 1]
            torch.where(allow_skip, prev[:, :-2], neg, out=s2s[t - 1])
            torch.logaddexp(prev[:, 2:], prev[:, 1:-1], out=o1s[t - 1])
            torch.logaddexp(o1s[t - 1], s2s[t - 1], out=o2s[t - 1])
            new = torch.where(ext_valid, o2s[t - 1] + emit[t], neg)
            torch.where(active[t][:, None], new, prev[:, 2:], out=alphas[t, :, 2:])
        alpha = alphas[-1, :, 2:]
        end_blank = (2 * target_lengths)[:, None]
        end_label = (2 * target_lengths - 1).clamp(min=0)[:, None]
        a_blank = alpha.gather(1, end_blank)[:, 0]
        a_label = torch.where(has_label, alpha.gather(1, end_label)[:, 0], NEG_INF)
        out = torch.logaddexp(a_blank, a_label)
        ctx.save_for_backward(log_probs, ext, allow_skip, ext_valid, active, has_label, end_blank,
                              end_label, a_blank, a_label, out, alphas, o1s, o2s, s2s)
        return -out

    @staticmethod
    def backward(ctx, grad):
        (log_probs, ext, allow_skip, ext_valid, active, has_label, end_blank, end_label,
         a_blank, a_label, out, alphas, o1s, o2s, s2s) = ctx.saved_tensors
        t_max = log_probs.shape[0]
        g = -grad
        # each input x of a logaddexp with output o gets exp(x - o), through
        # o1 = lae(alpha, shift1) and o2 = lae(o1, shift2)
        w_o1 = torch.exp(o1s - o2s)
        w_a = w_o1 * torch.exp(alphas[:-1, :, 2:] - o1s)
        w_s1 = w_o1 * torch.exp(alphas[:-1, :, 1:-1] - o1s)
        w_s2 = torch.where(allow_skip, torch.exp(s2s - o2s), 0.0)
        into_new = active[1:, :, None] & ext_valid  # where alpha_t took o2 + emit
        hold = ~active[1:, :, None]  # where alpha_t kept alpha_{t-1}
        zero = torch.zeros_like(alphas[0, :, 2:])
        galpha = zero.scatter_add(1, end_blank, (g * torch.exp(a_blank - out))[:, None])
        galpha = galpha.scatter_add(
            1, end_label, torch.where(has_label, g * torch.exp(a_label - out), 0.0)[:, None])
        g_emit = torch.empty_like(alphas[:, :, 2:])
        bufs = [torch.zeros_like(alphas[0]) for _ in range(2)]  # [B, 2 + L], columns as alphas
        for t in range(t_max - 1, 0, -1):
            g_o2 = torch.where(into_new[t - 1], galpha, zero, out=g_emit[t])
            nxt = bufs[t % 2]
            torch.where(hold[t - 1], galpha, zero, out=nxt[:, 2:])
            nxt[:, 2:].addcmul_(g_o2, w_a[t - 1])
            nxt[:, 1:-1].addcmul_(g_o2, w_s1[t - 1])
            nxt[:, :-2].addcmul_(g_o2, w_s2[t - 1])
            galpha = nxt[:, 2:]
            nxt[:, :2].zero_()
        g_emit[0] = zero
        g_emit[0, :, 0] = galpha[:, 0]
        g_emit[0, :, 1] = torch.where(has_label, galpha[:, 1], 0.0)
        g_lp = torch.zeros_like(log_probs).scatter_add(2, ext.expand(t_max, -1, -1), g_emit)
        return g_lp, None, None, None, None, None


def ctc_loss(
    log_probs: torch.Tensor,
    targets: torch.Tensor,
    input_lengths: torch.Tensor,
    target_lengths: torch.Tensor,
    blank: int = 0,
) -> torch.Tensor:
    """Per-sample negative log likelihood [B] (reduction 'none').

    ``log_probs`` [T, B, C] log-softmax outputs, ``targets`` [B, S] class
    ids padded past ``target_lengths`` [B], ``input_lengths`` [B]."""
    log_probs = log_probs.float()
    t_max, b, _ = log_probs.shape
    dev = log_probs.device
    targets = targets.to(dev, torch.long)
    target_lengths = target_lengths.to(dev, torch.long)
    length = 2 * targets.shape[1] + 1  # blank, t1, blank, t2, ..., blank
    ext = torch.full((b, length), blank, dtype=torch.long, device=dev)
    ext[:, 1::2] = targets
    ids = torch.arange(length, device=dev)
    # alpha[s] <- alpha[s] + alpha[s-1] (+ alpha[s-2] for a label unlike
    # the one two back)
    allow_skip = (ids % 2 == 1)[None, :] & (ext != F.pad(ext[:, :-2], (2, 0), value=-1))
    ext_valid = ids[None, :] < (2 * target_lengths[:, None] + 1)
    active = torch.arange(t_max, device=dev)[:, None] < input_lengths.to(dev)[None, :]
    return _CTC.apply(log_probs, ext, allow_skip, ext_valid, active, target_lengths)
