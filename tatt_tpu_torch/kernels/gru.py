"""Fused bidirectional-GRU forward recurrence: CUDA kernel and plain twin.

Counterpart of ``tatt_tpu/kernels/pallas_gru.py:_gru_fwd_kernel``.  The
kernel (``csrc/bigru_fwd.cu``) runs both directions of the recurrence in
one launch; its source says what bounds it on the card and how the design
answers that.  The input projection stays a matmul outside, as in JAX.

:func:`bigru_recurrence` launches the kernel for a CUDA tensor and uses
the plain :func:`bigru_recurrence_ref` only for a CPU tensor.  Forward
only: the backward kernel and ``autograd.Function`` come with training.
"""

from __future__ import annotations

import ctypes

import torch

from tatt_tpu_torch.kernels import _build

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
MAX_HIDDEN = 128


def bigru_recurrence_ref(
    gates: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor
) -> torch.Tensor:
    """Plain PyTorch version of the kernel, a Python loop over time.

    ``gates`` [2, L, 3H, R] (input projections in forward time for both
    directions, gate order r, z, n), ``w_hh`` [2, 3H, H], ``b_hh`` [2, 3H].
    Returns [L, 2H, R]: direction 1 scans t = L-1 .. 0 and each output sits
    at its forward-time slot."""
    _, length, g3, rows = gates.shape
    hid = g3 // 3
    out = gates.new_empty(length, 2 * hid, rows)
    for d in range(2):
        h = gates.new_zeros(hid, rows)
        steps = range(length) if d == 0 else range(length - 1, -1, -1)
        for t in steps:
            gh = w_hh[d] @ h + b_hh[d][:, None]
            gx = gates[d, t]
            r = torch.sigmoid(gx[:hid] + gh[:hid])
            z = torch.sigmoid(gx[hid : 2 * hid] + gh[hid : 2 * hid])
            n = torch.tanh(gx[2 * hid :] + r * gh[2 * hid :])
            h = (1.0 - z) * n + z * h
            out[t, d * hid : (d + 1) * hid] = h
    return out


def bigru_recurrence(
    gates: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor
) -> torch.Tensor:
    """The BiGRU forward recurrence: the CUDA kernel for a CUDA tensor, the
    plain version for a CPU tensor.  Shapes as :func:`bigru_recurrence_ref`.
    ``bigru_recurrence.launches`` counts kernel launches."""
    if torch.is_grad_enabled() and any(
        t.requires_grad for t in (gates, w_hh, b_hh)
    ):
        raise RuntimeError(
            "bigru_recurrence is forward-only; run it under torch.no_grad()"
        )
    if gates.device.type == "cpu":
        return bigru_recurrence_ref(gates, w_hh, b_hh)
    two, length, g3, rows = gates.shape
    hid = g3 // 3
    if gates.device.type != "cuda":
        raise ValueError(f"bigru_recurrence: unsupported device {gates.device}")
    if two != 2 or g3 != 3 * hid or not 0 < hid <= MAX_HIDDEN:
        raise ValueError(
            f"bigru_recurrence: gates {tuple(gates.shape)} must be "
            f"[2, L, 3H, R] with H <= {MAX_HIDDEN}"
        )
    if tuple(w_hh.shape) != (2, g3, hid) or tuple(b_hh.shape) != (2, g3):
        raise ValueError(
            f"bigru_recurrence: w_hh {tuple(w_hh.shape)} / b_hh "
            f"{tuple(b_hh.shape)} do not match H={hid}"
        )
    for name, t in (("gates", gates), ("w_hh", w_hh), ("b_hh", b_hh)):
        if t.device != gates.device or t.dtype != torch.float32:
            raise ValueError(f"bigru_recurrence: {name} must be float32 on {gates.device}")
    gates, w_hh, b_hh = gates.contiguous(), w_hh.contiguous(), b_hh.contiguous()
    out = torch.empty(length, 2 * hid, rows, device=gates.device, dtype=torch.float32)
    if length == 0 or rows == 0:
        return out
    lib = _build.load("bigru_fwd", _ARGTYPES)
    with torch.cuda.device(gates.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.bigru_fwd(
            gates.data_ptr(), w_hh.data_ptr(), b_hh.data_ptr(), out.data_ptr(),
            length, hid, rows, stream,
        )
    _build.check(err, "bigru_fwd")
    bigru_recurrence.launches += 1
    return out


bigru_recurrence.launches = 0
