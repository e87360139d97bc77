"""Fused bidirectional-LSTM forward recurrence: CUDA kernel and plain twin.

Counterpart of ``tatt_tpu/kernels/pallas_lstm.py:_lstm_fwd_kernel``.  The
kernel (``csrc/bilstm_fwd.cu``) runs both directions in one launch and
walks direction 1 backwards in time through mirrored indices; its source
says what bounds it on the card and how the design answers that.

:func:`bilstm_recurrence` launches the kernel for a CUDA tensor and uses
the plain :func:`bilstm_recurrence_ref` only for a CPU tensor.  Forward
only: the backward kernel and ``autograd.Function`` come with training.
"""

from __future__ import annotations

import ctypes

import torch

from tatt_tpu_torch.kernels import _build

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
MAX_HIDDEN = 256


def bilstm_recurrence_ref(
    gates: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor
) -> torch.Tensor:
    """Plain PyTorch version of the kernel, a Python loop over time.

    ``gates`` [2, R, L, 4H] (input projections in forward time for both
    directions, torch gate order i, f, g, o), ``w_hh`` [2, 4H, H],
    ``b_hh`` [2, 4H].  Returns [R, L, 2H] with direction 1 scanned
    t = L-1 .. 0 and stored at its forward-time slots."""
    _, rows, length, g4 = gates.shape
    hid = g4 // 4
    out = gates.new_empty(rows, length, 2 * hid)
    for d in range(2):
        h = gates.new_zeros(rows, hid)
        c = gates.new_zeros(rows, hid)
        steps = range(length) if d == 0 else range(length - 1, -1, -1)
        for t in steps:
            a = gates[d, :, t] + h @ w_hh[d].T + b_hh[d]
            i = torch.sigmoid(a[:, :hid])
            f = torch.sigmoid(a[:, hid : 2 * hid])
            g = torch.tanh(a[:, 2 * hid : 3 * hid])
            o = torch.sigmoid(a[:, 3 * hid :])
            c = f * c + i * g
            h = o * torch.tanh(c)
            out[:, t, d * hid : (d + 1) * hid] = h
    return out


def bilstm_recurrence(
    gates: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor
) -> torch.Tensor:
    """The BiLSTM forward recurrence: the CUDA kernel for a CUDA tensor,
    the plain version for a CPU tensor.  Shapes as
    :func:`bilstm_recurrence_ref`.  ``bilstm_recurrence.launches`` counts
    kernel launches."""
    if torch.is_grad_enabled() and any(
        t.requires_grad for t in (gates, w_hh, b_hh)
    ):
        raise RuntimeError(
            "bilstm_recurrence is forward-only; run it under torch.no_grad()"
        )
    if gates.device.type == "cpu":
        return bilstm_recurrence_ref(gates, w_hh, b_hh)
    two, rows, length, g4 = gates.shape
    hid = g4 // 4
    if gates.device.type != "cuda":
        raise ValueError(f"bilstm_recurrence: unsupported device {gates.device}")
    if two != 2 or g4 != 4 * hid or not 0 < hid <= MAX_HIDDEN:
        raise ValueError(
            f"bilstm_recurrence: gates {tuple(gates.shape)} must be "
            f"[2, R, L, 4H] with H <= {MAX_HIDDEN}"
        )
    if tuple(w_hh.shape) != (2, g4, hid) or tuple(b_hh.shape) != (2, g4):
        raise ValueError(
            f"bilstm_recurrence: w_hh {tuple(w_hh.shape)} / b_hh "
            f"{tuple(b_hh.shape)} do not match H={hid}"
        )
    for name, t in (("gates", gates), ("w_hh", w_hh), ("b_hh", b_hh)):
        if t.device != gates.device or t.dtype != torch.float32:
            raise ValueError(f"bilstm_recurrence: {name} must be float32 on {gates.device}")
    gates, w_hh, b_hh = gates.contiguous(), w_hh.contiguous(), b_hh.contiguous()
    out = torch.empty(rows, length, 2 * hid, device=gates.device, dtype=torch.float32)
    if length == 0 or rows == 0:
        return out
    lib = _build.load("bilstm_fwd", _ARGTYPES)
    with torch.cuda.device(gates.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.bilstm_fwd(
            gates.data_ptr(), w_hh.data_ptr(), b_hh.data_ptr(), out.data_ptr(),
            length, hid, rows, stream,
        )
    _build.check(err, "bilstm_fwd")
    bilstm_recurrence.launches += 1
    return out


bilstm_recurrence.launches = 0
