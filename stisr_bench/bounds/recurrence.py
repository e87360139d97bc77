"""The least time a recurrence launch can take, from its shapes.

``bound`` counts each input read once and each output written once at
the card's memory rate, and the float32 operations (a multiply-add as 2,
each gate nonlinearity and elementwise op as 1) at its float32 peak, and
returns the larger with what sets it.  A forward launch reads the gate
projections and the weights and writes h; a backward launch reads the
gates, h and dy (and the LSTM's c) and the weights, writes d(gates) and
the weight gradients, and per row-step does three matvec-sized products
(the gate recompute, W^T d(gates), d(gates) h_prev^T).  Every element
is a float32 of 4 bytes.  The bound files of the recurrent kernels
(``bigru.py``, ``bilstm.py``) choose their calls and use it.
"""

from __future__ import annotations

ELSIZE = 4


def launches(module, args) -> list[tuple[int, int, int]]:
    """(length, rows, hidden) of each layer's launch of a call of a
    bidirectional recurrent layer on [rows, length, features]."""
    x = args[0]
    return [(int(x.shape[1]), int(x.shape[0]), int(module.hidden))] * getattr(module, "num_layers", 1)


def bound(kind: str, length: int, rows: int, hid: int, backward: bool,
          peak: dict) -> tuple[float, str]:
    """(least seconds of one launch, "bytes" or "operations")."""
    g = (3 if kind == "gru" else 4) * hid
    seq = length * rows * 2 * hid
    weights = 2 * g * hid + 2 * g
    if backward:
        n_seq = 2 if kind == "gru" else 3
        nbytes = (ELSIZE * (2 * 2 * length * rows * g + n_seq * seq + weights)
                  + ELSIZE * (weights + (2 * g if kind == "gru" else 0)))
        per_row_step = 3 * 2 * g * hid + (30 if kind == "gru" else 24) * hid
    else:
        nbytes = ELSIZE * (2 * length * rows * g + seq + weights)
        per_row_step = 2 * g * hid + (14 if kind == "gru" else 12) * hid
    flops = 2 * length * rows * per_row_step
    t_bytes, t_ops = nbytes / peak["hbm_bytes_per_s"], flops / peak["flops_per_s"]["float32"]
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
