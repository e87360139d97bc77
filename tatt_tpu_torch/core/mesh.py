"""The data-parallel layout (counterpart of ``tatt_tpu/core/mesh.py``).

The JAX package shards the batch over a 1-D mesh of ``--dp_devices``
devices (0: all visible; a larger count takes them all, as
``devices[:n]`` does).  The port runs one process a rank
(``core/distributed.py``), and each holds the contiguous rows of the
global batch that JAX's ``shard_batch`` gives its device.
"""

from __future__ import annotations

import numpy as np
import torch


def resolve_dp(dp_devices: int, device: torch.device | str) -> int:
    """The number of data-parallel ranks for ``--dp_devices`` on
    ``device``'s type, printed: on CUDA the visible cards, all of them for
    0 (or a negative count) and at most as many as are visible
    (``make_mesh``'s ``devices[:n]``); on the CPU ``dp_devices`` processes
    as asked, 1 for 0 (the port's counterpart of the tests' virtual CPU
    mesh)."""
    device = torch.device(device)
    if device.type == "cuda":
        visible = torch.cuda.device_count()
        n = visible if dp_devices <= 0 else min(dp_devices, visible)
    else:
        n = max(dp_devices, 1)
    print(f"[dp] {n} data-parallel rank{'s' if n > 1 else ''} on {device.type}")
    return n


def shard_batch(batch, rank: int, world: int, copies: int = 1):
    """Rank ``rank``'s rows of every leaf of ``batch`` (a dict, or one array
    or tensor): the contiguous slice ``[rank * B / world, (rank + 1) * B /
    world)`` of JAX's row split, taken in each of ``copies`` equal blocks
    of the batch axis (a fused 2B batch keeps its main and its
    counter-rotated rows of this rank).  Raises, as JAX's ``device_put``
    does, for a batch that ``world * copies`` does not divide."""
    if isinstance(batch, dict):
        return {k: shard_batch(v, rank, world, copies) for k, v in batch.items()}
    total = batch.shape[0]
    if total % (world * copies):
        raise ValueError(f"batch {total} is not divisible by {world} ranks x {copies} copies")
    n, block = total // (world * copies), total // copies
    parts = [batch[c * block + rank * n:c * block + (rank + 1) * n] for c in range(copies)]
    if len(parts) == 1:
        return parts[0]
    return torch.cat(parts) if torch.is_tensor(batch) else np.concatenate(parts)


def pad_to_multiple(batch, multiple: int):
    """(every leaf padded with zero rows to a multiple of ``multiple``, the
    real count), as ``mesh.pad_to_multiple`` (``mesh.py:62-81``)."""
    if isinstance(batch, dict):
        leaves = list(batch.values())
        if not leaves:
            return batch, 0
        n = leaves[0].shape[0]
        return {k: pad_to_multiple(v, multiple)[0] for k, v in batch.items()}, n
    n = batch.shape[0]
    pad = (-n) % multiple
    if pad == 0:
        return batch, n
    if torch.is_tensor(batch):
        return torch.cat([batch, batch.new_zeros((pad, *batch.shape[1:]))]), n
    x = np.asarray(batch)
    return np.pad(x, [(0, pad)] + [(0, 0)] * (x.ndim - 1)), n
