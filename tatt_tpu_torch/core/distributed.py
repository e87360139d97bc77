"""Data parallelism across processes (counterpart of
``tatt_tpu/core/distributed.py`` and of the collectives that XLA inserts
from the mesh's shardings).

The JAX package runs one program over a 1-D device mesh: the batch is
sharded, the state replicated, and jit inserts the all-reduces of the
gradients and of the sync-BN moments.  The port runs one process a rank
in a ``torch.distributed`` process group (``nccl`` on CUDA devices,
``gloo`` on the CPU, chosen by the device's type), and makes those
reductions here by hand:

- :func:`mean_over_ranks`, differentiable: its backward is the all-reduce
  of the gradient, so that a gradient flows through a global mean as jit
  differentiates through it (the BatchNorm moments of
  ``models/common.py``);
- :func:`average_grads`: one flat all-reduce of every gradient over D;
- :func:`gather_rows`: a rank's rows placed in the global batch (an
  all-reduce into zeros, which ``gloo`` serves on CUDA tensors where its
  ``all_gather`` does not);
- :func:`reduce_metrics`: a step's metrics of the global batch;
- :func:`broadcast_tensors` / :func:`broadcast_state`: rank 0's values
  to every rank;
- :func:`rand_rows`: a random draw made at the global batch's shape, of
  which a rank keeps its rows, so that D ranks draw what one process draws
  at the global batch.

Every reduction across ranks is a mean of per-rank means over shards of
one size (``mesh.shard_batch``), which equals the mean over the global
batch; at one rank it is the local value bit for bit.  Without a process
group every function here is the single-process identity.
"""

from __future__ import annotations

import contextlib
import datetime
import os
from typing import Iterable, Optional, Sequence

import torch
import torch.distributed as dist

# the process group's timeout: a rank that waits longer on a collective
# (another rank died, or validates for longer) raises instead of hanging
GROUP_TIMEOUT_S = 1800.0

_COPIES = 1  # the logical batches packed in a forward's batch axis (packed_copies)


def backend_for(device: torch.device | str) -> str:
    """``nccl`` for a CUDA device, ``gloo`` for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def init_process(init_method: str, world_size: int, rank_id: int, device: torch.device | str,
                 backend: Optional[str] = None, timeout_s: float = GROUP_TIMEOUT_S) -> None:
    """Join the process group at ``init_method`` (``tcp://host:port`` or
    ``file://path``) as ``rank_id`` of ``world_size``, on ``backend`` (by
    default the device's, :func:`backend_for`)."""
    dist.init_process_group(
        backend or backend_for(device), init_method=init_method, world_size=world_size,
        rank=rank_id, timeout=datetime.timedelta(seconds=timeout_s),
    )


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device: torch.device | str = "cuda",
    timeout_s: float = GROUP_TIMEOUT_S,
    backend: Optional[str] = None,
) -> None:
    """The JAX package's ``initialize`` (``core/distributed.py:19-40``):
    join the process group of ``num_processes`` at ``coordinator_address``
    (``host:port``) as ``process_id``, with the environment's
    ``COORDINATOR_ADDRESS`` / ``NUM_PROCESSES`` / ``PROCESS_ID`` for what is
    not given; no coordinator means a single process, and nothing is
    done.  The backend follows ``device``'s type unless ``backend`` is
    given."""
    coordinator_address = coordinator_address or os.environ.get("COORDINATOR_ADDRESS")
    if coordinator_address is None:
        return
    if num_processes is None:
        num_processes = int(os.environ.get("NUM_PROCESSES", "1"))
    if process_id is None:  # `process_id or env` would be wrong: 0 is a valid id
        process_id = int(os.environ.get("PROCESS_ID", "0"))
    if "://" not in coordinator_address:
        coordinator_address = f"tcp://{coordinator_address}"
    init_process(coordinator_address, num_processes, process_id, device, backend, timeout_s)


def host_layout() -> tuple[int, int]:
    """(hosts, this host's index): ``NUM_PROCESSES`` and ``PROCESS_ID`` when
    ``COORDINATOR_ADDRESS`` is set, as :func:`initialize` reads them; (1, 0)
    without a coordinator.  Each host runs its own ranks
    (``cli/launch.py``)."""
    if not os.environ.get("COORDINATOR_ADDRESS"):
        return 1, 0
    return int(os.environ.get("NUM_PROCESSES", "1")), int(os.environ.get("PROCESS_ID", "0"))


def rank() -> int:
    """This process's rank; 0 without a process group."""
    return dist.get_rank() if dist.is_initialized() else 0


def world() -> int:
    """The number of ranks; 1 without a process group."""
    return dist.get_world_size() if dist.is_initialized() else 1


def local_batch_slice(global_batch: int) -> tuple[int, int]:
    """(local batch, offset) of this rank's shard of a global batch
    (``core/distributed.py:43-48``)."""
    per = global_batch // world()
    return per, rank() * per


def barrier() -> None:
    if dist.is_initialized():
        dist.barrier()


class _AllReduceSum(torch.autograd.Function):
    """The sum over ranks, whose gradient is the sum over ranks of the
    gradients (each rank's loss reads the sum)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor) -> torch.Tensor:
        x = x.clone()
        dist.all_reduce(x)
        return x

    @staticmethod
    def backward(ctx, grad: torch.Tensor) -> torch.Tensor:
        grad = grad.clone()
        dist.all_reduce(grad)
        return grad


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """Differentiable sum of ``x`` over the ranks."""
    return _AllReduceSum.apply(x)


def mean_over_ranks(x: torch.Tensor) -> torch.Tensor:
    """Differentiable mean of ``x`` over the ranks (``x`` itself without a
    process group)."""
    if not dist.is_initialized():
        return x
    return all_reduce_sum(x) / world()


@torch.no_grad()
def average_grads(params: Iterable[torch.nn.Parameter]) -> None:
    """Every gradient replaced by its mean over the ranks, in one flat
    all-reduce (a rank's loss is the mean over its shard, so this is the
    gradient of the global batch's loss)."""
    if not dist.is_initialized():
        return
    grads = [p.grad for p in params]
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat)
    flat /= world()
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


@torch.no_grad()
def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """The global batch of ``x`` [n, ...] (each rank's n rows at its
    offset), on every rank; no gradient."""
    if not dist.is_initialized():
        return x
    n = x.shape[0]
    out = x.new_zeros((n * world(), *x.shape[1:]))
    out[rank() * n:(rank() + 1) * n] = x
    dist.all_reduce(out)
    return out


MIN_METRICS, MAX_METRICS = ("sr_min",), ("sr_max",)


@torch.no_grad()
def reduce_metrics(metrics: dict) -> dict:
    """A step's metrics (device scalars) of the global batch: ``sr_min`` /
    ``sr_max`` by min / max over the ranks, every other one by the mean
    (each is a mean over the rank's shard)."""
    if not dist.is_initialized():
        return metrics
    out = dict(metrics)
    means = [k for k in metrics if k not in MIN_METRICS + MAX_METRICS]
    for keys, op in ((means, dist.ReduceOp.SUM), ([k for k in MIN_METRICS if k in metrics],
                     dist.ReduceOp.MIN), ([k for k in MAX_METRICS if k in metrics],
                                          dist.ReduceOp.MAX)):
        if not keys:
            continue
        flat = torch.stack([metrics[k].float() for k in keys])
        dist.all_reduce(flat, op=op)
        if op == dist.ReduceOp.SUM:
            flat /= world()
        out.update({k: flat[i] for i, k in enumerate(keys)})
    return out


@torch.no_grad()
def broadcast_tensors(tensors: Sequence[torch.Tensor], device: torch.device | str) -> None:
    """Rank 0's values of ``tensors`` copied into every rank's, one flat
    broadcast per dtype, staged on ``device`` (NCCL reads CUDA memory
    only)."""
    if not dist.is_initialized():
        return
    by_dtype: dict = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        flat = torch.cat([t.reshape(-1).to(device) for t in group])
        dist.broadcast(flat, 0)
        offset = 0
        for t in group:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


def broadcast_state(modules: Sequence[torch.nn.Module], optimizer: Optional[torch.optim.Optimizer],
                    device: torch.device | str) -> None:
    """Rank 0's parameters, buffers and optimizer state (Adam's moments and
    step counts) to every rank."""
    tensors = [t for m in modules for t in m.state_dict(keep_vars=True).values()]
    if optimizer is not None:
        for group in optimizer.param_groups:
            for p in group["params"]:
                state = optimizer.state.get(p, {})
                tensors += [state[k] for k in sorted(state) if torch.is_tensor(state[k])]
    broadcast_tensors([t.data if isinstance(t, torch.nn.Parameter) else t for t in tensors], device)


@contextlib.contextmanager
def packed_copies(copies: int):
    """Inside: the forwards pack ``copies`` logical batches of equal size in
    their batch axis (the fused-tssim 2B forward), which :func:`rand_rows`
    draws per copy."""
    global _COPIES
    before, _COPIES = _COPIES, int(copies)
    try:
        yield
    finally:
        _COPIES = before


def rand_rows(shape: Sequence[int], gen: torch.Generator, device: torch.device | str) -> torch.Tensor:
    """``torch.rand(shape)`` of this rank's rows of the global batch: the
    draw is made at the global shape (each copy of :func:`packed_copies`
    ``world()`` times as long) and each copy's rows at this rank's offset
    kept, so that every rank advances ``gen`` as one process does and D
    ranks together draw what one process draws at the global batch."""
    shape = tuple(shape)
    d = world()
    if d == 1:
        return torch.rand(shape, generator=gen, device=device)
    n = shape[0] // _COPIES
    full = torch.rand((shape[0] * d, *shape[1:]), generator=gen, device=device)
    r = rank()
    return torch.cat([full[(c * d + r) * n:(c * d + r + 1) * n] for c in range(_COPIES)])
