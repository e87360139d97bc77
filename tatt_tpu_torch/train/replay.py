"""Replays of a train step or of a BatchNorm forward on D ranks, to hold the
data-parallel path against a reference: the JAX package's step on its
mesh (the CPU tests), one process at the global batch, the CPU against
the card (``chip_smoke.py``).

A case is a file that ``torch.save`` wrote (modules whole, the global
batch as tensors, the step's configuration); unpickle only case files
that this program wrote.  :func:`run_cases` is a ``cli/launch.py``
``launch`` function, or a single process's call at rank 0 of 1: each rank
replays each case on its rows (``mesh.shard_batch``) and writes
``<case>.rank<r>.pt``.

``{"kind": "step", ...}``: ``cfg`` (a ``Config``, whose arch picks the
step, ``models.factory.arch_steps``), ``step_cfg``, ``generators``,
``students``, ``teacher``, ``batch`` (the global batch: the step's leaves,
optionally ``rot_arc`` / ``rot_offs``), ``steps``, ``seed`` (step i draws
from a generator seeded ``seed + i``), ``optimizer`` (``("sgd", lr)`` or
``("adam", lr, beta1)``), optionally ``optimizer_state`` (a ``state_dict``
to start from, as a resume restores it) and ``bn_replicas``.  The result:
per step the metrics, the models' ``state_dict``s after it, the gradients
it took and the optimizer's ``state_dict``.

``{"kind": "bn", ...}``: ``bn_replicas`` and ``items``, each a BatchNorm
``module`` in training mode with its global ``x``, output cotangent
``dy`` and ``copies``.  The result per item: the rank's rows of the
output and of the input's gradient, the gradients of the scale and
bias, and the running statistics.

A case's ``"device"`` runs it there in place of the rank's (a ``gloo``
group serves CPU and CUDA tensors alike: one launch replays a case on the
card and on the CPU).  ``"fault": "local_grad"`` plants the fault of a plain ``all_reduce`` of
the BatchNorm moments: the global statistics forward, the gradient of a
rank's local ones backward.
"""

from __future__ import annotations

import torch

from tatt_tpu_torch.core import distributed
from tatt_tpu_torch.core.mesh import shard_batch
from tatt_tpu_torch.models.common import set_bn_replicas
from tatt_tpu_torch.models.factory import arch_steps
from tatt_tpu_torch.train.state import make_optimizer


class _LocalGradSum(torch.autograd.Function):
    """The planted fault: the sum over ranks forward, the identity
    backward."""

    @staticmethod
    def forward(ctx, x: torch.Tensor) -> torch.Tensor:
        x = x.clone()
        torch.distributed.all_reduce(x)
        return x

    @staticmethod
    def backward(ctx, grad: torch.Tensor) -> torch.Tensor:
        return grad


def _cpu(tree):
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_cpu(v) for v in tree]
    return tree.detach().cpu().clone() if torch.is_tensor(tree) else tree


def _bn_case(case: dict, rank_id: int, world: int, device: torch.device) -> list:
    out = []
    for item in case["items"]:
        module, copies = item["module"].to(device).train(), item["copies"]
        x = shard_batch(item["x"], rank_id, world, copies).to(device).requires_grad_()
        dy = shard_batch(item["dy"], rank_id, world, copies).to(device)
        y = module(x, copies)
        (y * dy).sum().backward()
        out.append(_cpu({"y": y, "dx": x.grad, "dweight": module.weight.grad,
                         "dbias": module.bias.grad, "running_mean": module.running_mean,
                         "running_var": module.running_var}))
    return out


def _step_case(case: dict, rank_id: int, world: int, device: torch.device) -> list:
    generators = [m.to(device).train() for m in case["generators"]]
    students = [m.to(device).train() for m in case["students"]]
    teacher = case["teacher"].to(device).eval()
    params = [p for m in generators + students for p in m.parameters()]
    kind, lr, *rest = case["optimizer"]
    opt = torch.optim.SGD(params, lr=lr) if kind == "sgd" else make_optimizer(params, lr, *rest)
    if "optimizer_state" in case:
        opt.load_state_dict(case["optimizer_state"])
    batch = {k: v.to(device) for k, v in shard_batch(case["batch"], rank_id, world).items()}
    train_fn, _ = arch_steps(case["cfg"])
    distributed.broadcast_state(generators + students, opt, device)
    out = []
    for i in range(case["steps"]):
        gen = torch.Generator(device=device).manual_seed(case["seed"] + i)
        metrics = train_fn(generators, students, teacher, opt, batch, case["step_cfg"], gen)
        out.append(_cpu({
            "metrics": {k: v.item() for k, v in metrics.items()},
            "state": [m.state_dict() for m in generators + students],
            "grads": [{k: p.grad for k, p in m.named_parameters()} for m in generators + students],
            "optimizer": opt.state_dict(),
        }))
    return out


def run_cases(rank_id: int, world: int, device: torch.device, paths: list) -> None:
    """Replay each case file of ``paths`` as rank ``rank_id`` of ``world``
    on ``device``; write each result to ``<path>.rank<rank_id>.pt``."""
    for path in paths:
        case = torch.load(path, weights_only=False)
        set_bn_replicas(case.get("bn_replicas", 1))
        reduce_sum = distributed.all_reduce_sum
        if case.get("fault") == "local_grad":
            distributed.all_reduce_sum = _LocalGradSum.apply
        try:
            replay = _bn_case if case["kind"] == "bn" else _step_case
            result = replay(case, rank_id, world, torch.device(case.get("device", device)))
        finally:
            distributed.all_reduce_sum = reduce_sum
            set_bn_replicas(1)
        torch.save(result, f"{path}.rank{rank_id}.pt")
