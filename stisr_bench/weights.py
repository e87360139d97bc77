"""Seeded weights, made on the card in one draw and handed to both sides.

Every trainable leaf of the reference's models (sorted by qualified name)
takes its slice of one ``torch.rand`` on the device from a generator
seeded with the run's seed, scaled as torch's default initialisation
scales it: a matrix or kernel U(-b, b) with b = 1 / sqrt(fan_in) (fan_in:
the product of its dimensions after the first), the bias beside it with
its matrix's b.  The rest keep their published start: BatchNorm and
LayerNorm at 1 and 0, PReLU at 0.25, and the STN's last layer's bias at
the border grid of control points.  The program loads the same tensors
by name (``load_state_dict`` with ``strict=True``), so a name that one
side lacks stops the run.
"""

from __future__ import annotations

import math

import torch

from stisr_bench.reference.nets import control_points

# leaves that keep their published start (a name ending so)
_KEEP = (".activation.weight", "block1.1.weight")


def _bound(shape) -> float:
    fan_in = math.prod(shape[1:])
    return 1.0 / math.sqrt(fan_in) if fan_in else 0.0


def plan(models: dict) -> list[tuple[str, tuple, float]]:
    """(qualified name, shape, bound) of each drawn leaf, in draw order;
    bound 0 marks a leaf that keeps its start."""
    out = []
    for name in sorted(models):
        params = dict(models[name].named_parameters())
        for key in sorted(params):
            shape = tuple(params[key].shape)
            owner, _, leaf = key.rpartition(".")
            sibling = params.get(f"{owner}.{leaf.replace('bias', 'weight')}" if owner
                                 else leaf.replace("bias", "weight"))
            if len(shape) >= 2:
                bound = _bound(shape)
            elif "bias" in leaf and sibling is not None and sibling.dim() >= 2:
                bound = _bound(sibling.shape)
            else:
                bound = 0.0
            if key.endswith(_KEEP) or key.endswith("stn_fc2.bias"):
                bound = 0.0
            out.append((f"{name}.{key}", shape, bound))
    return out


@torch.no_grad()
def make(models: dict, seed: int, device) -> dict[str, dict[str, torch.Tensor]]:
    """{model: {leaf: tensor}} for ``models`` (the reference's), on
    ``device``, from ``seed``; leaves that keep their start are taken
    from the reference's constructor (and fc2's bias set to the grid)."""
    leaves = plan(models)
    total = sum(math.prod(s) for _, s, b in leaves if b > 0)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.rand(total, generator=gen, device=device)
    out: dict[str, dict[str, torch.Tensor]] = {name: {} for name in models}
    at = 0
    for qual, shape, bound in leaves:
        name, key = qual.split(".", 1)
        if bound > 0:
            n = math.prod(shape)
            out[name][key] = (flat[at:at + n] * (2 * bound) - bound).reshape(shape)
            at += n
        elif key.endswith("stn_fc2.bias"):
            out[name][key] = torch.as_tensor(control_points(shape[0] // 2), device=device)
        else:
            out[name][key] = dict(models[name].named_parameters())[key].detach().to(device).clone()
    return out


@torch.no_grad()
def load(module: torch.nn.Module, leaves: dict[str, torch.Tensor]) -> None:
    """Copy ``leaves`` into ``module``'s parameters; every parameter has
    to be given, and nothing else."""
    params = dict(module.named_parameters())
    missing, extra = sorted(set(params) - set(leaves)), sorted(set(leaves) - set(params))
    if missing or extra:
        raise KeyError(f"weights do not fit the module: missing {missing[:5]}, extra {extra[:5]}")
    for key, p in params.items():
        if tuple(p.shape) != tuple(leaves[key].shape):
            raise ValueError(f"{key}: shape {tuple(p.shape)} against {tuple(leaves[key].shape)}")
        p.copy_(leaves[key])
