"""Weight bridge: JAX-package variables and reference ``.pth`` files ->
the port's ``state_dict``.

The port's ``state_dict`` keys follow the reference PyTorch layout
(``model/tsrn.py``, ``model/crnn/crnn.py``), so reference checkpoints load
directly and the JAX package's own importers (``import_tatt``,
``import_crnn``) read port weights back.

:func:`from_jax` takes JAX variables as numpy arrays, either nested
(``{"params": {...}, "batch_stats": {...}}``, as ``tree_map(np.asarray,
variables)`` gives them) or flat (``"params/conv0/kernel"``, the form of
``tests/assets/fixture_crnn.npz``).  Every leaf must map, the STN head of
a ``TATT(stn=True)`` included (to the reference's ``stn_head.stn_convnet``
/ ``stn_fc1`` / ``stn_fc2`` names, ``torch_import.py:264-281``), or
:func:`from_jax` raises.
"""

from __future__ import annotations

import re
from typing import Any, Mapping

import numpy as np
import torch
from torch import nn

_RNN = {"w_ih": "weight_ih", "w_hh": "weight_hh", "b_ih": "bias_ih", "b_hh": "bias_hh"}
_LEAF = {
    "bias": "bias",
    "scale": "weight",
    "alpha": "weight",
    "mean": "running_mean",
    "var": "running_var",
    "in_proj_weight": "in_proj_weight",
    "in_proj_bias": "in_proj_bias",
    "out_proj_weight": "out_proj.weight",
    "out_proj_bias": "out_proj.bias",
}
_INFOGEN = {
    "fc_in": "fc_in",
    "fc_in_act": "activation",
    "gru_encoding": "transformer.gru_encoding",
    "decoder_norm": "transformer.decoder.norm",
}


def _flatten(variables: Mapping[str, Any]) -> dict[str, np.ndarray]:
    """Nested or flat JAX variables -> {"coll/mod/.../leaf": array}."""
    flat: dict[str, np.ndarray] = {}

    def walk(prefix: str, node) -> None:
        if isinstance(node, Mapping):
            for key, value in node.items():
                walk(f"{prefix}/{key}" if prefix else str(key), value)
        else:
            flat[prefix] = np.asarray(node)

    walk("", variables)
    for key in flat:
        if key.split("/")[0] not in ("params", "batch_stats"):
            raise KeyError(f"not a params/batch_stats leaf: {key!r}")
    return flat


def _tatt_prefix(mods: list[str], srb: int, n_up: int) -> str:
    head, rest = mods[0], mods[1:]
    m = re.fullmatch(r"srb(\d+)", head)
    if m:
        return ".".join([f"block{m[1]}", *rest])
    m = re.fullmatch(r"up(\d+)", head)
    if m:
        return ".".join([f"block{srb + 3}.{m[1]}", *rest])
    fixed = {
        "block1_conv": "block1.0",
        "block1_act": "block1.1",
        "post_conv": f"block{srb + 2}.0",
        "post_bn": f"block{srb + 2}.1",
        "final_conv": f"block{srb + 3}.{n_up}",
    }
    if head in fixed and not rest:
        return fixed[head]
    if head == "stn_head" and len(rest) == 1:
        m = re.fullmatch(r"(conv|bn)(\d)", rest[0])
        if m:  # conv blocks sit at the even indices of stn_convnet
            return f"stn_head.stn_convnet.{2 * int(m[2])}.{0 if m[1] == 'conv' else 1}"
        if rest[0] in ("fc1", "fc1_bn"):
            return f"stn_head.stn_fc1.{0 if rest[0] == 'fc1' else 1}"
    if head == "infoGen":
        if not rest:
            return "infoGen"
        sub, tail = rest[0], rest[1:]
        m = re.fullmatch(r"(encoder|decoder)_(\d+)", sub)
        if m:
            return ".".join([f"infoGen.transformer.{m[1]}.layers.{m[2]}", *tail])
        if sub in _INFOGEN:
            return ".".join([f"infoGen.{_INFOGEN[sub]}", *tail])
    raise KeyError(f"unmapped TATT module path {'/'.join(mods)!r}")


def _crnn_prefix(mods: list[str]) -> str:
    head, rest = mods[0], mods[1:]
    if re.fullmatch(r"(conv|batchnorm)\d", head) and not rest:
        return f"cnn.{head}"
    m = re.fullmatch(r"rnn(\d)", head)
    if m and rest and rest[0] in ("rnn", "embedding"):
        return ".".join([f"rnn.{m[1]}", *rest])
    raise KeyError(f"unmapped CRNN module path {'/'.join(mods)!r}")


def from_jax(variables: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """JAX ``TATT`` or ``CRNN`` variables -> the port's ``state_dict``."""
    flat = _flatten(variables)
    top = {k.split("/")[1] for k in flat}
    if "block1_conv" in top:
        srb = sum(bool(re.fullmatch(r"srb\d+", m)) for m in top)
        n_up = sum(bool(re.fullmatch(r"up\d+", m)) for m in top)
        prefix_of = lambda mods: _tatt_prefix(mods, srb, n_up)  # noqa: E731
    elif "conv0" in top:
        prefix_of = _crnn_prefix
    else:
        raise KeyError(f"neither TATT nor CRNN variables (modules {sorted(top)})")
    out: dict[str, torch.Tensor] = {}
    for key, value in flat.items():
        _, *mods, leaf = key.split("/")
        value = np.asarray(value, np.float32)
        if leaf == "init_factor" and mods == ["infoGen"]:
            entries = {"infoGen.init_factor.weight": value}
        elif leaf == "fc2_kernel" and mods == ["stn_head"]:
            entries = {"stn_head.stn_fc2.weight": value.T}
        elif leaf == "fc2_bias" and mods == ["stn_head"]:
            entries = {"stn_head.stn_fc2.bias": value}
        elif leaf in _RNN:
            base = f"{prefix_of(mods)}.{_RNN[leaf]}"
            entries = {f"{base}_l0": value[0], f"{base}_l0_reverse": value[1]}
        elif leaf == "kernel":
            # conv kernels are OIHW in both; Dense kernels are [in, out]
            entries = {f"{prefix_of(mods)}.weight": value if value.ndim == 4 else value.T}
        elif leaf in _LEAF:
            entries = {f"{prefix_of(mods)}.{_LEAF[leaf]}": value}
        else:
            raise KeyError(f"unmapped JAX leaf {key!r}")
        for name, arr in entries.items():
            if name in out:
                raise KeyError(f"two JAX leaves map to {name!r}")
            out[name] = torch.from_numpy(np.array(arr, np.float32))  # a writable copy
    return out


def load_npz(path: str) -> tuple[dict[str, np.ndarray], dict[str, Any]]:
    """A JAX-package ``save_variables_npz`` file -> (flat variables,
    metadata)."""
    with np.load(path) as data:
        variables = {k: data[k] for k in data.files if not k.startswith("__meta_")}
        meta = {
            k[len("__meta_") :]: (data[k].item() if data[k].ndim == 0 else data[k])
            for k in data.files
            if k.startswith("__meta_")
        }
    return variables, meta


def load_reference_pth(path: str) -> dict[str, torch.Tensor]:
    """A reference ``.pth`` (a ``state_dict_G`` generator checkpoint, a
    ``state_dict`` wrapper, or a bare ``crnn.pth``) -> its state dict with
    ``DataParallel``'s ``module.`` prefixes removed.  Mirrors the JAX
    package's ``--resume`` / ``--crnn_pretrained`` loading
    (``cli/main.py:242-250``, ``loop.py:454``)."""
    blob = torch.load(path, map_location="cpu", weights_only=True)
    for key in ("state_dict", "state_dict_G"):
        if isinstance(blob, dict) and key in blob:
            blob = blob[key]
    return {k.replace("module.", ""): v for k, v in blob.items() if torch.is_tensor(v)}


def load_weights(model: nn.Module, state_dict: Mapping[str, torch.Tensor]) -> list[str]:
    """Copy ``state_dict`` into ``model``.  Every entry of the model must be
    present; entries the model does not have (the STN head of a model built
    without ``stn``, the reference decoder's unused self-attention, BN
    counters) are returned by name."""
    own = model.state_dict()
    missing = sorted(set(own) - set(state_dict))
    if missing:
        raise KeyError(f"checkpoint lacks {len(missing)} entries, e.g. {missing[:5]}")
    bad = [k for k in own if tuple(own[k].shape) != tuple(state_dict[k].shape)]
    if bad:
        raise ValueError(
            f"shape mismatch for {bad[:5]} (model config differs from the checkpoint)"
        )
    model.load_state_dict({k: state_dict[k] for k in own})
    return sorted(set(state_dict) - set(own))
