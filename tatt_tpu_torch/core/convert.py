"""Weight bridge: JAX-package variables and reference ``.pth`` files ->
the port's ``state_dict``.

The port's ``state_dict`` keys follow the reference PyTorch layout
(``model/tsrn.py``, ``model/crnn/crnn.py``, ``model/recognizer/``,
``model/moran/``), so reference checkpoints load directly and the JAX
package's own importers (``import_tatt``, ``import_crnn``,
``import_aster``, ``import_moran``) read port weights back.

:func:`from_jax` takes JAX variables as numpy arrays, either nested
(``{"params": {...}, "batch_stats": {...}}``, as ``tree_map(np.asarray,
variables)`` gives them) or flat (``"params/conv0/kernel"``, the form of
``tests/assets/fixture_crnn.npz``).  Every leaf must map, the STN head of
a ``TATT(stn=True)`` included (to the reference's ``stn_head.stn_convnet``
/ ``stn_fc1`` / ``stn_fc2`` names, ``torch_import.py:264-281``), or
:func:`from_jax` raises.
"""

from __future__ import annotations

import pickle
import re
from typing import Any, Mapping, Sequence

import numpy as np
import torch
from torch import nn

from tatt_tpu_torch.train.state import make_optimizer

# marker of the port's own checkpoints (core/checkpoint.py): v2 holds a list
# of state_dicts per model (one per copy), v1 one state_dict
CHECKPOINT_FORMAT = "tatt_tpu_torch.checkpoint.v2"
CHECKPOINT_FORMATS = ("tatt_tpu_torch.checkpoint.v1", CHECKPOINT_FORMAT)
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
    if head == "stn_head":
        return _stn_prefix(mods)
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


def _stn_prefix(mods: list[str]) -> str:
    """An STN head's modules (the generator's or ASTER's)."""
    if len(mods) == 2:
        m = re.fullmatch(r"(conv|bn)(\d)", mods[1])
        if m:  # conv blocks sit at the even indices of stn_convnet
            return f"stn_head.stn_convnet.{2 * int(m[2])}.{0 if m[1] == 'conv' else 1}"
        if mods[1] in ("fc1", "fc1_bn"):
            return f"stn_head.stn_fc1.{0 if mods[1] == 'fc1' else 1}"
    raise KeyError(f"unmapped STN head module path {'/'.join(mods)!r}")


# a residual block's JAX submodules -> reference names, for ASTER
# (``torch_import.py:138-151``) and MORAN (``:193-208``)
_ASTER_BLOCK = {"conv1": "conv1", "bn1": "bn1", "conv2": "conv2", "bn2": "bn2",
                "downsample_conv": "downsample.0", "downsample_bn": "downsample.1"}
_MORAN_BLOCK = {"conv1": "conv1.0", "bn1": "conv1.1", "conv2": "conv2.0", "bn2": "conv2.1",
                "downsample_conv": "downsample.0", "downsample_bn": "downsample.1"}
# leaves of ASTER's decoder (``torch_import.py:154-173``): (name, transposed)
_ASTER_DECODER = {
    "tgt_embedding": ("tgt_embedding.weight", False),
    **{f"gru_{a}": (f"gru.{_RNN[a]}_l0", False) for a in _RNN},
    **{f"{m}_{leaf}": (f"{'fc' if m == 'fc' else 'attention_unit.' + m}.{t}", leaf == "kernel")
       for m in ("sEmbed", "xEmbed", "wEmbed", "fc") for leaf, t in (("kernel", "weight"),
                                                                      ("bias", "bias"))},
}
# leaves of a MORAN attention decoder (``torch_import.py:214-228``)
_MORAN_ATTENTION = {
    "i2h_w": "attention_cell.i2h.weight", "h2h_w": "attention_cell.h2h.weight",
    "h2h_b": "attention_cell.h2h.bias", "score_w": "attention_cell.score.weight",
    **{f"gru_{a}": f"attention_cell.rnn.{_RNN[a]}" for a in _RNN},
    "generator_w": "generator.weight", "generator_b": "generator.bias",
    "char_embeddings": "char_embeddings",
}
# MORN's offset tower: JAX conv<i> / bn<i> -> the reference Sequential index
_MORN_INDEX = {"conv1": 1, "bn1": 2, "conv2": 5, "bn2": 6, "conv3": 9, "bn3": 10,
               "conv4": 12, "bn4": 13, "conv5": 15, "bn5": 16}


def _aster_prefix(mods: list[str]) -> str:
    head, rest = mods[0], mods[1:]
    if head == "stn_head":
        return _stn_prefix(mods)
    if head == "encoder" and len(rest) == 1 and rest[0] in ("conv0", "bn0", "rnn"):
        return {"conv0": "encoder.layer0.0", "bn0": "encoder.layer0.1", "rnn": "encoder.rnn"}[rest[0]]
    if head == "encoder" and len(rest) == 2 and rest[1] in _ASTER_BLOCK:
        m = re.fullmatch(r"layer(\d)_(\d+)", rest[0])
        if m:
            return f"encoder.layer{m[1]}.{m[2]}.{_ASTER_BLOCK[rest[1]]}"
    raise KeyError(f"unmapped ASTER module path {'/'.join(mods)!r}")


def _moran_prefix(mods: list[str]) -> str:
    head, rest = mods[0], mods[1:]
    if head == "MORN" and len(rest) == 2 and rest[0] == "offsets" and rest[1] in _MORN_INDEX:
        return f"MORN.cnn.{_MORN_INDEX[rest[1]]}"
    if head == "cnn" and len(rest) == 1 and rest[0] in ("block0_conv", "block0_bn"):
        return f"ASRN.cnn.block0.{0 if rest[0] == 'block0_conv' else 1}"
    if head == "cnn" and len(rest) == 2 and rest[1] in _MORAN_BLOCK:
        m = re.fullmatch(r"block(\d)_(\d+)", rest[0])
        if m:
            return f"ASRN.cnn.block{m[1]}.{m[2]}.{_MORAN_BLOCK[rest[1]]}"
    m = re.fullmatch(r"rnn(\d)(_embedding)?", head)
    if m and not rest:
        return f"ASRN.rnn.{m[1]}.{'embedding' if m[2] else 'rnn'}"
    if head in ("attentionL2R", "attentionR2L") and not rest:
        return f"ASRN.{head}"
    raise KeyError(f"unmapped MORAN module path {'/'.join(mods)!r}")


def _crnn_prefix(mods: list[str]) -> str:
    head, rest = mods[0], mods[1:]
    if re.fullmatch(r"(conv|batchnorm)\d", head) and not rest:
        return f"cnn.{head}"
    m = re.fullmatch(r"rnn(\d)", head)
    if m and rest and rest[0] in ("rnn", "embedding"):
        return ".".join([f"rnn.{m[1]}", *rest])
    raise KeyError(f"unmapped CRNN module path {'/'.join(mods)!r}")


def from_jax(variables: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """JAX ``TATT``, ``CRNN``, ``AsterRecognizer`` or ``MORAN`` variables ->
    the port's ``state_dict``."""
    flat = _flatten(variables)
    top = {k.split("/")[1] for k in flat}
    if "block1_conv" in top:
        srb = sum(bool(re.fullmatch(r"srb\d+", m)) for m in top)
        n_up = sum(bool(re.fullmatch(r"up\d+", m)) for m in top)
        prefix_of = lambda mods: _tatt_prefix(mods, srb, n_up)  # noqa: E731
    elif "conv0" in top:
        prefix_of = _crnn_prefix
    elif "encoder" in top:
        prefix_of = _aster_prefix
    elif "MORN" in top:
        prefix_of = _moran_prefix
    else:
        raise KeyError(f"not TATT, CRNN, ASTER or MORAN variables (modules {sorted(top)})")
    out: dict[str, torch.Tensor] = {}
    for key, value in flat.items():
        _, *mods, leaf = key.split("/")
        value = np.asarray(value, np.float32)
        rnn = re.fullmatch(r"(w_ih|w_hh|b_ih|b_hh)(?:_l(\d))?", leaf)
        if leaf == "init_factor" and mods == ["infoGen"]:
            entries = {"infoGen.init_factor.weight": value}
        elif leaf == "fc2_kernel" and mods == ["stn_head"]:
            entries = {"stn_head.stn_fc2.weight": value.T}
        elif leaf == "fc2_bias" and mods == ["stn_head"]:
            entries = {"stn_head.stn_fc2.bias": value}
        elif mods == ["decoder"] and leaf in _ASTER_DECODER:
            name, transposed = _ASTER_DECODER[leaf]
            entries = {f"decoder.decoder.{name}": value.T if transposed else value}
        elif prefix_of is _moran_prefix and mods[0].startswith("attention") and leaf in _MORAN_ATTENTION:
            entries = {f"{prefix_of(mods)}.{_MORAN_ATTENTION[leaf]}": value}
        elif rnn:  # a bidirectional layer's [2, ...] leaf; "_l<k>" of a stacked BiLSTM
            base = f"{prefix_of(mods)}.{_RNN[rnn[1]]}_l{rnn[2] or 0}"
            entries = {base: value[0], f"{base}_reverse": value[1]}
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


def from_jax_copies(params: Sequence, batch_stats: Sequence) -> list[dict[str, torch.Tensor]]:
    """The per-copy tuples of a JAX ``TrainState`` (``sr_params`` with
    ``sr_batch_stats``, or ``student_params`` with ``student_batch_stats``,
    as numpy trees) -> one port ``state_dict`` per copy, in copy order."""
    return [from_jax({"params": p, "batch_stats": s}) for p, s in zip(params, batch_stats, strict=True)]


def adam_from_jax(mu, nu, count: int, params_order, lr: float) -> dict:
    """An optax ``adam`` state -> the ``state_dict`` of the port's Adam
    (``train/state.py:make_optimizer`` at ``lr``), so that a JAX run's
    optimizer state carries across with its weights.

    ``mu`` and ``nu`` (first and second moments) are sequences of JAX
    parameter trees as numpy arrays, one per model in the optimizer's
    order (every generator copy's, then every student copy's); ``count``
    is Adam's step count; ``params_order`` gives, for each model, the
    port's parameter names in ``named_parameters()`` order."""
    state, index = {}, 0
    for m_tree, v_tree, names in zip(mu, nu, params_order, strict=True):
        m_sd, v_sd = from_jax({"params": m_tree}), from_jax({"params": v_tree})
        if sorted(m_sd) != sorted(names):
            raise KeyError(f"moments and parameters differ: {sorted(set(m_sd) ^ set(names))[:5]}")
        for name in names:
            state[index] = {"step": torch.tensor(float(count)), "exp_avg": m_sd[name],
                            "exp_avg_sq": v_sd[name]}
            index += 1
    group = make_optimizer([nn.Parameter(torch.zeros(1))], lr).state_dict()["param_groups"][0]
    return {"state": state, "param_groups": [dict(group, params=list(range(index)))]}


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


def is_jax_checkpoint(path: str) -> bool:
    """A JAX-package ``.ckpt``: a msgpack map (fixmap 0x81-0x8f, map16
    0xde, map32 0xdf).  A torch zip starts with ``PK``, a legacy torch
    pickle with 0x80."""
    with open(path, "rb") as fh:
        head = fh.read(1)
    return bool(head) and (0x81 <= head[0] <= 0x8F or head[0] in (0xDE, 0xDF))


def load_reference_pth(path: str) -> dict[str, torch.Tensor]:
    """A reference ``.pth`` (a ``state_dict_G`` generator checkpoint, a
    ``state_dict`` wrapper such as ASTER's ``.pth.tar``, or a bare
    ``crnn.pth`` / ``moran.pth``) -> its state dict with ``DataParallel``'s
    ``module.`` prefixes removed.  Reads every file that the JAX package's
    ``load_state_dict`` reads (``torch_import.py:20-28``): tensors only
    first, and a wrapper that also pickles other objects (an epoch count,
    the training options) as JAX does, with ``weights_only=False`` — so
    load only files you trust.  A JAX-package checkpoint, one of the port's
    own, or a file torch cannot read raises ``ValueError`` naming the file
    and the reason."""
    if is_jax_checkpoint(path):
        raise ValueError(f"{path} is a checkpoint of the JAX package tatt_tpu (msgpack), "
                         "not a reference .pth")
    try:
        try:
            blob = torch.load(path, map_location="cpu", weights_only=True)
        except pickle.UnpicklingError:  # a wrapper pickling more than tensors
            blob = torch.load(path, map_location="cpu", weights_only=False)
    except Exception as exc:
        raise ValueError(f"{path}: not a readable torch checkpoint ({type(exc).__name__}: {exc})") from exc
    if isinstance(blob, dict) and blob.get("format") in CHECKPOINT_FORMATS:
        raise ValueError(f"{path} is a checkpoint of the port (core/checkpoint.py), "
                         "not a reference .pth: resume it with --resume")
    for key in ("state_dict", "state_dict_G"):
        if isinstance(blob, dict) and key in blob:
            blob = blob[key]
    if not isinstance(blob, Mapping):
        raise ValueError(f"{path}: holds a {type(blob).__name__}, not a state dict")
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
