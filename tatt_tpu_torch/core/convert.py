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

The generators share the reference trunk names (``block1``, ``block<i>``,
``block{srb+2}``, ``block{srb+3}``).  A generator's family shows in its
modules: ``infoGen/tconv*`` (the TL archs' InfoGen) against ``infoGen``'s
TP Interpreter (TATT), ``sft_layer`` (TSRN_TL_SFT), ``coarse_proj``
(TSRN_C2F) and ``w2v_proj`` (SEM_TSRN).  No reference importer defines
names for the last three or for SEM_TSRN's attention blocks
(``mask_multihead``, ``norm1`` / ``norm3`` with ``a_2`` / ``b_2``,
``pff_w1`` / ``pff_w2``): there the port keeps the JAX module names, its
own choice.

The zoo's generators (``models/zoo``) share top-level names with that
trunk and with one another (``block1_conv``, ``block2``, ``infoGen``,
...), so their layout is never guessed: ``from_jax(variables, arch=...)``
takes the factory's arch name.  The families that a JAX importer reads
keep the reference names that it reads: TBSRN (``import_tbsrn_tl``: the
TSRN trunk names, the FeatureEnhancer's ``multihead.linears.0-3``,
``mul_layernorm1`` / ``3`` and ``pff.w_1`` / ``w_2``), HAN
(``import_han``: ``head.0``, ``body.<g>.body.<b>.body.{0,2,3}``,
``la`` / ``csa``, ``tail``), RDN (``import_rdn_tl``:
``RDB<k>.dense_layers.<i>.conv``) and ESRGAN (``import_esrgan_tl``:
``RRDB_trunk.<i>``), the plain sibling of each too; every other zoo arch
keeps the JAX module names as they are (a TP Interpreter ``infoGen`` the
names of TATT's).
"""

from __future__ import annotations

import pickle
import re
from typing import Any, Mapping, Optional, Sequence

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
    "a_2": "a_2",
    "b_2": "b_2",
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


# top-level modules of the generators beside the shared trunk, kept under
# their JAX names (no JAX importer names them: SFT_TL's SFT layer, TSRN_C2F's
# coarse projection, SEM_TSRN's word-vector head)
_OWN_MODULES = ("sft_layer", "coarse_proj", "w2v_proj")


def _generator_prefix(mods: list[str], srb: int, n_up: int) -> str:
    """A module path of a TATT or TSRN-family generator -> the port's
    name.  The trunk takes the reference names that ``import_tatt`` reads
    (``torch_import.py:241``); ``infoGen`` holds either TATT's TP
    Interpreter or the TL archs' deconv stack (``tconv1-4``, ``bn1-4``:
    the names of ``torch_import._infogen``, ``:356``)."""
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
    if head in _OWN_MODULES:
        return ".".join(mods)
    if head == "infoGen" and len(rest) == 1 and re.fullmatch(r"(tconv|bn)[1-4]", rest[0]):
        return f"infoGen.{rest[0]}"
    if head == "infoGen":
        if not rest:
            return "infoGen"
        sub, tail = rest[0], rest[1:]
        m = re.fullmatch(r"(encoder|decoder)_(\d+)", sub)
        if m:
            return ".".join([f"infoGen.transformer.{m[1]}.layers.{m[2]}", *tail])
        if sub in _INFOGEN:
            return ".".join([f"infoGen.{_INFOGEN[sub]}", *tail])
    raise KeyError(f"unmapped generator module path {'/'.join(mods)!r} "
                   "(a zoo generator's variables need arch=)")


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


def _count(top: set, pattern: str) -> int:
    return sum(bool(re.fullmatch(pattern, m)) for m in top)


def _jax_names_prefix(mods: list[str]) -> str:
    """A zoo generator that keeps the JAX module names; its ``infoGen``
    (the TL archs' deconv stack, or a TP Interpreter) as TATT's."""
    return _generator_prefix(mods, 0, 0) if mods[0] == "infoGen" else ".".join(mods)


def _tbsrn_prefix(mods: list[str], srb: int, n_up: int) -> str:
    """TBSRN / TBSRN_TL -> the names of ``import_tbsrn_tl``
    (``torch_import.py:422``): the TSRN trunk's, blocks ``block<i>``."""
    head, rest = mods[0], mods[1:]
    if re.fullmatch(r"block\d+", head):
        if rest[:1] == ["feature_enhancer"] and len(rest) == 2:
            sub = {"multihead": "multihead", "norm1": "mul_layernorm1", "norm3": "mul_layernorm3",
                   "pff_w1": "pff.w_1", "pff_w2": "pff.w_2", "linear": "linear"}
            if rest[1] in sub:
                return f"{head}.feature_enhancer.{sub[rest[1]]}"
        if len(rest) == 1 and rest[0] in ("conv1", "bn1", "conv2", "bn2", "conv_proj"):
            return ".".join(mods)
        raise KeyError(f"unmapped TBSRN module path {'/'.join(mods)!r}")
    if head == "final" and not rest:
        return f"block{srb + 3}.{n_up}"
    if re.fullmatch(r"srb\d+|final_conv|stn_head", head):
        raise KeyError(f"unmapped TBSRN module path {'/'.join(mods)!r}")
    return _generator_prefix(mods, srb, n_up)


def _han_prefix(mods: list[str], n_resgroups: int, n_resblocks: int) -> str:
    """HAN -> the names of ``import_han`` (``torch_import.py:455``)."""
    head, rest = mods[0], mods[1:]
    m = re.fullmatch(r"group(\d+)", head)
    if m and rest == ["conv_tail"]:
        return f"body.{m[1]}.body.{n_resblocks}"
    if m and len(rest) >= 2 and re.fullmatch(r"rcab\d+", rest[0]):
        block = f"body.{m[1]}.body.{rest[0][len('rcab'):]}.body"
        sub = {("conv1",): "0", ("conv2",): "2", ("ca", "down"): "3.conv_du.0",
               ("ca", "up"): "3.conv_du.2"}.get(tuple(rest[1:]))
        if sub:
            return f"{block}.{sub}"
    m = re.fullmatch(r"up(\d+)", head)
    fixed = {"head": "head.0", "body_tail": f"body.{n_resgroups}", "la": "la", "csa": "csa",
             "last_conv": "last_conv", "last": "last", "tail": "tail.1"}
    if m and not rest:
        return f"tail.0.{2 * int(m[1])}"
    if head in fixed and not rest:
        return fixed[head]
    raise KeyError(f"unmapped HAN module path {'/'.join(mods)!r}")


def _rdn_prefix(mods: list[str]) -> str:
    """RDN / RDN_TL -> the names of ``import_rdn_tl`` (``torch_import.py:491``)."""
    if re.fullmatch(r"RDB\d", mods[0]) and len(mods) == 2:
        m = re.fullmatch(r"dense(\d+)", mods[1])
        if m:
            return f"{mods[0]}.dense_layers.{m[1]}.conv"
    return _jax_names_prefix(mods)


def _esrgan_prefix(mods: list[str]) -> str:
    """RRDBNet / RRDBNet_TL -> the names of ``import_esrgan_tl``
    (``torch_import.py:511``)."""
    m = re.fullmatch(r"RRDB(\d+)", mods[0])
    if m:
        return ".".join([f"RRDB_trunk.{m[1]}", *mods[1:]])
    return _jax_names_prefix(mods)


# the factory's archs by layout: the TSRN trunk (TATT and the TSRN family),
# the families of a JAX importer, and the rest of the zoo with JAX names
TSRN_ARCHS = ("tatt", "tsrn", "tsrn_tl_cascade", "tsrn_tl_cascade_sft", "tsrn_c2f", "sem_tsrn")
JAX_NAMED_ARCHS = ("srcnn", "srcnn_tl", "vdsr", "vdsr_tl", "scgan", "scgan_tl", "srres",
                   "srresnet_tl", "edsr", "lapsrn", "pcan", "pcan_tl", "tranSR_v4")
REFERENCE_NAMED_ARCHS = ("tbsrn", "tbsrn_tl", "han", "rdn", "rdn_tl", "esrgan", "esrgan_tl")


def _layout(arch: Optional[str], paths: list[list[str]]):
    """The module-path mapping of ``arch``'s variables (``paths``: each
    leaf's module path); with no arch, of TATT / TSRN-family, CRNN, ASTER
    or MORAN variables by their modules."""
    top = {p[0] for p in paths if p}
    srb, n_up = _count(top, r"srb\d+"), _count(top, r"up\d+")
    if arch in TSRN_ARCHS or (arch is None and "block1_conv" in top):
        return lambda mods: _generator_prefix(mods, srb, n_up)
    if arch in ("tbsrn", "tbsrn_tl"):
        return lambda mods: _tbsrn_prefix(mods, _count(top, r"block\d+"), n_up)
    if arch == "han":
        n_resblocks = _count({p[1] for p in paths if p[:1] == ["group0"]}, r"rcab\d+")
        return lambda mods: _han_prefix(mods, _count(top, r"group\d+"), n_resblocks)
    if arch in ("rdn", "rdn_tl"):
        return _rdn_prefix
    if arch in ("esrgan", "esrgan_tl"):
        return _esrgan_prefix
    if arch in JAX_NAMED_ARCHS:
        return _jax_names_prefix
    if arch is not None:
        known = sorted(TSRN_ARCHS + JAX_NAMED_ARCHS + REFERENCE_NAMED_ARCHS)
        raise KeyError(f"no weight layout for arch {arch!r} (have: {', '.join(known)})")
    for marker, prefix_of in (("conv0", _crnn_prefix), ("encoder", _aster_prefix),
                              ("MORN", _moran_prefix)):
        if marker in top:
            return prefix_of
    raise KeyError(f"not generator, CRNN, ASTER or MORAN variables (modules {sorted(top)}); "
                   "a zoo generator's needs arch=")


def _attention_entries(prefix: str, leaf: str, value: np.ndarray) -> Optional[dict]:
    """TBSRN's packed attention leaves -> the reference's four Linears
    (``import_tbsrn_tl`` packs them, ``torch_import.py:385-403``)."""
    if leaf in ("in_proj_weight", "in_proj_bias"):
        kind = "weight" if leaf == "in_proj_weight" else "bias"
        return {f"{prefix}.linears.{i}.{kind}": part
                for i, part in enumerate(np.split(value, 3, axis=0))}
    if leaf in ("out_proj_weight", "out_proj_bias"):
        return {f"{prefix}.linears.3.{leaf[len('out_proj_'):]}": value}
    return None


def from_jax(variables: Mapping[str, Any], arch: Optional[str] = None) -> dict[str, torch.Tensor]:
    """JAX variables -> the port's ``state_dict``.  ``arch``: the factory's
    name of the generator (every zoo generator needs it); without it, the
    variables of a ``TATT``, a TSRN-family generator (``TSRN``,
    ``TSRN_TL``, ``TSRN_TL_SFT``, ``TSRN_C2F``, ``SEM_TSRN``,
    ``TSRNEncoder``), a ``CRNN``, an ``AsterRecognizer`` or a ``MORAN``."""
    flat = _flatten(variables)
    prefix_of = _layout(arch, [k.split("/")[1:-1] for k in flat])
    out: dict[str, torch.Tensor] = {}
    for key, value in flat.items():
        _, *mods, leaf = key.split("/")
        value = np.asarray(value, np.float32)
        rnn = re.fullmatch(r"(w_ih|w_hh|b_ih|b_hh)(?:_l(\d))?", leaf)
        attention = (arch in ("tbsrn", "tbsrn_tl") and mods[-1:] == ["multihead"]
                     and _attention_entries(prefix_of(mods), leaf, value))
        if attention:
            entries = attention
        elif leaf == "init_factor" and mods == ["infoGen"]:
            entries = {"infoGen.init_factor.weight": value}
        elif leaf == "init_factor" and not mods and arch == "tranSR_v4":
            entries = {"init_factor": value}
        elif leaf in ("horizontal_w", "horizontal_b", "vertical_w", "vertical_b", "gamma"):
            entries = {f"{prefix_of(mods)}.{leaf}": value}
        elif leaf in ("conv3d_kernel", "conv3d_bias"):  # HAN's CSAM: a Conv3d
            entries = {f"{prefix_of(mods)}.conv.{'weight' if leaf == 'conv3d_kernel' else 'bias'}":
                       value}
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
