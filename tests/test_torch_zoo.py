"""The zoo (``tatt_tpu_torch/models/zoo``) against the JAX package's
(``tatt_tpu/models/zoo``) on the CPU, class by class at small depth, in
eval and in train mode.

Weights come from ``random_variables`` (which draws every leaf away from
its init: HAN's LAM and CSAM ``gamma``, CSAM's conv bias, the biases and
``init_factor``, all zero or N(0, 1) at init, so each branch they gate is
compared) through ``from_jax(..., arch=...)``; inputs are seeded numpy
arrays.  Output and every ``aux`` entry within atol 1e-5 / rtol 1e-4; in
train mode also each BatchNorm's running statistics after the forward.
Dropout is off on both sides (``dropout=0.0``; JAX's TBSRN, which has no
such field, runs its attention ``deterministic``), as its masks differ by
construction (ROADMAP C.3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_models import random_variables
from tatt_tpu.models.zoo import esrgan as jesrgan
from tatt_tpu.models.zoo import han as jhan
from tatt_tpu.models.zoo import pcan as jpcan
from tatt_tpu.models.zoo import resnets as jresnets
from tatt_tpu.models.zoo import simple as jsimple
from tatt_tpu.models.zoo import tbsrn as jtbsrn
from tatt_tpu.models.zoo import transformer_sr as jtsr
from tatt_tpu_torch.core.convert import from_jax
from tatt_tpu_torch.kernels.resize import upsample_nearest
from tatt_tpu_torch.models.zoo import esrgan, han, pcan, resnets, simple, tbsrn, transformer_sr

TOL = dict(atol=1e-5, rtol=1e-4)
# name -> (arch for from_jax, JAX module, port module, input channels, TL?)
CASES = {
    "srcnn": ("srcnn", jsimple.SRCNN(), simple.SRCNN(), 3, False),
    "srcnn_tl": ("srcnn_tl", jsimple.SRCNN_TL(), simple.SRCNN_TL(), 4, True),
    "vdsr": ("vdsr", jsimple.VDSR(num_blocks=2), simple.VDSR(num_blocks=2), 3, False),
    "vdsr_tl": ("vdsr_tl", jsimple.VDSR_TL(num_blocks=2), simple.VDSR_TL(num_blocks=2), 4, True),
    "scgan": ("scgan", jsimple.SCGAN(), simple.SCGAN(), 4, False),
    "scgan_tl": ("scgan_tl", jsimple.SCGAN_TL(), simple.SCGAN_TL(), 4, True),
    "srres": ("srres", jresnets.SRResNet(mask=True), resnets.SRResNet(mask=True), 4, False),
    "srresnet_tl": ("srresnet_tl", jresnets.SRResNet_TL(mask=True, dropout=0.0),
                    resnets.SRResNet_TL(mask=True, dropout=0.0), 4, True),
    "edsr": ("edsr", jresnets.EDSR(num_blocks=2), resnets.EDSR(num_blocks=2), 3, False),
    "lapsrn": ("lapsrn", jresnets.LapSRN(), resnets.LapSRN(), 3, False),
    "lapsrn x4": ("lapsrn", jresnets.LapSRN(scale_factor=4), resnets.LapSRN(scale_factor=4), 3,
                  False),
    "rdn": ("rdn", jresnets.RDN(), resnets.RDN(), 3, False),
    "rdn_tl": ("rdn_tl", jresnets.RDN_TL(), resnets.RDN_TL(), 4, True),
    "esrgan": ("esrgan", jesrgan.RRDBNet(nb=2), esrgan.RRDBNet(nb=2), 4, False),
    "esrgan_tl": ("esrgan_tl", jesrgan.RRDBNet_TL(nb=2), esrgan.RRDBNet_TL(nb=2), 4, True),
    "han": ("han", jhan.HAN(n_resgroups=2, n_resblocks=2, n_feats=16),
            han.HAN(n_resgroups=2, n_resblocks=2, n_feats=16), 3, False),
    "pcan": ("pcan", jpcan.PCAN(srb_nums=2, hidden_units=8), pcan.PCAN(srb_nums=2, hidden_units=8),
             4, False),
    "pcan_tl": ("pcan_tl", jpcan.PCAN_TL(srb_nums=2, hidden_units=8, out_text_channels=8),
                pcan.PCAN_TL(srb_nums=2, hidden_units=8, out_text_channels=8), 4, True),
    "tbsrn": ("tbsrn", jtbsrn.TBSRN(srb_nums=2, hidden_units=8, mask=True),
              tbsrn.TBSRN(srb_nums=2, hidden_units=8, mask=True, dropout=0.0), 4, False),
    "tbsrn_tl": ("tbsrn_tl", jtbsrn.TBSRN_TL(srb_nums=2, hidden_units=8, mask=True,
                                             out_text_channels=8),
                 tbsrn.TBSRN_TL(srb_nums=2, hidden_units=8, mask=True, out_text_channels=8,
                                dropout=0.0), 4, True),
    "tranSR_v4": ("tranSR_v4", jtsr.SRTransformerV4(t_encoder_num=1, t_decoder_num=1, dropout=0.0),
                  transformer_sr.SRTransformerV4(t_encoder_num=1, t_decoder_num=1, dropout=0.0),
                  4, True),
}


def _inputs(channels: int, seed: int):
    rng = np.random.default_rng(seed)
    x = rng.random((2, channels, 16, 64), dtype=np.float32)
    t = rng.random((2, 37, 1, 26), dtype=np.float32)
    return x, t / t.sum(axis=1, keepdims=True)  # a softmax-like prior


def _jax_apply(model, variables, x, t, tl, train):
    kwargs = {"deterministic": True} if isinstance(model, (jtbsrn.TBSRN, jtbsrn.TBSRN_TL)) else {}
    args = (x, t) if tl else (x,)
    if train:
        out, mut = model.apply(variables, *args, train=True, mutable=["batch_stats"], **kwargs)
    else:
        out, mut = model.apply(variables, *args, train=False, **kwargs), {}
    return out, mut


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("name", list(CASES))
def test_zoo_module_matches_jax(name, train):
    arch, jmodel, port, channels, tl = CASES[name]
    x, t = _inputs(channels, 7)
    init_args = (jnp.zeros_like(x), jnp.zeros_like(t)) if tl else (jnp.zeros_like(x),)
    variables = random_variables(jmodel, np.random.default_rng(sum(map(ord, name))), *init_args,
                                 train=True)
    sd = from_jax(_host(variables), arch)
    assert sorted(sd) == sorted(port.state_dict()), name  # every leaf maps, nothing left over
    port.load_state_dict(sd)
    port.train(train)
    want, mut = _jax_apply(jmodel, variables, jnp.asarray(x), jnp.asarray(t), tl, train)
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(t)) if tl else port(torch.from_numpy(x))
    if tl:
        (want, want_aux), (got, got_aux) = want, got
        assert sorted(got_aux) == sorted(want_aux)
        for key, value in want_aux.items():
            np.testing.assert_allclose(got_aux[key].numpy(), np.asarray(value), **TOL, err_msg=key)
    assert got.shape == want.shape == (2, channels, 32 * (2 if name == "lapsrn x4" else 1),
                                       128 * (2 if name == "lapsrn x4" else 1))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if train and mut.get("batch_stats"):
        stats = from_jax(_host({"params": variables["params"], "batch_stats": mut["batch_stats"]}),
                         arch)
        own = port.state_dict()
        keys = [k for k in stats if "running" in k]
        assert keys
        for k in keys:
            np.testing.assert_allclose(own[k].numpy(), stats[k].numpy(), **TOL, err_msg=k)


def test_bicubic_matches_jax():
    """BICUBIC has no variables: the interpolation alone."""
    x, _ = _inputs(4, 3)
    want = jsimple.BICUBIC().apply({}, jnp.asarray(x))
    got = simple.BICUBIC()(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert not list(simple.BICUBIC().parameters())


def test_upsample_nearest_matches_jax():
    from tatt_tpu.kernels.resize import upsample_nearest as jupsample

    x, _ = _inputs(3, 4)
    for scale in (2, 3):
        np.testing.assert_array_equal(upsample_nearest(torch.from_numpy(x), scale).numpy(),
                                      np.asarray(jupsample(jnp.asarray(x), scale)))


def test_decoder_layer_matches_jax():
    """``DecoderLayer`` (self- then cross-attention, post-norm) and
    ``positional_encoding``, with its cross-attention weights."""
    from tatt_tpu.models import transformer as jtr
    from tatt_tpu_torch.models import transformer as ttr

    rng = np.random.default_rng(5)
    tgt = rng.standard_normal((2, 10, 16)).astype(np.float32)
    memory = rng.standard_normal((2, 7, 16)).astype(np.float32)
    query_pos = rng.standard_normal((2, 10, 16)).astype(np.float32)
    pos = np.asarray(jtr.positional_encoding(7, 16))[None]
    np.testing.assert_array_equal(ttr.positional_encoding(7, 16).numpy(), pos[0])
    jlayer = jtr.DecoderLayer(16, 4, 24, dropout=0.0)
    variables = random_variables(jlayer, rng, tgt, memory, pos, query_pos)
    layer = ttr.DecoderLayer(16, 4, 24)
    sd = from_jax({"params": {"decoder_0": _host(variables["params"])}}, "tranSR_v4")
    layer.load_state_dict({k[len("decoder_0."):]: v for k, v in sd.items()})
    want, want_w = jlayer.apply(variables, tgt, memory, pos, query_pos)
    with torch.no_grad():
        got, got_w = layer(*(torch.from_numpy(a) for a in (tgt, memory, pos, query_pos)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got_w.numpy(), np.asarray(want_w), **TOL)
