"""Module-by-module parity of tatt_tpu_torch (CPU) against tatt_tpu (JAX, CPU).

Each JAX module and its port run on the same numpy inputs with the same
weights, converted by ``tatt_tpu_torch.core.convert.from_jax``; tolerances
are the repo's module-level f32 ones (atol 1e-5, rtol 1e-4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tatt_tpu.models import common as jcommon
from tatt_tpu.models import transformer as jtr
from tatt_tpu.models.recognizers import crnn as jcrnn
from tatt_tpu.models import tsrn as jtsrn
from tatt_tpu.models.tp_interpreter import TPInterpreter as JTPInterpreter
from tatt_tpu_torch.core.convert import from_jax
from tatt_tpu_torch.kernels import resize as tresize
from tatt_tpu_torch.models import common as tcommon
from tatt_tpu_torch.models.recognizers import crnn as tcrnn
from tatt_tpu_torch.models.tp_interpreter import TPInterpreter
from tatt_tpu_torch.models.tsrn import TATT

TOL = dict(atol=1e-5, rtol=1e-4)
SMALL = dict(srb_nums=1, hidden_units=4, out_text_channels=8)


def _np_tree(variables):
    return jax.tree_util.tree_map(np.asarray, variables)


def random_variables(model, rng, *args, **kwargs):
    """Variables of ``model`` drawn with numpy (shapes from tracing its
    init, which compiles nothing): torch-default-like ranges, BN running
    statistics and affine parameters away from their init values."""
    shapes = jax.eval_shape(lambda k: model.init(k, *args, **kwargs), jax.random.PRNGKey(0))
    flat, tree = jax.tree_util.tree_flatten_with_path(shapes)
    leaves = []
    for path, leaf in flat:
        name, shape = path[-1].key, leaf.shape
        if name == "var":
            v = rng.uniform(0.5, 1.5, shape)
        elif name == "scale":
            v = rng.uniform(0.8, 1.2, shape)
        elif name == "alpha":
            v = np.full(shape, 0.25)
        elif name in ("mean", "bias") or len(shape) == 1:
            v = rng.normal(0, 0.1, shape)
        elif name == "init_factor":
            v = rng.normal(0, 1, shape)
        else:
            fan_in = np.prod(shape[1:]) if len(shape) == 4 else shape[-1]
            v = rng.uniform(-1, 1, shape) / np.sqrt(fan_in)
        leaves.append(v.astype(np.float32))
    return jax.tree_util.tree_unflatten(tree, leaves)


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float32)


@pytest.fixture(scope="module")
def tatt_pair():
    """JAX TATT(stn=True) variables and the port TATT loaded from them."""
    model = jtsrn.TATT(stn=True, **SMALL)
    x = jnp.zeros((2, 4, 16, 64))
    t = jnp.zeros((2, 37, 1, 26))
    variables = random_variables(model, np.random.default_rng(1), x, t, train=True)
    port = TATT(stn=True, **SMALL)
    port.load_state_dict(from_jax(variables))
    return model, variables, port.eval()


def test_primitives_match():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 6, 8, 10)).astype(np.float32)
    x_nhwc = jnp.asarray(x.transpose(0, 2, 3, 1))
    with torch.no_grad():
        # conv (3x3, 9x9 'same', 2x2 valid) with OIHW weights
        for k, p in (((3, 3), (1, 1)), ((9, 9), (4, 4)), ((2, 2), (0, 0))):
            jconv = jcommon.Conv2d(5, k, padding=p, data_format="NHWC")
            v = _np_tree(jconv.init(jax.random.PRNGKey(2), x_nhwc))
            want = np.asarray(jconv.apply(v, x_nhwc)).transpose(0, 3, 1, 2)
            conv = tcommon.Conv2d(6, 5, k, p)
            conv.load_state_dict({"weight": _t(v["params"]["kernel"]), "bias": _t(v["params"]["bias"])})
            np.testing.assert_allclose(conv(_t(x)).numpy(), want, **TOL)
        # BatchNorm in eval mode from running statistics
        jbn = jcommon.BatchNorm2d(data_format="NHWC")
        bv = {
            "params": {"scale": rng.uniform(0.5, 2, 6).astype(np.float32),
                       "bias": rng.normal(0, 1, 6).astype(np.float32)},
            "batch_stats": {"mean": rng.normal(0, 1, 6).astype(np.float32),
                            "var": rng.uniform(0.1, 3, 6).astype(np.float32)},
        }
        want = np.asarray(jbn.apply(bv, x_nhwc, False)).transpose(0, 3, 1, 2)
        bn = tcommon.BatchNorm2d(6).eval()  # modules start in training mode
        bn.load_state_dict({
            "weight": _t(bv["params"]["scale"]), "bias": _t(bv["params"]["bias"]),
            "running_mean": _t(bv["batch_stats"]["mean"]),
            "running_var": _t(bv["batch_stats"]["var"]),
        })
        np.testing.assert_allclose(bn(_t(x)).numpy(), want, **TOL)
        # pixel shuffle (torch channel packing), max pools, mish, PReLU, Dense
        y = rng.standard_normal((2, 8, 3, 5)).astype(np.float32)
        want = np.asarray(jcommon.pixel_shuffle_nhwc(jnp.asarray(y.transpose(0, 2, 3, 1)), 2))
        np.testing.assert_allclose(
            tcommon.pixel_shuffle(_t(y), 2).numpy(), want.transpose(0, 3, 1, 2), **TOL
        )
        for win, st, pad in (((2, 2), (2, 2), (0, 0)), ((2, 2), (2, 1), (0, 1))):
            want = np.asarray(jcommon.max_pool_nhwc(x_nhwc, win, st, pad)).transpose(0, 3, 1, 2)
            np.testing.assert_allclose(tcommon.max_pool(_t(x), win, st, pad).numpy(), want, **TOL)
        np.testing.assert_allclose(
            tcommon.mish(_t(x)).numpy(), np.asarray(jcommon.mish(jnp.asarray(x))), **TOL
        )
        prelu = tcommon.PReLU()
        want = np.asarray(jcommon.PReLU().apply({"params": {"alpha": np.array([0.25], np.float32)}}, x))
        np.testing.assert_allclose(prelu(_t(x)).numpy(), want, **TOL)
        jd = jcommon.Dense(3)
        dv = _np_tree(jd.init(jax.random.PRNGKey(3), jnp.asarray(x)))
        dense = tcommon.Dense(10, 3)
        dense.load_state_dict({"weight": _t(dv["params"]["kernel"].T), "bias": _t(dv["params"]["bias"])})
        np.testing.assert_allclose(dense(_t(x)).numpy(), np.asarray(jd.apply(dv, x)), **TOL)


def test_resize_and_luma_match():
    from tatt_tpu.kernels import resize as jresize

    rng = np.random.default_rng(4)
    x = rng.uniform(0, 1, (2, 4, 16, 64)).astype(np.float32)
    cases = [
        (jresize.resize_bicubic(jnp.asarray(x), 32, 100), tresize.resize_bicubic(_t(x), 32, 100)),
        (jresize.resize_bicubic(jnp.asarray(x), 32, 128), tresize.resize_bicubic(_t(x), 32, 128)),
        (jresize.resize_bilinear(jnp.asarray(x), 7, 30, True),
         tresize.resize_bilinear(_t(x), 7, 30, True)),
        (jresize.resize_bilinear(jnp.asarray(x), 24, 80), tresize.resize_bilinear(_t(x), 24, 80)),
        (jresize.rgb_to_luma(jnp.asarray(x)), tresize.rgb_to_luma(_t(x))),
    ]
    for want, got in cases:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_attention_encoder_decoder_match(tatt_pair):
    _, variables, port = tatt_pair
    p = variables["params"]["infoGen"]
    rng = np.random.default_rng(5)
    src = rng.standard_normal((2, 26, 8)).astype(np.float32)
    tgt = rng.standard_normal((2, 40, 8)).astype(np.float32)
    pos = rng.standard_normal((1, 26, 8)).astype(np.float32)
    qpos = rng.standard_normal((2, 40, 8)).astype(np.float32)
    tr = port.infoGen.transformer
    with torch.no_grad():
        want_o, want_w = jtr.MultiheadAttention(8, 4).apply(
            {"params": p["decoder_0"]["multihead_attn"]}, tgt, src, src
        )
        got_o, got_w = tr.decoder.layers[0].multihead_attn(_t(tgt), _t(src), _t(src))
        np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o), **TOL)
        np.testing.assert_allclose(got_w.numpy(), np.asarray(want_w), **TOL)
        want = jtr.EncoderLayer(8, 4, 8).apply({"params": p["encoder_0"]}, src, pos)
        got = tr.encoder.layers[0](_t(src), _t(pos))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        want_o, want_w = jtr.TPDecoderLayer(8, 4, 8).apply(
            {"params": p["decoder_1"]}, tgt, src, pos, qpos
        )
        got_o, got_w = tr.decoder.layers[1](_t(tgt), _t(src), _t(pos), _t(qpos))
        np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o), **TOL)
        np.testing.assert_allclose(got_w.numpy(), np.asarray(want_w), **TOL)
        want = jtr.LayerNorm().apply({"params": p["decoder_norm"]}, tgt)
        np.testing.assert_allclose(tr.decoder.norm(_t(tgt)).numpy(), np.asarray(want), **TOL)
    np.testing.assert_array_equal(
        __import__("tatt_tpu_torch.models.transformer", fromlist=["x"]).positional_encoding_table(26, 8),
        jtr.positional_encoding_table(26, 8),
    )


@pytest.mark.parametrize("mode", ["width", "reference"])
def test_tp_interpreter_matches(tatt_pair, mode):
    _, variables, port = tatt_pair
    rng = np.random.default_rng(6)
    feat = rng.standard_normal((3, 8, 16, 64)).astype(np.float32)
    prior = rng.uniform(0, 1, (3, 37, 1, 26)).astype(np.float32)
    jmod = JTPInterpreter(d_model=8, query_gru_mode=mode, data_format="NHWC")
    want_map, want_w = jmod.apply(
        {"params": variables["params"]["infoGen"]},
        jnp.asarray(feat.transpose(0, 2, 3, 1)), jnp.asarray(prior), True,
    )
    tpi = TPInterpreter(d_model=8, query_gru_mode=mode)
    tpi.load_state_dict(
        {k[len("infoGen."):]: v for k, v in port.state_dict().items() if k.startswith("infoGen.")}
    )
    with torch.no_grad():
        got_map, got_w = tpi(_t(feat), _t(prior))
    np.testing.assert_allclose(got_map.numpy(), np.asarray(want_map).transpose(0, 3, 1, 2), **TOL)
    np.testing.assert_allclose(got_w.numpy(), np.asarray(want_w), **TOL)


def test_gru_block_and_residual_block_match(tatt_pair):
    _, variables, port = tatt_pair
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 8, 16, 64)).astype(np.float32)
    tp = rng.standard_normal((2, 8, 16, 64)).astype(np.float32)
    cat = rng.standard_normal((2, 16, 16, 64)).astype(np.float32)
    nhwc = lambda a: jnp.asarray(a.transpose(0, 2, 3, 1))  # noqa: E731
    srb_p, srb_s = variables["params"]["srb2"], variables["batch_stats"]["srb2"]
    with torch.no_grad():
        # gru2 scans W over N*H rows; gru1 scans H through the H<->W swap
        want = jtsrn.GruBlock(8, data_format="NHWC").apply({"params": srb_p["gru2"]}, nhwc(x))
        got = port.block2.gru2(_t(x))
        np.testing.assert_allclose(got.numpy(), np.asarray(want).transpose(0, 3, 1, 2), **TOL)
        swapped = jnp.asarray(cat.transpose(0, 3, 2, 1))  # NHWC of the H<->W swap
        want = jtsrn.GruBlock(8, data_format="NHWC").apply({"params": srb_p["gru1"]}, swapped)
        got = port.block2.gru1(_t(cat).transpose(2, 3))
        np.testing.assert_allclose(got.numpy(), np.asarray(want).transpose(0, 3, 1, 2), **TOL)
        want = jtsrn.RecurrentResidualBlockTL(8, 8, data_format="NHWC").apply(
            {"params": srb_p, "batch_stats": srb_s}, nhwc(x), nhwc(tp), False
        )
        got = port.block2(_t(x), _t(tp))
        np.testing.assert_allclose(got.numpy(), np.asarray(want).transpose(0, 3, 1, 2), **TOL)


def test_tatt_eval_forward_matches(tatt_pair):
    model, variables, port = tatt_pair
    rng = np.random.default_rng(8)
    lr = rng.uniform(0, 1, (3, 4, 16, 64)).astype(np.float32)
    logits = rng.standard_normal((3, 37, 1, 26)).astype(np.float32)
    prior = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    want_sr, want_aux = model.apply(variables, jnp.asarray(lr), jnp.asarray(prior), train=False)
    with torch.no_grad():
        got_sr, got_aux = port(_t(lr), _t(prior))
    np.testing.assert_allclose(got_sr.numpy(), np.asarray(want_sr), **TOL)
    np.testing.assert_allclose(
        got_aux["pr_weights"].numpy(), np.asarray(want_aux["pr_weights"]), **TOL
    )
    np.testing.assert_allclose(
        got_aux["trans_feat"].numpy(), np.asarray(want_aux["trans_feat"]), **TOL
    )


def test_crnn_matches():
    nm = (8, 8, 16, 16, 32, 32, 32)
    model = jcrnn.CRNN(nh=16, nm=nm)
    rng = np.random.default_rng(9)
    images = rng.uniform(0, 1, (3, 4, 16, 64)).astype(np.float32)
    luma = jcrnn.parse_crnn_input(jnp.asarray(images))
    variables = random_variables(model, rng, luma)
    want = np.asarray(model.apply(variables, luma, train=False))
    port = tcrnn.CRNN(nh=16, nm=nm).eval()
    port.load_state_dict(from_jax(variables))
    with torch.no_grad():
        got_luma = tcrnn.parse_crnn_input(_t(images))
        got = port(got_luma)
    np.testing.assert_allclose(got_luma.numpy(), np.asarray(luma), **TOL)
    assert got.shape == (26, 3, 37)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
