"""The TSRN family of tatt_tpu_torch (CPU) against tatt_tpu (JAX, CPU).

Each generator and its new parts (InfoGen, SFTLayer,
ReasoningResidualBlock, ConvTranspose2d) run on the same seeded numpy
inputs with the same weights (``random_variables`` through ``from_jax``),
in training mode (batch statistics, the running statistics they fold, the
STN) and in eval mode; the five criteria and ``distorted_ssim`` on seeded
images; the weight bridge read back by the JAX package's own importer
helpers.  Tolerance atol 1e-5 / rtol 1e-4, the repo's module-level f32 one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_models import random_variables
from tatt_tpu.core import torch_import as jimport
from tatt_tpu.losses import image as jimage
from tatt_tpu.losses import ssim as jssim
from tatt_tpu.models import common as jcommon
from tatt_tpu.models import tsrn as jtsrn
from tatt_tpu_torch.core.convert import from_jax
from tatt_tpu_torch.losses import image as timage
from tatt_tpu_torch.losses import ssim as tssim
from tatt_tpu_torch.models import common as tcommon
from tatt_tpu_torch.models import tsrn as ttsrn

TOL = dict(atol=1e-5, rtol=1e-4)
TRUNK = dict(srb_nums=1, hidden_units=4)
# (JAX class, port class, extra constructor arguments, takes a prior, STN).
# The STN head and the TPS they share with TATT are held on their own in
# test_torch_train.py (the TPS at the JAX package's own looser tolerance), so
# only TSRN runs with its STN, and only in eval mode, where it is skipped
GENERATORS = {
    "TSRN": (jtsrn.TSRN, ttsrn.TSRN, {}, False, True),
    "TSRN_TL": (jtsrn.TSRN_TL, ttsrn.TSRN_TL, {"out_text_channels": 8}, True, False),
    "TSRN_TL_SFT": (jtsrn.TSRN_TL_SFT, ttsrn.TSRN_TL_SFT, {"out_text_channels": 8}, True, False),
    "TSRN_C2F": (jtsrn.TSRN_C2F, ttsrn.TSRN_C2F, {}, False, False),
    "SEM_TSRN": (jtsrn.SEM_TSRN, ttsrn.SEM_TSRN, {"word_vec_d": 12}, False, False),
    "TSRNEncoder": (jtsrn.TSRNEncoder, ttsrn.TSRNEncoder, {}, False, False),
}


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float32)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _leaves(out):
    """A model's outputs as a flat list of arrays (tuples, lists, aux dicts)."""
    if isinstance(out, dict):
        return [v for k in sorted(out) for v in _leaves(out[k])]
    if isinstance(out, (tuple, list)):
        return [v for o in out for v in _leaves(o)]
    return [np.asarray(out.detach() if torch.is_tensor(out) else out)]


@pytest.fixture(scope="module")
def generator_vars():
    """Seeded JAX variables of every generator at the small width."""
    out = {}
    for i, (name, (jcls, _, extra, prior, stn)) in enumerate(GENERATORS.items()):
        model = jcls(stn=stn, **TRUNK, **extra)
        args = [jnp.zeros((2, 4, 16, 64))] + ([jnp.zeros((2, 37, 1, 26))] if prior else [])
        out[name] = model, random_variables(model, np.random.default_rng(100 + i), *args, train=True)
    return out


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("name", list(GENERATORS))
def test_generator_matches(generator_vars, name, train):
    """Outputs (with the TL archs' aux features and C2F's coarse map, SEM's
    word vectors) and, in training mode, the folded running statistics."""
    jcls, pcls, extra, prior, stn = GENERATORS[name]
    model, variables = generator_vars[name]
    if stn and train:
        model, stn = model.clone(stn=False), False
        variables = {c: {k: v for k, v in variables[c].items() if k != "stn_head"} for c in variables}
    rng = np.random.default_rng(7)
    n = 3
    x = rng.uniform(0, 1, (n, 4, 16, 64)).astype(np.float32)
    t = rng.dirichlet(np.ones(37), (n, 26)).transpose(0, 2, 1)[:, :, None, :].astype(np.float32)
    args = [jnp.asarray(x)] + ([jnp.asarray(t)] if prior else [])
    port = pcls(stn=stn, **TRUNK, **extra)
    sd = from_jax(_np_tree(variables))
    assert sorted(sd) == sorted(port.state_dict())
    port.load_state_dict(sd)
    port.train(train)
    with torch.no_grad():
        got = port(*(_t(a) for a in args))
    if train:
        want, mut = model.apply(variables, *args, train=True, mutable=["batch_stats"])
        new_sd = from_jax(_np_tree({"params": variables["params"], "batch_stats": mut["batch_stats"]}))
        for key, value in port.state_dict().items():
            np.testing.assert_allclose(value.numpy(), new_sd[key].numpy(), err_msg=key, **TOL)
    else:
        want = model.apply(variables, *args, train=False)
    got_l, want_l = _leaves(got), _leaves(want)
    assert len(got_l) == len(want_l)
    for g, w in zip(got_l, want_l):
        np.testing.assert_allclose(g, w, **TOL)


@pytest.mark.parametrize("copies", [1, 2])
def test_tl_generators_take_per_copy_batchnorm(generator_vars, copies):
    """The fused-tssim 2B forward of the TL archs: ``copies`` per-copy
    statistics everywhere BatchNorm appears (InfoGen, the SRBs, post_bn),
    against JAX's ``bn_copies`` clone."""
    rng = np.random.default_rng(8)
    x = rng.uniform(0, 1, (4, 4, 16, 64)).astype(np.float32)
    t = rng.dirichlet(np.ones(37), (4, 26)).transpose(0, 2, 1)[:, :, None, :].astype(np.float32)
    for name in ("TSRN_TL", "TSRN_TL_SFT"):
        model, variables = generator_vars[name]
        want, mut = model.clone(bn_copies=copies).apply(
            variables, jnp.asarray(x), jnp.asarray(t), train=True, mutable=["batch_stats"])
        port = GENERATORS[name][1](**TRUNK, **GENERATORS[name][2])
        port.load_state_dict(from_jax(_np_tree(variables)))
        with torch.no_grad():
            got = port.train()(_t(x), _t(t), copies=copies)
        for g, w in zip(_leaves(got), _leaves(want)):
            np.testing.assert_allclose(g, w, **TOL)
        new_sd = from_jax(_np_tree({"params": variables["params"], "batch_stats": mut["batch_stats"]}))
        for key, value in port.state_dict().items():
            np.testing.assert_allclose(value.numpy(), new_sd[key].numpy(), err_msg=key, **TOL)


def test_parts_match(generator_vars):
    """InfoGen, SFTLayer and ReasoningResidualBlock, each taken out of a
    generator's variables, and ConvTranspose2d at InfoGen's geometries."""
    rng = np.random.default_rng(9)
    tl_model, tl_vars = generator_vars["TSRN_TL"]
    port = ttsrn.TSRN_TL(**TRUNK, out_text_channels=8)
    port.load_state_dict(from_jax(_np_tree(tl_vars)))
    t = rng.dirichlet(np.ones(37), (3, 26)).transpose(0, 2, 1)[:, :, None, :].astype(np.float32)
    sub = {c: tl_vars[c]["infoGen"] for c in tl_vars}
    for train in (False, True):  # eval first: training folds the running statistics
        want = jtsrn.InfoGen(8).apply(sub, jnp.asarray(t), train, mutable=["batch_stats"])[0]
        with torch.no_grad():
            got = port.infoGen.train(train)(_t(t))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

    _, sft_vars = generator_vars["TSRN_TL_SFT"]
    sft = ttsrn.TSRN_TL_SFT(**TRUNK, out_text_channels=8)
    sft.load_state_dict(from_jax(_np_tree(sft_vars)))
    fea = rng.standard_normal((3, 8, 16, 64)).astype(np.float32)
    cond = rng.standard_normal((3, 8, 16, 64)).astype(np.float32)
    want = jtsrn.SFTLayer().apply({"params": sft_vars["params"]["sft_layer"]},
                                  jnp.asarray(fea), jnp.asarray(cond))
    with torch.no_grad():
        got = sft.sft_layer(_t(fea), _t(cond))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

    _, sem_vars = generator_vars["SEM_TSRN"]
    sem = ttsrn.SEM_TSRN(**TRUNK, word_vec_d=12)
    sem.load_state_dict(from_jax(_np_tree(sem_vars)))
    x = rng.standard_normal((2, 8, 16, 64)).astype(np.float32)
    sub = {c: sem_vars[c]["srb2"] for c in sem_vars}
    for train in (False, True):  # eval first: training folds the running statistics
        want = jtsrn.ReasoningResidualBlock(8).apply(sub, jnp.asarray(x), train,
                                                     mutable=["batch_stats"])[0]
        with torch.no_grad():
            got = sem.block2.train(train)(_t(x))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

    for cin, cout, stride, pad in ((37, 16, (2, 2), (0, 0)), (6, 5, (2, 1), (1, 1))):
        y = rng.standard_normal((2, cin, 3, 7)).astype(np.float32)
        jct = jcommon.ConvTranspose2d(cout, (3, 3), strides=stride, padding=pad, use_bias=False)
        v = _np_tree(jct.init(jax.random.PRNGKey(cin), jnp.asarray(y)))
        ct = tcommon.ConvTranspose2d(cin, cout, (3, 3), stride, pad)
        ct.load_state_dict({"weight": _t(v["params"]["kernel"])})
        with torch.no_grad():
            np.testing.assert_allclose(ct(_t(y)).numpy(), np.asarray(jct.apply(v, jnp.asarray(y))), **TOL)


def test_criteria_and_distorted_ssim_match():
    """The five per-sample criteria of ``build_criterion`` and
    ``distorted_ssim``."""
    rng = np.random.default_rng(10)
    a = rng.uniform(0, 1, (3, 4, 32, 128)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    pairs = [
        (jimage.mse_loss, timage.mse_loss), (jimage.l1_loss, timage.l1_loss),
        (jimage.charbonnier_loss, timage.charbonnier_loss),
        (jimage.edge_image_loss, timage.edge_image_loss),
        (jimage.image_loss, timage.image_loss),
    ]
    for jfn, tfn in pairs:
        want = np.asarray(jfn(jnp.asarray(a), jnp.asarray(b)))
        got = tfn(_t(a), _t(b)).numpy()
        assert got.shape == (3,)
        np.testing.assert_allclose(got, want, err_msg=tfn.__name__, **TOL)
    want = float(jssim.distorted_ssim(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(tssim.distorted_ssim(_t(a), _t(b)).item(), want, **TOL)


def _import_generator(sd, name, srb):
    """The port's state_dict of a TSRN-family generator back into JAX
    variables with the JAX package's importer helpers: the trunk as
    ``import_tatt`` reads it, InfoGen as ``torch_import._infogen``, the
    port's own modules by their JAX names."""
    sd = {k: v.numpy() for k, v in sd.items()}
    params, stats = {}, {}

    def bn(ours, theirs, p=params, s=stats):
        p[ours], s[ours] = jimport._bn(sd, theirs)

    params["block1_conv"] = jimport._conv(sd, "block1.0")
    params["block1_act"] = {"alpha": sd["block1.1.weight"]}
    for i in range(srb):
        blk, bp, bs = f"block{i + 2}", {}, {}
        bp["conv1"], bp["conv2"] = jimport._conv(sd, f"{blk}.conv1"), jimport._conv(sd, f"{blk}.conv2")
        bn("bn1", f"{blk}.bn1", bp, bs)
        bn("bn2", f"{blk}.bn2", bp, bs)
        if name == "SEM_TSRN":
            bp["mask_multihead"] = {k: sd[f"{blk}.mask_multihead.{k}"]
                                    for k in ("in_proj_weight", "in_proj_bias")}
            bp["mask_multihead"]["out_proj_weight"] = sd[f"{blk}.mask_multihead.out_proj.weight"]
            bp["mask_multihead"]["out_proj_bias"] = sd[f"{blk}.mask_multihead.out_proj.bias"]
            for norm in ("norm1", "norm3"):
                bp[norm] = {k: sd[f"{blk}.{norm}.{k}"] for k in ("a_2", "b_2")}
            for d in ("pff_w1", "pff_w2"):
                bp[d] = jimport._linear(sd, f"{blk}.{d}")
        else:
            for g in ("gru1", "gru2"):
                bp[g] = {"conv1": jimport._conv(sd, f"{blk}.{g}.conv1"),
                         "gru": jimport._birnn(sd, f"{blk}.{g}.gru")}
        params[f"srb{i + 2}"], stats[f"srb{i + 2}"] = bp, bs
    params["post_conv"] = jimport._conv(sd, f"block{srb + 2}.0")
    bn("post_bn", f"block{srb + 2}.1")
    if name != "TSRNEncoder":
        n_up = len({k.split(".")[1] for k in sd if k.startswith(f"block{srb + 3}.")}) - 1
        for j in range(n_up):
            params[f"up{j}"] = {"conv": jimport._conv(sd, f"block{srb + 3}.{j}.conv")}
        params["final_conv"] = jimport._conv(sd, f"block{srb + 3}.{n_up}")
    if name in ("TSRN_TL", "TSRN_TL_SFT"):
        params["infoGen"], stats["infoGen"] = jimport._infogen(sd, "infoGen")
    if name == "TSRN_TL_SFT":
        params["sft_layer"] = {f"{b}{i}": jimport._conv(sd, f"sft_layer.{b}{i}")
                               for b in ("SFT_scale_conv", "SFT_shift_conv") for i in (0, 1)}
    if name == "TSRN_C2F":
        params["coarse_proj"] = jimport._conv(sd, "coarse_proj")
    if name == "SEM_TSRN":
        params["w2v_proj"] = jimport._linear(sd, "w2v_proj")
    if "stn_head.stn_fc2.weight" in sd:  # the STN head as import_tatt reads it
        stn_p, stn_s = {}, {}
        for i, bi in enumerate((0, 2, 4, 6, 8, 10)):
            stn_p[f"conv{i}"] = jimport._conv(sd, f"stn_head.stn_convnet.{bi}.0")
            bn(f"bn{i}", f"stn_head.stn_convnet.{bi}.1", stn_p, stn_s)
        stn_p["fc1"] = jimport._linear(sd, "stn_head.stn_fc1.0")
        bn("fc1_bn", "stn_head.stn_fc1.1", stn_p, stn_s)
        stn_p["fc2_kernel"] = sd["stn_head.stn_fc2.weight"].T
        stn_p["fc2_bias"] = sd["stn_head.stn_fc2.bias"]
        params["stn_head"], stats["stn_head"] = stn_p, stn_s
    return {"params": params, "batch_stats": {k: v for k, v in stats.items() if v}}


@pytest.mark.parametrize("name", list(GENERATORS))
def test_weight_bridge_round_trips(generator_vars, name):
    """JAX variables -> from_jax -> the port's state_dict -> the JAX
    package's importer helpers give the same variables back, bit for bit."""
    _, variables = generator_vars[name]
    sd = from_jax(_np_tree(variables))
    back = _import_generator(sd, name, TRUNK["srb_nums"])

    def flat(tree):
        return {jax.tree_util.keystr(p): np.asarray(v)
                for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}

    want, got = flat(_np_tree(variables)), flat(back)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
