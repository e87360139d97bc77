"""Parity of the port's TPG recognizer (``--tpg OPT``,
``tatt_tpu_torch/models/recognizers/tpg.py``) against the JAX package's
(``tatt_tpu/models/recognizers/tpg.py``) on the CPU, at small widths.

Weights are drawn with numpy (``random_variables``) and carried over by
``from_jax``, strictly (every port entry from a JAX leaf, none left over).
Outputs and BatchNorm running statistics are held at the repo's module
tolerance, atol 1e-5 / rtol 1e-4, in eval and in train mode, for the three
feature extractors, GRCL, both sequence stages and both heads (the
attention head teacher-forced and greedy; its greedy ids equal), but for
the train-mode outputs (``TRAIN_TOL``, below).

The gradient of one SGD step's loss, ``sum(logits * w)``, is held against
``jax.grad`` for every parameter within 1e-4 of the model's largest entry,
with the port's CPU convolutions run without oneDNN (the port's code
chooses no convolution algorithm; on the card cuDNN runs them): in eval
mode the port's float32 backward (measured: within 2.6e-7), in train mode,
at 16 samples, its float64 one (within 7.1e-6).  Through train-mode
BatchNorm this random-weight net's gradient is ill-conditioned: there the
port's float32 gradients differ from its own float64 ones by up to 1.5e-2
of that entry (JAX's float32 ones from the port's float64 by 7.1e-6), and
oneDNN's float32 weight gradients of the narrow first convolutions by up
to 6e-3 in eval mode too.  No max-pool tie moves a gradient at these
inputs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_models import random_variables
from tatt_tpu.models.recognizers import tpg as jtpg
from tatt_tpu_torch.core.convert import from_jax
from tatt_tpu_torch.models.recognizers import tpg as ttpg

TOL = dict(atol=1e-5, rtol=1e-4)
# train-mode outputs: every BatchNorm normalizes with its batch's statistics
# (28 of them in the FAN ResNet, over 3 samples), which magnifies float32
# rounding: there the port's own float32 and float64 forwards differ by up
# to 2.9e-5 (JAX's float32 from the port's float64 by 5.1e-5) on outputs
# of order 2 (resnet-ctc); eval mode agrees within 6e-8
TRAIN_TOL = dict(atol=1e-4, rtol=1e-4)
GRAD_TOL = 1e-4  # of the model's largest gradient entry (module docstring)
ATTN_STEPS = 8  # the attention head's batch_max_length here (25 in the reference)


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float32)


def _luma(rng, n=2, width=64):
    return rng.uniform(0, 1, (n, 1, 32, width)).astype(np.float32)


def _pair(rng, x, **kw):
    """A JAX ``TPGModel(**kw)``, its variables and the port's model
    loaded from them."""
    model = jtpg.TPGModel(**kw)
    init_kw = {}
    if kw.get("prediction") == "Attn":
        init_kw = dict(train=True, text=jnp.zeros((x.shape[0], 26), jnp.int32))
    variables = random_variables(model, rng, jnp.asarray(x), **init_kw)
    port = ttpg.TPGModel(**kw)
    port.load_state_dict(from_jax(variables))
    return model, variables, port


def _assert_stats_match(port, new_stats):
    """The port's BN running statistics against JAX's updated batch_stats."""
    want = from_jax({"batch_stats": jax.tree_util.tree_map(np.asarray, new_stats)})
    own = port.state_dict()
    assert want and set(want) <= set(own)
    for name, value in want.items():
        np.testing.assert_allclose(own[name].numpy(), value.numpy(), **TOL, err_msg=name)


# (feature extractor, sequence stage, head, output_channel, width)
CASES = {
    "resnet-ctc": ("ResNet", "None", "CTC", 64, 64),
    "vgg-bilstm-ctc": ("VGG", "BiLSTM", "CTC", 64, 100),
    "rcnn-ctc": ("RCNN", "None", "CTC", 32, 100),
    "vgg-attn": ("VGG", "None", "Attn", 64, 100),
    "resnet-bilstm-attn": ("ResNet", "BiLSTM", "Attn", 32, 64),
}


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_tpg_matches(case, train):
    fe, seq, pred, oc, width = CASES[case]
    rng = np.random.default_rng(7)
    x = _luma(rng, 3, width)
    kw = dict(num_class=38 if pred == "Attn" else 37, feature_extraction=fe,
              sequence_modeling=seq, prediction=pred, output_channel=oc, hidden_size=16)
    model, variables, port = _pair(rng, x, **kw)
    text = rng.integers(0, kw["num_class"], (3, ATTN_STEPS + 1)).astype(np.int32)
    jkw = dict(text=jnp.asarray(text), batch_max_length=ATTN_STEPS) if pred == "Attn" else {}
    if train:
        want, new = model.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"],
                                **jkw)
    else:
        want = model.apply(variables, jnp.asarray(x), train=False, **jkw)
    port.train(train)
    with torch.no_grad():
        got = (port(_t(x), torch.from_numpy(text).long(), ATTN_STEPS) if pred == "Attn"
               else port(_t(x)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **(TRAIN_TOL if train else TOL))
    if train:
        _assert_stats_match(port, new["batch_stats"])
    if pred == "Attn" and not train:  # greedy: the argmax fed back is the same
        np.testing.assert_array_equal(got.numpy().argmax(-1), np.asarray(want).argmax(-1))


def test_attention_head_greedy_without_text_in_train_mode():
    """A student run in train mode without ``text`` decodes greedily, as
    JAX's head does when it is passed no text."""
    rng = np.random.default_rng(3)
    x = _luma(rng, 2, 100)
    model, variables, port = _pair(rng, x, num_class=12, feature_extraction="VGG",
                                   prediction="Attn", output_channel=32, hidden_size=16)
    feats = jtpg.VGGFeatureExtractor(32).apply({"params": variables["params"]["FeatureExtraction"],
                                                "batch_stats": variables["batch_stats"]
                                                ["FeatureExtraction"]}, jnp.asarray(x))
    seq = feats.mean(axis=2).transpose(0, 2, 1)
    head = jtpg.AttentionHead(16, 12)
    want = head.apply({"params": variables["params"]["Prediction"]}, seq, text=None,
                      batch_max_length=10)
    port.train(True)
    with torch.no_grad():
        got = port.Prediction(_t(seq), None, batch_max_length=10)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_array_equal(got.numpy().argmax(-1), np.asarray(want).argmax(-1))


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_grcl_matches(train):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 6, 8, 12)).astype(np.float32)
    model = jtpg.GRCL(10)
    variables = random_variables(model, rng, jnp.asarray(x))
    port = ttpg.GRCL(6, 10)
    port.load_state_dict(_grcl_state(variables))
    if train:
        want, new = model.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
    else:
        want = model.apply(variables, jnp.asarray(x), train=False)
    port.train(train)
    with torch.no_grad():
        got = port(_t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if train:
        want_stats = _grcl_state({"params": variables["params"], "batch_stats": new["batch_stats"]})
        for name, value in want_stats.items():
            if "running" in name:
                np.testing.assert_allclose(port.state_dict()[name].numpy(), value.numpy(), **TOL)


def _grcl_state(variables):
    """A bare GRCL's variables through ``from_jax`` (nested under a TPG's
    ``FeatureExtraction``, which the TPG layout is recognized by)."""
    sd = from_jax({"params": {"FeatureExtraction": variables["params"]},
                   "batch_stats": {"FeatureExtraction": variables["batch_stats"]}})
    return {k[len("FeatureExtraction."):]: v for k, v in sd.items()}


def test_parse_opt_input_matches():
    rng = np.random.default_rng(2)
    images = rng.uniform(0, 1, (2, 4, 16, 64)).astype(np.float32)
    want = jtpg.parse_opt_input(jnp.asarray(images))
    got = ttpg.parse_opt_input(_t(images))
    assert got.shape == (2, 1, 32, 512)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_fan_resnet_maps_512_columns_to_129_steps():
    """The shipped TPG's geometry at 32x512 and 3965 classes (T = 129),
    at a narrow width: logits against JAX in eval mode."""
    rng = np.random.default_rng(4)
    x = _luma(rng, 1, 512)
    model, variables, port = _pair(rng, x, num_class=3965, output_channel=32)
    want = model.apply(variables, jnp.asarray(x), train=False)
    with torch.no_grad():
        got = port.eval()(_t(x))
    assert got.shape == (129, 1, 3965)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("mode", ["eval-float32", "train-float64"])
@pytest.mark.parametrize("seq", ["None", "BiLSTM"])
def test_sgd_step_gradients_match_jax_grad(seq, mode):
    """The gradient of ``sum(logits * w)`` for every parameter against
    ``jax.grad`` (module docstring): in eval mode the port's float32
    backward; in train mode (BatchNorm over the batch's statistics, 16
    samples) the port's float64 one."""
    train = mode.startswith("train")
    dtype = torch.float64 if train else torch.float32
    rng = np.random.default_rng(11)
    n = 16 if train else 4
    x = _luma(rng, n, 64)
    kw = dict(num_class=37, output_channel=32, sequence_modeling=seq, hidden_size=16)
    model, variables, port = _pair(rng, x, **kw)
    w = rng.standard_normal((17, n, 37)).astype(np.float32)

    def loss(params):
        out = model.apply({"params": params, "batch_stats": variables["batch_stats"]},
                          jnp.asarray(x), train=train, mutable=["batch_stats"] if train else False)
        return ((out[0] if train else out) * w).sum()

    want = from_jax({"params": jax.tree_util.tree_map(
        np.asarray, jax.jit(jax.grad(loss))(variables["params"]))})
    port = port.to(dtype).train(train)
    with torch.backends.mkldnn.flags(enabled=False):
        (port(_t(x).to(dtype)) * _t(w).to(dtype)).sum().backward()
    got = {k: p.grad.float() for k, p in port.named_parameters()}
    assert sorted(got) == sorted(want)
    scale = max(float(np.abs(g.numpy()).max()) for g in want.values())
    for name, g in want.items():
        err = float(np.abs(got[name].numpy() - g.numpy()).max())
        assert err <= GRAD_TOL * scale, (name, err, scale)
