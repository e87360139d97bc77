"""The ASTER and MORAN judges of tatt_tpu_torch (CPU) against tatt_tpu (JAX, CPU).

Module by module on the same numpy inputs with the same weights
(``random_variables`` at full width, converted by ``from_jax``): the GRU
step, the two-layer BiLSTM, ASTER's STN head, encoder, greedy decode (ids
identical, scores within 1e-5) and beam search (tensors and backtrack, at
``max_len`` 8), MORAN's MORN and its two decoders (logits within 1e-4,
argmax ids identical), the id decoders, and the weight bridge both ways.
"""

import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_models import random_variables
from tatt_tpu.core import charset as jcharset
from tatt_tpu.core.torch_import import import_aster, import_moran
from tatt_tpu.kernels import rnn as jrnn
from tatt_tpu.models import stn as jstn
from tatt_tpu.models.recognizers import aster as jaster
from tatt_tpu.models.recognizers import moran as jmoran
from tatt_tpu_torch.core import charset
from tatt_tpu_torch.core.convert import from_jax, load_reference_pth, load_weights
from tatt_tpu_torch.kernels import rnn as trnn
from tatt_tpu_torch.models import stn as tstn
from tatt_tpu_torch.models.recognizers import aster as taster
from tatt_tpu_torch.models.recognizers import moran as tmoran

TOL = dict(atol=1e-5, rtol=1e-4)
MAX_LEN = 8
INFO = jcharset.AsterInfo("all")


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float32)


def _on_device(variables):
    """numpy leaves -> jax arrays: the decoders index their embedding
    tables with traced ids (``torch_import.py:_to_device``)."""
    return jax.tree_util.tree_map(jnp.asarray, variables)


def _port(module, variables):
    module.load_state_dict(from_jax(variables))
    return module.eval()


@pytest.fixture(scope="module")
def aster_pair():
    model = jaster.AsterRecognizer(num_classes=INFO.rec_num_classes, max_len=MAX_LEN)
    variables = _on_device(random_variables(model, np.random.default_rng(3), jnp.zeros((2, 3, 32, 100))))
    return model, variables, _port(taster.AsterRecognizer(INFO.rec_num_classes, MAX_LEN), variables)


@pytest.fixture(scope="module")
def moran_pair():
    model = jmoran.MORAN()
    variables = _on_device(random_variables(model, np.random.default_rng(4), jnp.zeros((2, 1, 32, 100))))
    return model, variables, _port(tmoran.MORAN(), variables)


def _images(seed, n=3, w=128):
    return np.random.default_rng(seed).uniform(0, 1, (n, 4, 32, w)).astype(np.float32)


def test_gru_cell_matches():
    rng = np.random.default_rng(0)
    x, h = rng.standard_normal((5, 12)), rng.standard_normal((5, 7))
    w = [rng.standard_normal(s) * 0.3 for s in ((21, 12), (21, 7), (21,), (21,))]
    want = jrnn.gru_cell(*(jnp.asarray(a, jnp.float32) for a in (x, h, *w)))
    got = trnn.gru_cell(*(_t(a) for a in (x, h, *w)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_two_layer_bilstm_matches():
    model = jrnn.BiLSTM(hidden=6, num_layers=2)
    x = np.random.default_rng(1).standard_normal((3, 5, 10)).astype(np.float32)
    variables = random_variables(model, np.random.default_rng(2), jnp.zeros((3, 5, 10)))
    want = model.apply(variables, jnp.asarray(x))
    port = trnn.BiLSTM(10, 6, num_layers=2)
    names = {"w_ih": "weight_ih", "w_hh": "weight_hh", "b_ih": "bias_ih", "b_hh": "bias_hh"}
    sd = {}
    for leaf, value in variables["params"].items():
        base = f"{names[leaf[:4]]}_l{leaf[-1]}"
        sd[base], sd[f"{base}_reverse"] = _t(value[0]), _t(value[1])
    assert sorted(sd) == sorted(port.state_dict())  # torch's nn.LSTM names, layer 1 reads 2H
    port.load_state_dict(sd)
    with torch.no_grad():
        got = port(_t(x))
    assert got.shape == (3, 5, 12)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_aster_stn_head_matches(aster_pair):
    """The STN head's ``aster`` variant: five 2x2 pools on a 32x64 input."""
    model, variables, port = aster_pair
    x = np.random.default_rng(5).uniform(-1, 1, (2, 3, 32, 64)).astype(np.float32)
    want = model.apply(variables, jnp.asarray(x), method=lambda m, z: m.stn_head(z))
    with torch.no_grad():
        got = port.stn_head(_t(x))
    assert isinstance(port.stn_head, tstn.STNHead) and got.shape == (2, 20, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_aster_encoder_and_greedy_decode_match(aster_pair):
    model, variables, port = aster_pair
    x = jaster.parse_aster_input(jnp.asarray(_images(7)))
    feats = model.apply(variables, x, method=jaster.AsterRecognizer.encode)
    ids, scores = model.apply(variables, x)
    with torch.no_grad():
        tx = taster.parse_aster_input(torch.from_numpy(_images(7)))
        t_feats = port.encode(tx)
        t_ids, t_scores = port(tx)
    assert t_feats.shape == (3, 25, 512)
    np.testing.assert_allclose(t_feats.numpy(), np.asarray(feats), **TOL)
    np.testing.assert_array_equal(t_ids.numpy(), np.asarray(ids))
    np.testing.assert_allclose(t_scores.numpy(), np.asarray(scores), atol=1e-5)


def test_aster_beam_search_matches(aster_pair):
    model, variables, port = aster_pair
    x = jaster.parse_aster_input(jnp.asarray(_images(8, n=2)))
    want = model.apply(variables, x, 3, method=jaster.AsterRecognizer.beam_tensors)
    with torch.no_grad():
        got = port.beam_tensors(taster.parse_aster_input(torch.from_numpy(_images(8, n=2))), 3)
    for g, w in zip(got[:2], want[:2]):  # symbols, predecessors
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), atol=1e-4, rtol=1e-5)
    eos = INFO.char2id[INFO.EOS]
    seq = taster.beam_backtrack(*(t.numpy() for t in got), 2, 3, eos)
    np.testing.assert_array_equal(
        seq, jaster.beam_backtrack(*(np.asarray(t) for t in want), 2, 3, eos))
    # width 1 is the greedy decode
    with torch.no_grad():
        tx = taster.parse_aster_input(torch.from_numpy(_images(8, n=2)))
        one = port.beam_tensors(tx, 1)
        greedy, _ = port(tx)
    np.testing.assert_array_equal(
        taster.beam_backtrack(*(t.numpy() for t in one), 2, 1, eos), greedy.numpy())


def test_moran_matches(moran_pair):
    model, variables, port = moran_pair
    x = jmoran.parse_moran_input(jnp.asarray(_images(9)))
    l2r, r2l = model.apply(variables, x)
    rect = jmoran.MORN().apply({k: v["MORN"] for k, v in variables.items()}, x)
    with torch.no_grad():
        tx = tmoran.parse_moran_input(torch.from_numpy(_images(9)))
        np.testing.assert_allclose(tx.numpy(), np.asarray(x), **TOL)
        t_rect = port.MORN(tx)
        t_l2r, t_r2l = port(tx)
    np.testing.assert_allclose(t_rect.numpy(), np.asarray(rect), **TOL)
    for g, w in ((t_l2r, l2r), (t_r2l, r2l)):
        assert g.shape == (3, 20, 37)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4, rtol=1e-4)
        np.testing.assert_array_equal(g.argmax(-1).numpy(), np.asarray(w).argmax(-1))


def test_id_decoders_match():
    rng = np.random.default_rng(10)
    info = charset.AsterInfo("all")
    assert info.voc == INFO.voc and info.rec_num_classes == INFO.rec_num_classes
    ids = rng.integers(0, INFO.rec_num_classes, (64, 12))
    ids[::3, 4] = INFO.char2id["EOS"]
    assert charset.decode_aster_ids(ids, info) == jcharset.decode_aster_ids(ids, INFO)
    m_ids = rng.integers(0, 37, (64, 20))
    assert tmoran.decode_moran_ids(m_ids) == jmoran.decode_moran_ids(m_ids)
    for s in ("Ab-3!x", "", "ÉtÉ 12"):
        assert charset.normalize_text(s) == jcharset.normalize_text(s)
    for voc in ("digit", "lower", "upper", "all"):
        assert charset.voc_table(voc) == jcharset.voc_table(voc)


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("which", ["aster", "moran"])
def test_weight_bridge_round_trips(which, aster_pair, moran_pair):
    """JAX variables -> from_jax -> the port's state_dict (exactly its keys)
    -> the JAX package's importer gives the same variables back."""
    _, variables, port = aster_pair if which == "aster" else moran_pair
    importer = import_aster if which == "aster" else import_moran
    sd = from_jax(variables)
    assert sorted(sd) == sorted(port.state_dict())
    back = importer({k: v.numpy() for k, v in port.state_dict().items()})
    want, got = _leaves(variables), _leaves(back)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_pth_tar_wrapper_loads(tmp_path, moran_pair):
    """A reference-style ``.pth.tar`` (``state_dict`` with ``module.``
    prefixes beside pickled options, which ``weights_only`` refuses) loads
    as the JAX package loads it; an unreadable file names itself."""
    _, _, port = moran_pair
    path = str(tmp_path / "moran_demo.pth.tar")
    torch.save({"state_dict": {f"module.{k}": v for k, v in port.state_dict().items()},
                "epoch": 7, "options": argparse.Namespace(arch="MORAN")}, path)
    dst = tmoran.MORAN()
    assert load_weights(dst, load_reference_pth(path)) == []
    for k, v in port.state_dict().items():
        assert torch.equal(dst.state_dict()[k], v), k
    bad = tmp_path / "broken.pth"
    bad.write_bytes(b"PK\x03\x04 not a zip")
    with pytest.raises(ValueError, match="broken.pth"):
        load_reference_pth(str(bad))
