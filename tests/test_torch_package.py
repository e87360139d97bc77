"""Package rules of tatt_tpu_torch: imports, device policy, weight bridge
and the host-side copies (charset, metrics, collate)."""

import ast
import os
import pkgutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tatt_tpu_torch
from test_torch_models import random_variables

PKG_DIR = os.path.dirname(tatt_tpu_torch.__file__)
SUBMODULES = sorted(
    m.name for m in pkgutil.walk_packages([PKG_DIR], prefix="tatt_tpu_torch.")
)


def test_import_pulls_in_no_jax_or_jax_package():
    code = (
        "import importlib, sys\n"
        f"for m in {SUBMODULES!r}: importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'flax', 'tatt_tpu', 'cv2'))\n"
        "print(len(sys.modules)); assert not bad, bad\n"
    )
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=os.path.dirname(PKG_DIR), env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert res.returncode == 0, res.stderr
    assert len(SUBMODULES) >= 20
    zoo = ("esrgan", "han", "pcan", "resnets", "simple", "tbsrn", "transformer_sr")
    assert {f"tatt_tpu_torch.models.zoo.{m}" for m in zoo} <= set(SUBMODULES)


def test_sources_use_no_jax_library_rnn_compile_or_sdpa():
    banned_attrs = {"compile", "scaled_dot_product_attention", "GRU", "LSTM", "_VF"}
    for root, _, files in os.walk(PKG_DIR):
        for name in files:
            if not name.endswith(".py"):
                continue
            path = os.path.join(root, name)
            tree = ast.parse(open(path).read(), path)
            for node in ast.walk(tree):
                mods = []
                if isinstance(node, ast.Import):
                    mods = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.module:
                    mods = [node.module]
                for mod in mods:
                    # no OpenCV either: the card's machine has none (data/imgproc.py)
                    assert mod.split(".")[0] not in ("jax", "jaxlib", "flax", "tatt_tpu", "cv2"), (path, mod)
                if isinstance(node, ast.Attribute):
                    assert node.attr not in banned_attrs, (path, node.attr, node.lineno)


def test_entry_points_need_cuda_unless_told_cpu(monkeypatch):
    from tatt_tpu_torch.cli import main as cli
    from tatt_tpu_torch.core.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for dev in (None, "cuda", "cuda:0"):
        with pytest.raises(RuntimeError, match="CUDA"):
            resolve_device(dev)
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["--go_test", "--synthetic", "8", "--mask"])


def _roundtrip_check(original, imported):
    def flat(tree):
        return {
            jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]
        }

    want = flat(original)
    got = flat(imported)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_weight_bridge_round_trips_tatt():
    """A TATT(stn=True) in full, its STN head and BN statistics included:
    JAX variables -> from_jax -> the port's state_dict -> the JAX package's
    import_tatt gives the same variables back, bit for bit."""
    from tatt_tpu.core.torch_import import import_tatt
    from tatt_tpu.models.tsrn import TATT as JTATT
    from tatt_tpu_torch.core.convert import from_jax
    from tatt_tpu_torch.models.tsrn import TATT

    small = dict(srb_nums=2, hidden_units=4, out_text_channels=8)
    variables = random_variables(
        JTATT(stn=True, **small), np.random.default_rng(0),
        jnp.zeros((2, 4, 16, 64)), jnp.zeros((2, 37, 1, 26)), train=True,
    )
    sd = from_jax(variables)
    port = TATT(stn=True, **small)
    assert sorted(sd) == sorted(port.state_dict())  # exactly the port's keys
    port.load_state_dict(sd)
    assert any(k.startswith("stn_head.stn_fc2.") for k in sd)
    assert len(sd) > len(TATT(**small).state_dict())
    back = import_tatt({k: v.numpy() for k, v in port.state_dict().items()}, srb_nums=2)
    _roundtrip_check(variables, back)


def test_weight_bridge_round_trips_crnn_flat_and_nested():
    from tatt_tpu.core.torch_import import import_crnn
    from tatt_tpu.models.recognizers.crnn import CRNN as JCRNN
    from tatt_tpu_torch.core.convert import from_jax, load_npz

    nested = random_variables(
        JCRNN(nh=16, nm=(8, 8, 16, 16, 32, 32, 32)), np.random.default_rng(1),
        jnp.zeros((2, 1, 32, 100)),
    )
    back = import_crnn({k: v.numpy() for k, v in from_jax(nested).items()})
    _roundtrip_check(nested, back)
    flat, meta = load_npz(os.path.join(os.path.dirname(__file__), "assets", "fixture_crnn.npz"))
    assert int(meta["nh"]) == 64 and "params/conv0/kernel" in flat
    sd = from_jax(flat)
    back = import_crnn({k: v.numpy() for k, v in sd.items()})
    for key, value in flat.items():
        node = back
        for part in key.split("/"):
            node = node[part]
        np.testing.assert_array_equal(np.asarray(node), value, err_msg=key)


def test_reference_pth_loading(tmp_path):
    from tatt_tpu_torch.core.convert import load_reference_pth, load_weights
    from tatt_tpu_torch.models.common import init_parameters
    from tatt_tpu_torch.models.tsrn import TATT

    small = dict(srb_nums=1, hidden_units=4, out_text_channels=8)
    src = init_parameters(TATT(**small), 3)
    sd = {f"module.{k}": v for k, v in src.state_dict().items()}
    sd["module.stn_head.stn_fc2.weight"] = torch.zeros(40, 512)
    sd["module.block2.bn1.num_batches_tracked"] = torch.tensor(5)
    path = str(tmp_path / "model_best_acc_0.pth")
    torch.save({"state_dict_G": sd, "info": {"iters": 1}}, path)
    dst = init_parameters(TATT(**small), 4)
    unused = load_weights(dst, load_reference_pth(path))
    assert unused == ["block2.bn1.num_batches_tracked", "stn_head.stn_fc2.weight"]
    for k, v in src.state_dict().items():
        assert torch.equal(dst.state_dict()[k], v), k
    with pytest.raises(KeyError, match="lacks"):
        load_weights(init_parameters(TATT(srb_nums=2, hidden_units=4, out_text_channels=8), 0),
                     load_reference_pth(path))


def test_host_copies_match_the_jax_package():
    from tatt_tpu.core import charset as jcharset
    from tatt_tpu.data.collate import collate as jcollate
    from tatt_tpu.data.synthetic import SyntheticTextDataset as JSynthetic
    from tatt_tpu.train.metrics import EvalAccumulator as JAcc
    from tatt_tpu_torch.core import charset
    from tatt_tpu_torch.data.collate import collate
    from tatt_tpu_torch.data.device_pipeline import device_normalize, host_normalize_u8
    from tatt_tpu_torch.data.synthetic import SyntheticTextDataset
    from tatt_tpu_torch.train.metrics import EvalAccumulator

    rng = np.random.default_rng(2)
    logits = rng.standard_normal((26, 16, 37)).astype(np.float32)
    logits[:, :, 0] += 1.0  # plenty of blanks between repeats
    assert charset.ctc_greedy_decode(logits) == jcharset.ctc_greedy_decode(logits)
    assert charset.CRNN_ALPHABET == jcharset.CRNN_ALPHABET
    for a, b in (("kitten", "sitting"), ("", "abc"), ("Ab-3!", "ab3")):
        assert charset.levenshtein(a, b) == jcharset.levenshtein(a, b)
        assert charset.str_filt(a, "lower") == jcharset.str_filt(a, "lower")

    samples = [JSynthetic(n=6, seed=9)[i] for i in range(6)]
    ours = [SyntheticTextDataset(n=6, seed=9)[i] for i in range(6)]
    assert [s[2] for s in samples] == [s[2] for s in ours]
    ref = jcollate(samples, mask=True)
    b = collate(ours)
    for u8, want in ((b.images_hr, ref.images_hr), (b.images_lr, ref.images_lr)):
        np.testing.assert_array_equal(host_normalize_u8(u8, True), want)
        np.testing.assert_array_equal(device_normalize(torch.from_numpy(u8), True).numpy(), want)
        np.testing.assert_array_equal(
            device_normalize(torch.from_numpy(u8), False).numpy(), want[:, :3]
        )

    j, t = JAcc(), EvalAccumulator()
    for acc in (j, t):
        acc.add_batch(20.5, 0.7, ["ab", "c"], ["a", "c"], ["ab", "cd"], ["AB", "cd"],
                      psnr_lr=18.0, ssim_lr=0.6, n_real=2)
        acc.add_batch(21.5, 0.8, ["x"], ["y"], ["x"], ["x"], psnr_lr=19.0, ssim_lr=0.5, n_real=1)
    assert t.summary() == j.summary()
