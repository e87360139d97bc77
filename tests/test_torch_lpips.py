"""LPIPS-VGG and the perceptual loss of tatt_tpu_torch (CPU) against
tatt_tpu (JAX, CPU), with seeded weights (the real VGG16 and lpips heads
are the user's to supply): every VGG16 tap within 1e-5 (absolute, and
1e-4 relative), LPIPS within 1e-5 relative, ``import_lpips`` from a
torchvision-layout state dict (``features.<i>``, classifier entries
beside) and the lpips package's ``lin<i>.model.1.weight`` heads, and
``generator_loss`` / ``total_variation``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tatt_tpu.losses import perceptual as jp
from tatt_tpu_torch.losses import perceptual as tp

SHAPE = (2, 4, 32, 64)


@pytest.fixture(scope="module")
def weights():
    """A torchvision-layout VGG16 state dict and lpips heads, from numpy."""
    rng = np.random.default_rng(0)
    sd, cin, idx = {}, 3, 0
    for spec in tp.VGG16_PLAN:
        if spec == "M":
            idx += 1
            continue
        sd[f"features.{idx}.weight"] = torch.from_numpy(
            (rng.standard_normal((spec, cin, 3, 3)) * np.sqrt(2.0 / (9 * cin))).astype(np.float32))
        sd[f"features.{idx}.bias"] = torch.from_numpy(rng.normal(0, 0.05, spec).astype(np.float32))
        cin, idx = spec, idx + 2
    sd["classifier.0.weight"] = torch.zeros(4, 8)  # the rest of torchvision's vgg16
    chans = (64, 128, 256, 512, 512)
    lp = {f"lin{i}.model.1.weight": torch.from_numpy(
        np.abs(rng.normal(0, 0.1, (1, c, 1, 1))).astype(np.float32)) for i, c in enumerate(chans)}
    return sd, lp


def _images(seed):
    return np.random.default_rng(seed).uniform(0, 1, SHAPE).astype(np.float32)


def test_vgg16_taps_match(weights):
    sd, lp = weights
    vgg, _ = tp.import_lpips(sd, lp)
    j_vars, _ = jp.import_lpips({k: v.numpy() for k, v in sd.items()}, {k: v.numpy() for k, v in lp.items()})
    x = _images(1)[:, :3]
    want = jp.VGG16Features().apply(j_vars, jnp.asarray(x))
    with torch.no_grad():
        got = vgg(torch.from_numpy(x))
    assert sorted(got) == sorted(want) and max(got) == 30
    for k in want:
        w = np.asarray(want[k])
        np.testing.assert_allclose(got[k].numpy(), w, atol=1e-5 * max(1.0, np.abs(w).max()), rtol=1e-4,
                                   err_msg=str(k))


def test_lpips_matches(weights):
    sd, lp = weights
    vgg, lin = tp.import_lpips(sd, lp)
    j_vars, j_lin = jp.import_lpips({k: v.numpy() for k, v in sd.items()}, {k: v.numpy() for k, v in lp.items()})
    a, b = _images(2), _images(3)
    want = np.asarray(jax.jit(lambda x, y: jp.lpips_vgg(j_vars, j_lin, x, y))(jnp.asarray(a), jnp.asarray(b)))
    with torch.no_grad():
        got = tp.lpips_vgg(vgg, lin, torch.from_numpy(a), torch.from_numpy(b)).numpy()
        same = tp.lpips_vgg(vgg, lin, torch.from_numpy(a), torch.from_numpy(a)).numpy()
    assert got.shape == (2,) and (want > 0).all()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    np.testing.assert_allclose(same, 0.0, atol=1e-6)


def test_import_lpips_reads_files_and_features_only(tmp_path, weights):
    """Paths (read through ``load_reference_pth``) and a ``features``-only
    state dict give the same network."""
    sd, lp = weights
    vgg_path, lp_path = str(tmp_path / "vgg16.pth"), str(tmp_path / "vgg.pth")
    torch.save(sd, vgg_path)
    torch.save(lp, lp_path)
    vgg, lin = tp.import_lpips(vgg_path, lp_path)
    features = {k[len("features."):]: v for k, v in sd.items() if k.startswith("features.")}
    vgg2, lin2 = tp.import_lpips(features, lp)
    for k, v in vgg.state_dict().items():
        assert torch.equal(v, vgg2.state_dict()[k]) and torch.equal(v, sd[f"features.{k}"]), k
    assert all(torch.equal(x, y) for x, y in zip(lin, lin2)) and [w.shape[0] for w in lin] == [
        64, 128, 256, 512, 512]


def test_generator_loss_and_tv_match(weights):
    sd, lp = weights
    vgg, _ = tp.import_lpips(sd, lp)
    j_vars, _ = jp.import_lpips({k: v.numpy() for k, v in sd.items()}, {k: v.numpy() for k, v in lp.items()})
    a, b = _images(4), _images(5)
    with torch.no_grad():
        got_tv = tp.total_variation(torch.from_numpy(a)).item()
        got = tp.generator_loss(vgg, torch.from_numpy(a), torch.from_numpy(b)).item()
    np.testing.assert_allclose(got_tv, float(jp.total_variation(jnp.asarray(a))), rtol=1e-5)
    want = float(jax.jit(lambda x, y: jp.generator_loss(j_vars, x, y))(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(got, want, rtol=1e-5)
