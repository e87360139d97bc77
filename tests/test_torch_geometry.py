"""The YAML's geometry (``TRAIN.width``, ``TRAIN.height``,
``TRAIN.down_sample_scale``) in the port (CPU) against the JAX package
(CPU), at two geometries besides the default 128x32 at scale 2: 256x64 at
scale 2 (LR 32x128) and 128x32 at scale 4 (LR 8x32); small widths.

- The collate: uint8 HR / LR crops (normalized as the card does), the
  ``YCbCr`` crops and the label fields equal JAX's ``collate`` at each
  geometry; under ``--syn`` the HR / LR crops equal and the pseudo-LR
  crops within 1 level on at most 1e-3 of the values (the blur ensemble's
  ``bilateral_filter`` and float32 ``gaussian_blur`` differences from
  OpenCV, ROADMAP C.3; measured 0 here).  The train loader collates no
  pseudo-LR crops, and every other field is unchanged by that.
- The factory: every arch of the JAX factory but ``bicubic``, built at
  full width with ``--STN --mask`` at each geometry, has the
  ``state_dict`` that ``from_jax`` gives for the JAX model's variables
  (the STN head's fc1 reads 2048 inputs at LR 32x128 and none at 8x32).
- Every arch choice of the JAX CLI that JAX runs at a geometry: one
  eval-mode forward at small widths on converted weights matches JAX's
  (output and every ``aux`` entry within atol 1e-5 / rtol 1e-4).
- Steps, against the JAX package from the same weights and batch (SGD at
  lr 1, rotation pinned, dropout off; ``test_torch_flags.
  assert_steps_match``: metrics rtol 1e-5 but ``gnorm/stn_head`` 2e-2 and
  ``grad_norm_sr`` 1e-4, every gradient leaf within 1e-4 of its model's
  largest entry, the STN head's 1e-3, the student's conv stack 1e-3, the
  updated parameters and BatchNorm statistics rtol 1e-4): the recipe's
  TATT step (``--STN``, fused tssim) and ``tsrn``'s plain step at 256x64;
  the recipe's TATT step without ``--STN`` at scale 4; the bf16 recipe
  step at 256x64 held as ``tests/test_torch_bf16_step.py`` holds it.
- ``Evaluator`` against JAX ``Trainer.evaluate`` at 256x64: PSNR within
  0.01 dB, SSIM within 1e-3, identical strings.
- The CLI trains at 256x64 (the recipe, and ``--CHNSR --tpg OPT`` with
  ``tsrn_tl_cascade``, which the JAX CLI runs too), and refuses what the
  JAX package cannot run there, with its reason: ``pcan`` / ``pcan_tl``
  at scale 4 (JAX raises on HOTA's empty pooled map) and ``--STN``
  training at scale 4 (JAX's step gives NaN gradients).
"""

import math
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_bf16_step import GRAD_TOL as BF16_GRAD_TOL
from test_torch_bf16_step import LOSS_RTOL as BF16_LOSS_RTOL
from test_torch_bf16_step import LOSSES as BF16_LOSSES
from test_torch_flags import TINY_CRNN, assert_steps_match
from test_torch_models import random_variables
from tatt_tpu.core.config import Config as JConfig
from tatt_tpu.core.config import Flags as JFlags
from tatt_tpu.data.collate import collate as jcollate
from tatt_tpu.data.synthetic import SyntheticTextDataset as JSynthetic
from tatt_tpu.losses.image import image_loss as jimage_loss
from tatt_tpu.models import factory as jfactory
from tatt_tpu.models import stn as jstn
from tatt_tpu.models import tsrn as jtsrn
from tatt_tpu.models.recognizers.crnn import CRNN as JCRNN
from tatt_tpu.models.zoo import esrgan as jesrgan
from tatt_tpu.models.zoo import han as jhan
from tatt_tpu.models.zoo import pcan as jpcan
from tatt_tpu.models.zoo import resnets as jresnets
from tatt_tpu.models.zoo import simple as jsimple
from tatt_tpu.models.zoo import tbsrn as jtbsrn
from tatt_tpu.train.state import TrainState
from tatt_tpu.train.steps import StepConfig as JStepConfig
from tatt_tpu.train.steps import make_plain_train_step, make_train_step
from tatt_tpu_torch.cli import main as cli
from tatt_tpu_torch.core.config import Config, Flags
from tatt_tpu_torch.core.convert import from_jax
from tatt_tpu_torch.data.collate import collate
from tatt_tpu_torch.data.device_pipeline import host_normalize_u8
from tatt_tpu_torch.data.loader import DataLoader
from tatt_tpu_torch.data.lmdb_dataset import sample_key
from tatt_tpu_torch.data.synthetic import SyntheticTextDataset
from tatt_tpu_torch.losses.image import image_loss
from tatt_tpu_torch.models import factory
from tatt_tpu_torch.models import tsrn as ttsrn
from tatt_tpu_torch.models.recognizers.crnn import CRNN
from tatt_tpu_torch.models.zoo import esrgan, han, pcan, resnets, simple, tbsrn
from tatt_tpu_torch.train.loop import Evaluator
from tatt_tpu_torch.train.steps import StepConfig, plain_train_step, train_step

GEOMETRIES = {"256x64": dict(width=256, height=64, down_sample_scale=2),
              "scale4": dict(width=128, height=32, down_sample_scale=4)}
TOL = dict(atol=1e-5, rtol=1e-4)
SMALL = dict(srb_nums=1, hidden_units=4)
SHRUNK = ["--srb", "1", "--hd_u", "4", "--tiny_tpg", "--batch_size", "4", "--device", "cpu",
          "--log_dir", ""]
RECIPE = ["--arch=tatt", "--STN", "--mask", "--use_distill", "--gradient", "--sr_share",
          "--stu_iter=1", "--rotate_train=5.0", "--tssim_loss"]
PSEUDO_LR_SHARE = 1e-3  # module docstring


def _lr_hw(geo: dict) -> tuple[int, int]:
    return geo["height"] // geo["down_sample_scale"], geo["width"] // geo["down_sample_scale"]


def _model_geo(geo: dict) -> dict:
    """A JAX / port generator's geometry arguments."""
    return dict(scale_factor=geo["down_sample_scale"], width=geo["width"], height=geo["height"])


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _yaml(tmp_path, geo: dict, name: str = "geo.yaml") -> str:
    path = tmp_path / name
    path.write_text("TRAIN:\n" + "".join(f"  {k}: {v}\n" for k, v in geo.items())
                    + "  VAL:\n    crnn_pretrained: ''\n")
    return str(path)


# ---------------------------------------------------------------- collate
@pytest.mark.parametrize("geo", list(GEOMETRIES))
def test_collate_matches_jax_at_geometry(geo):
    g = GEOMETRIES[geo]
    ds = SyntheticTextDataset(n=6, seed=5)
    samples = [ds[i] for i in range(6)]
    ours, theirs = collate(samples, y_domain=True, **g), jcollate(samples, y_domain=True, **g)
    h, w = _lr_hw(g)
    assert ours.images_hr.shape == (6, g["height"], g["width"], 3)
    assert ours.images_lr.shape == (6, h, w, 3) and ours.images_lr.dtype == np.uint8
    for name in ("images_hr", "images_lr", "images_hr_y", "images_lr_y"):
        np.testing.assert_array_equal(host_normalize_u8(getattr(ours, name), True),
                                      getattr(theirs, name), err_msg=name)
    for name in ("label_vecs", "ctc_ids", "ctc_targets", "ctc_lengths", "weighted_tics"):
        np.testing.assert_array_equal(getattr(ours, name), getattr(theirs, name), err_msg=name)
    for seed in (11, 29):
        ours, theirs = (collate(samples, syn=True, seed=seed, **g),
                        jcollate(samples, syn=True, seed=seed, **g))
        for name in ("images_hr", "images_lr"):
            np.testing.assert_array_equal(host_normalize_u8(getattr(ours, name), True),
                                          getattr(theirs, name), err_msg=name)
        assert ours.images_pseudo_lr.shape == (6, h, w, 3)
        got = host_normalize_u8(ours.images_pseudo_lr, False) * 255.0
        gap = np.abs(got - theirs.images_pseudo_lr[:, :3] * 255.0)
        assert gap.max() <= 1.0 + 1e-3 and (gap > 0.5).mean() <= PSEUDO_LR_SHARE, (seed, gap.max())


def test_train_loader_skips_pseudo_lr_and_nothing_else():
    """``--syn``'s pseudo-LR crops draw only from their own stream: the
    train loader's batches (none) equal the collate's with them, field by
    field, at the default geometry and at 256x64."""
    ds = SyntheticTextDataset(n=8, seed=5)
    for g in ({}, GEOMETRIES["256x64"]):
        loader = DataLoader(ds, 4, seed=7, syn=True, **g)
        for b, batch in enumerate(loader):
            sel = np.random.default_rng(7).permutation(8)[4 * b: 4 * (b + 1)]
            full = collate([ds[int(i)] for i in sel], syn=True, seed=sample_key(7, 0, b), **g)
            assert batch.images_pseudo_lr is None and full.images_pseudo_lr is not None
            for name in ("images_hr", "images_lr", "label_vecs", "ctc_ids", "ctc_targets",
                         "ctc_lengths", "weighted_tics"):
                np.testing.assert_array_equal(getattr(batch, name), getattr(full, name),
                                              err_msg=name)
            assert batch.label_strs == full.label_strs


# ---------------------------------------------------------------- factory
@pytest.mark.parametrize("geo", list(GEOMETRIES))
def test_factory_builds_every_jax_arch_at_geometry(geo):
    g = GEOMETRIES[geo]
    lr = jnp.zeros((2, 4, *_lr_hw(g)))
    for arch in factory.available_archs():
        # tranSR_v4 (no CLI choice) runs only at a 16-row LR crop in JAX too:
        # its d_model 1024 is 64 channels x 16 rows (transformer_sr.py:47)
        skip = arch == "tranSR_v4" and _lr_hw(g)[0] != 16 or (arch, geo) in JAX_FAILS
        if arch == "bicubic" or skip:
            continue
        cfg = Config(args=Flags(arch=arch, mask=True, STN=True))
        jcfg = JConfig(args=JFlags(arch=arch, mask=True, STN=True))
        for c in (cfg, jcfg):
            c.TRAIN.width, c.TRAIN.height, c.TRAIN.down_sample_scale = (
                g["width"], g["height"], g["down_sample_scale"])
        jmodel = jfactory.build_generator(arch, jcfg)
        args = (lr[:, :3] if arch in factory.THREE_CHANNEL_ARCHS else lr,)
        if arch in factory.ABLATION_SET:
            args += (jnp.zeros((2, 37, 1, 26)),)
        shapes = jax.eval_shape(lambda k: jmodel.init(k, *args, train=True),  # noqa: B023
                                jax.random.PRNGKey(0))
        zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)
        want = {k: tuple(v.shape) for k, v in from_jax(zeros, arch).items()}
        port = factory.build_generator(arch, cfg)
        assert {k: tuple(v.shape) for k, v in port.state_dict().items()} == want, arch


# ------------------------------------------------- a forward of every arch
def _forward_cases():
    """arch -> (JAX module, port module, channels, text prior?) at small
    widths, built for geometry ``g``."""
    def cases(g):
        s, hw = g["down_sample_scale"], dict(height=g["height"], width=g["width"])
        geo = _model_geo(g)
        return {
            "tatt": (jtsrn.TATT(**SMALL, **geo, out_text_channels=8, dropout=0.0),
                     ttsrn.TATT(**SMALL, **geo, out_text_channels=8, dropout=0.0), 4, True),
            "tsrn": (jtsrn.TSRN(**SMALL, **geo), ttsrn.TSRN(**SMALL, **geo), 4, False),
            "sem_tsrn": (jtsrn.SEM_TSRN(**SMALL, scale_factor=s, word_vec_d=12),
                         ttsrn.SEM_TSRN(**SMALL, **geo, word_vec_d=12), 4, False),
            "tsrn_c2f": (jtsrn.TSRN_C2F(**SMALL, scale_factor=s),
                         ttsrn.TSRN_C2F(**SMALL, **geo), 4, False),
            "tsrn_tl_cascade": (jtsrn.TSRN_TL(**SMALL, **geo, out_text_channels=8),
                                ttsrn.TSRN_TL(**SMALL, **geo, out_text_channels=8), 4, True),
            "tsrn_tl_cascade_sft": (jtsrn.TSRN_TL_SFT(**SMALL, **geo, out_text_channels=8),
                                    ttsrn.TSRN_TL_SFT(**SMALL, **geo, out_text_channels=8), 4,
                                    True),
            "srcnn": (jsimple.SRCNN(scale_factor=s), simple.SRCNN(scale_factor=s), 3, False),
            "srcnn_tl": (jsimple.SRCNN_TL(scale_factor=s, **hw),
                         simple.SRCNN_TL(scale_factor=s, **hw), 4, True),
            "vdsr": (jsimple.VDSR(scale_factor=s, num_blocks=2),
                     simple.VDSR(scale_factor=s, num_blocks=2), 3, False),
            "vdsr_tl": (jsimple.VDSR_TL(scale_factor=s, num_blocks=2, **hw),
                        simple.VDSR_TL(scale_factor=s, num_blocks=2, **hw), 4, True),
            "srres": (jresnets.SRResNet(scale_factor=s, mask=True),
                      resnets.SRResNet(scale_factor=s, mask=True), 4, False),
            "srresnet_tl": (jresnets.SRResNet_TL(scale_factor=s, mask=True, dropout=0.0, **hw),
                            resnets.SRResNet_TL(scale_factor=s, mask=True, dropout=0.0, **hw), 4,
                            True),
            "edsr": (jresnets.EDSR(scale_factor=s, num_blocks=2),
                     resnets.EDSR(scale_factor=s, num_blocks=2), 3, False),
            "rdn": (jresnets.RDN(scale_factor=s, n_feat=16), resnets.RDN(scale_factor=s, n_feat=16),
                    3, False),
            "rdn_tl": (jresnets.RDN_TL(scale_factor=s, n_feat=16),
                       resnets.RDN_TL(scale_factor=s, n_feat=16), 4, True),
            "lapsrn": (jresnets.LapSRN(scale_factor=s), resnets.LapSRN(scale_factor=s), 3, False),
            "esrgan": (jesrgan.RRDBNet(scale_factor=s, nb=2), esrgan.RRDBNet(scale_factor=s, nb=2),
                       4, False),
            "esrgan_tl": (jesrgan.RRDBNet_TL(scale_factor=s, nb=2),
                          esrgan.RRDBNet_TL(scale_factor=s, nb=2), 4, True),
            "scgan": (jsimple.SCGAN(scale_factor=s), simple.SCGAN(scale_factor=s), 4, False),
            "scgan_tl": (jsimple.SCGAN_TL(scale_factor=s, **hw),
                         simple.SCGAN_TL(scale_factor=s, **hw), 4, True),
            "han": (jhan.HAN(scale=s, n_resgroups=2, n_resblocks=2, n_feats=16),
                    han.HAN(scale=s, n_resgroups=2, n_resblocks=2, n_feats=16), 3, False),
            "pcan": (jpcan.PCAN(scale_factor=s, srb_nums=2, hidden_units=4),
                     pcan.PCAN(scale_factor=s, srb_nums=2, hidden_units=4), 4, False),
            "pcan_tl": (jpcan.PCAN_TL(scale_factor=s, srb_nums=2, hidden_units=4,
                                      out_text_channels=8),
                        pcan.PCAN_TL(scale_factor=s, srb_nums=2, hidden_units=4,
                                     out_text_channels=8), 4, True),
            "tbsrn": (jtbsrn.TBSRN(scale_factor=s, **SMALL, mask=True),
                      tbsrn.TBSRN(scale_factor=s, **SMALL, mask=True, dropout=0.0), 4, False),
            "tbsrn_tl": (jtbsrn.TBSRN_TL(scale_factor=s, **SMALL, mask=True, out_text_channels=8),
                         tbsrn.TBSRN_TL(scale_factor=s, **SMALL, mask=True, out_text_channels=8,
                                        dropout=0.0), 4, True),
        }
    return cases


FORWARD_CASES = _forward_cases()
# what the JAX package cannot run (the CLI's refusals): pcan's HOTA at LR 8x32
JAX_FAILS = {("pcan", "scale4"), ("pcan_tl", "scale4")}


@pytest.mark.parametrize("geo", list(GEOMETRIES))
@pytest.mark.parametrize("arch", [a for a in cli.ARCHS if a != "bicubic"])
def test_forward_matches_jax_at_geometry(arch, geo):
    if (arch, geo) in JAX_FAILS:  # held by test_cli_refuses_what_jax_cannot_run_there
        return
    g = GEOMETRIES[geo]
    jmodel, port, channels, tl = FORWARD_CASES(g)[arch]
    rng = np.random.default_rng(sum(map(ord, arch + geo)))
    x = rng.random((2, channels, *_lr_hw(g)), dtype=np.float32)
    t = rng.random((2, 37, 1, 26), dtype=np.float32)
    t /= t.sum(axis=1, keepdims=True)
    args = (x, t) if tl else (x,)
    variables = _host(random_variables(jmodel, rng, *map(jnp.zeros_like, args), train=True))
    port.load_state_dict(from_jax(variables, arch))
    port.eval()
    kwargs = {"deterministic": True} if isinstance(jmodel, (jtbsrn.TBSRN, jtbsrn.TBSRN_TL)) else {}
    want = jmodel.apply(variables, *map(jnp.asarray, args), train=False, **kwargs)
    with torch.no_grad():
        got = port(*map(torch.from_numpy, args))
    if tl:
        (want, want_aux), (got, got_aux) = want, got
        assert sorted(got_aux) == sorted(want_aux)
        for key, value in want_aux.items():
            np.testing.assert_allclose(got_aux[key].numpy(), np.asarray(value), **TOL, err_msg=key)
    elif isinstance(want, tuple):  # tsrn_c2f, sem_tsrn: (out, extra)
        want, got = want[0], got[0]
    assert got.shape == (2, channels, g["height"], g["width"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ------------------------------------------------------------------ steps
def _batch(g: dict, seed: int = 3, n: int = 8) -> dict:
    ds = JSynthetic(n=n, seed=seed)
    arrays = jcollate([ds[i] for i in range(n)], **g).device_arrays()
    rng = np.random.default_rng(seed)
    return {"images_hr": np.asarray(arrays["images_hr"]),
            "images_lr": np.asarray(arrays["images_lr"]),
            "rot_arc": (rng.uniform(-1, 1, n) * 5.0 / 180.0 * math.pi).astype(np.float32),
            "rot_offs": rng.uniform(0, 1, n).astype(np.float32)}


def _tatt_variables(jmodel, g, seed, prior=True):
    """(generator, student CRNN, teacher CRNN) variables; the generator's
    with a text prior unless ``prior`` is off."""
    rng = np.random.default_rng(seed)
    args = (jnp.zeros((2, 4, *_lr_hw(g))),) + ((jnp.zeros((2, 37, 1, 26)),) if prior else ())
    sr = _host(random_variables(jmodel, rng, *args, train=True))
    if "stn_head" in sr["params"]:  # near its identity border grid, as its init starts it
        stn = sr["params"]["stn_head"]
        stn["fc2_kernel"] = stn["fc2_kernel"] * 0.1
        stn["fc2_bias"] = (jstn.build_output_control_points(20, (0.01, 0.01)).reshape(-1)
                           + rng.normal(0, 0.01, 40)).astype(np.float32)
    luma = jnp.zeros((2, 1, 32, 100))
    stu, teacher = (_host(random_variables(JCRNN(**TINY_CRNN), rng, luma)) for _ in range(2))
    return sr, stu, teacher


def _jax_tatt_step(jmodel, sr, stu, teacher, batch, compute_dtype="float32"):
    crnn = JCRNN(**TINY_CRNN)

    def apply(model):
        return lambda v, lr, prior, train, rngs=None, mutable=False: model.apply(
            v, lr, prior, train=train, rngs=rngs, mutable=mutable)

    def crnn_apply(variables, luma, train, mutable=False):
        return crnn.apply(variables, luma, train=train, mutable=mutable)

    step = jax.jit(make_train_step(apply(jmodel), crnn_apply, crnn_apply,
                                   JStepConfig(compute_dtype=compute_dtype),
                                   sr_apply_fused=apply(jmodel.clone(bn_copies=2))))
    state = TrainState.create([sr], [stu], optax.sgd(1.0))
    new, metrics = step(state, teacher, {k: jnp.asarray(v) for k, v in batch.items()},
                        jax.random.PRNGKey(0))
    return _results(state, new, metrics)


def _results(state, new, metrics):
    grads = {part: [from_jax({"params": jax.tree_util.tree_map(
        lambda a, b: np.asarray(a) - np.asarray(b), getattr(state, f"{part}_params")[0],
        getattr(new, f"{part}_params")[0])})] for part in ("sr", "student")}
    states = {part: [from_jax(_host({"params": getattr(new, f"{part}_params")[0],
                                     "batch_stats": getattr(new, f"{part}_batch_stats")[0]}))]
              for part in ("sr", "student")}
    return {k: float(v) for k, v in metrics.items()}, grads, states


def _port_tatt_step(port_cls, sr, stu, teacher_vars, batch, compute_dtype="float32"):
    generator, student, teacher = port_cls(), CRNN(**TINY_CRNN), CRNN(**TINY_CRNN)
    for model, variables in ((generator, sr), (student, stu), (teacher, teacher_vars)):
        model.load_state_dict(from_jax(variables))
    opt = torch.optim.SGD([*generator.parameters(), *student.parameters()], lr=1.0)
    metrics = train_step([generator.train()], [student.train()], teacher.eval(), opt,
                         {k: torch.from_numpy(v) for k, v in batch.items()},
                         StepConfig(compute_dtype=compute_dtype), torch.Generator().manual_seed(0))
    return ({k: v.item() for k, v in metrics.items()},
            {"sr": [{k: p.grad.clone() for k, p in generator.named_parameters()}],
             "student": [{k: p.grad.clone() for k, p in student.named_parameters()}]},
            {"sr": [generator.state_dict()], "student": [student.state_dict()]})


@pytest.mark.parametrize("geo, stn", [("256x64", True), ("scale4", False)])
def test_recipe_step_matches_jax_at_geometry(geo, stn):
    """The recipe's flags (the StepConfig defaults) with TATT; at scale 4
    without ``--STN``, which the CLI refuses there."""
    g = GEOMETRIES[geo]
    kw = dict(SMALL, **_model_geo(g), out_text_channels=8, dropout=0.0, stn=stn)
    jmodel = jtsrn.TATT(**kw)
    sr, stu, teacher = _tatt_variables(jmodel, g, 31)
    batch = _batch(g)
    want = _jax_tatt_step(jmodel, sr, stu, teacher, batch)
    got = _port_tatt_step(partial(ttsrn.TATT, **kw), sr, stu, teacher, batch)
    assert ("gnorm/stn_head" in got[0]) == stn
    assert_steps_match(want, got)


def test_bf16_recipe_step_matches_jax_at_256x64():
    """The bf16 recipe step at 256x64 held as tests/test_torch_bf16_step.py
    holds it at 128x32: the losses within 2e-3 relative of JAX's bf16
    step, every gradient entry within JAX's own bf16 error there plus 5e-2
    of the model's largest f32 gradient entry."""
    g = GEOMETRIES["256x64"]
    kw = dict(SMALL, **_model_geo(g), out_text_channels=8, dropout=0.0, stn=True)
    jmodel = jtsrn.TATT(**kw)
    sr, stu, teacher = _tatt_variables(jmodel, g, 15)
    batch = _batch(g, seed=4)
    m_j, g_j, _ = _jax_tatt_step(jmodel, sr, stu, teacher, batch, "bfloat16")
    _, g_j32, _ = _jax_tatt_step(jmodel, sr, stu, teacher, batch)
    m_t, g_t, _ = _port_tatt_step(partial(ttsrn.TATT, **kw), sr, stu, teacher, batch, "bfloat16")
    for key in BF16_LOSSES:
        assert math.isfinite(m_t[key])
        assert abs(m_t[key] - m_j[key]) <= BF16_LOSS_RTOL * abs(m_j[key]), (key, m_t[key], m_j[key])
    for part in ("sr", "student"):
        (gt,), (gj,), (gj32,) = g_t[part], g_j[part], g_j32[part]
        scale = max(v.abs().max().item() for v in gj32.values())
        for name, want in gj.items():
            own = (want - gj32[name]).abs()
            excess = ((gt[name].double() - want.double()).abs() - own).max().item()
            assert excess <= BF16_GRAD_TOL * scale, (part, name, excess, scale)


def test_tsrn_plain_step_matches_jax_at_256x64():
    """``tsrn``'s plain step (``--tssim_loss --rotate_train=5``, distorted
    SSIM) with ``--STN`` against ``make_plain_train_step``."""
    g = GEOMETRIES["256x64"]
    kw = dict(SMALL, **_model_geo(g), stn=True)
    jmodel = jtsrn.TSRN(**kw)
    sr, stu, _ = _tatt_variables(jmodel, g, 21, prior=False)
    # the rotation from the JAX plain step's own draws at PRNGKey(0)
    from test_torch_plain_step import _jax_rotation

    batch = _batch(g)
    arc, offs = _jax_rotation(8, 5.0)
    flags = dict(tssim_loss=True, rotate_train=5.0)

    def sr_apply_plain(variables, lr, train, rngs=None, mutable=False):
        return jmodel.apply(variables, lr, train=train, rngs=rngs, mutable=mutable)

    cfg = JStepConfig(**flags)
    criterion = partial(jimage_loss, gradient=cfg.gradient, loss_weight=(1.0, 1e-4))
    step = jax.jit(make_plain_train_step(sr_apply_plain, criterion, cfg, 4,
                                         ssim_variant="distorted"))
    state = TrainState.create([sr], [stu], optax.sgd(1.0))
    jbatch = {k: jnp.asarray(batch[k]) for k in ("images_hr", "images_lr")}
    new, metrics = step(state, jbatch, jax.random.PRNGKey(0))
    want = _results(state, new, metrics)

    generator, student = ttsrn.TSRN(**kw), CRNN(**TINY_CRNN)
    generator.load_state_dict(from_jax(sr))
    student.load_state_dict(from_jax(stu))
    opt = torch.optim.SGD([*generator.parameters(), *student.parameters()], lr=1.0)
    tbatch = {"images_hr": torch.from_numpy(batch["images_hr"]),
              "images_lr": torch.from_numpy(batch["images_lr"]),
              "rot_arc": torch.from_numpy(arc.astype(np.float32)),
              "rot_offs": torch.from_numpy(offs.astype(np.float32))}
    scfg = StepConfig(**flags)
    m = plain_train_step([generator.train()], opt, tbatch, scfg, torch.Generator().manual_seed(0),
                         partial(image_loss, gradient=scfg.gradient), 4, distorted=True)
    got = ({k: v.item() for k, v in m.items()},
           {"sr": [{k: p.grad.clone() for k, p in generator.named_parameters()}],
            "student": [{k: torch.zeros_like(p) for k, p in student.named_parameters()}]},
           {"sr": [generator.state_dict()], "student": [student.state_dict()]})
    assert set(got[0]) == {"loss_sr", "loss_tssim", "loss_total"}
    assert_steps_match(want, got)


# -------------------------------------------------------------- evaluator
def test_evaluator_matches_jax_trainer_evaluate_at_256x64():
    from tatt_tpu.train.loop import Trainer as JTrainer

    g = GEOMETRIES["256x64"]
    jcfg = JConfig()
    for key, value in dict(tiny_tpg=True, log_dir="", tssim_loss=False, rotate_train=0.0,
                           batch_size=8, hd_u=4, srb=1, mask=True).items():
        setattr(jcfg.args, key, value)
    jcfg.TRAIN.batch_size, jcfg.TRAIN.VAL.valInterval = 8, 0
    jcfg.TRAIN.width, jcfg.TRAIN.height = g["width"], g["height"]
    jcfg.MODEL.srb_nums, jcfg.MODEL.hidden_units, jcfg.MODEL.out_text_channels = 1, 4, 8
    val = JSynthetic(n=12, seed=2)
    trainer = JTrainer(jcfg, val, {"val": val})
    want = trainer.evaluate(val, batch_size=8)

    st = trainer.state
    generator = ttsrn.TATT(mask=True, **SMALL, **_model_geo(g), out_text_channels=8)
    generator.load_state_dict(from_jax({"params": st.sr_params[0],
                                        "batch_stats": st.sr_batch_stats[0]}))
    student, teacher = CRNN(**TINY_CRNN), CRNN(**TINY_CRNN)
    student.load_state_dict(from_jax({"params": st.student_params[0],
                                      "batch_stats": st.student_batch_stats[0]}))
    teacher.load_state_dict(from_jax(_host(trainer.teacher_vars)))
    ev = Evaluator([generator.eval()], [student.eval()], teacher.eval(), torch.device("cpu"),
                   batch_size=8, mask=True, **g)
    got = ev.evaluate(SyntheticTextDataset(n=12, seed=2))
    for key in ("psnr_avg", "psnr_avg_lr"):
        assert abs(got[key] - want[key]) <= 0.01, (key, got[key], want[key])
    for key in ("ssim_avg", "ssim_avg_lr"):
        assert abs(got[key] - want[key]) <= 1e-3, (key, got[key], want[key])
    for key in ("accuracy", "accuracy_lr", "accuracy_hr", "images"):
        assert got[key] == want[key], (key, got[key], want[key])
    assert got["ned"] == pytest.approx(want["ned"], abs=1e-12)


# -------------------------------------------------------------------- CLI
@pytest.mark.parametrize("argv", [RECIPE, ["--arch=tsrn_tl_cascade", "--CHNSR", "--tpg", "OPT"]
                                  + RECIPE[1:]], ids=["recipe", "chnsr-tsrn_tl_cascade"])
def test_cli_trains_at_256x64(tmp_path, monkeypatch, argv):
    monkeypatch.chdir(tmp_path)
    code, trainer = cli.run(argv + SHRUNK + ["--synthetic", "8", "--max_iters", "1",
                                             "--config", _yaml(tmp_path, GEOMETRIES["256x64"])])
    assert code == 0 and trainer.iters == 1
    batch = next(iter(trainer.loader))
    assert batch.images_hr.shape == (4, 64, 256, 3) and batch.images_lr.shape == (4, 32, 128, 3)
    assert trainer.loader.geometry == trainer.evaluator.geometry == GEOMETRIES["256x64"]
    assert trainer.generators[0].lr_size == (32, 128)
    assert factory.recognizer_spec(trainer.cfg).num_class == (3965 if "--CHNSR" in argv else 37)


def _jax_hota_fails() -> str:
    """JAX's PCAN_TL forward at LR 8x32: the error it raises."""
    model = jpcan.PCAN_TL(scale_factor=4, srb_nums=1, hidden_units=4, out_text_channels=8)
    with pytest.raises(IndexError) as err:
        jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.zeros((2, 4, 8, 32)),
                       jnp.zeros((2, 37, 1, 26)))
    return str(err.value)


def _jax_stn_grads_nan() -> list:
    """The leaves of JAX's STN head with NaN gradients after a training
    forward at LR 8x32 (its BatchNorm over the empty maps)."""
    head = jstn.STNHead()
    x = jnp.asarray(np.random.default_rng(0).random((2, 4, 8, 32), dtype=np.float32))
    v = head.init(jax.random.PRNGKey(0), x, True)

    @jax.jit
    def grads(p):
        def loss(p):
            pts, _ = head.apply({"params": p, "batch_stats": v["batch_stats"]}, x, True,
                                mutable=["batch_stats"])
            return (pts ** 2).mean()
        return jax.grad(loss)(p)

    flat = jax.tree_util.tree_flatten_with_path(grads(v["params"]))[0]
    return [jax.tree_util.keystr(k) for k, a in flat if np.isnan(np.asarray(a)).any()]


@pytest.mark.parametrize("case", ["pcan_tl", "pcan", "stn"])
def test_cli_refuses_what_jax_cannot_run_there(tmp_path, case):
    yaml = _yaml(tmp_path, GEOMETRIES["scale4"])
    if case == "stn":
        assert _jax_stn_grads_nan() == ["['bn4']['scale']", "['bn5']['scale']"]
        argv, reason = RECIPE, "--STN with an LR crop of 8x32"
        # the same flags evaluate (the STN rectifies in training only) and
        # train without --STN
        cfg, _ = cli.parse_config(RECIPE + ["--go_test", "--config", yaml] + SHRUNK)
        assert cfg.scale_factor == 4
        cli.parse_config([a for a in RECIPE if a != "--STN"] + ["--config", yaml] + SHRUNK)
    else:
        assert "index -1 is out of bounds for axis 1 with size 0" in _jax_hota_fails()
        argv = [f"--arch={case}", "--mask"] + (["--go_test"] if case == "pcan" else [])
        reason = "index -1 is out of bounds for axis 1 with size 0"
    with pytest.raises(SystemExit, match=reason):
        cli.main(argv + ["--synthetic", "8", "--max_iters", "1", "--config", yaml] + SHRUNK)
    cli.parse_config(argv + ["--config", _yaml(tmp_path, GEOMETRIES["256x64"], "ok.yaml")]
                     + SHRUNK)  # served at 256x64
