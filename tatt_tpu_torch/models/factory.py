"""Arch name -> generator and criterion (counterpart of
``tatt_tpu/models/factory.py``).

:func:`build_generator` builds every arch of the JAX factory with its
constructor arguments (``factory.py:83-374``): ``tatt``, the TSRN family
and the zoo (``models/zoo``), ``tranSR_v4`` included.
``ABLATION_SET`` (``factory.py:18-31``, reference
``super_resolution.py:59-61``) lists the archs that take a text prior:
:func:`arch_steps` gives them the TATT step and the rest the plain step,
and says whether the TATT step fuses its tssim copy.
:func:`build_criterion` holds every branch of ``factory.py:56-80``.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable

from torch import nn

from tatt_tpu_torch.core.config import Config
from tatt_tpu_torch.losses.image import (
    charbonnier_loss,
    edge_image_loss,
    image_loss,
    l1_loss,
    mse_loss,
)
from tatt_tpu_torch.models.tsrn import SEM_TSRN, TATT, TSRN, TSRN_C2F, TSRN_TL, TSRN_TL_SFT
from tatt_tpu_torch.models.zoo.esrgan import RRDBNet, RRDBNet_TL
from tatt_tpu_torch.models.zoo.han import HAN
from tatt_tpu_torch.models.zoo.pcan import PCAN, PCAN_TL
from tatt_tpu_torch.models.zoo.resnets import EDSR, RDN, RDN_TL, LapSRN, SRResNet, SRResNet_TL
from tatt_tpu_torch.models.zoo.simple import (
    BICUBIC, SCGAN, SCGAN_TL, SRCNN, SRCNN_TL, VDSR, VDSR_TL,
)
from tatt_tpu_torch.models.zoo.tbsrn import TBSRN, TBSRN_TL
from tatt_tpu_torch.models.zoo.transformer_sr import SRTransformerV4
from tatt_tpu_torch.train.steps import eval_step, plain_eval_step, plain_train_step, train_step

ABLATION_SET = [
    "tsrn_tl_cascade_sft",
    "tsrn_tl_cascade",
    "srcnn_tl",
    "srresnet_tl",
    "rdn_tl",
    "vdsr_tl",
    "tranSR_v4",
    "esrgan_tl",
    "scgan_tl",
    "tbsrn_tl",
    "tatt",
    "pcan_tl",
]
# archs the reference feeds 3 channels whatever --mask says
# (super_resolution.py:1038-1043, tatt_tpu/train/loop.py:151-153)
THREE_CHANNEL_ARCHS = ("srcnn", "rdn", "vdsr", "edsr", "lapsrn", "han")
# the archs whose TATT step runs sr and the counter-rotated sr_ret in one 2B
# forward under --tssim_loss --fused_tssim: JAX fuses the models with a
# bn_copies field (loop.py:240-253; TATT, TSRN_TL, TSRN_TL_SFT), every other
# arch of ABLATION_SET takes two forwards of B
FUSED_TSSIM_ARCHS = ("tatt", "tsrn_tl_cascade", "tsrn_tl_cascade_sft")

_REGISTRY: dict[str, Callable[[Config], nn.Module]] = {}


def register(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn

    return deco


def build_generator(arch: str, cfg: Config) -> nn.Module:
    if arch not in _REGISTRY:
        raise ValueError(f"arch '{arch}' not implemented (have: {sorted(_REGISTRY)})")
    return _REGISTRY[arch](cfg)


def available_archs() -> list[str]:
    return sorted(_REGISTRY)


def arch_steps(cfg: Config) -> tuple[Callable, Callable]:
    """``(train_fn, sr_fn)`` of ``cfg.args.arch``, the one place that says
    which step an arch takes: ``train_fn(generators, students, teacher,
    optimizer, arrays, step_cfg, gen) -> metrics`` and ``sr_fn(generators,
    students, lr) -> (sr, aux)``.  An arch of ``ABLATION_SET`` takes the
    TATT step and its eval, with ``fused_tssim`` as the flags say for the
    archs of ``FUSED_TSSIM_ARCHS`` and off for the rest; the others the
    plain step and eval on their channels (``loop.py:149-153``) with their
    criterion, distorted SSIM for ``tsrn`` (``loop.py:317``) and no loss
    on the students."""
    a = cfg.args
    if a.arch in ABLATION_SET:
        fuses = a.arch in FUSED_TSSIM_ARCHS

        def tatt_fn(generators, students, teacher, optimizer, arrays, step_cfg, gen):
            if not fuses:
                step_cfg = dataclasses.replace(step_cfg, fused_tssim=False)
            return train_step(generators, students, teacher, optimizer, arrays, step_cfg, gen)

        return tatt_fn, lambda gens, stus, lr: eval_step(gens, stus, lr, a.stu_iter,
                                                         a.for_cascading)
    channels = 3 if a.arch in THREE_CHANNEL_ARCHS else 4 if a.mask else 3
    criterion, distorted = build_criterion(a.arch, cfg), a.arch == "tsrn"

    def train_fn(generators, students, teacher, optimizer, arrays, step_cfg, gen):
        return plain_train_step(generators, optimizer, arrays, step_cfg, gen, criterion,
                                channels, distorted)

    return train_fn, lambda gens, stus, lr: plain_eval_step(gens[0], lr, channels)


def build_criterion(arch: str, cfg: Config) -> Callable:
    """The per-sample image criterion of the arch (``generator_init``,
    ``interfaces/base.py:255-444``): ImageLoss([1, 1e-4]) for the TL / TATT
    family and TSRN, MSE / L1 / Charbonnier / EdgeImageLoss for the
    baselines."""
    mse_archs = {"srcnn", "vdsr", "srres", "han", "srcnn_tl", "srresnet_tl", "vdsr_tl", "bicubic"}
    l1_archs = {"esrgan", "scgan", "rdn", "edsr", "esrgan_tl", "scgan_tl", "rdn_tl"}
    if arch in mse_archs:
        return mse_loss
    if arch in l1_archs:
        return l1_loss
    if arch == "lapsrn":
        return charbonnier_loss
    if arch == "pcan":
        return edge_image_loss
    return partial(image_loss, gradient=cfg.args.gradient, loss_weight=(1.0, 1e-4))


def _trunk_args(cfg: Config) -> dict:
    a = cfg.args
    return dict(scale_factor=cfg.scale_factor, stn=a.STN, srb_nums=a.srb, mask=a.mask,
                hidden_units=a.hd_u)


def _geometry(cfg: Config) -> dict:
    return dict(width=cfg.TRAIN.width, height=cfg.TRAIN.height)


@register("tatt")
def _tatt(cfg: Config):
    # the TP decoder uses the stem features as queries, so the prior width
    # is 2 * hidden_units
    return TATT(**_trunk_args(cfg), **_geometry(cfg), out_text_channels=2 * cfg.args.hd_u)


@register("tsrn")
def _tsrn(cfg: Config):
    return TSRN(**_trunk_args(cfg), **_geometry(cfg))


@register("tsrn_tl_cascade")
def _tsrn_tl(cfg: Config):
    # text_emb 37 and out_text_channels 64: the constructors' defaults are
    # the JAX package's ModelConfig defaults (tatt_tpu/core/config.py:71-72)
    return TSRN_TL(**_trunk_args(cfg), **_geometry(cfg))


@register("tsrn_tl_cascade_sft")
def _tsrn_tl_sft(cfg: Config):
    return TSRN_TL_SFT(**_trunk_args(cfg), **_geometry(cfg), out_text_channels=2 * cfg.args.hd_u)


@register("tsrn_c2f")
def _tsrn_c2f(cfg: Config):
    return TSRN_C2F(**_trunk_args(cfg))


@register("sem_tsrn")
def _sem_tsrn(cfg: Config):
    return SEM_TSRN(**_trunk_args(cfg))


def _planes(cfg: Config) -> int:
    return 4 if cfg.args.mask else 3


def _hr(cfg: Config) -> dict:
    return dict(height=cfg.TRAIN.height, width=cfg.TRAIN.width)


def _zoo_trunk(cfg: Config) -> dict:
    a = cfg.args
    return dict(scale_factor=cfg.scale_factor, srb_nums=a.srb, mask=a.mask, hidden_units=a.hd_u)


# the zoo (factory.py:119-316): the reference feeds srcnn, vdsr, rdn, edsr,
# lapsrn and han 3 channels whatever --mask says (THREE_CHANNEL_ARCHS)
_ZOO: dict[str, Callable[[Config], nn.Module]] = {
    "srcnn": lambda c: SRCNN(scale_factor=c.scale_factor, in_planes=3),
    "srcnn_tl": lambda c: SRCNN_TL(scale_factor=c.scale_factor, in_planes=_planes(c), **_hr(c)),
    "vdsr": lambda c: VDSR(scale_factor=c.scale_factor, in_planes=3),
    "vdsr_tl": lambda c: VDSR_TL(scale_factor=c.scale_factor, in_planes=_planes(c), **_hr(c)),
    "scgan": lambda c: SCGAN(scale_factor=c.scale_factor, in_planes=_planes(c)),
    "scgan_tl": lambda c: SCGAN_TL(scale_factor=c.scale_factor, in_planes=_planes(c), **_hr(c)),
    "bicubic": lambda c: BICUBIC(scale_factor=c.scale_factor),
    "srres": lambda c: SRResNet(scale_factor=c.scale_factor, mask=c.args.mask),
    "srresnet_tl": lambda c: SRResNet_TL(scale_factor=c.scale_factor, mask=c.args.mask, **_hr(c)),
    "edsr": lambda c: EDSR(scale_factor=c.scale_factor),
    "lapsrn": lambda c: LapSRN(scale_factor=c.scale_factor, in_planes=3),
    "rdn": lambda c: RDN(scale_factor=c.scale_factor, in_planes=3),
    "rdn_tl": lambda c: RDN_TL(scale_factor=c.scale_factor, in_planes=_planes(c)),
    "esrgan": lambda c: RRDBNet(scale_factor=c.scale_factor, in_nc=_planes(c), out_nc=_planes(c)),
    "esrgan_tl": lambda c: RRDBNet_TL(scale_factor=c.scale_factor, in_nc=_planes(c),
                                      out_nc=_planes(c)),
    "han": lambda c: HAN(scale=c.scale_factor),
    "pcan": lambda c: PCAN(**_zoo_trunk(c)),
    "pcan_tl": lambda c: PCAN_TL(**_zoo_trunk(c)),
    # the reference CLI lists tbsrn but its factory lacks the branch
    # (base.py:368-369); the JAX package wires it as evidently intended
    "tbsrn": lambda c: TBSRN(**_zoo_trunk(c)),
    "tbsrn_tl": lambda c: TBSRN_TL(**_zoo_trunk(c)),
    "tranSR_v4": lambda c: SRTransformerV4(
        scale_factor=c.scale_factor, in_planes=_planes(c),
        lr_size=(c.TRAIN.height // c.scale_factor, c.TRAIN.width // c.scale_factor)),
}
for _name, _build in _ZOO.items():
    register(_name)(_build)
