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
:func:`recognizer_spec` is the one place that reads ``--tpg`` and
``--CHNSR`` (``tatt_tpu/train/loop.py:105-147``): its
:class:`RecognizerSpec` builds the students and teacher (a ``CRNN``, or
the NAVER ``TPGModel`` under ``OPT``) and carries their class count,
input adapter, decode alphabet and accuracy filter to the steps, the
judge, the evaluator and the collate.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable, Optional

from torch import nn

from tatt_tpu_torch.core.charset import CRNN_ALPHABET, voc_table
from tatt_tpu_torch.core.config import Config
from tatt_tpu_torch.losses.image import (
    charbonnier_loss,
    edge_image_loss,
    image_loss,
    l1_loss,
    mse_loss,
)
from tatt_tpu_torch.models.recognizers.crnn import CRNN, parse_crnn_input
from tatt_tpu_torch.models.recognizers.tpg import TPGModel, parse_opt_input
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


# --tiny_tpg's shrunk recognizers (tatt_tpu/train/loop.py:133-147)
TINY_CRNN = dict(nh=16, nm=(8, 8, 16, 16, 32, 32, 32))
TINY_TPG = dict(output_channel=64, hidden_size=32)


@dataclasses.dataclass(frozen=True)
class RecognizerSpec:
    """The students' and teacher's recognizer: ``tpg`` (``CRNN`` or
    ``OPT``), ``num_class`` (its classes and the prior's width,
    ``text_emb``), ``parse_fn`` (its input adapter), ``alphabet`` (the
    blank-first CTC decode alphabet; under ``--CHNSR`` blank + the
    3965-character table, whose last character the 3965-class head cannot
    emit, a reference quirk kept), ``filter_mode`` (``str_filt``'s
    vocabulary for accuracy, ``loop.py:789-792``) and ``tiny``
    (``--tiny_tpg``)."""

    tpg: str
    num_class: int
    parse_fn: Callable
    alphabet: str
    filter_mode: str
    tiny: bool = False

    def build(self, crnn_widths: Optional[dict] = None) -> nn.Module:
        """A student or teacher: ``TPGModel(num_class)`` under ``OPT``
        (the FAN ResNet, CTC head), else a ``CRNN`` at ``crnn_widths`` (a
        teacher file's); ``tiny`` shrinks either.  Parameters
        uninitialized (``init_parameters``)."""
        if self.tpg == "OPT":
            return TPGModel(num_class=self.num_class, **(TINY_TPG if self.tiny else {}))
        return CRNN(**(crnn_widths or (TINY_CRNN if self.tiny else {})))


CRNN_SPEC = RecognizerSpec("CRNN", len(CRNN_ALPHABET), parse_crnn_input, CRNN_ALPHABET, "lower")


def recognizer_spec(cfg: Config) -> RecognizerSpec:
    """What ``--tpg`` and ``--CHNSR`` choose: the TPG through
    ``parse_opt_input`` (32x512 luma) under ``OPT``, else the CRNN through
    ``parse_crnn_input`` (``parse_OPT_data`` / ``parse_crnn_data``); the
    3965-character table's classes, alphabet and filter under ``--CHNSR``
    (``loop.py:105-116``), else the CRNN's 37 and ``lower``."""
    a = cfg.args
    parse_fn = parse_opt_input if a.tpg == "OPT" else parse_crnn_input
    if a.CHNSR:
        table = voc_table("chinese")
        return RecognizerSpec(a.tpg, len(table), parse_fn, "-" + table, "chinese", a.tiny_tpg)
    return dataclasses.replace(CRNN_SPEC, tpg=a.tpg, parse_fn=parse_fn, tiny=a.tiny_tpg)


def arch_steps(cfg: Config) -> tuple[Callable, Callable]:
    """``(train_fn, sr_fn)`` of ``cfg.args.arch``, the one place that says
    which step an arch takes: ``train_fn(generators, students, teacher,
    optimizer, arrays, step_cfg, gen) -> metrics`` and ``sr_fn(generators,
    students, lr) -> (sr, aux)``.  An arch of ``ABLATION_SET`` takes the
    TATT step and its eval, with ``fused_tssim`` as the flags say for the
    archs of ``FUSED_TSSIM_ARCHS`` and off for the rest; the others the
    plain step and eval on their channels (``loop.py:149-153``) with their
    criterion, distorted SSIM for ``tsrn`` (``loop.py:317``) and no loss
    on the students.  The TATT step and eval read the recognizers through
    :func:`recognizer_spec`'s input adapter."""
    a = cfg.args
    if a.arch in ABLATION_SET:
        fuses = a.arch in FUSED_TSSIM_ARCHS
        parse_fn = recognizer_spec(cfg).parse_fn

        def tatt_fn(generators, students, teacher, optimizer, arrays, step_cfg, gen):
            if not fuses:
                step_cfg = dataclasses.replace(step_cfg, fused_tssim=False)
            return train_step(generators, students, teacher, optimizer, arrays, step_cfg, gen,
                              parse_fn)

        return tatt_fn, lambda gens, stus, lr: eval_step(gens, stus, lr, a.stu_iter,
                                                         a.for_cascading, parse_fn)
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
    # is 2 * hidden_units; its input, the recognizer's classes
    return TATT(**_trunk_args(cfg), **_geometry(cfg), text_emb=recognizer_spec(cfg).num_class,
                out_text_channels=2 * cfg.args.hd_u)


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
