"""Typed configuration tree (counterpart of ``tatt_tpu/core/config.py``).

The reference YAML schema (``config/super_resolution.yaml``) read into
``TrainConfig`` / ``ValConfig`` / ``TestConfig`` with the JAX package's
field names and defaults, unknown keys ignored.  ``Flags`` holds the CLI
flags that the port serves, with the same names and defaults; flags win
over the YAML through the same ``Config`` properties (``batch_size``,
``lr``, ``resume``, ``vis_dir``, ``epochs``).  ``ModelConfig`` and the
flags of paths not yet ported are not here: of ``ModelConfig`` the port
reads only ``text_emb``, the recognizer's class count, which follows
``--CHNSR`` as the JAX ``Trainer`` sets it (``loop.py:112-116``); what
``--tpg`` and ``--CHNSR`` choose is read in one place,
``tatt_tpu_torch.models.factory.recognizer_spec``.

``TRAIN.width``, ``TRAIN.height`` and ``TRAIN.down_sample_scale`` (the HR
crop and the scale; the LR crop is ``width // scale`` x ``height //
scale``) reach the collate, the generators, the STN and the evaluator,
as in JAX.  ``voc_type`` filters the LMDB labels; ``chinese`` reads the
3965-character table.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Optional

import yaml


@dataclass
class ValConfig:
    val_data_dir: list[str] = field(default_factory=list)
    n_vis: int = 10
    vis_dir: str = "demo"
    valInterval: int = 400
    rec_pretrained: str = ""
    moran_pretrained: str = ""
    crnn_pretrained: str = ""
    vgg16_pretrained: str = ""
    lpips_pretrained: str = ""


@dataclass
class TrainConfig:
    train_data_dir: list[str] = field(default_factory=list)
    batch_size: int = 64
    width: int = 128
    height: int = 32
    epochs: int = 500
    workers: int = 0
    resume: str = ""
    ckpt_dir: str = "./ckpt"
    voc_type: str = "all"  # digit | lower | upper | all | chinese
    saveInterval: int = 200
    displayInterval: int = 50
    lr: float = 1e-3
    optimizer: str = "Adam"
    beta1: float = 0.5
    manualSeed: int = 1234
    max_len: int = 100
    keep_ratio: bool = False
    down_sample_scale: int = 2
    VAL: ValConfig = field(default_factory=ValConfig)


@dataclass
class TestConfig:
    checkpoint: str = ""
    test_data_dir: list[str] = field(default_factory=list)


@dataclass
class Flags:
    """The CLI flags the port serves (reference ``main.py:23-69``)."""

    arch: str = "tatt"
    test_model: str = "CRNN"
    batch_size: Optional[int] = None
    val_batch_size: Optional[int] = None
    epochs: Optional[int] = None
    resume: Optional[str] = None
    vis_dir: Optional[str] = None
    STN: bool = False
    mask: bool = False
    gradient: bool = False
    use_distill: bool = False
    use_label: bool = False
    ssim_loss: bool = False
    tssim_loss: bool = False
    fused_tssim: bool = True
    sr_share: bool = False
    tpg_share: bool = False
    for_cascading: bool = False
    y_domain: bool = False
    learning_STN: bool = False
    training_stablize: bool = False
    color_loss: bool = False
    mse_fuse: bool = False
    stu_iter: int = 1
    rotate_train: float = 0.0
    go_test: bool = False
    srb: int = 5
    hd_u: int = 32
    lr: Optional[float] = None
    # the TATT step's compute dtype: float32 | bfloat16 (train/steps.py)
    dtype: str = "float32"
    tpg: str = "CRNN"  # the recognizer: CRNN | OPT (the NAVER TPG)
    CHNSR: bool = False  # the Chinese path: the 3965-character table
    tiny_tpg: bool = False
    # the data long tail (``tatt_tpu/core/config.py:117-142``): the --syn
    # collate, the --mixed train wrapper, the --ic15sr / --badset val readers
    syn: bool = False
    mixed: bool = False
    ic15sr: bool = False
    badset: bool = False
    # parsed by the JAX CLI and read nowhere (cli/main.py:warn_dead_flags)
    test_data_dir: Optional[str] = None
    # the JAX package's uint8 collate; the port always ships uint8
    device_collate: bool = False
    # data parallelism (``tatt_tpu/core/config.py:137-145``): ranks (0 = all
    # visible cards), per-rank BatchNorm statistics in place of sync-BN, and
    # the JAX package's TPU dispatch of K steps, of which only 1 is served
    dp_devices: int = 0
    bn_per_replica: bool = False
    steps_per_dispatch: int = 1
    # eval extras (``tatt_tpu/core/config.py``'s defaults)
    rec: str = "crnn"  # --test's recognizer: crnn | aster | moran
    test: bool = False
    demo: bool = False
    demo_dir: str = "./demo"
    vis: bool = False  # LR / SR / HR triptychs during eval
    log_dir: str = "tensorboard"
    # parsed by the reference and read nowhere (cli/main.py:warn_dead_flags)
    text_focus: bool = False
    prob_insert: float = 1.0
    test_distorted_fusing: int = 0
    BiSR: bool = False
    rotate_test: float = 0.0
    results_rotate: bool = False
    results_rotate_angle: float = 5.0


@dataclass
class Config:
    TRAIN: TrainConfig = field(default_factory=TrainConfig)
    TEST: TestConfig = field(default_factory=TestConfig)
    args: Flags = field(default_factory=Flags)

    # flags over YAML (reference base.py:168-182)
    @property
    def batch_size(self) -> int:
        return self.args.batch_size if self.args.batch_size is not None else self.TRAIN.batch_size

    @property
    def lr(self) -> float:
        return self.args.lr if self.args.lr is not None else self.TRAIN.lr

    @property
    def resume(self) -> str:
        return self.args.resume if self.args.resume is not None else self.TRAIN.resume

    @property
    def vis_dir(self) -> str:
        return self.args.vis_dir if self.args.vis_dir is not None else self.TRAIN.VAL.vis_dir

    @property
    def epochs(self) -> int:
        return self.args.epochs if self.args.epochs is not None else self.TRAIN.epochs

    @property
    def scale_factor(self) -> int:
        return self.TRAIN.down_sample_scale


def _coerce(dc_cls, data: Optional[dict]) -> Any:
    """A dataclass from a dict, recursing into nested dataclasses and
    ignoring unknown keys (the reference YAML carries commented-out junk)."""
    kwargs = {}
    fields = {f.name: f for f in dataclasses.fields(dc_cls)}
    for key, value in (data or {}).items():
        if key not in fields:
            continue
        nested = _NESTED.get(fields[key].type)
        if nested is not None:
            kwargs[key] = _coerce(nested, value)
        elif value is not None:
            kwargs[key] = value
    return dc_cls(**kwargs)


_NESTED = {"ValConfig": ValConfig}


def load_config(yaml_path: Optional[str] = None, flags: Optional[Flags] = None) -> Config:
    """The reference YAML schema into the typed tree, ``flags`` as
    ``Config.args``."""
    cfg = Config()
    if yaml_path:
        with open(yaml_path) as fh:
            raw = yaml.safe_load(fh) or {}
        cfg = Config(TRAIN=_coerce(TrainConfig, raw.get("TRAIN")),
                     TEST=_coerce(TestConfig, raw.get("TEST")))
    if flags is not None:
        cfg.args = flags
    return cfg
