"""The system under test, built as its CLI builds it.

The configuration's flags go through the port's own parser
(``cli.main.parse_config``) with a YAML written beside the run's data, so
the flags mean what they mean to a user.  The models are the factory's
(``build_generator``, the recognizer spec's CRNN), made on the card and
given the benchmark's seeded weights; the trainer and the evaluator are
``Trainer`` and ``Evaluator`` as ``cli.main.train`` makes them.  Nothing
here changes how the program computes.
"""

from __future__ import annotations

import os

import torch

from stisr_bench import weights as seeded


def import_all() -> None:
    """The port's modules that the CLI loads."""
    import tatt_tpu_torch.cli.main  # noqa: F401


def yaml_text(config: dict, seed: int, train_dirs: list, val_dirs: list, batch: int,
              ckpt_dir: str) -> str:
    g = config["geometry"]
    lines = [
        "TRAIN:",
        f"  train_data_dir: {train_dirs!r}",
        f"  batch_size: {batch}",
        f"  width: {g['width']}",
        f"  height: {g['height']}",
        f"  down_sample_scale: {g['down_sample_scale']}",
        f"  epochs: {config['epochs']}",
        f"  workers: {config['workers']}",
        f"  ckpt_dir: {ckpt_dir!r}",
        f"  voc_type: {config['voc_type']!r}",
        f"  saveInterval: {config['saveInterval']}",
        f"  displayInterval: {config['displayInterval']}",
        f"  lr: {config['lr']}",
        f"  beta1: {config['beta1']}",
        f"  manualSeed: {seed}",
        "  VAL:",
        f"    val_data_dir: {val_dirs!r}",
        f"    valInterval: {config['valInterval']}",
        "    crnn_pretrained: ''",
        "    rec_pretrained: ''",
        "    moran_pretrained: ''",
    ]
    return "\n".join(lines) + "\n"


def parse(config: dict, yaml_path: str, batch: int, extra=()):
    """(the port's Config, its parsed namespace) of the configuration's
    flags; scalar logging off."""
    from tatt_tpu_torch.cli.main import parse_config

    argv = [*config["flags"], f"--srb={config['srb']}", f"--hd_u={config['hd_u']}",
            f"--dtype={config['dtype']}", f"--batch_size={batch}", f"--val_batch_size={batch}",
            "--config", yaml_path, "--log_dir", "", *extra]
    return parse_config(argv)


def build_models(cfg, leaves: dict, device) -> tuple[list, list, torch.nn.Module]:
    """(generators, students, teacher) of the port, on ``device``, with
    the seeded ``leaves`` ({"generator" | "student" | "teacher": {name:
    tensor}})."""
    from tatt_tpu_torch.models.factory import build_generator, recognizer_spec

    with torch.device(device):
        generator = build_generator(cfg.args.arch, cfg)
        spec = recognizer_spec(cfg)
        student, teacher = spec.build(), spec.build()
    for name, module in (("generator", generator), ("student", student), ("teacher", teacher)):
        seeded.load(module, leaves[name])
    return [generator], [student], teacher


def trainer(cfg, models, train_ds, device):
    from tatt_tpu_torch.train.loop import Trainer

    generators, students, teacher = models
    return Trainer(cfg, generators, students, teacher, train_ds, device, {}, None, None)


def evaluator(cfg, models, device):
    """The ``--go_test`` evaluator of ``cli.main.train``."""
    from tatt_tpu_torch.models.factory import arch_steps, recognizer_spec
    from tatt_tpu_torch.train.loop import Evaluator, geometry_of

    generators, students, teacher = models
    generators, students = [m.eval() for m in generators], [m.eval() for m in students]
    a = cfg.args
    _, sr_fn = arch_steps(cfg)
    return Evaluator(generators, students, teacher.eval(), device,
                     batch_size=a.val_batch_size or cfg.batch_size, mask=a.mask,
                     workers=max(cfg.TRAIN.workers, 1), stu_iter=a.stu_iter,
                     for_cascading=a.for_cascading, lpips=None, n_vis=0,
                     vis_root=os.path.join("demo", cfg.vis_dir), sr_fn=sr_fn,
                     spec=recognizer_spec(cfg), **geometry_of(cfg))


def lmdb_dataset(root: str, voc_type: str):
    from tatt_tpu_torch.data.lmdb_dataset import LmdbTextDataset

    return LmdbTextDataset(root, voc_type=voc_type)


def write_lmdb(root: str, records: dict) -> None:
    """The container: the port's LMDB writer (its ``create_lmdb`` tool's)."""
    from tatt_tpu_torch.data.lmdb_lite import write_lmdb as write

    write(root, records)


def prepare_device(build: bool = True) -> float:
    """The port's process-wide CUDA settings and its kernels, built into
    the checkout's ``tatt_tpu_torch/_build`` on a first run; (the build's
    seconds)."""
    from tatt_tpu_torch.core.device import set_cuda_flags
    from tatt_tpu_torch.kernels import _build

    set_cuda_flags()
    return _build.build() if build else 0.0

