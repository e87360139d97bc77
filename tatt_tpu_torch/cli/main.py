"""CLI of the port (the ported subset of ``tatt_tpu/cli/main.py``).

Training of ``--arch`` ``tatt`` (the canonical recipe of
``scripts/train_TATT.sh`` below), of the TSRN family (``tsrn``,
``tsrn_tl_cascade``, ``tsrn_tl_cascade_sft``, ``tsrn_c2f``, ``sem_tsrn``)
or of the baselines of the zoo (``srcnn``, ``srcnn_tl``, ``vdsr``,
``vdsr_tl``, ``srres``, ``srresnet_tl``, ``edsr``, ``rdn``, ``rdn_tl``,
``lapsrn``, ``esrgan``, ``esrgan_tl``, ``scgan``, ``scgan_tl``, ``han``,
``pcan``, ``pcan_tl``, ``tbsrn``, ``tbsrn_tl``): the JAX CLI's choices.
The archs of ``ABLATION_SET`` take the TATT step, the others the plain
step, on the TextZoom LMDBs that a YAML names (``TRAIN.train_data_dir``, and
``TRAIN.VAL.val_data_dir`` for validation, each set keyed by its
directory's basename):

  python -m tatt_tpu_torch.cli.main --arch=tatt --STN --mask --use_distill \\
      --gradient --sr_share --stu_iter=1 --rotate_train=5.0 --tssim_loss \\
      --test_model=CRNN --vis_dir=vis_TATT --config=config/super_resolution.yaml

It writes ``<TRAIN.ckpt_dir>/<vis_dir>/checkpoint.ckpt`` every
``saveInterval`` and ``model_best_acc_0.ckpt`` on a new best sum-accuracy.
The finetune stage adds ``--resume ckpt/vis_TATT --lr 2e-4``.  Evaluation
of the best checkpoint on each val set:

  python -m tatt_tpu_torch.cli.main --arch=tatt --mask --go_test \\
      --vis_dir=vis_TATT --resume=ckpt/vis_TATT/model_best_acc_0.ckpt \\
      --config=config/super_resolution.yaml

``--synthetic N`` takes synthetic crops in place of the YAML's data; with
neither, the CLI exits with code 2 ("no data").  Flags and defaults follow
the JAX package.  Ported: the step's flags ``--STN``, ``--mask``,
``--gradient``, ``--use_distill``, ``--use_label``, ``--ssim_loss``,
``--tssim_loss`` (``--no-fused_tssim``), ``--sr_share``, ``--tpg_share``,
``--stu_iter``, ``--for_cascading``, ``--y_domain``, ``--learning_STN``,
``--training_stablize``, ``--rotate_train`` (any angle, 0 for none), and
``--color_loss`` and ``--mse_fuse``, which act in the plain step only, as
in JAX;
``--config``, ``--vis_dir``, ``--batch_size``, ``--val_batch_size``,
``--lr``, ``--epochs``, ``--max_iters``, ``--resume`` (a port checkpoint,
a run directory or a reference ``.pth``; else the YAML's
``TRAIN.resume``), ``--crnn_pretrained`` (a ``.pth``, such as one that
``python -m tatt_tpu_torch.train.pretrain`` writes; else
``TRAIN.VAL.crnn_pretrained``; a missing file exits with code 2; the
CRNNs take the file's widths),
the shrink flags ``--srb``, ``--hd_u`` and ``--tiny_tpg``, and
``--device`` (default ``cuda``).

The evaluation protocol of ``scripts/test_TATT.sh``: ``--go_test`` reads
SR, LR and HR with the ``--test_model`` judge: CRNN (the teacher), ASTER
(weights from ``--rec_pretrained``, else ``TRAIN.VAL.rec_pretrained``) or
MORAN (``--moran_pretrained`` / ``TRAIN.VAL.moran_pretrained``); a
non-CRNN judge without weights is an error, as in JAX.  ``--test`` runs
the same evaluation with the ``--rec`` recognizer (crnn, aster or moran,
fed the LR input as JAX feeds it), ``--demo`` super-resolves the images
of ``--demo_dir`` into ``demo_out/<vis_dir>`` and prints the ``--rec``
readings, ``--vis`` writes ``n_vis`` LR / SR / HR triptychs of each
evaluation to ``demo/<vis_dir>``, ``--vgg16_pretrained`` with
``--lpips_pretrained`` (else the YAML's) adds LPIPS-VGG to the summaries,
and ``--log_dir`` (default ``tensorboard``) takes the trainer's scalars.
The reference's dead flags (``--text_focus``, ``--prob_insert``,
``--test_distorted_fusing``, ``--BiSR``, ``--rotate_test``,
``--results_rotate``) are accepted with a warning.

``--tpg OPT`` takes the NAVER TPG recognizer (``TPGModel``, 32x512 luma,
129 CTC steps) for the students, the teacher and the CRNN-kind judge, and
``--CHNSR`` the Chinese path: the 3965-character table as the
recognizer's classes and the prior's width (``text_emb``), its decode
alphabet, and the ``chinese`` accuracy filter, as
``tatt_tpu/train/loop.py:105-147`` wires them:

  python -m tatt_tpu_torch.cli.main --arch=tatt --CHNSR --tpg OPT --STN \\
      --mask --use_distill --gradient --sr_share --stu_iter=1 \\
      --rotate_train=5.0 --tssim_loss --synthetic 512 --max_iters 100

Every arch of ``ABLATION_SET`` trains on that path, its prior 3965 wide.
``--tiny_tpg`` shrinks the TPG to ``output_channel`` 64, hidden 32.  Two
combinations are refused with the JAX package's reason, because it fails on
them: ``--CHNSR`` without ``--tpg OPT`` (the 37-class CRNN's prior meets a
generator built for 3965 classes) and ``--tpg OPT`` with a teacher file
(``--crnn_pretrained`` or the YAML's: JAX reads it as a CRNN and hands the
CRNN's variables to the TPG).

``--arch=bicubic`` is refused in every mode: BICUBIC has no parameters, so
there is nothing to train or to checkpoint (the JAX CLI accepts it and
fails in every mode: its ``TrainState`` reads the absent ``params``,
``tatt_tpu/train/state.py:36``).  ``tranSR_v4``, which the factory builds,
is not among the JAX CLI's choices: argparse refuses it (exit code 2).
The data long tail, as the JAX CLI wires it (``tatt_tpu/cli/main.py:195-231``):
``--syn`` collates the train batches as ``alignCollate_syn`` (the LR
halved again, unspread labels, the pseudo-LR blur ensemble), ``--mixed``
wraps each train LMDB in ``MixDataset`` (half of the LR crops replaced by
the manmade degradation of HR), and ``--badset`` / ``--ic15sr`` read each
``TRAIN.VAL.val_data_dir`` as a folder of ``name_label_*.png`` crops /
an IC15 TextSR tree of PGMs (``data/variants.py``).  Under ``--synthetic``
the JAX CLI ignores ``--mixed``, ``--badset`` and ``--ic15sr``; the port
does too, with a warning.  ``--device_collate`` is accepted and changes
nothing (the port always ships uint8 crops and normalizes them on the
card, ``data/device_pipeline.py``), and ``--test_data_dir``, which the JAX
CLI parses and reads nowhere, is accepted with a warning.  No OpenCV is
needed: ``data/imgproc.py`` computes its image operations.

``--dtype bfloat16`` trains the TATT step in bf16 (``train/steps.py``;
the four recurrence kernels' bf16 instantiations on the card), as the JAX
CLI does: ``--arch=tatt`` and ``--arch=srresnet_tl``, with every step
flag, with the CRNN or with the TPG of ``--tpg OPT`` (``--CHNSR`` too).
The other nine archs of the TATT step (``tsrn_tl_cascade``,
``tsrn_tl_cascade_sft``, ``srcnn_tl``, ``vdsr_tl``, ``scgan_tl``,
``rdn_tl``, ``esrgan_tl``, ``pcan_tl``, ``tbsrn_tl``) are refused under it
with the JAX package's reason: their prior runs through a
``ConvTranspose2d`` whose float32 kernel the JAX package never casts, and
its bf16 step fails there (``INFOGEN_BF16_REFUSAL``).  As in the JAX
package the flag acts in that step alone: the plain step's archs train,
and ``--go_test`` / ``--test`` / ``--demo`` evaluate, in float32 (with a
warning).

The YAML's ``TRAIN.width``, ``TRAIN.height`` and ``TRAIN.down_sample_scale``
set the crops, the generators and the evaluation, as in JAX.  Two of their
combinations are refused with the JAX package's reason: ``pcan`` /
``pcan_tl`` at an LR crop below 15 rows or columns (HOTA pools it to
nothing, and JAX fails), and training with ``--STN`` at an LR crop below
16 rows or 32 columns (the STN head pools it to nothing, and JAX trains it
to NaN), as the recipe at ``down_sample_scale: 4`` of a 32-row crop.

Data parallelism, as the JAX CLI's mesh: ``--dp_devices N`` trains on N
ranks, one process each (``cli/launch.py``): on CUDA the first N visible
cards (0, the default, all of them; a larger N takes them all, as JAX's
``devices[:n]``), on the CPU N processes (0 is 1).  ``--batch_size`` is
the global batch, which N must divide; each rank steps on its rows,
BatchNorm takes sync statistics over the global batch, or per rank with
``--bn_per_replica`` (DataParallel's, ``interfaces/base.py:390``), and
rank 0 alone validates, saves and prints.  ``--go_test``, ``--test`` and
``--demo`` run in one process, as JAX's eval does.  With
``COORDINATOR_ADDRESS`` set, this is host ``PROCESS_ID`` of
``NUM_PROCESSES``, whose N ranks take their global ranks in a world of
``NUM_PROCESSES`` x N (``cli/launch.py``).  ``--steps_per_dispatch 1`` is
the default; K > 1 is refused (``STEPS_PER_DISPATCH_REFUSAL``).

Refused with "not ported yet": any flag the JAX CLI does not have
(abbreviations included); nothing is silently ignored.  Without weights the generators
and the students / teacher start from initial weights seeded by
``TRAIN.manualSeed``.
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import os
import sys
from typing import Optional

import torch

from tatt_tpu_torch.cli.launch import launch, train_worker
from tatt_tpu_torch.core import distributed
from tatt_tpu_torch.core.charset import AsterInfo
from tatt_tpu_torch.core.checkpoint import resume_models
from tatt_tpu_torch.core.config import Config, Flags, load_config
from tatt_tpu_torch.core.convert import load_reference_pth, load_weights
from tatt_tpu_torch.core.device import resolve_device, set_cuda_flags
from tatt_tpu_torch.core.mesh import resolve_dp
from tatt_tpu_torch.data.lmdb_dataset import ConcatDataset, LmdbTextDataset, MixDataset
from tatt_tpu_torch.data.synthetic import SyntheticTextDataset
from tatt_tpu_torch.data.variants import BadSetFolderDataset, IC15TextSRDataset
from tatt_tpu_torch.kernels import _build
from tatt_tpu_torch.losses.perceptual import import_lpips, lpips_vgg
from tatt_tpu_torch.models.common import init_parameters
from tatt_tpu_torch.models.factory import (
    ABLATION_SET, BF16_ARCHS, STN_ARCHS, arch_steps, build_generator, recognizer_spec,
)
from tatt_tpu_torch.models.recognizers.aster import AsterRecognizer
from tatt_tpu_torch.models.recognizers.crnn import crnn_widths
from tatt_tpu_torch.models.recognizers.moran import MORAN
from tatt_tpu_torch.models.stn import pooled_map
from tatt_tpu_torch.models.zoo.pcan import hota_pooled
from tatt_tpu_torch.train.demo import run_demo
from tatt_tpu_torch.train.judge import make_judge
from tatt_tpu_torch.train.loop import Evaluator, Trainer, copies, geometry_of

STEP_FLAGS = ("STN", "mask", "gradient", "use_distill", "use_label", "ssim_loss", "tssim_loss",
              "sr_share", "tpg_share", "for_cascading", "y_domain", "learning_STN",
              "training_stablize", "color_loss", "mse_fuse")
# a non-CRNN judge's or recognizer's weights: the flag, else the YAML's key
JUDGE_WEIGHTS = {"ASTER": "rec_pretrained", "MORAN": "moran_pretrained"}
# --arch choices: the JAX CLI's (tatt_tpu/cli/main.py:25-55)
ARCHS = ("tatt", "tsrn", "sem_tsrn", "tsrn_c2f", "tsrn_tl_cascade", "tsrn_tl_cascade_sft",
         "srcnn", "srcnn_tl", "vdsr", "vdsr_tl", "srres", "srresnet_tl", "edsr", "rdn", "rdn_tl",
         "lapsrn", "esrgan", "esrgan_tl", "scgan", "scgan_tl", "han", "pcan", "pcan_tl", "tbsrn",
         "tbsrn_tl", "bicubic")
BICUBIC_REFUSAL = ("--arch=bicubic: BICUBIC has no parameters, so there is nothing to train, "
                   "optimize or checkpoint (the JAX package fails on it in every mode too)")
# combinations the JAX package fails on (its flax errors quoted)
CHNSR_CRNN_REFUSAL = (
    "--CHNSR needs --tpg OPT: the 37-class CRNN's prior meets a generator built for the "
    "3965-character table (the JAX package fails on it too: 'For parameter \"kernel\" in "
    "\"/infoGen/fc_in\", the given initializer is expected to generate shape (37, 8), but the "
    "existing parameter it received has shape (3965, 8)')")
OPT_TEACHER_REFUSAL = (
    "--tpg OPT with a teacher file ({path}): the file is read as a CRNN, and CRNN weights do "
    "not fit the TPG recognizer (the JAX package imports it with import_crnn and fails too: "
    "'Could not find parameter named \"kernel\" in scope \"/FeatureExtraction/conv0_1_conv\"')")
# the YAML's geometries the JAX package cannot run: an LR crop that a
# module pools to nothing (models/stn.py:pooled_map, models/zoo/pcan.py:hota_pooled)
STN_LR_REFUSAL = (
    "--STN with an LR crop of {h}x{w} (TRAIN.height / width over down_sample_scale): the STN "
    "head pools it to nothing (it needs 16 rows and 32 columns), and the JAX package trains it "
    "to NaN: its BatchNorm over the empty maps gives NaN gradients, which the per-model "
    "clipping spreads to every generator weight at the first step")
HOTA_LR_REFUSAL = (
    "--arch={arch} with an LR crop of {h}x{w} (TRAIN.height / width over down_sample_scale): "
    "HOTA's 8x8 pool takes no window of the halved crop (it needs 15 rows and columns), so "
    "there is nothing to resize back (the JAX package fails on it too: 'IndexError: index -1 is "
    "out of bounds for axis 1 with size 0')")
# the JAX CLI's K steps a dispatch (tatt_tpu/cli/main.py:111-116)
STEPS_PER_DISPATCH_REFUSAL = (
    "--steps_per_dispatch {k}: K optimizer steps in one dispatch is the JAX package's TPU "
    "dispatch (one jitted lax.scan of K steps, tatt_tpu/train/loop.py:289-296); its CUDA "
    "counterpart is CUDA graphs, a speed item that is not served: pass 1, the default")

# bf16 training of the text-prior archs outside factory.BF16_ARCHS
INFOGEN_BF16_REFUSAL = (
    "--dtype bfloat16 with --arch={arch}: its text prior runs through a ConvTranspose2d whose "
    "float32 kernel meets the bf16 input, and the JAX package's bf16 step fails on it "
    "(tatt_tpu/models/common.py:300: 'TypeError: lax.conv_general_dilated requires arguments "
    "to have the same dtypes, got bfloat16, float32'); it trains in bf16 only --arch=tatt and "
    "--arch=srresnet_tl")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="tatt_tpu_torch — TATT on CUDA", allow_abbrev=False)
    p.add_argument("--arch", default="tatt", choices=ARCHS)
    p.add_argument("--test_model", default="CRNN", choices=["CRNN", "ASTER", "MORAN"])
    p.add_argument("--config", default=None, help="YAML config path")
    p.add_argument("--go_test", action="store_true")
    p.add_argument("--test", action="store_true")
    p.add_argument("--rec", default="crnn", choices=["crnn", "aster", "moran"])
    p.add_argument("--demo", action="store_true")
    p.add_argument("--demo_dir", type=str, default="./demo")
    p.add_argument("--vis", action="store_true", help="dump LR/SR/HR triptychs during eval")
    p.add_argument("--log_dir", default="tensorboard")
    p.add_argument("--tpg", default="CRNN", choices=["CRNN", "OPT"])
    p.add_argument("--CHNSR", action="store_true")
    for flag in ("text_focus", "BiSR", "results_rotate"):
        p.add_argument(f"--{flag}", action="store_true")
    p.add_argument("--prob_insert", type=float, default=1.0)
    p.add_argument("--test_distorted_fusing", type=int, default=0)
    p.add_argument("--rotate_test", type=float, default=0.0)
    p.add_argument("--results_rotate_angle", type=float, default=5.0)
    for flag in ("syn", "mixed", "ic15sr", "badset", "device_collate"):
        p.add_argument(f"--{flag}", action="store_true")
    p.add_argument("--test_data_dir", type=str, default=None)
    p.add_argument("--synthetic", type=int, default=0, metavar="N")
    p.add_argument("--max_iters", type=int, default=None)
    for flag in STEP_FLAGS:
        p.add_argument(f"--{flag}", action="store_true")
    p.add_argument("--fused_tssim", action=argparse.BooleanOptionalAction, default=True)
    p.add_argument("--stu_iter", type=int, default=1)
    p.add_argument("--rotate_train", type=float, default=0.0)
    p.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"])
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--val_batch_size", type=int, default=None)
    p.add_argument("--learning_rate", "--lr", dest="lr", type=float, default=None)
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--vis_dir", type=str, default=None)
    p.add_argument("--srb", type=int, default=5)
    p.add_argument("--hd_u", type=int, default=32)
    p.add_argument("--tiny_tpg", action="store_true")
    p.add_argument("--resume", type=str, default=None)
    p.add_argument("--crnn_pretrained", type=str, default=None)
    for name, what in (("rec", "ASTER (--test_model=ASTER, --rec=aster)"),
                       ("moran", "MORAN (--test_model=MORAN, --rec=moran)"),
                       ("vgg16", "torchvision VGG16 (LPIPS, with --lpips_pretrained)"),
                       ("lpips", "the lpips package's vgg heads (with --vgg16_pretrained)")):
        p.add_argument(f"--{name}_pretrained", type=str, default=None, help=f".pth weights of {what}")
    p.add_argument("--dp_devices", type=int, default=0)
    p.add_argument("--steps_per_dispatch", type=int, default=1)
    p.add_argument("--bn_per_replica", action="store_true",
                   help="BatchNorm statistics per data-parallel rank (DataParallel's) in place "
                        "of sync-BN")
    p.add_argument("--device", default="cuda")
    return p


def parse_config(argv=None) -> tuple[Config, argparse.Namespace]:
    """(the config tree, the parsed namespace with the extras that are
    not ``Flags``: ``synthetic``, ``max_iters``, the ``*_pretrained``
    paths, ``device``).  Raises SystemExit("not ported yet: ..."),
    SystemExit(BICUBIC_REFUSAL), SystemExit(CHNSR_CRNN_REFUSAL),
    SystemExit(STEPS_PER_DISPATCH_REFUSAL),
    SystemExit(INFOGEN_BF16_REFUSAL), and for a geometry the JAX package
    cannot run SystemExit(HOTA_LR_REFUSAL) or SystemExit(STN_LR_REFUSAL)."""
    args, unknown = build_parser().parse_known_args(argv)
    if args.arch == "bicubic":
        raise SystemExit(BICUBIC_REFUSAL)
    if args.CHNSR and args.tpg != "OPT":
        raise SystemExit(CHNSR_CRNN_REFUSAL)
    if unknown:
        raise SystemExit(f"not ported yet: {' '.join(unknown)}")
    if args.steps_per_dispatch != 1:
        raise SystemExit(STEPS_PER_DISPATCH_REFUSAL.format(k=args.steps_per_dispatch))
    bf16_train = args.dtype == "bfloat16" and not (args.go_test or args.test or args.demo)
    if bf16_train and args.arch in ABLATION_SET and args.arch not in BF16_ARCHS:
        raise SystemExit(INFOGEN_BF16_REFUSAL.format(arch=args.arch))
    names = {f.name for f in dataclasses.fields(Flags)}
    flags = Flags(**{k: v for k, v in vars(args).items() if k in names})
    cfg = load_config(args.config, flags)
    h, w = (getattr(cfg.TRAIN, k) // cfg.scale_factor for k in ("height", "width"))
    if args.arch in ("pcan", "pcan_tl") and 0 in hota_pooled((h, w)):
        raise SystemExit(HOTA_LR_REFUSAL.format(arch=args.arch, h=h, w=w))
    training = not (args.go_test or args.test or args.demo)
    if training and args.STN and args.arch in STN_ARCHS and 0 in pooled_map((h, w)):
        raise SystemExit(STN_LR_REFUSAL.format(h=h, w=w))
    return cfg, args


def warn_dead_flags(cfg: Config) -> None:
    """The reference parses these flags and reads them nowhere
    (``tatt_tpu/cli/main.py:157-184``): accepted, each with a warning."""
    a = cfg.args
    dead = [flag for flag, on in (
        ("--text_focus", a.text_focus), ("--test_distorted_fusing", a.test_distorted_fusing),
        ("--BiSR", a.BiSR), ("--prob_insert", a.prob_insert != 1.0),
        ("--rotate_test", a.rotate_test), ("--results_rotate", a.results_rotate),
    ) if on]
    for flag in dead:
        print(f"WARNING: {flag} is dead code in the reference and has no effect here "
              "(accepted for CLI compatibility)", file=sys.stderr)
    if a.test_data_dir is not None:
        print("WARNING: --test_data_dir is parsed by the JAX CLI and read nowhere; it has no "
              "effect here (accepted for CLI compatibility)", file=sys.stderr)
    if a.device_collate:
        print("WARNING: --device_collate changes nothing here: the port always ships uint8 "
              "crops and normalizes them on the card", file=sys.stderr)
    if a.dtype == "bfloat16" and (a.go_test or a.test or a.demo or a.arch not in ABLATION_SET):
        what = "evaluation" if a.go_test or a.test or a.demo else f"--arch={a.arch}'s plain step"
        print(f"WARNING: --dtype bfloat16 acts in the TATT train step only; {what} runs in "
              "float32, as in the JAX package", file=sys.stderr)


def warn_synthetic_ignores(cfg: Config, synthetic: int) -> None:
    """``--synthetic`` takes the place of the YAML's LMDBs, so the flags
    that choose their readers act on nothing (the JAX CLI ignores them
    there silently, ``tatt_tpu/cli/main.py:195-199``)."""
    a = cfg.args
    for flag, on in (("--mixed", a.mixed), ("--badset", a.badset), ("--ic15sr", a.ic15sr)):
        if on and synthetic > 0:
            print(f"WARNING: {flag} has no effect with --synthetic (it chooses how the YAML's "
                  "LMDBs are read)", file=sys.stderr)


def weights_path(kind: str, cfg: Config, cli: argparse.Namespace) -> str:
    """The ASTER or MORAN weights: the flag, else the YAML's path."""
    key = JUDGE_WEIGHTS[kind]
    return getattr(cli, key) or getattr(cfg.TRAIN.VAL, key)


def load_judge(kind: str, path: str, voc_type: str, device):
    """A judge (:func:`make_judge`) over an ASTER or MORAN ``.pth`` (or
    ``.pth.tar``) in the reference layout, on ``device``."""
    model = AsterRecognizer(AsterInfo(voc_type).rec_num_classes) if kind == "ASTER" else MORAN()
    load_weights(model, load_reference_pth(path))
    return make_judge(kind, model.to(device).eval(), voc_type)


def datasets(cfg: Config, synthetic: int) -> Optional[tuple]:
    """(train set, {name: val set}) from ``--synthetic N`` or the YAML's
    directories, or None when there are neither: each train LMDB, in a
    ``MixDataset`` under ``--mixed``; each val directory read by
    ``--badset``'s or ``--ic15sr``'s reader, else as an LMDB."""
    if synthetic > 0:
        return (SyntheticTextDataset(n=synthetic, seed=1),
                {"easy": SyntheticTextDataset(n=max(synthetic // 4, 8), seed=2)})
    if not cfg.TRAIN.train_data_dir:
        return None
    a, voc = cfg.args, cfg.TRAIN.voc_type
    train = [LmdbTextDataset(d, voc_type=voc) for d in cfg.TRAIN.train_data_dir]
    reader = BadSetFolderDataset if a.badset else IC15TextSRDataset if a.ic15sr else LmdbTextDataset
    vals = {os.path.basename(d.rstrip("/")): reader(d, voc_type=voc)
            for d in cfg.TRAIN.VAL.val_data_dir}
    return ConcatDataset([MixDataset(d) for d in train] if a.mixed else train), vals


def build_models(cfg: Config, crnn_path: str):
    """(generators, students, teacher): the :func:`~tatt_tpu_torch.train.
    loop.copies` of the ``--arch`` generator (:func:`~tatt_tpu_torch.models.
    factory.build_generator`) and of the student (a CRNN, or the TPG
    under ``--tpg OPT``: :func:`~tatt_tpu_torch.models.factory.
    recognizer_spec`), each copy seeded from ``TRAIN.manualSeed`` and its
    index; the teacher's weights, and every student's start, from
    ``crnn_path`` (``loop.py:176-186``), whose shapes also give the CRNN's
    widths (a CRNN that ``tatt_tpu_torch.train.pretrain`` trained at any
    width)."""
    a, seed = cfg.args, cfg.TRAIN.manualSeed
    n_sr, n_stu = copies(a)
    generators = [init_parameters(build_generator(a.arch, cfg), seed + 3 * i) for i in range(n_sr)]
    sd = load_reference_pth(crnn_path) if crnn_path else None
    widths, spec = crnn_widths(sd) if sd else None, recognizer_spec(cfg)
    students = [init_parameters(spec.build(widths), seed + 1 + 3 * i) for i in range(n_stu)]
    teacher = init_parameters(spec.build(widths), seed + 2)  # also the judge
    if sd:
        for model in (teacher, *students):
            load_weights(model, sd)
    return generators, students, teacher


def rec_judge(cfg: Config, cli: argparse.Namespace, teacher, device):
    """The ``--rec`` recognizer of ``--test`` and ``--demo``
    (``super_resolution.py:1702-1876``): the teacher (CRNN or TPG), or
    ASTER / MORAN, which need their weights."""
    rec = cfg.args.rec
    if rec == "crnn":
        return make_judge("CRNN", teacher, spec=recognizer_spec(cfg))
    kind = rec.upper()
    path = weights_path(kind, cfg, cli)
    if not path or not os.path.exists(path):
        key = JUDGE_WEIGHTS[kind]
        raise SystemExit(f"--rec={rec} requires {kind} weights: pass --{key} or set TRAIN.VAL.{key}")
    return load_judge(kind, path, cfg.TRAIN.voc_type, device)


def run(argv=None) -> tuple[int, Optional[Trainer]]:
    """:func:`main`, also returning the trainer of a training run in this
    process (None when ``--dp_devices`` spread it over ranks)."""
    argv = sys.argv[1:] if argv is None else list(argv)
    cfg, cli = parse_config(argv)
    warn_dead_flags(cfg)
    warn_synthetic_ignores(cfg, cli.synthetic)
    device = resolve_device(cli.device)
    a = cfg.args
    if not (a.go_test or a.test or a.demo):
        world = resolve_dp(a.dp_devices, device)
        if world * distributed.host_layout()[0] > 1:
            if device.type == "cuda":
                _build.build()  # once, before the ranks load it
            devices = [f"cuda:{r}" for r in range(world)] if device.type == "cuda" else ["cpu"] * world
            launch(train_worker, world, ([argv],), devices)
            return 0, None
    code, trainer, _ = train(cfg, cli, device)
    return code, trainer


def train(cfg: Config, cli: argparse.Namespace, device: torch.device):
    """The run of the parsed flags on ``device`` in this process: the
    evaluation modes, or training as this process's rank ->
    (exit code, the trainer or None, its ``train`` result or None)."""
    set_cuda_flags()  # full f32 (no TF32) and cuDNN autotuning

    data = datasets(cfg, cli.synthetic)
    if data is None:
        print("no data: pass --synthetic N or a --config with train_data_dir", file=sys.stderr)
        return 2, None, None
    train_ds, val_sets = data
    # the teacher: the flag, else the YAML's path (cli/main.py:236-262)
    crnn_path = cli.crnn_pretrained or cfg.TRAIN.VAL.crnn_pretrained
    if crnn_path and not os.path.exists(crnn_path):
        print(f"teacher CRNN weights not found: {crnn_path}", file=sys.stderr)
        return 2, None, None
    if crnn_path and cfg.args.tpg == "OPT":
        raise SystemExit(OPT_TEACHER_REFUSAL.format(path=crnn_path))
    if not crnn_path and cfg.args.use_distill and not cli.synthetic:
        print(
            "WARNING: --use_distill with a RANDOMLY-INITIALIZED teacher CRNN "
            "(no --crnn_pretrained / TRAIN.VAL.crnn_pretrained). The distill "
            "loss will pull the student toward random logits and the CRNN "
            "judge makes best-acc selection noise. Supply crnn.pth weights "
            "for meaningful training.",
            file=sys.stderr,
        )
    generators, students, teacher = build_models(cfg, crnn_path)
    generators = [m.to(device) for m in generators]
    students = [m.to(device) for m in students]
    teacher = teacher.to(device)

    # the judge per --test_model (test_bible, super_resolution.py:485-513);
    # None: the teacher, read as a CRNN judge
    a, judge = cfg.args, None
    if a.test_model != "CRNN":
        path = weights_path(a.test_model, cfg, cli)
        if not path:
            raise SystemExit(
                f"--test_model={a.test_model} requires judge weights: set TRAIN.VAL.rec_pretrained "
                "(ASTER) / moran_pretrained (MORAN) in the YAML or pass --rec_pretrained / "
                "--moran_pretrained")
        if not os.path.exists(path):
            print(f"{a.test_model} judge weights not found: {path}", file=sys.stderr)
            return 2, None, None
        judge = load_judge(a.test_model, path, cfg.TRAIN.voc_type, device)
    # LPIPS when both checkpoints are given (super_resolution.py:41-43, 1409-1420)
    lpips = None
    lpips_paths = (cli.vgg16_pretrained or cfg.TRAIN.VAL.vgg16_pretrained,
                   cli.lpips_pretrained or cfg.TRAIN.VAL.lpips_pretrained)
    if all(lpips_paths):
        missing = [pth for pth in lpips_paths if not os.path.exists(pth)]
        if missing:
            print(f"LPIPS weights not found: {missing[0]}", file=sys.stderr)
            return 2, None, None
        vgg, lin = import_lpips(*lpips_paths)
        vgg, lin = vgg.to(device), [w.to(device) for w in lin]
        lpips = lambda x, y: lpips_vgg(vgg, lin, x, y)  # noqa: E731

    if a.go_test or a.test or a.demo:
        if cfg.resume:
            resume_models(cfg.resume, generators, students)
        generators, students = [m.eval() for m in generators], [m.eval() for m in students]
        if a.test or a.demo:
            judge = rec_judge(cfg, cli, teacher.eval(), device)
        _, sr_fn = arch_steps(cfg)
        if a.demo:
            with torch.no_grad():
                run_demo(a.demo_dir, lambda lr: sr_fn(generators, students, lr)[0], judge,
                         os.path.join("demo_out", cfg.vis_dir), device, cfg.TRAIN.width,
                         cfg.TRAIN.height, cfg.scale_factor, a.mask)
            return 0, None, None
        evaluator = Evaluator(
            generators, students, judge or teacher.eval(), device,
            batch_size=a.val_batch_size or cfg.batch_size, mask=a.mask,
            workers=max(cfg.TRAIN.workers, 1), stu_iter=a.stu_iter, for_cascading=a.for_cascading,
            lpips=lpips, n_vis=cfg.TRAIN.VAL.n_vis if a.vis else 0,
            vis_root=os.path.join("demo", cfg.vis_dir), sr_fn=sr_fn,
            spec=recognizer_spec(cfg), **geometry_of(cfg),
        )
        for name, ds in val_sets.items():
            print(f"[{name}] {evaluator.evaluate(ds)}")
        return 0, None, None

    trainer = Trainer(cfg, generators, students, teacher, train_ds, device, val_sets, judge, lpips)
    if cfg.resume:
        trainer.resume(cfg.resume)
    result = trainer.train(max_iters=cli.max_iters)
    last = {k: v[-1] for k, v in result["metrics"].items()}
    if distributed.rank() == 0:
        print(f"[train] iters {result['iters']} " + " ".join(f"{k} {v:.6g}" for k, v in last.items()))
    return (0 if all(math.isfinite(v) for v in last.values()) else 1), trainer, result


def main(argv=None) -> int:
    return run(argv)[0]


if __name__ == "__main__":
    sys.exit(main())
