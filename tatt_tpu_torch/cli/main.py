"""CLI of the port (the ported subset of ``tatt_tpu/cli/main.py``).

Training, the canonical recipe of ``scripts/train_TATT.sh`` on synthetic
data:

  python -m tatt_tpu_torch.cli.main --arch=tatt --STN --mask --use_distill \\
      --gradient --sr_share --stu_iter=1 --rotate_train=5.0 --tssim_loss \\
      --synthetic 256 --max_iters 20

Evaluation: ``--arch=tatt --go_test --synthetic 256 --mask``.

Flags and defaults follow the JAX package.  Ported besides those:
``--test_model=CRNN``, ``--batch_size``, ``--lr``, ``--epochs``,
``--no-fused_tssim``, the shrink flags ``--srb``, ``--hd_u`` and
``--tiny_tpg``, ``--resume <reference .pth>``, ``--crnn_pretrained
<.pth>`` and ``--device`` (default ``cuda``).  Training requires every
flag of the recipe.  Any other flag or value raises "not ported yet"; none
is silently ignored.  Without weights the
generator and the CRNN student / teacher start from seeded initial
weights; the teacher is also the judge.
"""

from __future__ import annotations

import argparse
import math
import os
import sys

from tatt_tpu_torch.core.convert import load_reference_pth, load_weights
from tatt_tpu_torch.core.device import resolve_device, set_cuda_flags
from tatt_tpu_torch.data.synthetic import SyntheticTextDataset
from tatt_tpu_torch.models.common import init_parameters
from tatt_tpu_torch.models.recognizers.crnn import CRNN
from tatt_tpu_torch.models.tsrn import TATT
from tatt_tpu_torch.train.loop import Evaluator, Trainer
from tatt_tpu_torch.train.steps import StepConfig

# TRAIN defaults of tatt_tpu/core/config.py:35-55
MANUAL_SEED = 1234
BATCH_SIZE = 64
LR = 1e-3
EPOCHS = 500
DISPLAY_INTERVAL = 50
VAL_INTERVAL = 400
TINY_CRNN = dict(nh=16, nm=(8, 8, 16, 16, 32, 32, 32))  # --tiny_tpg
# the flags of scripts/train_TATT.sh that training requires
RECIPE_FLAGS = ("STN", "mask", "use_distill", "gradient", "sr_share", "tssim_loss")
RECIPE_ROTATE = 5.0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="tatt_tpu_torch — TATT on CUDA")
    p.add_argument("--arch", default="tatt")
    p.add_argument("--test_model", default="CRNN")
    p.add_argument("--go_test", action="store_true")
    p.add_argument("--synthetic", type=int, default=0, metavar="N")
    p.add_argument("--max_iters", type=int, default=None)
    p.add_argument("--mask", action="store_true")
    p.add_argument("--STN", action="store_true")
    p.add_argument("--use_distill", action="store_true")
    p.add_argument("--gradient", action="store_true")
    p.add_argument("--sr_share", action="store_true")
    p.add_argument("--tssim_loss", action="store_true")
    p.add_argument("--fused_tssim", action=argparse.BooleanOptionalAction, default=True)
    p.add_argument("--stu_iter", type=int, default=1)
    p.add_argument("--rotate_train", type=float, default=0.0)
    p.add_argument("--dtype", default="float32")
    p.add_argument("--batch_size", type=int, default=BATCH_SIZE)
    p.add_argument("--learning_rate", "--lr", dest="lr", type=float, default=LR)
    p.add_argument("--epochs", type=int, default=EPOCHS)
    p.add_argument("--srb", type=int, default=5)
    p.add_argument("--hd_u", type=int, default=32)
    p.add_argument("--tiny_tpg", action="store_true")
    p.add_argument("--resume", type=str, default=None)
    p.add_argument("--crnn_pretrained", type=str, default=None)
    p.add_argument("--device", default="cuda")
    return p


def parse_args(argv=None) -> argparse.Namespace:
    args, unknown = build_parser().parse_known_args(argv)
    refused = [
        (bool(unknown), " ".join(unknown)),
        (args.arch != "tatt", f"--arch={args.arch} (only tatt)"),
        (args.test_model != "CRNN", f"--test_model={args.test_model} (only CRNN)"),
        (args.dtype != "float32", f"--dtype={args.dtype} (the port runs float32)"),
        (args.stu_iter != 1, f"--stu_iter={args.stu_iter} (only 1)"),
        (args.synthetic <= 0, "LMDB data (pass --synthetic N)"),
        (bool(args.resume) and not args.resume.endswith(".pth"),
         f"--resume {args.resume} (only a reference .pth)"),
    ]
    if not args.go_test:  # training runs the canonical recipe and nothing else
        missing = [f"--{k}" for k in RECIPE_FLAGS if not getattr(args, k)]
        refused += [
            (bool(missing), f"training without {' '.join(missing)} (the recipe sets them)"),
            (args.rotate_train != RECIPE_ROTATE,
             f"--rotate_train={args.rotate_train} (only {RECIPE_ROTATE})"),
        ]
    for bad, what in refused:
        if bad:
            raise SystemExit(f"not ported yet: {what}")
    return args


def main(argv=None) -> int:
    args = parse_args(argv)
    device = resolve_device(args.device)
    set_cuda_flags()  # full f32 (no TF32) and cuDNN autotuning

    generator = init_parameters(
        TATT(srb_nums=args.srb, hidden_units=args.hd_u, out_text_channels=2 * args.hd_u,
             mask=args.mask, stn=args.STN),
        MANUAL_SEED,
    )
    crnn = TINY_CRNN if args.tiny_tpg else {}
    student = init_parameters(CRNN(**crnn), MANUAL_SEED + 1)
    teacher = init_parameters(CRNN(**crnn), MANUAL_SEED + 2)  # also the judge
    if args.crnn_pretrained:  # teacher weights: the teacher/judge and the student
        if not os.path.exists(args.crnn_pretrained):
            print(f"teacher CRNN weights not found: {args.crnn_pretrained}", file=sys.stderr)
            return 2
        sd = load_reference_pth(args.crnn_pretrained)
        load_weights(teacher, sd)
        load_weights(student, sd)
    if args.resume:
        unused = load_weights(generator, load_reference_pth(args.resume))
        print(
            f"generator from {args.resume} ({len(unused)} checkpoint entries unused); "
            "note: reference TATT checkpoints were trained under the batch_first "
            "query-GRU quirk (TATT(query_gru_mode='reference') reproduces it)",
            file=sys.stderr,
        )
        rec = os.path.join(os.path.dirname(args.resume), "recognizer_best_acc_0.pth")
        if os.path.exists(rec):
            load_weights(student, load_reference_pth(rec))

    generator, student, teacher = (m.to(device) for m in (generator, student, teacher))
    val_sets = {"easy": SyntheticTextDataset(n=max(args.synthetic // 4, 8), seed=2)}
    if args.go_test:
        evaluator = Evaluator(
            [generator.eval()], [student.eval()], teacher.eval(), device,
            batch_size=args.batch_size, mask=args.mask,
        )
        for name, ds in val_sets.items():
            print(f"[{name}] {evaluator.evaluate(ds)}")
        return 0

    trainer = Trainer(
        generator, student, teacher, SyntheticTextDataset(n=args.synthetic, seed=1), device,
        StepConfig(fused_tssim=args.fused_tssim),
        batch_size=args.batch_size, lr=args.lr, epochs=args.epochs, seed=MANUAL_SEED,
        display_interval=DISPLAY_INTERVAL, val_interval=VAL_INTERVAL, val_datasets=val_sets,
        mask=args.mask,
    )
    result = trainer.train(max_iters=args.max_iters)
    last = {k: v[-1] for k, v in result["metrics"].items()}
    print(f"[train] iters {result['iters']} " + " ".join(f"{k} {v:.6g}" for k, v in last.items()))
    return 0 if all(math.isfinite(v) for v in last.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
