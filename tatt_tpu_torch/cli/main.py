"""CLI for the eval path (the ``--go_test`` subset of ``tatt_tpu/cli/main.py``).

  python -m tatt_tpu_torch.cli.main --arch=tatt --go_test --synthetic 256 --mask

Flags and defaults follow the JAX package.  Ported: ``--arch=tatt``,
``--go_test``, ``--synthetic N``, ``--mask``, ``--batch_size``,
``--resume <reference .pth>``, ``--crnn_pretrained <.pth>`` and
``--device`` (default ``cuda``).  Any other flag raises "not ported yet";
none is silently ignored.  Without weights the generator and the CRNN
student/judge start from seeded initial weights.
"""

from __future__ import annotations

import argparse
import os
import sys

from tatt_tpu_torch.core.convert import load_reference_pth, load_weights
from tatt_tpu_torch.core.device import resolve_device, set_cuda_flags
from tatt_tpu_torch.data.synthetic import SyntheticTextDataset
from tatt_tpu_torch.models.common import init_parameters
from tatt_tpu_torch.models.recognizers.crnn import CRNN
from tatt_tpu_torch.models.tsrn import TATT
from tatt_tpu_torch.train.loop import Evaluator

MANUAL_SEED = 1234  # TRAIN.manualSeed default (tatt_tpu/core/config.py)
BATCH_SIZE = 64  # TRAIN.batch_size default


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="tatt_tpu_torch — TATT eval on CUDA")
    p.add_argument("--arch", default="tatt")
    p.add_argument("--go_test", action="store_true")
    p.add_argument("--synthetic", type=int, default=0, metavar="N")
    p.add_argument("--mask", action="store_true")
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--resume", type=str, default=None)
    p.add_argument("--crnn_pretrained", type=str, default=None)
    p.add_argument("--device", default="cuda")
    return p


def parse_args(argv=None) -> argparse.Namespace:
    args, unknown = build_parser().parse_known_args(argv)
    if unknown:
        raise SystemExit(f"not ported yet: {' '.join(unknown)}")
    if args.arch != "tatt":
        raise SystemExit(f"not ported yet: --arch={args.arch} (only tatt)")
    if not args.go_test:
        raise SystemExit("not ported yet: training (pass --go_test)")
    if args.synthetic <= 0:
        raise SystemExit("not ported yet: LMDB data (pass --synthetic N)")
    return args


def main(argv=None) -> int:
    args = parse_args(argv)
    device = resolve_device(args.device)
    set_cuda_flags()  # full f32 (no TF32) and cuDNN autotuning

    generator = init_parameters(TATT(mask=args.mask), MANUAL_SEED)
    student = init_parameters(CRNN(), MANUAL_SEED + 1)
    judge = init_parameters(CRNN(), MANUAL_SEED + 2)
    if args.crnn_pretrained:  # teacher weights: the judge and the student
        if not os.path.exists(args.crnn_pretrained):
            print(f"teacher CRNN weights not found: {args.crnn_pretrained}", file=sys.stderr)
            return 2
        sd = load_reference_pth(args.crnn_pretrained)
        load_weights(judge, sd)
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

    models = [m.to(device).eval() for m in (generator, student, judge)]
    evaluator = Evaluator(
        models[:1], models[1:2], models[2], device,
        batch_size=args.batch_size or BATCH_SIZE, mask=args.mask,
    )
    val_sets = {"easy": SyntheticTextDataset(n=max(args.synthetic // 4, 8), seed=2)}
    for name, ds in val_sets.items():
        print(f"[{name}] {evaluator.evaluate(ds)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
