"""The falling-loss_sr gate of ``chip_smoke.py`` phases 12, 14, 15 and 16
under run-to-run noise: Trainer runs at full width and batch 64 on one
CUDA card, set up as those phases set them up (an arch with the recipe's
flags, phases 14-15; TATT with one of phase 12's flag sets; the Chinese
path, ``--CHNSR --tpg OPT``, on Chinese-labelled crops, phase 16), repeated and
over a few init seeds.  Each run is two ``Trainer.train`` calls, the
phase's warm-up and then the rest, as the phases run them (each call
walks the loader afresh).  For each run prints ``loss_sr`` step by step,
the median of steps 2-4 and of the 5 steps ending at each of ``--ends``.

  python3 scripts/loss_gate_margins.py --archs pcan_tl pcan --steps 45 --reps 3 --seeds 77 5150
  python3 scripts/loss_gate_margins.py --archs --flag-sets "training_stablize + ssim_loss" \\
      --steps 47 --ends 32 47
  python3 scripts/loss_gate_margins.py --archs --chinese --steps 45 --ends 25 35 45
  python3 scripts/loss_gate_margins.py --archs --bf16-windows chinese recipe --steps 45

``--bf16-windows`` runs phase 18's gated bf16 windows (``chip_smoke.BF16_WINDOWS``)
as that phase sets them up (``chip_smoke.cli_trainer``, ``--dtype bfloat16``).

The trajectory of one seed differs run to run from about the fifth step
(cuDNN's weight-gradient sums), and loss_sr varies about 2x from batch to
batch, so the gate's margin is read over repeats.  Imports no JAX.
"""

from __future__ import annotations

import argparse
import copy
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402  (exits when no CUDA device is present)


def _config(args):
    cfg = cs.Config(args=args)
    cfg.TRAIN.VAL.valInterval = cfg.TRAIN.saveInterval = 0
    cfg.TRAIN.displayInterval = 10**9
    return cfg


def arch_trainer(arch: str, seed: int, train_ds):
    """Phases 14-15: ``arch`` from the factory, the recipe's flags."""
    cfg = _config(cs.Flags(arch=arch, batch_size=cs.BATCH, lr=cs.ZOO_LR.get(arch), **cs.TSRN_RECIPE))
    gen = cs.init_parameters(cs.build_generator(arch, cfg), seed).to(cs.DEV)
    return cs.Trainer(cfg, [gen], [cs.init_parameters(cs.CRNN(), seed + 1).to(cs.DEV)],
                      cs.init_parameters(cs.CRNN(), seed + 2).to(cs.DEV), train_ds, cs.DEV)


def flags_trainer(name: str, seed: int, train_ds):
    """Phase 12: TATT at full width with the recipe and flag set ``name``."""
    args = cs.Flags(**{**cs.TSRN_RECIPE, "batch_size": cs.BATCH, **cs.FLAG_SETS[name][0]})
    n_sr, n_stu = cs.copies(args)
    tatt = cs.TATT(srb_nums=5, hidden_units=32, out_text_channels=64, mask=True, stn=True)
    gens = [cs.init_parameters(copy.deepcopy(tatt), seed + 3 * i).to(cs.DEV) for i in range(n_sr)]
    stus = [cs.init_parameters(cs.CRNN(), seed + 1 + 3 * i).to(cs.DEV) for i in range(n_stu)]
    return cs.Trainer(_config(args), gens, stus, cs.init_parameters(cs.CRNN(), seed + 2).to(cs.DEV),
                      train_ds, cs.DEV)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--archs", nargs="*", default=["pcan_tl", "pcan"])
    ap.add_argument("--flag-sets", nargs="*", default=[], choices=list(cs.FLAG_SETS),
                    help="phase 12's flag sets, by name")
    ap.add_argument("--chinese", action="store_true", help="phase 16's --CHNSR --tpg OPT trainer")
    ap.add_argument("--bf16-windows", nargs="*", default=[],
                    choices=[k for k, v in cs.BF16_WINDOWS.items() if v[5]],
                    help="phase 18's gated bf16 windows, by name")
    ap.add_argument("--steps", type=int, default=45, help="steps a run, warm-up included")
    ap.add_argument("--reps", type=int, default=3, help="runs at the phases' init seed 1234")
    ap.add_argument("--seeds", type=int, nargs="*", default=[77, 5150],
                    help="further init seeds, one run each")
    ap.add_argument("--ends", type=int, nargs="+", default=[25, 35, 45],
                    help="steps at which the gate's last-5 median is read")
    args = ap.parse_args(argv)
    cs.set_cuda_flags()
    cs._build.build()
    smi = cs.subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                            capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi)
    train_ds = cs.SyntheticTextDataset(n=8 * cs.BATCH, seed=1)
    for i in range(len(train_ds)):
        train_ds[i]
    # warm-up steps: phase 15's gated archs, phase 14 and phase 16 take 5, phase 12 2
    runs = ([(a, arch_trainer, cs.TSRN_WARM) for a in args.archs]
            + [(f, flags_trainer, cs.FLAG_WARM) for f in args.flag_sets])
    chinese_ds = (cs.chinese_dataset(8 * cs.BATCH, 1)
                  if args.chinese or "chinese" in args.bf16_windows else None)
    if args.chinese:
        runs.append(("chinese", lambda _, seed, __: cs.chinese_trainer(seed, chinese_ds),
                     cs.CHINESE_WARM))
    for name in args.bf16_windows:
        argv, data, warm = cs.BF16_WINDOWS[name][:3]
        ds = chinese_ds if data == "chinese" else train_ds
        runs.append((f"{name} bf16", lambda _, seed, __, argv=argv, ds=ds: cs.cli_trainer(
            argv + ["--dtype", "bfloat16"], seed, ds), warm))
    for name, build, warm in runs:
        for rep, seed in enumerate([1234] * args.reps + list(args.seeds)):
            trainer = build(name, seed, train_ds)
            t0 = time.perf_counter()
            sr = trainer.train(max_iters=warm)["metrics"]["loss_sr"]
            sr += trainer.train(max_iters=args.steps)["metrics"]["loss_sr"]
            wall = time.perf_counter() - t0
            ends = ", ".join(f"last 5 at {e} {np.median(sr[e - 5:e]):.3f}"
                             for e in args.ends if e <= len(sr))
            print(f"[gate] {name} init seed {seed} run {rep} ({wall:.1f} s): steps 2-4 "
                  f"{np.median(sr[1:4]):.3f}, {ends}; loss_sr {[round(v, 3) for v in sr]} ({smi})",
                  flush=True)
            del trainer
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
