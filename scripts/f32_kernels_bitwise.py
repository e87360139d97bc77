"""Whether two trees' float32 recurrence kernels give bitwise-equal results.

On one CUDA card, each tree's four kernels (``tatt_tpu_torch/csrc``, built
from that tree's sources into its own ``_build``) run on the same seeded
inputs at the training path's shapes (gru1 L=16 R=8192, gru2 L=64 R=2048,
H=32; the student's BiLSTM L=26 R=64 H=256), forward and backward; the
outputs are saved, then compared bit for bit:

  python3 scripts/f32_kernels_bitwise.py --tree OLD --out old.pt
  python3 scripts/f32_kernels_bitwise.py --tree NEW --out new.pt
  python3 scripts/f32_kernels_bitwise.py --compare old.pt new.pt

Each ``--tree`` run is its own process, so the two packages never meet.
"""

from __future__ import annotations

import argparse
import sys

import torch

SHAPES = (("gru", 16, 8192, 32), ("gru", 64, 2048, 32), ("lstm", 26, 64, 256))


def run(tree: str, out: str) -> None:
    sys.path.insert(0, tree)
    from tatt_tpu_torch.kernels import gru, lstm

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    results = {}
    for kind, length, rows, hid in SHAPES:
        rnd = lambda *s: torch.randn(*s, generator=gen).to(dev)  # noqa: E731
        key = f"{kind} L={length} R={rows} H={hid}"
        if kind == "gru":
            gates, w, b = rnd(2, length, 3 * hid, rows), rnd(2, 3 * hid, hid) * hid**-0.5, rnd(2, 3 * hid)
            out_h = gru.bigru_recurrence(gates, w, b)
            dy = rnd(*out_h.shape)
            results[key] = [out_h, *gru.bigru_recurrence_bwd(gates, w, b, out_h, dy)]
        else:
            gates, w, b = rnd(2, rows, length, 4 * hid), rnd(2, 4 * hid, hid) * hid**-0.5, rnd(2, 4 * hid)
            out_h, cs = lstm.bilstm_recurrence(gates, w, b, with_cs=True)
            dy = rnd(*out_h.shape)
            results[key] = [out_h, cs, *lstm.bilstm_recurrence_bwd(gates, w, b, out_h, cs, dy)]
    torch.save({k: [t.cpu() for t in v] for k, v in results.items()}, out)
    print(f"{tree}: saved {sum(len(v) for v in results.values())} outputs to {out}")


def compare(a: str, b: str) -> int:
    ra, rb = torch.load(a), torch.load(b)
    same = True
    for key in ra:
        eq = [torch.equal(x, y) for x, y in zip(ra[key], rb[key])]
        same &= all(eq)
        print(f"{key}: outputs bitwise equal {eq}")
    print("f32 kernels bitwise equal" if same else "f32 kernels DIFFER")
    return 0 if same else 1


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree")
    ap.add_argument("--out")
    ap.add_argument("--compare", nargs=2)
    args = ap.parse_args()
    if args.compare:
        return compare(*args.compare)
    run(args.tree, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
