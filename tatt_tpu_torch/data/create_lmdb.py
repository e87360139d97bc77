"""A TextZoom-layout LMDB from image folders (counterpart of
``tatt_tpu/data/create_lmdb.py``, the reference's ``dataset/create_lmdb.py``).

Keys ``num-samples``, ``label-%09d``, ``image_hr-%09d`` and
``image_lr-%09d`` (PNG), from paired HR / LR folders, or from HR alone
with the LR its bicubic downsample by ``--scale``:

  python -m tatt_tpu_torch.data.create_lmdb --hr_dir HR [--lr_dir LR] \\
      [--labels labels.txt] [--scale 2] --out train_lmdb

``--labels`` holds ``<name> <label>`` lines (a name with or without its
extension); an image without one is labelled by its stem.
"""

from __future__ import annotations

import argparse
import io
import os
import sys
from typing import Iterable, Optional

from PIL import Image

from tatt_tpu_torch.data.lmdb_lite import write_lmdb


def encode_image(img: Image.Image, fmt: str = "PNG") -> bytes:
    buf = io.BytesIO()
    img.save(buf, format=fmt)
    return buf.getvalue()


def create_dataset(out_root: str, samples: Iterable, down_sample_scale: int = 2) -> int:
    """``samples``: (HR PIL, LR PIL or None, label) triples.  Writes
    ``<out_root>/data.mdb``; returns the sample count."""
    records: dict[bytes, bytes] = {}
    n = 0
    for hr, lr, label in samples:
        n += 1
        if lr is None:
            lr = hr.resize((hr.width // down_sample_scale, hr.height // down_sample_scale),
                           Image.BICUBIC)
        records[b"label-%09d" % n] = label.encode("utf-8")
        records[b"image_hr-%09d" % n] = encode_image(hr)
        records[b"image_lr-%09d" % n] = encode_image(lr)
    records[b"num-samples"] = str(n).encode()
    write_lmdb(out_root, records)
    return n


def iter_folder(hr_dir: str, lr_dir: Optional[str], labels_file: Optional[str]):
    """(HR, LR or None, label) triples of the images of ``hr_dir``, by name."""
    labels = {}
    if labels_file:
        with open(labels_file) as fh:
            for line in fh:
                parts = line.rstrip("\n").split(maxsplit=1)
                if len(parts) == 2:
                    labels[parts[0]] = parts[1]
    for name in sorted(os.listdir(hr_dir)):
        stem = os.path.splitext(name)[0]
        label = labels.get(name, labels.get(stem, stem))
        hr = Image.open(os.path.join(hr_dir, name)).convert("RGB")
        lr = None
        if lr_dir and os.path.exists(os.path.join(lr_dir, name)):
            lr = Image.open(os.path.join(lr_dir, name)).convert("RGB")
        yield hr, lr, label


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="create a TextZoom-layout LMDB")
    p.add_argument("--hr_dir", required=True)
    p.add_argument("--lr_dir", default=None)
    p.add_argument("--labels", default=None, help="file of '<name> <label>' lines")
    p.add_argument("--out", required=True)
    p.add_argument("--scale", type=int, default=2)
    args = p.parse_args(argv)
    n = create_dataset(args.out, iter_folder(args.hr_dir, args.lr_dir, args.labels), args.scale)
    print(f"wrote {n} samples to {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
