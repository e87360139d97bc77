"""The port's LMDB reader and writer, TextZoom dataset and loader (CPU)
against the JAX package.

The writer must give the same ``data.mdb`` bytes as the JAX one, each
package must read the other's files, dataset items must be equal (arrays
bit for bit, labels as strings), and loader batches bitwise equal for any
worker count.  Exact equality throughout: no arithmetic differs.
"""

import io

import numpy as np
import pytest
from PIL import Image

from tatt_tpu.data import lmdb_dataset as jlmdb_dataset
from tatt_tpu.data.lmdb_dataset import ConcatDataset as JConcat
from tatt_tpu.data.lmdb_dataset import LmdbTextDataset as JLmdbText
from tatt_tpu.data.lmdb_lite import LmdbEnv as JEnv
from tatt_tpu.data.lmdb_lite import write_lmdb as jwrite_lmdb
from tatt_tpu.data.loader import DataLoader as JDataLoader
from tatt_tpu_torch.data.lmdb_dataset import ConcatDataset, LmdbTextDataset
from tatt_tpu_torch.data.lmdb_lite import LmdbEnv, write_lmdb
from tatt_tpu_torch.data.loader import DataLoader
from tatt_tpu_torch.data.synthetic import SyntheticTextDataset


def _records(kind: str) -> dict:
    """The three record sets of tests/test_lmdb.py."""
    if kind == "small":
        records = {b"key-%03d" % i: b"value-%05d" % (i * 7) for i in range(500)}
        records[b"num-samples"] = b"500"
        return records
    if kind == "overflow":
        rng = np.random.default_rng(0)
        return {
            b"blob-%09d" % i: rng.integers(0, 256, int(rng.integers(3000, 60000)), dtype=np.uint8).tobytes()
            for i in range(20)
        }
    return {b"k%09d" % i: (b"v%d" % i) * 10 for i in range(20000)}


@pytest.mark.parametrize("kind", ["small", "overflow", "many_keys"])
def test_writer_bytes_and_cross_reading_match_the_jax_package(tmp_path, kind):
    records = _records(kind)
    ours = write_lmdb(str(tmp_path / "port"), records)
    theirs = jwrite_lmdb(str(tmp_path / "jax"), records)
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    keys = list(records) if kind != "many_keys" else [b"k%09d" % i for i in (0, 1, 9999, 19998, 19999)]
    for reader, root in ((LmdbEnv, "jax"), (JEnv, "port")):  # each reads the other's file
        env = reader(str(tmp_path / root))
        assert env.entries() == len(records)
        for k in keys:
            assert env.get(k) == records[k], (reader, k)
        assert env.get(b"missing") is None
        env.close()


def _encode(img: Image.Image, fmt: str) -> bytes:
    buf = io.BytesIO()
    img.save(buf, format=fmt)
    return buf.getvalue()


def write_textzoom(root: str, n: int, seed: int) -> str:
    """A TextZoom-layout LMDB of ``n`` synthetic samples: every third one
    JPEG, every fifth an HR and LR of another size than 128x32 / 64x16,
    mixed-case labels with punctuation, sample 4 without its label and
    sample 6 with a corrupt HR image."""
    ds = SyntheticTextDataset(n=n, seed=seed)
    records = {b"num-samples": str(n).encode()}
    for i in range(n):
        hr, lr, label = ds[i]
        if i % 5 == 2:
            hr, lr = hr.resize((100, 30)), lr.resize((50, 14))
        fmt = "JPEG" if i % 3 == 0 else "PNG"
        key = i + 1
        if i != 4:
            records[b"label-%09d" % key] = (label.upper() if i % 2 else label).encode() + b"-!"
        records[b"image_hr-%09d" % key] = b"\x89PNG garbage" if i == 6 else _encode(hr, fmt)
        records[b"image_lr-%09d" % key] = _encode(lr, fmt)
    write_lmdb(root, records)
    return root


@pytest.fixture
def pil_decode_in_jax(monkeypatch):
    """The port decodes with PIL: the card's machine may have no OpenCV.
    The JAX package decodes JPEG with OpenCV when it can import it
    (``lmdb_dataset.py:70``); whether OpenCV's libjpeg build and PIL's
    agree is a property of the two installed builds, not of the format,
    so the JAX side is held on its PIL path to compare one decoder with
    itself and test the dataset logic alone."""
    monkeypatch.setattr(jlmdb_dataset, "_cv2", None)


@pytest.mark.parametrize("voc_type", ["lower", "all"])
def test_textzoom_items_match_the_jax_dataset(tmp_path, pil_decode_in_jax, voc_type):
    root = write_textzoom(str(tmp_path / "tz"), 12, seed=3)
    ours, theirs = LmdbTextDataset(root, voc_type=voc_type), JLmdbText(root, voc_type=voc_type)
    assert len(ours) == len(theirs) == 12
    for i in list(range(12)) + [12, 40]:  # past the end reads the last sample
        (hr, lr, label), (jhr, jlr, jlabel) = ours[i], theirs[i]
        np.testing.assert_array_equal(np.asarray(hr), np.asarray(jhr), err_msg=str(i))
        np.testing.assert_array_equal(np.asarray(lr), np.asarray(jlr), err_msg=str(i))
        assert label == jlabel, i
    assert ours[4][2] == ""  # the missing label reads " ", which no vocabulary keeps
    assert ours[6][2] == ours[7][2]  # the corrupt record reads the next one
    assert ours[2][0].size == (100, 30)  # odd sizes come through as stored


def test_concat_indexing_matches(tmp_path):
    roots = [write_textzoom(str(tmp_path / f"tz{k}"), n, seed=k) for k, n in enumerate((5, 7, 3))]
    ours = ConcatDataset([LmdbTextDataset(r) for r in roots])
    theirs = JConcat([JLmdbText(r) for r in roots])
    assert len(ours) == len(theirs) == 15
    assert [ours[i][2] for i in range(15)] == [theirs[i][2] for i in range(15)]


@pytest.mark.parametrize("workers", [1, 4])
def test_loader_batches_match_the_jax_loader(tmp_path, pil_decode_in_jax, workers):
    """Two shuffled epochs at batch 4 over 22 samples (two LMDBs, odd
    sizes resized in collate), against the JAX loader's uint8 collate with
    the same seed: bitwise equal, so every worker count agrees."""
    roots = [write_textzoom(str(tmp_path / f"tz{k}"), 11, seed=k) for k in range(2)]
    ours = DataLoader(ConcatDataset([LmdbTextDataset(r) for r in roots]), 4, seed=7,
                      num_workers=workers)
    theirs = JDataLoader(JConcat([JLmdbText(r) for r in roots]), 4, seed=7,
                         collate_kwargs=dict(raw=True))
    for _ in range(2):
        got, want = list(ours), list(theirs)
        assert len(got) == len(want) == 5
        for b, jb in zip(got, want):
            np.testing.assert_array_equal(b.images_hr, jb.images_hr)
            np.testing.assert_array_equal(b.images_lr, jb.images_lr)
            assert b.label_strs == jb.label_strs
    assert len(list(DataLoader(ours.dataset, 4, drop_last=False, num_workers=workers,
                               prefetch=0))) == 6
