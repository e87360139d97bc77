"""The port's dataset readers, augmenting TextZoom datasets and LMDB tools
(``tatt_tpu_torch.data.variants``, ``lmdb_dataset``, ``prep_tools``,
``create_lmdb``) against the JAX package's on the same fixtures, which the
tests write (a few small crops in each corpus's layout): identical pixels
and labels.  The JAX side decodes with PIL (``pil_decode_in_jax``) and its
shot noise, which it draws from numpy's global state, is seeded with the
sample's key, as the port seeds its own generator.  The manmade
degradation is compared with ``cv2``'s primitives swapped in for the
port's (exact), and with the port's own within the gap
``tests/test_torch_degradation.py`` states.
"""

import io
import os
import pickle
import random

import numpy as np
import pytest
from PIL import Image

from tatt_tpu.data import create_lmdb as jcreate
from tatt_tpu.data import lmdb_dataset as jlmdb
from tatt_tpu.data import prep_tools as jprep
from tatt_tpu.data import variants as jvariants
from tatt_tpu_torch.data import create_lmdb, lmdb_dataset, prep_tools, variants
from tatt_tpu_torch.data.lmdb_lite import write_lmdb
from test_torch_degradation import cv2_primitives  # noqa: F401  (a fixture)
from test_torch_lmdb import pil_decode_in_jax, write_textzoom  # noqa: F401  (a fixture)


def _crop(seed: int, w: int = 64, h: int = 32) -> Image.Image:
    """A noisy colour crop (uniform crops would hide a wrong blur)."""
    return Image.fromarray(np.random.RandomState(seed).randint(0, 256, (h, w, 3)).astype(np.uint8))


def _png(img: Image.Image) -> bytes:
    buf = io.BytesIO()
    img.save(buf, format="PNG")
    return buf.getvalue()


def _same_items(ours, theirs, indices=None):
    assert len(ours) == len(theirs)
    for i in indices if indices is not None else range(len(ours) + 2):
        a, b = ours[i], theirs[i]
        assert len(a) == len(b), i
        for x, y in zip(a, b):
            if isinstance(x, str):
                assert x == y, i
            else:
                np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=str(i))


def _badset(tmp_path):
    d = tmp_path / "bad"
    d.mkdir()
    for i, word in enumerate(["Hello", "wor-ld", "x"]):
        _crop(i, 60 + i, 20 + i).save(d / f"{i:04d}_{word}_x.png")
    (d / "0003_broken_x.png").write_bytes(b"not a png")
    Image.new("RGB", (1, 5)).save(d / "0004_tiny_x.png")  # under 2 px: skipped
    return str(d)


def _write_pgm(path, arr):
    with open(path, "wb") as fh:
        fh.write(b"P5\n# a comment\n%d %d\n255\n" % (arr.shape[1], arr.shape[0]))
        fh.write(arr.astype(np.uint8).tobytes())


def _ic15_textsr(tmp_path, split="TEST"):
    root = tmp_path / split / "ic15"
    for sub in ("HR", "LR", "ANNOTATION"):
        (root / sub).mkdir(parents=True)
    mode = "train" if split == "TRAIN" else "test"
    rs = np.random.RandomState(1)
    for i in range(3):
        _write_pgm(root / "HR" / f"{mode}-hr-{i + 1:04d}.pgm", rs.randint(0, 256, (32, 128)))
        _write_pgm(root / "LR" / f"{mode}-lr-{i + 1:04d}.pgm", rs.randint(0, 256, (16, 64)))
        (root / "ANNOTATION" / f"{mode}-annot-{i + 1:04d}.txt").write_text(f"Word{i}!\n")
    (root / "ANNOTATION" / f"{mode}-annot-0002.txt").write_text("")  # empty: skipped
    return str(root)


def test_badset_folder(tmp_path):
    root = _badset(tmp_path)
    _same_items(variants.BadSetFolderDataset(root), jvariants.BadSetFolderDataset(root))


@pytest.mark.parametrize("split", ["TEST", "TRAIN"])
def test_ic15_textsr_and_read_pgm(tmp_path, split):
    root = _ic15_textsr(tmp_path, split)
    _same_items(variants.IC15TextSRDataset(root, voc_type="lower"),
                jvariants.IC15TextSRDataset(root, voc_type="lower"))
    mode = "train" if split == "TRAIN" else "test"
    path = os.path.join(root, "HR", f"{mode}-hr-0001.pgm")
    np.testing.assert_array_equal(variants.read_pgm(path), jvariants.read_pgm(path))


def test_svt_folder(tmp_path):
    for split in ("svt_test", "svt_train"):
        (tmp_path / split / "IMG").mkdir(parents=True)
        (tmp_path / split / "label").mkdir()
        for i, word in enumerate(["Street", "sign"]):
            _crop(10 + i).save(tmp_path / split / "IMG" / f"im{i}.jpg")
            (tmp_path / split / "label" / f"im{i}.txt").write_text(word + "\n")
        (tmp_path / split / "label" / "im9.txt").write_text("nojpg\n")  # image missing: skipped
    for test in (False, True):
        _same_items(variants.SVTFolderDataset(str(tmp_path), test=test),
                    jvariants.SVTFolderDataset(str(tmp_path), test=test))


def test_ic15_recognition_sr(tmp_path):
    root = str(tmp_path / "ic15")
    records = {b"num-samples": b"4"}
    for i in range(1, 5):
        img = Image.new("RGB", (3, 3)) if i == 2 else _crop(i, 50, 20)  # under 4 px: skipped
        records[b"image-%09d" % i] = b"\x89PNG broken" if i == 3 else _png(img)
        if i != 4:
            records[b"label-%09d" % i] = b"IcText%d" % i
    write_lmdb(root, records)
    _same_items(variants.IC15RecognitionSRDataset(root), jvariants.IC15RecognitionSRDataset(root))


def test_csvtr_list(tmp_path):
    (tmp_path / "filter_dir").mkdir()
    for i in range(2):
        _crop(20 + i).save(tmp_path / "filter_dir" / f"im{i}.jpg")
    (tmp_path / "filter_train_test.list").write_text(
        "0\t1\tim0.jpg\t中文\n1\t1\tim1.jpg\tAb中\nshort\tline\n2\t1\tmissing.jpg\t字\n")
    _same_items(variants.CSVTRDataset(str(tmp_path)), jvariants.CSVTRDataset(str(tmp_path)))


def test_cocotext(tmp_path):
    for split in ("train", "val"):
        (tmp_path / f"{split}_words").mkdir()
        _crop(30).save(tmp_path / f"{split}_words" / "img7.jpg")
        (tmp_path / f"{split}_words_gt.txt").write_text("img7,Caption\nbroken\nimg8,nofile\n")
    for test in (False, True):
        _same_items(variants.COCOTextDataset(str(tmp_path), test=test),
                    jvariants.COCOTextDataset(str(tmp_path), test=test))


def test_chn_syn_pkl_blurs_as_opencv(tmp_path):
    for i in range(3):
        _crop(40 + i, 70, 30).save(tmp_path / f"k{i}.jpg")
    with open(tmp_path / "a.pkl", "wb") as fh:
        pickle.dump({"k0": "汉字", "k1": "Ab"}, fh)
    with open(tmp_path / "b.pkl", "wb") as fh:
        pickle.dump({"k2": "字x", "k9": "no image"}, fh)
    _same_items(variants.CHNSynPklDataset(str(tmp_path)), jvariants.CHNSynPklDataset(str(tmp_path)))


def test_distorted_masked_and_w2v(tmp_path, pil_decode_in_jax):  # noqa: F811
    root = write_textzoom(str(tmp_path / "tz"), 8, seed=4)
    picked = tmp_path / "easy_distorted.txt"
    picked.write_text("2\n7\n\n5\n")
    _same_items(variants.DistortedSubsetDataset(root, str(picked)),
                jvariants.DistortedSubsetDataset(root, str(picked)))
    _same_items(variants.MaskedLmdbDataset(root), jvariants.MaskedLmdbDataset(root), range(8))

    def embed(word):
        return np.arange(300, dtype=np.float64) * len(word)

    _same_items(variants.W2VLmdbDataset(root, embed_fn=embed),
                jvariants.W2VLmdbDataset(root, embed_fn=embed), range(8))
    with pytest.raises(ValueError, match="embed_fn"):
        variants.W2VLmdbDataset(root)


def _synthtext(tmp_path):
    from scipy.io import savemat

    _crop(50, 200, 100).save(tmp_path / "scene.jpg")
    word_bb = np.zeros((2, 4, 3))
    word_bb[:, :, 0] = [[10, 90, 90, 10], [10, 10, 40, 40]]
    word_bb[:, :, 1] = [[100.5, 150, 150, 100.5], [50, 50, 80.2, 80.2]]
    word_bb[:, :, 2] = [[5, 7, 7, 5], [5, 5, 7, 7]]  # under 4 px: skipped
    gt = {
        "imnames": np.array([[np.array(["scene.jpg"]), np.array(["missing.jpg"])]], dtype=object),
        "wordBB": np.array([[word_bb, word_bb]], dtype=object),
        "txt": np.array([[np.array(["Hello  world\n x"]), np.array(["y"])]], dtype=object),
    }
    savemat(tmp_path / "gt.mat", gt)
    return str(tmp_path / "gt.mat"), str(tmp_path)


def test_globalsr_and_synthtext_crops(tmp_path):
    gt_path, root = _synthtext(tmp_path)
    ours, theirs = list(prep_tools.iter_synthtext_crops(gt_path, root)), \
        list(jprep.iter_synthtext_crops(gt_path, root))
    assert [c[1] for c in ours] == [c[1] for c in theirs] == ["Hello", "world"]
    _same_items(variants.GlobalSRDataset(root), jvariants.GlobalSRDataset(root))
    _same_items(variants.GlobalSRDataset(root, limit=1), jvariants.GlobalSRDataset(root, limit=1))


def test_synthtext_to_lmdb_reads_back_in_jax(tmp_path, pil_decode_in_jax):  # noqa: F811
    gt_path, root = _synthtext(tmp_path)
    assert prep_tools.synthtext_to_lmdb(gt_path, root, str(tmp_path / "ours")) == 2
    assert jprep.synthtext_to_lmdb(gt_path, root, str(tmp_path / "theirs")) == 2
    with open(tmp_path / "ours" / "data.mdb", "rb") as a, open(tmp_path / "theirs" / "data.mdb", "rb") as b:
        assert a.read() == b.read()
    _same_items(lmdb_dataset.LmdbTextDataset(str(tmp_path / "ours")),
                jlmdb.LmdbTextDataset(str(tmp_path / "ours")), range(2))


def test_voc_folder(tmp_path):
    _crop(60, 30, 10).save(tmp_path / "word1.jpg")
    (tmp_path / "word1.txt").write_text("theword\n")
    _crop(61, 30, 10).save(tmp_path / "stem2.JPG")
    _same_items(prep_tools.VocFolderDataset(str(tmp_path)), jprep.VocFolderDataset(str(tmp_path)),
                range(2))


@pytest.mark.parametrize("with_lr", [False, True])
def test_create_lmdb_cli_matches_and_jax_reads_it(tmp_path, pil_decode_in_jax, with_lr):  # noqa: F811
    hr_dir, lr_dir = tmp_path / "hr", tmp_path / "lr"
    hr_dir.mkdir()
    lr_dir.mkdir()
    for i in range(3):
        _crop(70 + i, 128, 32).save(hr_dir / f"s{i}.png")
        _crop(80 + i, 64, 16).save(lr_dir / f"s{i}.png")
    labels = tmp_path / "labels.txt"
    labels.write_text("s0.png Alpha\ns1 beta\n")
    args = ["--hr_dir", str(hr_dir), "--labels", str(labels)] + (["--lr_dir", str(lr_dir)] if with_lr else [])
    assert create_lmdb.main(args + ["--out", str(tmp_path / "ours")]) == 0
    assert jcreate.main(args + ["--out", str(tmp_path / "theirs")]) == 0
    with open(tmp_path / "ours" / "data.mdb", "rb") as a, open(tmp_path / "theirs" / "data.mdb", "rb") as b:
        assert a.read() == b.read()
    theirs = jlmdb.LmdbTextDataset(str(tmp_path / "ours"))
    assert [theirs[i][2] for i in range(3)] == ["Alpha", "beta", "s2"]
    _same_items(lmdb_dataset.LmdbTextDataset(str(tmp_path / "ours")), theirs, range(3))


def test_lmdb_recognition_dataset(tmp_path):
    root = str(tmp_path / "rec")
    records = {b"num-samples": b"3", b"label-000000001": b"One", b"label-000000002": b"Two",
               b"image_hr-000000001": _png(_crop(90)), b"image-000000002": _png(_crop(91)),
               b"image-000000003": b"broken"}
    write_lmdb(root, records)
    _same_items(lmdb_dataset.LmdbRecognitionDataset(root), jlmdb.LmdbRecognitionDataset(root), range(3))


def _seeded_jax_items(theirs, key_of, indices):
    """JAX items with numpy's global state seeded as the port seeds its
    shot noise, sample by sample."""
    out = []
    for i in indices:
        np.random.seed(key_of(i) % 2**32)
        out.append(theirs[i])
    return out


def _compare(ours, jax_items, indices, exact: bool):
    for i, a, b in zip(indices, ours, jax_items):
        assert a[2] == b[2]
        np.testing.assert_array_equal(np.asarray(a[0]), np.asarray(b[0]))
        lr, jlr = np.asarray(a[1]), np.asarray(b[1])
        if exact:
            np.testing.assert_array_equal(lr, jlr, err_msg=str(i))
        else:  # the bilateral branch's rare rounding (test_torch_degradation)
            d = np.abs(lr.astype(int) - jlr)
            assert d.max() <= 8 and (d > 0).mean() <= 1e-3, (i, d.max())


@pytest.mark.parametrize("swap", [True, False])
def test_textzoom_manmade_degrade_and_cutblur_over_two_epochs(tmp_path, pil_decode_in_jax,  # noqa: F811
                                                              request, swap):
    if swap:
        request.getfixturevalue("cv2_primitives")
    root = write_textzoom(str(tmp_path / "tz"), 10, seed=6)
    stored = [np.asarray(jlmdb.LmdbTextDataset(root)[i][1]) for i in range(10)]
    for kwargs in (dict(manmade_degrade=True), dict(cutblur=True),
                   dict(manmade_degrade=True, cutblur=True, seed=3), dict(cutblur=True, test=True)):
        ours, theirs = lmdb_dataset.LmdbTextDataset(root, **kwargs), jlmdb.LmdbTextDataset(root, **kwargs)
        seed, changed = kwargs.get("seed", 0), 0
        for epoch in (0, 1):
            ours.set_epoch(epoch)
            theirs.set_epoch(epoch)

            def key(i):  # sample 6 is corrupt: the dataset reads sample 7, with its key
                return lmdb_dataset.sample_key(seed, epoch, 7 if i == 6 else i)

            items = [ours[i] for i in range(10)]
            _compare(items, _seeded_jax_items(theirs, key, range(10)), range(10), swap)
            changed += sum(not np.array_equal(np.asarray(it[1]), lr) for it, lr in zip(items, stored))
        assert changed > 0 or kwargs.get("test")


@pytest.mark.parametrize("swap", [True, False])
def test_mix_dataset_over_two_epochs(tmp_path, pil_decode_in_jax, request, swap):  # noqa: F811
    if swap:
        request.getfixturevalue("cv2_primitives")
    roots = [write_textzoom(str(tmp_path / f"tz{k}"), 6, seed=7 + k) for k in range(2)]
    ours = lmdb_dataset.ConcatDataset([lmdb_dataset.MixDataset(lmdb_dataset.LmdbTextDataset(r))
                                       for r in roots])
    theirs = jlmdb.ConcatDataset([jlmdb.MixDataset(jlmdb.LmdbTextDataset(r)) for r in roots])
    replaced = []
    for epoch in (0, 1):
        ours.set_epoch(epoch)
        theirs.set_epoch(epoch)

        def key(i):
            return lmdb_dataset.sample_key(0, epoch, i % 6) ^ lmdb_dataset.MIX_STREAM

        items = [ours[i] for i in range(12)]
        _compare(items, _seeded_jax_items(theirs, key, range(12)), range(12), swap)
        replaced.append([random.Random(key(i)).random() < 0.5 for i in range(12)])
    assert replaced[0] != replaced[1]  # the next epoch's draws differ
