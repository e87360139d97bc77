"""Dataset-variant readers (counterpart of ``tatt_tpu/data/variants.py``):
the reference's corpora beyond the TextZoom default, each
``ds[i] -> (img_hr, img_lr, label)`` PIL triples for the collate
(the masked and word-vector readers add a fourth element).

| Class here                | Reference (dataset/dataset.py)       |
|---------------------------|--------------------------------------|
| BadSetFolderDataset       | lmdbDataset_realBadSet:62            |
| GlobalSRDataset           | lmdbDataset_GlobalSR:379 (+ get_Syn_800K_with_words:173) |
| DistortedSubsetDataset    | lmdbDataset_realDistorted:689        |
| CHNSynPklDataset          | lmdbDataset_realCHNSyn:821           |
| IC15TextSRDataset         | lmdbDataset_realIC15TextSR:877       |
| SVTFolderDataset          | lmdbDataset_realSVT:967              |
| IC15RecognitionSRDataset  | lmdbDataset_realIC15:1023            |
| CSVTRDataset              | lmdbDataset_CSVTR:1118               |
| COCOTextDataset           | lmdbDataset_realCOCOText:1160        |
| W2VLmdbDataset            | lmdbDatasetWithW2V_real:1209         |
| MaskedLmdbDataset         | lmdbDatasetWithMask_real:1538        |
"""

from __future__ import annotations

import os
import pickle
import re
from typing import Callable, Optional

import numpy as np
from PIL import Image

from tatt_tpu_torch.core.charset import str_filt
from tatt_tpu_torch.data import imgproc
from tatt_tpu_torch.data.lmdb_dataset import LmdbTextDataset, open_lmdb, buf2pil
from tatt_tpu_torch.data.prep_tools import iter_synthtext_crops


def _rgb(path: str) -> Image.Image:
    return Image.open(path).convert("RGB")


class BadSetFolderDataset:
    """Folder of hard-case images, the label from the file name
    (``name_label_*.png``); LR = HR copy (``dataset.py:62-126``)."""

    def __init__(self, root: str, voc_type: str = "all"):
        self.root = root
        self.imlist = sorted(os.listdir(root))
        self.voc_type = voc_type

    def __len__(self) -> int:
        return len(self.imlist)

    def __getitem__(self, index: int):
        imfile = self.imlist[index % len(self.imlist)]
        parts = imfile.split("_")
        word = parts[1] if len(parts) > 1 else ""
        try:
            img_hr = _rgb(os.path.join(self.root, imfile))
        except (OSError, ValueError):
            return self[(index + 1) % len(self)]
        if img_hr.width < 2 or img_hr.height < 2:
            return self[(index + 1) % len(self)]
        return img_hr, img_hr.copy(), str_filt(word, self.voc_type)


def read_pgm(filename: str) -> np.ndarray:
    """Raw PGM (P5) reader (``dataset.py:912-934``)."""
    with open(filename, "rb") as fh:
        buf = fh.read()
    m = re.search(
        rb"(^P5\s(?:\s*#.*[\r\n])*"
        rb"(\d+)\s(?:\s*#.*[\r\n])*"
        rb"(\d+)\s(?:\s*#.*[\r\n])*"
        rb"(\d+)\s(?:\s*#.*[\r\n]\s)*)",
        buf,
    )
    if m is None:
        raise ValueError(f"not a raw PGM file: {filename}")
    header, width, height, maxval = m.groups()
    dtype = "u1" if int(maxval) < 256 else "<u2"
    return np.frombuffer(
        buf, dtype=dtype, count=int(width) * int(height), offset=len(header)
    ).reshape((int(height), int(width)))


class IC15TextSRDataset:
    """IC15 TextSR pairs: HR / LR / ANNOTATION dirs of .pgm crops and txt
    labels (``dataset.py:877-964``); the split from the parent dir's name."""

    def __init__(self, root: str, voc_type: str = "all"):
        mode = "train" if os.path.basename(os.path.dirname(root.rstrip("/"))) == "TRAIN" else "test"
        hr_dir = os.path.join(root, "HR")
        n = len(os.listdir(hr_dir))
        self.hr_paths = [os.path.join(hr_dir, f"{mode}-hr-{i + 1:04d}.pgm") for i in range(n)]
        self.lr_paths = [os.path.join(root, "LR", f"{mode}-lr-{i + 1:04d}.pgm") for i in range(n)]
        self.anno_paths = [os.path.join(root, "ANNOTATION", f"{mode}-annot-{i + 1:04d}.txt")
                           for i in range(n)]
        self.voc_type = voc_type

    def __len__(self) -> int:
        return len(self.anno_paths)

    def __getitem__(self, index: int):
        idx = index % len(self)
        try:
            hr = read_pgm(self.hr_paths[idx]).astype(np.uint8)
            lr = read_pgm(self.lr_paths[idx]).astype(np.uint8)
            with open(self.anno_paths[idx]) as fh:
                label = fh.readlines()[0].strip()
        except (OSError, ValueError, IndexError):
            return self[(index + 1) % len(self)]
        img_hr = Image.fromarray(np.repeat(hr[..., None], 3, axis=-1))
        img_lr = Image.fromarray(np.repeat(lr[..., None], 3, axis=-1))
        return img_hr, img_lr, str_filt(label, self.voc_type)


class SVTFolderDataset:
    """SVT word crops: ``svt_{train,test}/IMG/*.jpg`` + ``label/*.txt``
    (``dataset.py:967-1020``); LR = HR."""

    def __init__(self, root: str, voc_type: str = "all", test: bool = False):
        split = "svt_test" if test else "svt_train"
        self.image_dir = os.path.join(root, split, "IMG")
        self.anno_dir = os.path.join(root, split, "label")
        self.anno_list = sorted(os.listdir(self.anno_dir))
        self.voc_type = voc_type

    def __len__(self) -> int:
        return len(self.anno_list)

    def __getitem__(self, index: int):
        anno = self.anno_list[index % len(self)]
        image_path = os.path.join(self.image_dir, anno.split(".")[0] + ".jpg")
        try:
            with open(os.path.join(self.anno_dir, anno)) as fh:
                word = fh.readlines()[0].strip()
            img_hr = _rgb(image_path)
        except (OSError, ValueError, IndexError):
            return self[(index + 1) % len(self)]
        return img_hr, img_hr.copy(), str_filt(word, self.voc_type)


class IC15RecognitionSRDataset:
    """A recognition LMDB (``image-%09d`` keys) as an SR corpus with LR =
    HR (``lmdbDataset_realIC15``, ``dataset.py:1023-1115``); crops under
    4 px skipped."""

    def __init__(self, root: str, voc_type: str = "all"):
        self.env, self.n_samples = open_lmdb(root)
        self.voc_type = voc_type

    def __len__(self) -> int:
        return self.n_samples

    def __getitem__(self, index: int):
        idx = (index % self.n_samples) + 1
        label_buf = self.env.get(b"label-%09d" % idx)
        word = label_buf.decode("utf-8", "ignore") if label_buf else " "
        buf = self.env.get(b"image-%09d" % idx)
        try:
            img_hr = buf2pil(buf) if buf is not None else None
        except OSError:
            img_hr = None
        if img_hr is None or img_hr.width < 4 or img_hr.height < 4:
            return self[(index + 1) % self.n_samples]
        return img_hr, img_hr.copy(), str_filt(word, self.voc_type)


class CSVTRDataset:
    """Chinese street-view text: ``filter_dir`` images and the
    tab-separated ``filter_train_test.list`` (``dataset.py:1118-1157``);
    labels are not filtered."""

    def __init__(self, root: str):
        self.imdir = os.path.join(root, "filter_dir")
        self.gt_pairs = []
        with open(os.path.join(root, "filter_train_test.list")) as fh:
            for line in fh:
                items = line.rstrip("\n").split("\t")
                if len(items) >= 4:
                    self.gt_pairs.append((os.path.join(self.imdir, items[2]), items[3]))

    def __len__(self) -> int:
        return len(self.gt_pairs)

    def __getitem__(self, index: int):
        path, word = self.gt_pairs[index % len(self)]
        try:
            img_hr = _rgb(path)
        except OSError:
            return self[(index + 1) % len(self)]
        return img_hr, img_hr.copy(), word


class COCOTextDataset:
    """COCO-Text word crops: ``{train,val}_words/`` and a comma-separated
    gt file; the test split cut to 3000 (``dataset.py:1160-1206``)."""

    def __init__(self, root: str, voc_type: str = "all", test: bool = False):
        gt_file = "val_words_gt.txt" if test else "train_words_gt.txt"
        self.image_dir = os.path.join(root, "val_words" if test else "train_words")
        with open(os.path.join(root, gt_file)) as fh:
            self.gtlist = [line.rstrip("\n") for line in fh]
        if test:
            self.gtlist = self.gtlist[:3000]
        self.voc_type = voc_type

    def __len__(self) -> int:
        return len(self.gtlist)

    def __getitem__(self, index: int):
        parts = self.gtlist[index % len(self)].split(",")
        if len(parts) < 2:
            return self[(index + 1) % len(self)]
        img_id, label = parts[:2]
        try:
            img_hr = _rgb(os.path.join(self.image_dir, img_id + ".jpg"))
        except OSError:
            return self[(index + 1) % len(self)]
        return img_hr, img_hr.copy(), str_filt(label, self.voc_type)


class CHNSynPklDataset:
    """Chinese synthetic corpus: pickled ``{key: word}`` dicts and
    ``key.jpg`` images; LR = the 5x5, sigma 1 Gaussian blur of HR
    (``dataset.py:821-874``).  The pickles are the corpus's own files."""

    def __init__(self, root: str, voc_type: str = "chinese"):
        self.root = root
        self.database: dict[str, str] = {}
        for f in sorted(os.listdir(root)):
            if f.endswith(".pkl"):
                with open(os.path.join(root, f), "rb") as fh:
                    self.database.update(pickle.load(fh))
        self.keys = sorted(self.database)
        self.voc_type = voc_type

    def __len__(self) -> int:
        return len(self.keys)

    def __getitem__(self, index: int):
        key = self.keys[index % len(self)]
        try:
            img_hr = _rgb(os.path.join(self.root, key + ".jpg"))
        except OSError:
            return self[(index + 1) % len(self)]
        lr = imgproc.gaussian_blur(np.asarray(img_hr), 5, 1.0)
        return img_hr, Image.fromarray(lr), str_filt(self.database[key], self.voc_type)


class DistortedSubsetDataset:
    """TextZoom restricted to a picked-index file (one 1-based LMDB index
    a line), the ``*_distorted.txt`` protocol (``dataset.py:689-817``)."""

    def __init__(self, root: str, picked_index_file: str, voc_type: str = "all",
                 cutblur: bool = False, manmade_degrade: bool = False, test: bool = False):
        self.base = LmdbTextDataset(root, voc_type=voc_type, cutblur=cutblur,
                                    manmade_degrade=manmade_degrade, test=test)
        with open(picked_index_file) as fh:
            self.picked = [int(line) for line in fh if line.strip()]

    def __len__(self) -> int:
        return len(self.picked)

    def __getitem__(self, index: int):
        return self.base[self.picked[index % len(self)] - 1]


def canny_weight_mask(img) -> np.ndarray:
    """Edge-weighted mask ``0.4 + 0.5 * blur(dilate(canny))`` / 255
    (``dataset.py:1563-1574``), float64 [H, W]."""
    edges = imgproc.canny(imgproc.rgb_to_gray(np.asarray(img)), 20, 150)
    edges = imgproc.gaussian_blur(imgproc.dilate(edges, 5), 5, 1.0)
    return 0.4 + (edges / 255.0) * 0.5


class MaskedLmdbDataset:
    """TextZoom and each sample's canny weight mask as a fourth element
    (``lmdbDatasetWithMask_real``, ``dataset.py:1538-1594``)."""

    def __init__(self, root: str, voc_type: str = "all"):
        self.base = LmdbTextDataset(root, voc_type=voc_type)

    def __len__(self) -> int:
        return len(self.base)

    def __getitem__(self, index: int):
        img_hr, img_lr, label = self.base[index]
        return img_hr, img_lr, label, canny_weight_mask(img_hr)


class W2VLmdbDataset:
    """TextZoom and each label's word vector (``lmdbDatasetWithW2V_real``,
    ``dataset.py:1209-1330``).  The reference embeds with pyfasttext
    (``cc.en.300.bin``); here the caller passes ``embed_fn(label) -> [D]``."""

    def __init__(self, root: str, embed_fn: Optional[Callable[[str], np.ndarray]] = None,
                 voc_type: str = "all"):
        self.base = LmdbTextDataset(root, voc_type=voc_type)
        if embed_fn is None:
            raise ValueError("W2VLmdbDataset needs embed_fn (e.g. a fasttext model's "
                             "get_numpy_vector); the reference uses cc.en.300.bin")
        self.embed_fn = embed_fn

    def __len__(self) -> int:
        return len(self.base)

    def __getitem__(self, index: int):
        img_hr, img_lr, label = self.base[index]
        return img_hr, img_lr, label, np.asarray(self.embed_fn(label), np.float32)


class GlobalSRDataset:
    """SynthText-800K word crops from ``gt.mat`` (``lmdbDataset_GlobalSR``
    and ``get_Syn_800K_with_words``, ``dataset.py:173-441``), cut out by
    :func:`~tatt_tpu_torch.data.prep_tools.iter_synthtext_crops`; LR = HR."""

    def __init__(self, root: str, voc_type: str = "all", limit: Optional[int] = None):
        self.samples = []
        for img, label in iter_synthtext_crops(os.path.join(root, "gt.mat"), root):
            self.samples.append((img, label))
            if limit is not None and len(self.samples) >= limit:
                break
        self.voc_type = voc_type

    def __len__(self) -> int:
        return len(self.samples)

    def __getitem__(self, index: int):
        img, label = self.samples[index % len(self)]
        return img, img.copy(), str_filt(label, self.voc_type)
