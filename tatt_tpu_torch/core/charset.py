"""Character set, vocabulary filter, CTC greedy decode, the ASTER
vocabulary and decode, and the collate's label spreading (copied from
``tatt_tpu/core/charset.py``; the port imports nothing from the JAX
package).  The ``chinese`` vocabulary of ``--CHNSR`` is the reference's
3965-character table, shipped as ``tatt_tpu_torch/data/al_chinese.txt``
(byte-identical to the JAX package's copy) and read once a process."""

from __future__ import annotations

import os
import string
from functools import lru_cache
from typing import Sequence

import numpy as np

# Blank-first alphabet of the CRNN text-prior generator and judge
# (reference ``main.py:137``, ``utils/metrics.py:71``).
CRNN_ALPHABET = "-0123456789abcdefghijklmnopqrstuvwxyz"

_TABLES = {
    "digit": string.digits,
    "lower": string.digits + string.ascii_lowercase,
    "upper": string.digits + string.ascii_letters,
    "all": string.digits + string.ascii_letters + string.punctuation,
}


_CHINESE_TABLE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                              "data", "al_chinese.txt")
# what the chinese filter keeps before the table (``utils/util.py:24-30``):
# CJK U+4E00-U+9FA5, ASCII digits and letters
_CJK_FIRST, _CJK_LAST = "\u4e00", "\u9fa5"
_ALNUM = frozenset(string.digits + string.ascii_letters)


@lru_cache(maxsize=None)
def voc_table(voc_type: str) -> str:
    """The characters of ``voc_type`` (digit, lower, upper, all or
    chinese).  ``chinese``: the first line of the packaged table (the
    reference's ``al_chinese.txt``, ``main.py:140-142``)."""
    if voc_type != "chinese":
        return _TABLES[voc_type]
    with open(_CHINESE_TABLE, encoding="utf-8") as fh:
        return fh.readline().replace("\n", "")


def str_filt(s: str, voc_type: str) -> str:
    """Vocabulary filter of the accuracy protocol (``utils/util.py:12-32``):
    lowercases for 'lower'; for 'chinese' keeps CJK U+4E00-U+9FA5 and
    ASCII letters and digits; then drops out-of-vocabulary characters."""
    table = voc_table(voc_type)
    if voc_type == "lower":
        s = s.lower()
    if voc_type == "chinese":
        s = "".join(ch for ch in s if _CJK_FIRST <= ch <= _CJK_LAST or ch in _ALNUM)
    return "".join(ch for ch in s if ch in table)


def normalize_text(text: str) -> str:
    """ASTER-eval normalization (``utils/metrics.py:15-17``): lowercase
    alphanumerics only."""
    return "".join(ch for ch in text if ch in string.digits + string.ascii_letters).lower()


class AsterInfo:
    """ASTER vocabulary (``interfaces/base.py:862-874``,
    ``utils/labelmaps.py:6-28``): the table's characters, then EOS,
    PADDING and UNKNOWN."""

    def __init__(self, voc_type: str = "all"):
        self.voc_type = voc_type
        self.EOS, self.PADDING, self.UNKNOWN = "EOS", "PADDING", "UNKNOWN"
        self.max_len = 100
        self.voc = list(voc_table(voc_type)) + [self.EOS, self.PADDING, self.UNKNOWN]
        self.char2id = {c: i for i, c in enumerate(self.voc)}
        self.id2char = dict(enumerate(self.voc))
        self.rec_num_classes = len(self.voc)


def decode_aster_ids(ids, info: AsterInfo) -> list[str]:
    """``get_string_aster`` (``utils/metrics.py:20-68``): each row of ids
    up to its first EOS, UNKNOWN skipped, then :func:`normalize_text`."""
    eos, unk = info.char2id[info.EOS], info.char2id[info.UNKNOWN]
    out = []
    for row in np.asarray(ids):
        chars = []
        for v in row:
            v = int(v)
            if v == eos:
                break
            if v != unk and v in info.id2char:
                chars.append(info.id2char[v])
        out.append(normalize_text("".join(chars)))
    return out


def ctc_greedy_decode(logits, alphabet: str = CRNN_ALPHABET) -> list[str]:
    """Greedy CTC decode with blank collapse of ``logits`` [T, B, C]."""
    return ctc_collapse(np.asarray(logits).argmax(-1).T, alphabet)


def ctc_collapse(best, alphabet: str = CRNN_ALPHABET) -> list[str]:
    """The blank collapse of greedy ids ``best`` [B, T].

    Mirrors ``get_string_crnn`` (``utils/metrics.py:71-92``) including its
    quirk of resetting the repeat tracker on blanks ("a-a" -> "aa")."""
    out = []
    for row in np.asarray(best):
        s, last = "", ""
        for idx in row:
            ch = alphabet[int(idx)]
            if ch != last:
                if idx != 0:
                    s += ch
                    last = ch
                else:
                    last = ""
        out.append(s)
    return out


def levenshtein(a: str, b: str) -> int:
    """Edit distance."""
    if len(a) < len(b):
        a, b = b, a
    if not b:
        return len(a)
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (ca != cb)))
        prev = cur
    return prev[-1]


def spread_label(word: str, max_len: int = 26) -> str:
    """Interleave '-' padding between characters so a short word spans the
    26 CTC time slots (``dataset/dataset.py:2026-2036``)."""
    word = word.lower()
    if len(word) <= 1:
        return word
    if len(word) >= max_len:
        return word[:max_len]
    padding = (max_len - len(word)) // (len(word) - 1)
    return word[0] + "".join("-" * padding + ch for ch in word[1:])


def encode_label_vecs(
    labels: Sequence[str],
    alphabet: str,
    max_len: int = 26,
    eval_perturb: bool = False,
    spread: bool = True,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The collate's label tensors (``alignCollate_realWTLAMask``,
    ``dataset/dataset.py:1979-2076``): ``(label_vecs [B, C, 1, T]`` one-hots
    of the spread words, ``ctc_ids`` the flat ids (the '-' padding is id
    0, the blank), ``weighted_tics [B]`` 1 for a word with any character
    of the alphabet, else 0).  ``eval_perturb`` is the eval collate's
    ``word[2]='e'`` (``dataset.py:1928-1931``)."""
    if not alphabet.startswith("-"):
        alphabet = "-" + alphabet
    a2d = {ch: i for i, ch in enumerate(alphabet)}
    batch = np.zeros((len(labels), max_len, len(a2d)), dtype=np.float32)
    ctc_ids: list[int] = []
    tics = np.zeros((len(labels),), dtype=np.int32)
    for b, word in enumerate(labels):
        word = word.lower()
        if eval_perturb and len(word) > 4:
            word = word[:2] + "e" + word[3:]
        word = spread_label(word, max_len) if spread else word[:max_len]
        ids = [a2d[ch] for ch in word if ch in a2d]
        if ids:
            ctc_ids.extend(ids)
            batch[b, np.arange(len(ids)), ids] = 1.0
            tics[b] = 1
        else:
            ctc_ids.append(0)
            batch[b, 0, 0] = 1.0
    return batch.transpose(0, 2, 1)[:, :, None, :], np.asarray(ctc_ids, dtype=np.int32), tics
