"""Character set, vocabulary filter and CTC greedy decode (copied from
``tatt_tpu/core/charset.py``; the port imports nothing from the JAX
package)."""

from __future__ import annotations

import string

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


def str_filt(s: str, voc_type: str) -> str:
    """Vocabulary filter of the accuracy protocol (``utils/util.py:12-32``):
    lowercases for 'lower', drops out-of-vocabulary characters."""
    table = _TABLES[voc_type]
    if voc_type == "lower":
        s = s.lower()
    return "".join(ch for ch in s if ch in table)


def ctc_greedy_decode(logits, alphabet: str = CRNN_ALPHABET) -> list[str]:
    """Greedy CTC decode with blank collapse of ``logits`` [T, B, C].

    Mirrors ``get_string_crnn`` (``utils/metrics.py:71-92``) including its
    quirk of resetting the repeat tracker on blanks ("a-a" -> "aa")."""
    best = np.asarray(logits).argmax(-1).T  # [B, T]
    out = []
    for row in best:
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
