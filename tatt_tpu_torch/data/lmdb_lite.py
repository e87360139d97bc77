"""ctypes bindings for the native LMDB-format library (copied from
``tatt_tpu/data/lmdb_lite.py``; the port imports nothing from the JAX
package).

The slice of the ``lmdb`` API that TextZoom reading needs: open an
environment directory holding ``data.mdb``, ``get(key)``, the entry count,
and bulk creation (tests and ``chip_smoke.py`` write TextZoom-layout
LMDBs).  ``native/lmdb_lite.cc`` is host code with a plain C ABI
(``ll_open``, ``ll_get``, ``ll_entries``, ``ll_write``, ``ll_close``),
compiled with ``g++`` on first use into ``tatt_tpu_torch/_build/`` (git-ignored),
never at import.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Mapping, Optional

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG, "native", "lmdb_lite.cc")
_SO = os.path.join(_PKG, "_build", "liblmdb_lite.so")
_lock = threading.Lock()
_lib_handle: list[ctypes.CDLL] = []


def _build() -> None:
    """Compile to a per-process temporary name, then rename: processes
    that build at once (test workers) never load a half-written file."""
    os.makedirs(os.path.dirname(_SO), exist_ok=True)
    tmp = f"{_SO}.{os.getpid()}.tmp"
    subprocess.run(
        ["g++", "-O2", "-shared", "-fPIC", "-std=c++17", _SRC, "-o", tmp], check=True
    )
    os.replace(tmp, _SO)


def _lib() -> ctypes.CDLL:
    with _lock:
        if _lib_handle:
            return _lib_handle[0]
        if not os.path.exists(_SO) or os.path.getmtime(_SO) < os.path.getmtime(_SRC):
            _build()
        lib = ctypes.CDLL(_SO)
        lib.ll_open.restype = ctypes.c_void_p
        lib.ll_open.argtypes = [ctypes.c_char_p]
        lib.ll_close.restype = None
        lib.ll_close.argtypes = [ctypes.c_void_p]
        lib.ll_entries.restype = ctypes.c_longlong
        lib.ll_entries.argtypes = [ctypes.c_void_p]
        lib.ll_get.restype = ctypes.c_longlong
        lib.ll_get.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_size_t),
        ]
        lib.ll_write.restype = ctypes.c_longlong
        lib.ll_write.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_size_t),
            ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_size_t),
            ctypes.c_size_t, ctypes.c_int,
        ]
        _lib_handle.append(lib)
        return lib


class LmdbEnv:
    """Read-only environment over ``<root>/data.mdb`` (or a bare file)."""

    def __init__(self, root: str):
        path = os.path.join(root, "data.mdb") if os.path.isdir(root) else root
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        self._lib = _lib()
        self._h = self._lib.ll_open(path.encode())
        if not self._h:
            raise IOError(f"not a valid LMDB file: {path}")
        self.path = path

    def get(self, key: bytes) -> Optional[bytes]:
        """The value of ``key``, or None when the key is absent."""
        out, olen = ctypes.c_void_p(), ctypes.c_size_t()
        rc = self._lib.ll_get(self._h, key, len(key), ctypes.byref(out), ctypes.byref(olen))
        if rc == -1:
            return None
        if rc != 0:
            raise IOError(f"lmdb_lite corruption reading {self.path} (rc={rc})")
        return ctypes.string_at(out.value, olen.value)

    def entries(self) -> int:
        return int(self._lib.ll_entries(self._h))

    def close(self) -> None:
        if getattr(self, "_h", None):
            self._lib.ll_close(self._h)
            self._h = None

    def __del__(self):
        self.close()


def write_lmdb(root: str, records: Mapping[bytes, bytes]) -> str:
    """Create ``<root>/data.mdb`` from a mapping (the reference's
    ``createDataset`` writer, ``dataset/create_lmdb.py``).  Returns the
    file's path."""
    os.makedirs(root, exist_ok=True)
    path = os.path.join(root, "data.mdb")
    keys = list(records)
    vals = [records[k] for k in keys]
    n = len(keys)
    strs, lens = ctypes.c_char_p * n, ctypes.c_size_t * n
    rc = _lib().ll_write(
        path.encode(),
        strs(*keys), lens(*[len(k) for k in keys]),
        strs(*vals), lens(*[len(v) for v in vals]),
        n, 0,
    )
    if rc != 0:
        raise IOError(f"lmdb_lite write failed rc={rc}")
    return path
