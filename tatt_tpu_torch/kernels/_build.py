"""Build the CUDA kernels in ``csrc/`` with ``nvcc`` and bind them.

Each ``csrc/<name>.cu`` has plain C entry points (``<name>`` for float32,
``<name>_bf16`` for bfloat16, and their ``_plan`` queries), is compiled on
first use into ``tatt_tpu_torch/_build/lib<name>.so`` (git-ignored) and
loaded with ``ctypes``.  Every pointer and the stream go over as ``c_void_p``,
each int as ``c_int``; every entry point returns ``cudaGetLastError()``
and :func:`check` raises when it is non-zero.  Nothing here runs at
import time.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
KERNELS = ("bigru_fwd", "bigru_bwd", "bilstm_fwd", "bilstm_bwd", "query_gru")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_entries: dict[tuple, object] = {}
# ptxas register / shared-memory report of each build, for the smoke log
ptxas_report: dict[str, str] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME); the CUDA kernels are built "
            "from tatt_tpu_torch/csrc at first use"
        )
    return found


def _lib_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}.so")


def _stale(name: str) -> bool:
    lib, src = _lib_path(name), os.path.join(CSRC, f"{name}.cu")
    return not os.path.exists(lib) or os.path.getmtime(lib) < os.path.getmtime(src)


def build(names=KERNELS) -> float:
    """Compile every stale kernel in ``names``, one ``nvcc`` per source,
    all started together.  Returns the wall seconds spent."""
    t0 = time.perf_counter()
    with _lock:
        todo = [n for n in names if _stale(n)]
        if not todo:
            return 0.0
        os.makedirs(BUILD_DIR, exist_ok=True)
        nvcc = _nvcc()
        procs = {}
        for name in todo:
            tmp = _lib_path(name) + f".{os.getpid()}.tmp"
            cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
            procs[name] = (
                tmp,
                subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True
                ),
            )
        failed = []
        for name, (tmp, proc) in procs.items():
            out, err = proc.communicate()
            ptxas_report[name] = (out + err).strip()
            if proc.returncode != 0:
                failed.append(f"{name}:\n{err}")
            else:
                os.replace(tmp, _lib_path(name))
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return time.perf_counter() - t0


def entry(name: str, fn: str, argtypes: list):
    """Entry point ``fn`` of kernel ``name``'s library (built and loaded
    if needed), its argument types declared and its result an int."""
    func = _entries.get((name, fn))
    if func is None:
        lib = _libs.get(name)
        if lib is None:
            build((name,))
            with _lock:
                lib = _libs.setdefault(name, ctypes.CDLL(_lib_path(name)))
        func = getattr(lib, fn)
        func.argtypes, func.restype = argtypes, ctypes.c_int
        _entries[(name, fn)] = func
    return func


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {err}")
