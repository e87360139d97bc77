"""PyTorch/CUDA port of ``tatt_tpu`` for one NVIDIA H100.

Module paths mirror the JAX package (``tatt_tpu_torch/models/tsrn.py`` is
the counterpart of ``tatt_tpu/models/tsrn.py``, and so on).  The package
imports ``torch``, numpy, PIL and PyYAML only (the YAML config); it never
imports ``jax``, ``flax`` or ``tatt_tpu``.  Entry points run on ``cuda``
unless the caller passes ``device="cpu"``.  The four recurrences of the
eval and training paths are hand-written CUDA kernels (``csrc/``), built
with ``nvcc`` at first use; the TextZoom LMDB reader
(``native/lmdb_lite.cc``) is host code, built with ``g++`` at first use.
Both builds go into the git-ignored ``_build/``, never at import.
"""
