"""PyTorch/CUDA port of ``tatt_tpu`` for one NVIDIA H100.

Module paths mirror the JAX package (``tatt_tpu_torch/models/tsrn.py`` is
the counterpart of ``tatt_tpu/models/tsrn.py``, and so on).  The package
imports ``torch``, numpy and PIL only; it never imports ``jax``, ``flax`` or
``tatt_tpu``.  Entry points run on ``cuda`` unless the caller passes
``device="cpu"``.  The two recurrences of the eval path are hand-written
CUDA kernels (``csrc/``), built with ``nvcc`` at first use.
"""
