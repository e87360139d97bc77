"""Device selection and reduced-precision policy for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for the CPU.  Raises when CUDA is asked for (or defaulted to) and no
    CUDA device exists — nothing carries on quietly on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "tatt_tpu_torch runs on a CUDA device and none is available; "
            "pass device='cpu' to run the plain PyTorch path"
        )
    return dev


def set_cuda_flags() -> None:
    """Process-wide cuDNN/cuBLAS settings of the port's entry points.

    Every float32 contraction stays in full float32: PyTorch runs cuDNN
    convolutions in TF32 by default, which keeps about three decimal
    digits, and the JAX package's precision audit
    (``tests/test_precision_audit.py``) pins SSIM windows, resize
    matrices, attention logits/softmax and BatchNorm in f32.  Under
    ``--dtype bfloat16`` every bf16 GEMM sums in f32 as XLA's do: PyTorch
    lets cuBLAS add split-K partial sums in bf16 by default.  cuDNN
    autotunes its convolution algorithms (all of them f32 here): the eval
    path runs fixed shapes, and without TF32 the heuristic picks slow FFT
    algorithms for the 9x9 convolutions."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cudnn.benchmark = True
