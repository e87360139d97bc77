"""CUDA kernels of tatt_tpu_torch against their plain PyTorch versions.

Needs a CUDA card (the kernels are built with nvcc for sm_90a at first
use); skipped elsewhere.  Imports no JAX, so it also runs where JAX is
not installed:

  python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import math

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

# f32 kernel vs the same maths in plain PyTorch on the same card: only the
# summation order of the hidden-state matvec differs (~1e-7 relative per
# step, contracted by the gates over the sequence)
ATOL = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are CUDA C++ for sm_90a")
    from tatt_tpu_torch.core.device import set_cuda_flags

    set_cuda_flags()
    return torch.device("cuda")


def _recurrence_inputs(shape_gates, gdim, hid, dev, seed=0):
    rng = np.random.default_rng(seed)
    b = 1.0 / math.sqrt(hid)
    mk = lambda a: torch.tensor(a, dtype=torch.float32, device=dev)  # noqa: E731
    return (
        mk(rng.standard_normal(shape_gates)),
        mk(rng.uniform(-b, b, (2, gdim, hid))),
        mk(rng.uniform(-b, b, (2, gdim))),
    )


# (L, R, H): gru1 and gru2 of the full-width generator at batch 64, a
# ragged row count, L=1, odd L, and the hidden sizes at the dispatch edges
@pytest.mark.parametrize(
    "length,rows,hid",
    [(16, 4096, 32), (64, 1024, 32), (16, 4099, 32), (1, 37, 32), (7, 45, 32),
     (5, 70, 128), (9, 33, 4), (3, 10, 5)],
)
def test_bigru_kernel_matches_plain(cuda, length, rows, hid):
    from tatt_tpu_torch.kernels.gru import bigru_recurrence, bigru_recurrence_ref

    gates, w_hh, b_hh = _recurrence_inputs((2, length, 3 * hid, rows), 3 * hid, hid, cuda)
    before = bigru_recurrence.launches
    with torch.no_grad():
        out = bigru_recurrence(gates, w_hh, b_hh)
        ref = bigru_recurrence_ref(gates, w_hh, b_hh)
    torch.cuda.synchronize()
    assert bigru_recurrence.launches == before + 1
    assert out.shape == (length, 2 * hid, rows)
    assert (out - ref).abs().max().item() <= ATOL


# (L, R, H): the CRNN head (R = batch 64, H = 256), the fixture judge
# (H = 64), ragged rows, L=1, odd L, and H not a multiple of 32
@pytest.mark.parametrize(
    "length,rows,hid",
    [(26, 64, 256), (26, 64, 64), (26, 61, 256), (1, 9, 256), (7, 13, 64),
     (5, 17, 48), (4, 3, 16)],
)
def test_bilstm_kernel_matches_plain(cuda, length, rows, hid):
    from tatt_tpu_torch.kernels.lstm import bilstm_recurrence, bilstm_recurrence_ref

    gates, w_hh, b_hh = _recurrence_inputs((2, rows, length, 4 * hid), 4 * hid, hid, cuda)
    before = bilstm_recurrence.launches
    with torch.no_grad():
        out = bilstm_recurrence(gates, w_hh, b_hh)
        ref = bilstm_recurrence_ref(gates, w_hh, b_hh)
    torch.cuda.synchronize()
    assert bilstm_recurrence.launches == before + 1
    assert out.shape == (rows, length, 2 * hid)
    assert (out - ref).abs().max().item() <= ATOL


def test_wrappers_refuse_grad_on_card(cuda):
    from tatt_tpu_torch.kernels.gru import bigru_recurrence

    gates, w_hh, b_hh = _recurrence_inputs((2, 3, 96, 8), 96, 32, cuda)
    with pytest.raises(RuntimeError, match="forward-only"):
        bigru_recurrence(gates, w_hh.requires_grad_(), b_hh)


def test_small_eval_path_card_matches_cpu(cuda):
    """A small TATT + CRNN eval step through both kernels on the card
    against the plain versions on the CPU."""
    from tatt_tpu_torch.kernels.gru import bigru_recurrence
    from tatt_tpu_torch.kernels.lstm import bilstm_recurrence
    from tatt_tpu_torch.models.common import init_parameters
    from tatt_tpu_torch.models.recognizers.crnn import CRNN
    from tatt_tpu_torch.models.tsrn import TATT
    from tatt_tpu_torch.train.steps import eval_step

    gen = init_parameters(TATT(srb_nums=1, hidden_units=4, out_text_channels=8), 0).eval()
    stu = init_parameters(CRNN(nh=32, nm=(8, 8, 16, 16, 32, 32, 32)), 1).eval()
    lr = torch.tensor(np.random.default_rng(3).uniform(0, 1, (5, 4, 16, 64)), dtype=torch.float32)
    sr_cpu, _ = eval_step([gen], [stu], lr)
    g0, l0 = bigru_recurrence.launches, bilstm_recurrence.launches
    sr_gpu, _ = eval_step([gen.to(cuda)], [stu.to(cuda)], lr.to(cuda))
    torch.cuda.synchronize()
    # gru1 + gru2 of the one block, and the query GRU (hidden 16*8/2 = 64)
    assert bigru_recurrence.launches - g0 == 3
    assert bilstm_recurrence.launches - l0 == 2
    assert (sr_gpu.cpu() - sr_cpu).abs().max().item() <= 1e-4
