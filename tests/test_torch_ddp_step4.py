"""The canonical recipe's step on D = 4 ``gloo`` ranks (CPU) against the JAX
package's step at the global batch of 16: fused and with two forwards,
sync-BN and ``--bn_per_replica``.  The cases, the tolerances and the
bitwise agreement of the ranks are those of ``test_torch_ddp_step.py``,
whose helpers run them; a file of its own, so that the two share the
suite's workers."""

import pytest

from test_torch_ddp_step import CASES_2, check_against_jax, run_world

CASES_4 = {k: v for k, v in CASES_2.items() if k.startswith(("fused", "two forwards"))}


@pytest.fixture(scope="module")
def ranks_4(tmp_path_factory):
    return run_world(CASES_4, 4, tmp_path_factory)


@pytest.mark.parametrize("case", list(CASES_4))
def test_step_on_four_ranks_matches_jax(ranks_4, case):
    check_against_jax(ranks_4, CASES_4, case, 4)
