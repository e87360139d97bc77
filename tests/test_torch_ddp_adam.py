"""One step of the trainer's Adam (lr 1e-3, betas (0.5, 0.999)) in the
canonical recipe, fused with sync-BN, on D = 2 ``gloo`` ranks (CPU)
against JAX's ``train/state.make_optimizer`` at the global batch of 16,
with the weights, batch and replay of ``test_torch_ddp_step.py``.

The metrics and gradients are held as ``test_torch_flags.assert_steps_match``
holds them, the BN running statistics within rtol 1e-4 / atol 1e-6, and
each parameter after the step within rtol 1e-4 / atol 1e-6 but for the
entries whose gradient lies within its leaf's gradient tolerance of zero,
held within ``2 lr``: Adam's first step moves an entry by
``lr g / (|g| + 1e-8)``, about ``lr`` whatever ``g``'s size, in the
direction of the gradient's rounding where it vanishes analytically (as
``test_torch_plain_step.test_plain_step_adam_update_matches`` holds it).
The ranks' models are bitwise equal.  A file of its own, so that its
launch and JAX compile share the suite's workers.
"""

import numpy as np
import pytest

from test_torch_ddp_step import (
    ADAM_LR, as_step, assert_ranks_equal, jax_steps, run_world, step_case,
)
from test_torch_flags import _grad_scale, _leaf_tol, assert_steps_match

# the recipe fused, sync-BN, on 2 ranks
ADAM_CASE = (dict(fused_tssim=True), 2, False, False)


@pytest.fixture(scope="module")
def adam_ranks(tmp_path_factory):
    adam = ("adam", lambda p: step_case(p, *ADAM_CASE, adam=True))
    return run_world({}, 2, tmp_path_factory, extra=[adam])[0]["adam"]


def assert_adam_step_matches(want: tuple, got: tuple) -> None:
    """One Adam step against JAX's (module docstring): the metrics and
    gradients as ``assert_steps_match`` holds them, the parameters after the
    update within rtol 1e-4 / atol 1e-6, or within ``2 lr`` where the
    gradient is within its leaf's tolerance of zero; the BN running
    statistics within rtol 1e-4 / atol 1e-6."""
    (m_j, g_j, s_j), (m_t, g_t, s_t) = want, got
    assert_steps_match((m_j, g_j, {p: [{}] for p in s_j}), (m_t, g_t, {p: [{}] for p in s_t}))
    for part in ("sr", "student"):
        (gj,), (st,), (sj,) = g_j[part], s_t[part], s_j[part]
        assert sorted(st) == sorted(sj)
        scale = _grad_scale(gj)
        for name, w in sj.items():
            have, w = st[name].numpy(), w.numpy()
            if name not in gj:  # BN running statistics
                np.testing.assert_allclose(have, w, rtol=1e-4, atol=1e-6, err_msg=f"{part} {name}")
                continue
            noise = np.abs(gj[name].numpy()) <= _leaf_tol(part, name) * scale
            ok = np.isclose(have, w, rtol=1e-4, atol=1e-6) | (
                noise & (np.abs(have - w) <= 2 * ADAM_LR * (1 + 1e-4)))
            assert ok.all(), (part, name, np.abs(have - w).max())


def test_adam_step_on_two_ranks_matches_jax(adam_ranks):
    """The trainer's Adam after one step of the recipe on 2 ranks against
    JAX's optax Adam at the global batch (module docstring)."""
    (want,) = jax_steps(*ADAM_CASE, adam=True)
    assert_ranks_equal(adam_ranks)
    assert_adam_step_matches(want, as_step(adam_ranks[0][0]))
