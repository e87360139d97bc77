"""The SR output's statistics of the port's step against JAX's, on 2 ranks
and in one process, at the inputs of ``test_torch_ddp_step.py`` (CPU).

For each recipe case of ``CASES_2`` and each of its two SGD steps, prints
``|port - JAX| / |JAX|`` of ``sr_mean``, ``sr_min``, ``sr_max`` and
``loss_total``: the port replayed on 2 ``gloo`` ranks and in one process
at the global batch, JAX's step at the global batch.  It shows where the
second step's statistics stand against rtol 1e-5 in one process, which
the 2-rank test holds them beside.

  JAX_PLATFORMS=cpu python tests/ddp_metric_gaps.py
"""

import os
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

import conftest  # noqa: E402,F401  (JAX on the CPU, 8 virtual devices)
import torch  # noqa: E402

import test_torch_ddp_step as steps  # noqa: E402
from tatt_tpu_torch.train.replay import run_cases  # noqa: E402

KEYS = ("sr_mean", "sr_min", "sr_max", "loss_total")


def main() -> int:
    cases = {k: v for k, v in steps.CASES_2.items() if not v[2]}  # the plain step has no sr_*
    with tempfile.TemporaryDirectory() as tmp:
        paths = {name: steps.step_case(os.path.join(tmp, f"{i}.case"), flags, 2, rep, plain)
                 for i, (name, (flags, rep, plain)) in enumerate(cases.items())}
        two = dict(zip(cases, steps.replay(list(paths.values()), 2)))
        for name, (flags, rep, plain) in cases.items():
            want = steps.jax_steps(flags, 2, rep, plain)
            run_cases(0, 1, torch.device("cpu"), [paths[name]])
            one = torch.load(f"{paths[name]}.rank0.pt", weights_only=False)
            for i in range(steps.STEPS):
                for key in KEYS:
                    w = want[i][0][key]
                    gaps = [abs(r[i]["metrics"][key] - w) / abs(w) for r in (two[name][0], one)]
                    print(f"{name:26s} step {i + 1} {key:10s} 2 ranks {gaps[0]:.3e}  "
                          f"one process {gaps[1]:.3e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
