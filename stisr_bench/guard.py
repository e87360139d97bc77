"""What a run must refuse: no card, too few cards, and a JAX module loaded.

The measured package's name begins with the JAX package's, so modules are
compared by their whole top-level name, the part before the first dot.
"""

from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "tatt_tpu")


class Refused(SystemExit):
    """Ends the run with a non-zero code and no result line."""

    def __init__(self, message: str, code: int = 2):
        print(f"stisr_bench: {message}", file=sys.stderr)
        super().__init__(code)


def require_cards(chips: int) -> None:
    import torch

    if not torch.cuda.is_available():
        raise Refused("no CUDA card: the benchmark measures the card and never falls back to "
                      "the CPU")
    if torch.cuda.device_count() < chips:
        raise Refused(f"the cell needs {chips} cards, {torch.cuda.device_count()} are visible")


def forbidden_modules(names=None) -> list[str]:
    """The loaded modules whose top-level name is a forbidden one."""
    names = sys.modules if names is None else names
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)


def require_no_jax() -> None:
    found = forbidden_modules()
    if found:
        raise Refused("the process loaded the JAX stack or the JAX package: "
                      + ", ".join(found[:20]), code=3)
