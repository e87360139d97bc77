"""The narrow BiGRU kernels (``csrc/bigru_*.cu``): every ``BiGRU`` call
of hidden 128 or less, one launch."""

from stisr_bench.bounds import recurrence

MAX_HIDDEN = 128


def shapes(module, args):
    return recurrence.launches(module, args) if module.hidden <= MAX_HIDDEN else []


def bound(shape, backward: bool, peak: dict):
    return recurrence.bound("gru", *shape, backward, peak)
