"""The BiLSTM kernels (``csrc/bilstm_*.cu``): every ``BiLSTM`` call of
hidden 256 or less, one launch a layer."""

from stisr_bench.bounds import recurrence

MAX_HIDDEN = 256


def shapes(module, args):
    return recurrence.launches(module, args) if module.hidden <= MAX_HIDDEN else []


def bound(shape, backward: bool, peak: dict):
    return recurrence.bound("lstm", *shape, backward, peak)
