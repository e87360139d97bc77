"""The card's published peaks (``peaks.json``), which every roofline and
``mfu`` metric is held against; each kernel's least time is its bound
file's (``bounds/``)."""

from __future__ import annotations

import json
import os

PEAKS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "peaks.json")


def peaks(device_name: str):
    """The card's published peaks (peaks.json), matched by a key that
    its name holds; None for a card the table lacks."""
    with open(PEAKS) as f:
        table = json.load(f)["cards"]
    for key, row in table.items():
        if key in device_name:
            return row
    return None
