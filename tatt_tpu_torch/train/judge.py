"""Eval judges (counterpart of ``tatt_tpu/train/judge.py``), the
reference's ``test_bible`` (``super_resolution.py:485-513``): for
``--test_model`` CRNN, ASTER or MORAN, a callable that reads a batch of
NCHW RGB images in [0, 1] and returns one string per image.  Each judge
runs its recognizer (on the images' device, under ``no_grad``) and decodes
on the host: CTC greedy for CRNN, ids to the first EOS for ASTER, the
left-to-right decoder's argmax cut at '$' for MORAN.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn

from tatt_tpu_torch.core.charset import CRNN_ALPHABET, AsterInfo, ctc_greedy_decode, decode_aster_ids

Judge = Callable[[torch.Tensor], list]


def make_judge(test_model: str, model: nn.Module, voc_type: str = "all") -> Judge:
    """``judge(images) -> list[str]`` over ``model`` (a ``CRNN``, an
    ``AsterRecognizer`` built for ``AsterInfo(voc_type)`` or a ``MORAN``,
    in eval mode on the images' device)."""
    if test_model == "CRNN":
        from tatt_tpu_torch.models.recognizers.crnn import parse_crnn_input

        @torch.no_grad()
        def judge(images):
            return ctc_greedy_decode(model(parse_crnn_input(images[:, :3])).cpu().numpy(), CRNN_ALPHABET)

    elif test_model == "ASTER":
        from tatt_tpu_torch.models.recognizers.aster import parse_aster_input

        info = AsterInfo(voc_type)

        @torch.no_grad()
        def judge(images):
            return decode_aster_ids(model(parse_aster_input(images))[0].cpu().numpy(), info)

    elif test_model == "MORAN":
        from tatt_tpu_torch.models.recognizers.moran import decode_moran_ids, parse_moran_input

        @torch.no_grad()
        def judge(images):
            return decode_moran_ids(model(parse_moran_input(images))[0].argmax(-1).cpu().numpy())

    else:
        raise ValueError(f"unknown test_model {test_model!r}")
    return judge
