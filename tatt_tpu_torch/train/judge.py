"""Eval judges (counterpart of ``tatt_tpu/train/judge.py``), the
reference's ``test_bible`` (``super_resolution.py:485-513``): for
``--test_model`` CRNN, ASTER or MORAN, a callable that reads a batch of
NCHW RGB images in [0, 1] and returns one string per image.  Each judge
runs its recognizer (on the images' device, under ``no_grad``; span
``tatt.judge``) and decodes on the host (span ``tatt.judge.decode``, the
copy to the host included): CTC greedy for CRNN (the argmax taken on the
device, only the [B, T] ids copied), ids to the first EOS for ASTER, the
left-to-right decoder's argmax cut at '$' for MORAN.  The CRNN kind is any CTC
recognizer with its :class:`~tatt_tpu_torch.models.factory.RecognizerSpec`'s
input adapter and alphabet: under ``--tpg OPT`` the teacher TPG through
``parse_opt_input``, decoded over blank + the Chinese table under
``--CHNSR`` (``loop.py:400-417``).
"""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn

from tatt_tpu_torch.core.charset import AsterInfo, ctc_collapse, decode_aster_ids
from tatt_tpu_torch.models.factory import CRNN_SPEC, RecognizerSpec
from tatt_tpu_torch.train.observe import span

Judge = Callable[[torch.Tensor], list]


def make_judge(test_model: str, model: nn.Module, voc_type: str = "all",
               spec: RecognizerSpec = CRNN_SPEC) -> Judge:
    """``judge(images) -> list[str]`` over ``model`` (a CTC recognizer, an
    ``AsterRecognizer`` built for ``AsterInfo(voc_type)`` or a ``MORAN``,
    in eval mode on the images' device).  For ``CRNN``: read through
    ``spec.parse_fn`` and decoded over ``spec.alphabet``."""
    if test_model == "CRNN":

        @torch.no_grad()
        def judge(images):
            with span("tatt.judge"):
                best = model(spec.parse_fn(images[:, :3])).argmax(-1).T  # [B, T]
                with span("tatt.judge.decode"):
                    return ctc_collapse(best.cpu().numpy(), spec.alphabet)

    elif test_model == "ASTER":
        from tatt_tpu_torch.models.recognizers.aster import parse_aster_input

        info = AsterInfo(voc_type)

        @torch.no_grad()
        def judge(images):
            with span("tatt.judge"):
                ids = model(parse_aster_input(images))[0]
                with span("tatt.judge.decode"):
                    return decode_aster_ids(ids.cpu().numpy(), info)

    elif test_model == "MORAN":
        from tatt_tpu_torch.models.recognizers.moran import decode_moran_ids, parse_moran_input

        @torch.no_grad()
        def judge(images):
            with span("tatt.judge"):
                best = model(parse_moran_input(images))[0].argmax(-1)
                with span("tatt.judge.decode"):
                    return decode_moran_ids(best.cpu().numpy())

    else:
        raise ValueError(f"unknown test_model {test_model!r}")
    return judge
