"""TPG recognizer of the Chinese path (``--tpg OPT``; counterpart of
``tatt_tpu/models/recognizers/tpg.py``): the NAVER deep-text-recognition
pipeline, feature extractor -> optional BiLSTM stage -> CTC linear head or
attention decoder, returning [T, B, num_class] logits.

The reference's shipped TPG (``main.py:127-144``) is the FAN ResNet with
blocks [1, 2, 5, 3] at ``output_channel`` 512, no sequence stage and a CTC
head: on a 32x512 luma input its pools and strided convs map the width
512 -> 256 -> 128 -> 129 -> 130 -> 129, so T = 129.  The VGG and GRCNN
(``RCNN``) extractors, the BiLSTM stage (two ``BiLSTM`` layers of
``hidden_size``, each followed by a linear map, both through the
recurrence kernels) and the attention head are the other variants of
``TPGModel``.  Submodules carry the flax module names (``FeatureExtraction``,
``conv0_1_conv``, ``layer3_4``, ``seq0``, ``seq0_embedding``,
``Prediction``, ...), so ``core/convert.from_jax`` maps each leaf to its
counterpart by name.  The module's ``training`` flag is JAX's ``train``:
BatchNorm statistics and, for the attention head, teacher forcing from
``text`` (greedy decoding otherwise, and always in eval mode).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from tatt_tpu_torch.kernels.resize import resize_bicubic, rgb_to_luma
from tatt_tpu_torch.kernels.rnn import BiLSTM
from tatt_tpu_torch.models.common import BatchNorm2d, Conv2d, Dense, max_pool

TPG_WIDTH = 512  # the luma width parse_OPT_data resizes to


def parse_opt_input(images: torch.Tensor, width: int = TPG_WIDTH) -> torch.Tensor:
    """[N, >=3, H, W] RGB (first 3 channels) -> [N, 1, 32, width] luma
    (``parse_OPT_data``, ``interfaces/base.py:817-835``)."""
    return rgb_to_luma(resize_bicubic(images[:, :3], 32, width))


def _conv(cin: int, cout: int, kernel=(3, 3), stride=(1, 1), pad=(1, 1), bias=False) -> Conv2d:
    return Conv2d(cin, cout, kernel, pad, bias=bias, stride=stride)


class FanBasicBlock(nn.Module):
    """3x3 conv-BN-ReLU, 3x3 conv-BN, a 1x1 conv-BN shortcut where the
    width changes, ReLU of the sum (``tpg.py:29-47``)."""

    def __init__(self, inplanes: int, planes: int, downsample: bool = False):
        super().__init__()
        self.conv1, self.bn1 = _conv(inplanes, planes), BatchNorm2d(planes)
        self.conv2, self.bn2 = _conv(planes, planes), BatchNorm2d(planes)
        self.downsample = downsample
        if downsample:
            self.downsample_conv = _conv(inplanes, planes, (1, 1), pad=(0, 0))
            self.downsample_bn = BatchNorm2d(planes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.bn2(self.conv2(torch.relu(self.bn1(self.conv1(x)))))
        residual = self.downsample_bn(self.downsample_conv(x)) if self.downsample else x
        return torch.relu(out + residual)


class FanResNet(nn.Module):
    """``modules/feature_extraction.py:153-246`` with blocks [1, 2, 5, 3]:
    [N, 1, 32, W] -> [N, output_channel, 1, W/4 + 1] (``tpg.py:50-92``)."""

    LAYERS = (1, 2, 5, 3)

    def __init__(self, output_channel: int = 512, in_channels: int = 1):
        super().__init__()
        oc = output_channel
        blocks_ch = (oc // 4, oc // 2, oc, oc)

        def conv_bn(name, cin, cout, kernel=(3, 3), stride=(1, 1), pad=(1, 1)):
            setattr(self, f"{name}_conv", _conv(cin, cout, kernel, stride, pad))
            setattr(self, f"{name}_bn", BatchNorm2d(cout))

        conv_bn("conv0_1", in_channels, oc // 16)
        conv_bn("conv0_2", oc // 16, oc // 8)
        inplanes = oc // 8
        for li, (planes, n_blocks) in enumerate(zip(blocks_ch, self.LAYERS), 1):
            for b in range(n_blocks):
                setattr(self, f"layer{li}_{b}",
                        FanBasicBlock(inplanes, planes, b == 0 and inplanes != planes))
                inplanes = planes
            if li < 4:
                conv_bn(f"conv{li}", planes, planes)
        conv_bn("conv4_1", oc, oc, (2, 2), (2, 1), (0, 1))
        conv_bn("conv4_2", oc, oc, (2, 2), (1, 1), (0, 0))

    def _stage(self, x: torch.Tensor, name: str) -> torch.Tensor:
        return torch.relu(getattr(self, f"{name}_bn")(getattr(self, f"{name}_conv")(x)))

    def _layer(self, x: torch.Tensor, li: int) -> torch.Tensor:
        for b in range(self.LAYERS[li - 1]):
            x = getattr(self, f"layer{li}_{b}")(x)
        return x

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self._stage(self._stage(x, "conv0_1"), "conv0_2")
        x = max_pool(x, (2, 2), (2, 2))
        x = self._stage(self._layer(x, 1), "conv1")
        x = max_pool(x, (2, 2), (2, 2))
        x = self._stage(self._layer(x, 2), "conv2")
        x = max_pool(x, (2, 2), (2, 1), (0, 1))
        x = self._stage(self._layer(x, 3), "conv3")
        x = self._layer(x, 4)
        return self._stage(self._stage(x, "conv4_1"), "conv4_2")


class VGGFeatureExtractor(nn.Module):
    """CRNN-style VGG tower (``modules/feature_extraction.py:5-28``):
    [N, 1, 32, W] -> [N, C, 1, W/4 - 1] (``tpg.py:95-119``)."""

    def __init__(self, output_channel: int = 512, in_channels: int = 1):
        super().__init__()
        oc = (output_channel // 8, output_channel // 4, output_channel // 2, output_channel)
        self.conv0 = _conv(in_channels, oc[0], bias=True)
        self.conv1 = _conv(oc[0], oc[1], bias=True)
        self.conv2 = _conv(oc[1], oc[2], bias=True)
        self.conv3 = _conv(oc[2], oc[2], bias=True)
        self.conv4, self.bn4 = _conv(oc[2], oc[3]), BatchNorm2d(oc[3])
        self.conv5, self.bn5 = _conv(oc[3], oc[3]), BatchNorm2d(oc[3])
        self.conv6 = _conv(oc[3], oc[3], (2, 2), pad=(0, 0), bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        relu = torch.relu
        x = max_pool(relu(self.conv0(x)), (2, 2), (2, 2))
        x = max_pool(relu(self.conv1(x)), (2, 2), (2, 2))
        x = relu(self.conv3(relu(self.conv2(x))))
        x = max_pool(x, (2, 1), (2, 1))
        x = relu(self.bn5(self.conv5(relu(self.bn4(self.conv4(x))))))
        x = max_pool(x, (2, 1), (2, 1))
        return relu(self.conv6(x))


class GRCL(nn.Module):
    """Gated recurrent conv layer (``modules/feature_extraction.py:66-119``,
    ``tpg.py:122-147``): each of ``num_iteration`` steps has BatchNorms of
    its own over the same input maps ``wgf_u`` and ``wf_u``, so each one's
    running statistics advance in training."""

    def __init__(self, in_channels: int, output_channel: int, num_iteration: int = 5):
        super().__init__()
        oc = output_channel
        self.num_iteration = num_iteration
        self.wgf_u = _conv(in_channels, oc, (1, 1), pad=(0, 0))
        self.wf_u = _conv(in_channels, oc)
        self.bn_x_init = BatchNorm2d(oc)
        for i in range(num_iteration):
            setattr(self, f"bn_gfu_{i}", BatchNorm2d(oc))
            setattr(self, f"wgr_x_{i}", _conv(oc, oc, (1, 1), pad=(0, 0)))
            setattr(self, f"bn_grx_{i}", BatchNorm2d(oc))
            setattr(self, f"bn_fu_{i}", BatchNorm2d(oc))
            setattr(self, f"wr_x_{i}", _conv(oc, oc))
            setattr(self, f"bn_gx_{i}", BatchNorm2d(oc))
            setattr(self, f"bn_gated_{i}", BatchNorm2d(oc))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        wgf_u, wf_u = self.wgf_u(x), self.wf_u(x)
        h = torch.relu(self.bn_x_init(wf_u))
        for i in range(self.num_iteration):
            m = lambda name: getattr(self, f"{name}_{i}")  # noqa: E731
            gate = torch.sigmoid(m("bn_gfu")(wgf_u) + m("bn_grx")(m("wgr_x")(h)))
            f2 = m("bn_gx")(m("wr_x")(h))
            h = torch.relu(m("bn_fu")(wf_u) + m("bn_gated")(f2 * gate))
        return h


class RCNNFeatureExtractor(nn.Module):
    """GRCNN tower (``modules/feature_extraction.py:31-52``, ``tpg.py:150-168``)."""

    def __init__(self, output_channel: int = 512, in_channels: int = 1):
        super().__init__()
        oc = (output_channel // 8, output_channel // 4, output_channel // 2, output_channel)
        self.conv0 = _conv(in_channels, oc[0], bias=True)
        self.grcl0 = GRCL(oc[0], oc[0])
        self.grcl1 = GRCL(oc[0], oc[1])
        self.grcl2 = GRCL(oc[1], oc[2])
        self.conv1, self.bn1 = _conv(oc[2], oc[3], (2, 2), pad=(0, 0)), BatchNorm2d(oc[3])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = max_pool(torch.relu(self.conv0(x)), (2, 2), (2, 2))
        x = max_pool(self.grcl0(x), (2, 2), (2, 2))
        x = max_pool(self.grcl1(x), (2, 2), (2, 1), (0, 1))
        x = max_pool(self.grcl2(x), (2, 2), (2, 1), (0, 1))
        return torch.relu(self.bn1(self.conv1(x)))


class LSTMCell(nn.Module):
    """flax ``nn.LSTMCell`` as one module: gates (i, f, g, o) of
    ``x W_ih^T + h W_hh^T + b`` (flax's input Denses have no bias, its
    hidden ones do: one bias of 4H), carry ``(c, h)``."""

    def __init__(self, in_features: int, hidden: int):
        super().__init__()
        self.hidden = hidden
        self.weight_ih = nn.Parameter(torch.empty(4 * hidden, in_features))
        self.weight_hh = nn.Parameter(torch.empty(4 * hidden, hidden))
        self.bias = nn.Parameter(torch.empty(4 * hidden))

    def reset_parameters(self, gen: torch.Generator) -> None:
        bound = 1.0 / math.sqrt(self.hidden)
        for p in self.parameters(recurse=False):
            p.uniform_(-bound, bound, generator=gen)

    def forward(self, x: torch.Tensor, carry: tuple[torch.Tensor, torch.Tensor]):
        c, h = carry
        a = torch.addmm(self.bias, x, self.weight_ih.T) + h @ self.weight_hh.T
        i, f, g, o = a.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        return c, torch.sigmoid(o) * torch.tanh(c)


class AttentionHead(nn.Module):
    """Attn prediction head (``modules/prediction.py:6-58``,
    ``tpg.py:171-216``): an LSTM decoder with additive attention over the
    encoder steps; teacher-forced from ``text`` ([B, max_len + 1] ids,
    [GO] = 0 first) when it is given, else greedy over each step's argmax.
    Returns [B, batch_max_length + 1, num_classes]."""

    def __init__(self, input_size: int, hidden_size: int = 256, num_classes: int = 38):
        super().__init__()
        self.hidden_size, self.num_classes = hidden_size, num_classes
        self.i2h = Dense(input_size, hidden_size, bias=False)
        self.h2h = Dense(hidden_size, hidden_size)
        self.score = Dense(hidden_size, 1, bias=False)
        self.rnn = LSTMCell(input_size + num_classes, hidden_size)
        self.generator = Dense(hidden_size, num_classes)

    def forward(self, batch_h: torch.Tensor, text: Optional[torch.Tensor] = None,
                batch_max_length: int = 25) -> torch.Tensor:
        b = batch_h.shape[0]
        c = h = batch_h.new_zeros(b, self.hidden_size)
        h_proj = self.i2h(batch_h)
        targets = torch.zeros(b, dtype=torch.long, device=batch_h.device)  # [GO]
        probs = []
        for i in range(batch_max_length + 1):
            ids = text[:, i] if text is not None else targets
            onehots = F.one_hot(ids.long(), self.num_classes).to(batch_h.dtype)
            alpha = torch.softmax(self.score(torch.tanh(h_proj + self.h2h(h)[:, None])), dim=1)
            context = (alpha * batch_h).sum(dim=1)
            c, h = self.rnn(torch.cat([context, onehots], dim=-1), (c, h))
            step_logits = self.generator(h)
            probs.append(step_logits)
            if text is None:
                targets = step_logits.argmax(dim=-1)
        return torch.stack(probs, dim=1)


_EXTRACTORS = {"ResNet": FanResNet, "VGG": VGGFeatureExtractor, "RCNN": RCNNFeatureExtractor}


class TPGModel(nn.Module):
    """[N, 1, 32, W] luma -> [T, N, num_class] logits (``tpg.py:219-264``,
    reference ``model/crnn/model.py:27-95``): the extractor's map averaged
    over its height, then ``sequence_modeling`` "None" or "BiLSTM", then
    ``prediction`` "CTC" (a linear map) or "Attn" (:class:`AttentionHead`,
    fed ``text`` only in training mode, as JAX feeds it only when
    ``train``)."""

    def __init__(self, num_class: int = 37, hidden_size: int = 256,
                 feature_extraction: str = "ResNet", sequence_modeling: str = "None",
                 prediction: str = "CTC", output_channel: int = 512):
        super().__init__()
        if feature_extraction not in _EXTRACTORS:
            raise ValueError(f"feature_extraction {feature_extraction!r} (have {sorted(_EXTRACTORS)})")
        if sequence_modeling not in ("None", "BiLSTM") or prediction not in ("CTC", "Attn"):
            raise ValueError(f"sequence_modeling {sequence_modeling!r} / prediction {prediction!r}")
        self.num_class, self.prediction = num_class, prediction
        self.FeatureExtraction = _EXTRACTORS[feature_extraction](output_channel)
        width = output_channel
        self.bilstm = sequence_modeling == "BiLSTM"
        if self.bilstm:
            self.seq0 = BiLSTM(output_channel, hidden_size)
            self.seq0_embedding = Dense(2 * hidden_size, hidden_size)
            self.seq1 = BiLSTM(hidden_size, hidden_size)
            self.seq1_embedding = Dense(2 * hidden_size, hidden_size)
            width = hidden_size
        self.Prediction = (AttentionHead(width, hidden_size, num_class) if prediction == "Attn"
                           else Dense(width, num_class))

    def forward(self, x: torch.Tensor, text: Optional[torch.Tensor] = None,
                batch_max_length: int = 25) -> torch.Tensor:
        # AdaptiveAvgPool2d((None, 1)) over [b, w, c, h]: the mean over h
        seq = self.FeatureExtraction(x).mean(dim=2).transpose(1, 2)  # [B, W, C]
        if self.bilstm:
            seq = self.seq0_embedding(self.seq0(seq))
            seq = self.seq1_embedding(self.seq1(seq))
        if self.prediction == "Attn":
            out = self.Prediction(seq, text if self.training else None, batch_max_length)
        else:
            out = self.Prediction(seq)
        return out.transpose(0, 1)  # [T, B, C]

