"""MORAN recognizer, the judge of ``--test_model=MORAN``
(counterpart of ``tatt_tpu/models/recognizers/moran.py``).

The eval path of ``model/moran/``: ``MORN`` predicts a vertical offset
field from a conv tower, adds it to a fixed inclusive [-1, 1] grid and
resamples the input (bilinear, zero padding, ``align_corners=False``), then
once more from the rectified image (the test-time ``enhance`` pass,
``morn.py:46-51``).  ``ASRN``: a five-stage strided residual CNN ([N, 512,
1, 25]), two BiLSTM(256) layers each with a linear embedding, and two
attention-GRU decoders (left-to-right and right-to-left), each greedy for
20 steps.  Module names follow the reference checkpoint (``MORN.cnn.<i>``,
``ASRN.cnn.block<i>.<j>.*``, ``ASRN.rnn.<j>.{rnn,embedding}``,
``ASRN.attention{L2R,R2L}.{attention_cell.*,generator,char_embeddings}``).
Input: ``parse_moran_data`` (``interfaces/base.py:694-710``), bicubic to
32x100 and BT.601 luma; the alphabet ``0..9a..z$`` is cut at '$'.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from tatt_tpu_torch.kernels.grid_sample import grid_sample_bilinear
from tatt_tpu_torch.kernels.resize import resize_bicubic, resize_bilinear, rgb_to_luma
from tatt_tpu_torch.kernels.rnn import GRUCellWeights
from tatt_tpu_torch.models.common import BatchNorm2d, Conv2d, Dense, max_pool
from tatt_tpu_torch.models.recognizers.crnn import BidirectionalLSTM

MORAN_ALPHABET = "0123456789abcdefghijklmnopqrstuvwxyz$"


def parse_moran_input(images: torch.Tensor, width: int = 100) -> torch.Tensor:
    """[N, >=3, H, W] RGB in [0, 1] -> [N, 1, 32, width] luma."""
    return rgb_to_luma(resize_bicubic(images[:, :3], 32, width))


def decode_moran_ids(ids, alphabet: str = MORAN_ALPHABET) -> list[str]:
    """[B, T] 0-based class ids -> strings cut at '$' (EOS)."""
    return ["".join(alphabet[int(i)] for i in row).split("$")[0] for row in np.asarray(ids)]


def _conv_bn(cin: int, cout: int, kernel=(3, 3), padding=(1, 1), stride=(1, 1)) -> nn.Sequential:
    return nn.Sequential(Conv2d(cin, cout, kernel, padding, stride=stride), BatchNorm2d(cout))


class MORN(nn.Module):
    """Offset-grid rectifier to ``target_h`` x ``target_w`` with ``enhance``
    refinement passes (``morn.py:6-141``).  ``cnn`` keeps the reference's
    ``nn.Sequential`` indices: convs at 1, 5, 9, 12, 15, their BNs after."""

    def __init__(self, target_h: int = 32, target_w: int = 100, enhance: int = 1):
        super().__init__()
        self.target_h, self.target_w, self.enhance = target_h, target_w, enhance
        self.cnn = nn.Module()
        for (ci, bi), (cin, cout) in zip(((1, 2), (5, 6), (9, 10), (12, 13), (15, 16)),
                                         ((1, 64), (64, 128), (128, 64), (64, 16), (16, 1))):
            self.cnn.add_module(str(ci), Conv2d(cin, cout))
            self.cnn.add_module(str(bi), BatchNorm2d(cout))

    def offsets(self, z: torch.Tensor) -> torch.Tensor:
        layer = lambda i, z: getattr(self.cnn, str(i + 1))(getattr(self.cnn, str(i))(z))  # noqa: E731
        pool = lambda z: max_pool(z, (2, 2), (2, 2))  # noqa: E731
        z = torch.relu(layer(1, pool(z)))
        z = torch.relu(layer(5, pool(z)))
        z = torch.relu(layer(9, pool(z)))
        z = torch.relu(layer(12, z))
        return layer(15, z)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        th, tw = self.target_h, self.target_w
        ys = torch.arange(th, dtype=torch.float32, device=x.device) * 2.0 / (th - 1) - 1.0
        xs = torch.arange(tw, dtype=torch.float32, device=x.device) * 2.0 / (tw - 1) - 1.0
        gx, gy = torch.meshgrid(xs, ys, indexing="xy")  # [th, tw]
        grid = torch.stack([gx, gy], -1)[None].to(x.dtype).expand(x.shape[0], th, tw, 2)

        def rectify(src, prev):
            off = self.offsets(src)
            off = (max_pool(torch.relu(off), (2, 2), (1, 1))
                   - max_pool(torch.relu(-off), (2, 2), (1, 1)))
            og = grid_sample_bilinear(off, grid).permute(0, 2, 3, 1)  # [N, th, tw, 1]
            if prev is not None:
                og = og + prev
            warp = torch.cat([grid[..., :1], grid[..., 1:] + og], dim=-1)
            return grid_sample_bilinear(x, warp), og

        x_rect, og = rectify(resize_bilinear(x, th, tw), None)
        for _ in range(self.enhance):
            x_rect, og = rectify(x_rect, og)
        return x_rect


class MoranResidualBlock(nn.Module):
    """``asrn_res.py:160-186``: a strided block (3x3 conv1 and a 3x3
    downsample) or a plain one (1x1 conv1, identity); no ReLU between
    the two convs."""

    def __init__(self, c_in: int, c_out: int, stride=(1, 1)):
        super().__init__()
        down = stride[0] > 1
        self.conv1 = _conv_bn(c_in, c_out, stride=stride) if down else _conv_bn(c_in, c_out, (1, 1), (0, 0))
        self.conv2 = _conv_bn(c_out, c_out)
        self.downsample = _conv_bn(c_in, c_out, stride=stride) if down else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        residual = x if self.downsample is None else self.downsample(x)
        return torch.relu(residual + self.conv2(self.conv1(x)))


class MoranResNet(nn.Module):
    """``asrn_res.py:188-212``: [N, 1, 32, 100] -> [N, 512, 1, 25]."""

    PLAN = ((32, (2, 2), 3), (64, (2, 2), 4), (128, (2, 1), 6), (256, (2, 1), 6), (512, (2, 1), 3))

    def __init__(self):
        super().__init__()
        self.block0 = _conv_bn(1, 32)
        cin = 32
        for li, (c, stride, rep) in enumerate(self.PLAN, start=1):
            blocks = []
            for bi in range(rep):
                blocks.append(MoranResidualBlock(cin, c, stride if bi == 0 else (1, 1)))
                cin = c
            setattr(self, f"block{li}", nn.Sequential(*blocks))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.block0(x)
        for li in range(1, len(self.PLAN) + 1):
            x = getattr(self, f"block{li}")(x)
        return x


class _Weight(nn.Module):
    """A bias-free ``nn.Linear`` [out, in]."""

    def __init__(self, n_in: int, n_out: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(n_out, n_in))

    def reset_parameters(self, gen: torch.Generator) -> None:
        self.weight.uniform_(-1 / math.sqrt(self.weight.shape[1]), 1 / math.sqrt(self.weight.shape[1]),
                             generator=gen)


class _AttentionCell(nn.Module):
    def __init__(self, hidden: int, num_embeddings: int):
        super().__init__()
        self.i2h = _Weight(hidden, hidden)
        self.h2h = Dense(hidden, hidden)
        self.score = _Weight(hidden, 1)
        self.rnn = GRUCellWeights(hidden + num_embeddings, hidden)


class MoranAttention(nn.Module):
    """Greedy eval decode of one direction (``asrn_res.py:127-155``)."""

    def __init__(self, num_classes: int, hidden: int = 256, num_embeddings: int = 256,
                 num_steps: int = 20):
        super().__init__()
        self.hidden, self.num_steps = hidden, num_steps
        self.attention_cell = _AttentionCell(hidden, num_embeddings)
        self.generator = Dense(hidden, num_classes)
        self.char_embeddings = nn.Parameter(torch.empty(num_classes + 1, num_embeddings))

    def reset_parameters(self, gen: torch.Generator) -> None:
        self.char_embeddings.normal_(0.0, 1.0, generator=gen)

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        """``feats`` [T, B, C] -> logits [B, num_steps, classes]."""
        cell = self.attention_cell
        feats_proj = feats @ cell.i2h.weight.T  # [T, B, H]
        hidden = feats.new_zeros(feats.shape[1], self.hidden)
        tgt = torch.zeros(feats.shape[1], dtype=torch.long, device=feats.device)
        out = []
        for _ in range(self.num_steps):
            e = torch.tanh(feats_proj + cell.h2h(hidden)[None]) @ cell.score.weight[0]  # [T, B]
            context = (feats * torch.softmax(e, dim=0)[:, :, None]).sum(0)
            gru_in = torch.cat([context, self.char_embeddings[tgt]], dim=1)
            hidden = cell.rnn.step(gru_in, hidden)
            logits = self.generator(hidden)
            tgt = logits.argmax(dim=1) + 1
            out.append(logits)
        return torch.stack(out, 1)


class ASRN(nn.Module):
    """``asrn_res.py:214-259``, eval path: CNN, two BiLSTM + embedding
    layers, and the two attention decoders."""

    def __init__(self, num_classes: int = 37, hidden: int = 256, num_steps: int = 20):
        super().__init__()
        self.cnn = MoranResNet()
        self.rnn = nn.ModuleList([BidirectionalLSTM(512, hidden, hidden),
                                  BidirectionalLSTM(hidden, hidden, hidden)])
        self.attentionL2R = MoranAttention(num_classes, hidden, 256, num_steps)
        self.attentionR2L = MoranAttention(num_classes, hidden, 256, num_steps)

    def forward(self, x: torch.Tensor):
        seq = self.cnn(x)[:, :, 0].transpose(1, 2)  # [B, W, C]
        for layer in self.rnn:
            seq = layer(seq)
        feats = seq.transpose(0, 1)  # [T, B, C]
        return self.attentionL2R(feats), self.attentionR2L(feats)


class MORAN(nn.Module):
    """MORN + ASRN: [N, 1, 32, 100] luma -> (logits L2R, logits R2L), each
    [N, num_steps, classes]."""

    def __init__(self, num_classes: int = 37, hidden: int = 256, num_steps: int = 20):
        super().__init__()
        self.MORN = MORN()
        self.ASRN = ASRN(num_classes, hidden, num_steps)

    def forward(self, x: torch.Tensor):
        return self.ASRN(self.MORN(x))
