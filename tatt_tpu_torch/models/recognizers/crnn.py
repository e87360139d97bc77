"""CRNN recognizer — text-prior generator and eval judge
(counterpart of ``tatt_tpu/models/recognizers/crnn.py``).

VGG-style CNN whose pools collapse H 32 -> 1 and map W 100 -> 26, then two
BiLSTM heads emitting [T=26, B, 37] CTC logits.  Names follow the
reference ``model/crnn/crnn.py`` (``cnn.conv<i>``, ``cnn.batchnorm<i>``,
``rnn.<j>.rnn``, ``rnn.<j>.embedding``).
"""

from __future__ import annotations

import torch
from torch import nn

from tatt_tpu_torch.kernels.resize import resize_bicubic, rgb_to_luma
from tatt_tpu_torch.kernels.rnn import BiLSTM
from tatt_tpu_torch.models.common import BatchNorm2d, Conv2d, Dense, max_pool


def parse_crnn_input(images: torch.Tensor, width: int = 100) -> torch.Tensor:
    """[N, >=3, H, W] RGB (first 3 channels) -> [N, 1, 32, width] luma."""
    return rgb_to_luma(resize_bicubic(images[:, :3], 32, width))


class BidirectionalLSTM(nn.Module):
    """BiLSTM + linear head on [B, T, C] (``crnn.py:5-26``)."""

    def __init__(self, n_in: int, hidden: int, n_out: int):
        super().__init__()
        self.rnn = BiLSTM(n_in, hidden)
        self.embedding = Dense(2 * hidden, n_out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.embedding(self.rnn(x))


class _CNN(nn.Module):
    def __init__(self, nm):
        super().__init__()
        ins = (1,) + tuple(nm[:-1])
        for i in range(7):
            k, p = ((2, 2), (0, 0)) if i == 6 else ((3, 3), (1, 1))
            setattr(self, f"conv{i}", Conv2d(ins[i], nm[i], k, p))
        for i in (2, 4, 6):
            setattr(self, f"batchnorm{i}", BatchNorm2d(nm[i]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        relu = torch.relu
        x = max_pool(relu(self.conv0(x)), (2, 2), (2, 2))
        x = max_pool(relu(self.conv1(x)), (2, 2), (2, 2))
        x = relu(self.batchnorm2(self.conv2(x)))
        x = max_pool(relu(self.conv3(x)), (2, 2), (2, 1), (0, 1))
        x = relu(self.batchnorm4(self.conv4(x)))
        x = max_pool(relu(self.conv5(x)), (2, 2), (2, 1), (0, 1))
        return relu(self.batchnorm6(self.conv6(x)))


class CRNN(nn.Module):
    """Returns [T, B, nclass] logits.  ``nm`` follows the reference channel
    plan; ``nh=64`` with a narrow ``nm`` is the in-repo fixture judge."""

    def __init__(
        self,
        nclass: int = 37,
        nh: int = 256,
        nm: tuple[int, ...] = (64, 128, 256, 256, 512, 512, 512),
    ):
        super().__init__()
        self.cnn = _CNN(nm)
        self.rnn = nn.ModuleList(
            [BidirectionalLSTM(nm[6], nh, nh), BidirectionalLSTM(nh, nh, nclass)]
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.cnn(x)
        if x.shape[2] != 1:
            raise ValueError(f"conv tower must collapse height to 1, got {x.shape[2]}")
        seq = x[:, :, 0].transpose(1, 2)  # [B, T, C]
        for layer in self.rnn:
            seq = layer(seq)
        return seq.transpose(0, 1)  # [T, B, nclass]
