"""HAN, the holistic attention network (counterpart of
``tatt_tpu/models/zoo/han.py``, reference ``model/han.py``).

``n_resgroups`` residual groups of ``n_resblocks`` RCABs at ``n_feats``
channels; layer attention (LAM) over the stacked group outputs and
channel-spatial attention (CSAM, a 3-D conv) fused before the tail.
Module names are the reference's, which ``import_han`` reads: ``head.0``,
``body.<g>.body.<b>.body.{0,2}`` (an RCAB's convs) and ``.body.3.conv_du``
(its channel attention), ``body.<g>.body.<n_resblocks>`` (a group's tail
conv), ``body.<n_resgroups>``, ``la``, ``csa``, ``last_conv``, ``last``
and ``tail`` (upsampler, then the output conv).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from tatt_tpu_torch.models.common import Conv2d, JaxNamed

RGB_MEAN = (0.4488, 0.4371, 0.4040)


class CALayer(nn.Module):
    """Channel attention (``han.py:19-33``): global mean -> 1x1 down, ReLU,
    1x1 up, sigmoid -> a gain per channel."""

    def __init__(self, channel: int, reduction: int = 16):
        super().__init__()
        self.conv_du = nn.Sequential(
            Conv2d(channel, channel // reduction, (1, 1), (0, 0)), nn.ReLU(),
            Conv2d(channel // reduction, channel, (1, 1), (0, 0)), nn.Sigmoid())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.conv_du(x.mean(dim=(2, 3), keepdim=True))


class RCAB(nn.Module):
    """conv-ReLU-conv-CA plus the skip (``han.py:36-44``)."""

    def __init__(self, n_feat: int):
        super().__init__()
        self.body = nn.Sequential(Conv2d(n_feat, n_feat), nn.ReLU(), Conv2d(n_feat, n_feat),
                                  CALayer(n_feat))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.body(x)


class ResidualGroup(nn.Module):
    """``n_resblocks`` RCABs and a conv, plus the skip (``han.py:47-57``)."""

    def __init__(self, n_feat: int, n_resblocks: int = 20):
        super().__init__()
        self.body = nn.Sequential(*(RCAB(n_feat) for _ in range(n_resblocks)),
                                  Conv2d(n_feat, n_feat))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.body(x)


class LAM(nn.Module):
    """Layer attention over N stacked group outputs (``han.py:60-73``):
    softmax of ``max(energy) - energy`` over the layers, scaled by
    ``gamma`` (initialized 0) and added back."""

    def __init__(self):
        super().__init__()
        self.gamma = nn.Parameter(torch.zeros(1))

    def reset_parameters(self, gen: torch.Generator) -> None:
        self.gamma.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, c, h, w = x.shape
        q = x.reshape(b, n, -1)
        energy = torch.bmm(q, q.transpose(1, 2))
        attn = torch.softmax(energy.amax(-1, keepdim=True) - energy, dim=-1)
        out = torch.bmm(attn, q).reshape(b, n, c, h, w)
        return (self.gamma * out + x).reshape(b, n * c, h, w)


class _Conv3d(nn.Module):
    """CSAM's one-channel 3x3x3 conv (``[1, 1, 3, 3, 3]`` weight, padding 1)."""

    def __init__(self):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(1, 1, 3, 3, 3))
        self.bias = nn.Parameter(torch.zeros(1))

    def reset_parameters(self, gen: torch.Generator) -> None:
        # U(-2 / sqrt(27), 2 / sqrt(27)) as the JAX package draws it; bias 0
        self.weight.uniform_(-2.0 / math.sqrt(27), 2.0 / math.sqrt(27), generator=gen)
        self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv3d(x, self.weight, self.bias, padding=1)


class CSAM(nn.Module):
    """Channel-spatial attention by a 3-D conv over (C, H, W)
    (``han.py:76-98``), scaled by ``gamma`` (initialized 0)."""

    def __init__(self):
        super().__init__()
        self.conv = _Conv3d()
        self.gamma = nn.Parameter(torch.zeros(1))

    def reset_parameters(self, gen: torch.Generator) -> None:
        self.gamma.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.sigmoid(self.conv(x[:, None])) * self.gamma
        return x * out[:, 0] + x


class HAN(JaxNamed):
    """``han.py:101-130``: reads the first 3 channels, [N, 3, 16, 64] ->
    [N, 3, 32, 128] at scale 2."""

    def __init__(self, n_resgroups: int = 10, n_resblocks: int = 20, n_feats: int = 128,
                 scale: int = 2):
        super().__init__()
        self.n_resgroups = n_resgroups
        self.head = nn.Sequential(Conv2d(3, n_feats))
        groups = [ResidualGroup(n_feats, n_resblocks) for _ in range(n_resgroups)]
        self.body = nn.ModuleList([*groups, Conv2d(n_feats, n_feats)])
        self.la = LAM()
        self.last_conv = Conv2d(n_feats * (n_resgroups + 1), n_feats)
        self.csa = CSAM()
        self.last = Conv2d(n_feats * 2, n_feats)
        up = []
        for _ in range(int(math.log2(scale))):
            up += [Conv2d(n_feats, n_feats * 4), nn.PixelShuffle(2)]
        self.tail = nn.Sequential(nn.Sequential(*up), Conv2d(n_feats, 3))

    def forward(self, x: torch.Tensor, gen: Optional[torch.Generator] = None) -> torch.Tensor:
        mean = torch.tensor(RGB_MEAN, dtype=x.dtype, device=x.device)[None, :, None, None]
        x = self.head(x[:, :3] - mean)
        res, stack = x, []
        for group in self.body[: self.n_resgroups]:
            res = group(res)
            stack.insert(0, res)  # the reference prepends (han.py:116-120)
        res = self.body[self.n_resgroups](res)
        stack.insert(0, res)
        out2 = self.last_conv(self.la(torch.stack(stack, dim=1)))
        out = self.last(torch.cat([self.csa(res), out2], dim=1)) + x
        return self.tail(out) + mean
