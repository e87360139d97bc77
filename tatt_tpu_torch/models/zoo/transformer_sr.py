"""SRTransformer_V4, arch ``tranSR_v4`` (counterpart of
``tatt_tpu/models/zoo/transformer_sr.py``, reference
``model/transformerSR.py:794-923``).

A column-token SR transformer: a light conv encoder lifts the LR image to
64 channels; a TP Interpreter gives a text-prior map; features and prior
become the W columns of the map, tokens of C*H = 1,024; 4 encoder layers
run over the prior's columns and 8 decoder layers (self-attention, then
cross-attention; queries from the learned ``init_factor`` table, targets
the feature columns), whose ``decoder_norm`` outputs are averaged; a
pixel-shuffle tail decodes the sum with the features and the prior.
Dropout (``dropout``) draws from the ``gen`` of a training forward.
Module names are the JAX package's.
"""

from __future__ import annotations

from typing import Any, Optional

import torch
from torch import nn

from tatt_tpu_torch.models.common import (
    BatchNorm2d, Conv2d, JaxNamed, PReLU, check_copies, pixel_shuffle,
)
from tatt_tpu_torch.models.tp_interpreter import TPInterpreter
from tatt_tpu_torch.models.transformer import (
    DecoderLayer, EncoderLayer, LayerNorm, positional_encoding,
)


class _ResBlock(nn.Module):
    """conv-BN-PReLU-conv-BN plus the skip (``transformer_sr.py:31-43``)."""

    def __init__(self, channels: int = 64):
        super().__init__()
        self.conv1 = Conv2d(channels, channels)
        self.bn1 = BatchNorm2d(channels)
        self.prelu = PReLU()
        self.conv2 = Conv2d(channels, channels)
        self.bn2 = BatchNorm2d(channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.bn2(self.conv2(self.prelu(self.bn1(self.conv1(x)))))


class SRTransformerV4(JaxNamed):
    """``transformer_sr.py:46-126``.  ``lr_size``: the input's H x W, which
    sizes the TP Interpreter and the query table (the JAX module reads it
    from its input at init); ``d_model`` must be ``cnt_d_model * H``."""

    def __init__(self, d_model: int = 1024, cnt_d_model: int = 64, t_encoder_num: int = 4,
                 t_decoder_num: int = 8, scale_factor: int = 2, in_planes: int = 4,
                 text_emb: int = 37, dropout: float = 0.1, lr_size: tuple[int, int] = (16, 64)):
        super().__init__()
        if d_model != cnt_d_model * lr_size[0]:
            raise ValueError(f"d_model {d_model} != {cnt_d_model} channels x H {lr_size[0]}")
        self.d_model, self.dropout = d_model, dropout
        self.t_encoder_num, self.t_decoder_num = t_encoder_num, t_decoder_num
        self.enc_conv = Conv2d(in_planes, 64, (9, 9), (4, 4))
        self.enc_act = PReLU()
        self.enc_block1 = _ResBlock(64)
        self.enc_block2 = _ResBlock(64)
        self.infoGen = TPInterpreter(text_emb=text_emb, d_model=cnt_d_model, output_size=lr_size)
        for i in range(t_encoder_num):
            setattr(self, f"encoder_{i}", EncoderLayer(d_model, 4, 1024))
        self.init_factor = nn.Parameter(torch.empty(lr_size[1], d_model))
        for i in range(t_decoder_num):
            setattr(self, f"decoder_{i}", DecoderLayer(d_model, 4, 1024))
        self.decoder_norm = LayerNorm(d_model)
        self.dec_up_conv = Conv2d(64, 64 * 4)
        self.dec_up_act = PReLU()
        self.dec_final = Conv2d(64, in_planes, (9, 9), (4, 4))

    def reset_parameters(self, gen: torch.Generator) -> None:
        self.init_factor.normal_(0.0, 1.0, generator=gen)  # as the JAX package draws it

    def forward(self, img_lr: torch.Tensor, text_prior: torch.Tensor, copies: int = 1,
                gen: Optional[torch.Generator] = None) -> tuple[torch.Tensor, dict[str, Any]]:
        check_copies(copies)
        drop = (self.dropout, gen) if self.training else (0.0, None)
        feat = self.enc_block2(self.enc_block1(self.enc_act(self.enc_conv(img_lr))))
        n, c, h, w = feat.shape
        tp_map, pr_weights = self.infoGen(feat, text_prior, *drop)
        src = torch.relu(feat + tp_map)

        def columns(z: torch.Tensor) -> torch.Tensor:  # [N, C, H, W] -> [N, W, C*H]
            return z.reshape(n, c * h, w).transpose(1, 2)

        pos = positional_encoding(w, self.d_model, feat.device)[None].to(feat.dtype)
        memory = columns(tp_map)
        for i in range(self.t_encoder_num):
            memory = getattr(self, f"encoder_{i}")(memory, pos, *drop)
        query_pos = self.init_factor.to(feat.dtype)[None].expand(n, w, self.d_model)
        out, total = columns(feat), 0.0
        for i in range(self.t_decoder_num):
            out, _ = getattr(self, f"decoder_{i}")(out, memory, pos, query_pos, *drop)
            total = total + self.decoder_norm(out)
        hs = total / self.t_decoder_num
        fused = hs.transpose(1, 2).reshape(n, c, h, w) + src
        up = self.dec_up_act(pixel_shuffle(self.dec_up_conv(fused), 2))
        return torch.tanh(self.dec_final(up)), {"pr_weights": pr_weights, "spatial_t_emb": tp_map}
