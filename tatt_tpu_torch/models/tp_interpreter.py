"""TP Interpreter: text prior -> spatial prior map by cross-attention
(counterpart of ``tatt_tpu/models/tp_interpreter.py``).

  text prior [N, text_emb, 1, T] --fc_in + PReLU--> [N, T, 64] text tokens
    (text_emb 37, or 3965 under --CHNSR; T 26, or the TPG's 129)
  1 encoder layer over the T tokens (sinusoidal PE as pos)
  learned query table (lr_h * lr_w x 64; 1024 x 64 at the 16x64 LR)
    smoothed by a BiGRU, used as query_pos
  2 cross-attention decoder layers with tgt = flattened image features
  mean over the normed decoder outputs -> [N, 64, lr_h, lr_w] prior map

``query_gru_mode``: ``width`` (default) scans the table along W, shared
by the batch; ``reference`` reproduces the reference's batch_first quirk
(the scan runs across the batch), needed for reference checkpoints.
The query GRU reads lr_h * 64 wide columns with hidden lr_h * 32 over lr_w
steps (512 over 64 at the 16x64 LR, 1024 over 128 at 32x128) and stays on
the plain path.  Dropout
(``rate`` with a generator) runs at the JAX sites, the positional encoding
itself included (``tp_interpreter.py:76-79``).  The image features' dtype
is the compute dtype: the prior, the positional table and the query table
are cast to it (``tp_interpreter.py:69-71, 75, 96``).
"""

from __future__ import annotations

import torch
from torch import nn

from tatt_tpu_torch.kernels.rnn import BiGRU
from tatt_tpu_torch.models.common import Dense, PReLU, dropout
from tatt_tpu_torch.models.transformer import (
    EncoderLayer,
    LayerNorm,
    TPDecoderLayer,
    positional_encoding_table,
)
from tatt_tpu_torch.train.observe import span


class _Embedding(nn.Module):
    """The query table, kept under the reference name
    ``init_factor.weight``; init N(0, 1) like ``nn.Embedding``."""

    def __init__(self, n: int, d: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(n, d))

    def reset_parameters(self, gen: torch.Generator) -> None:
        self.weight.normal_(0.0, 1.0, generator=gen)


class _Stack(nn.Module):
    """``layers.<i>`` container (reference ``TransformerEncoder`` /
    ``TransformerDecoder`` naming) with an optional final ``norm``."""

    def __init__(self, layers, norm=None):
        super().__init__()
        self.layers = nn.ModuleList(layers)
        if norm is not None:
            self.norm = norm


class _InfoTransformer(nn.Module):
    def __init__(self, d_model, nhead, n_enc, n_dec, query_rows):
        super().__init__()
        self.encoder = _Stack([EncoderLayer(d_model, nhead, d_model) for _ in range(n_enc)])
        self.decoder = _Stack(
            [TPDecoderLayer(d_model, nhead, d_model) for _ in range(n_dec)],
            LayerNorm(d_model),
        )
        self.gru_encoding = BiGRU(query_rows * d_model, query_rows * d_model // 2)


class TPInterpreter(nn.Module):
    def __init__(
        self,
        text_emb: int = 37,
        d_model: int = 64,
        output_size: tuple[int, int] = (16, 64),
        nhead: int = 4,
        num_encoder_layers: int = 1,
        num_decoder_layers: int = 2,
        query_gru_mode: str = "width",
    ):
        super().__init__()
        if query_gru_mode not in ("width", "reference"):
            raise ValueError(f"unknown query_gru_mode {query_gru_mode!r}")
        self.d_model = d_model
        self.output_size = output_size
        self.query_gru_mode = query_gru_mode
        fh, fw = output_size
        self.fc_in = Dense(text_emb, d_model)
        self.activation = PReLU()
        self.init_factor = _Embedding(fh * fw, d_model)
        self.transformer = _InfoTransformer(
            d_model, nhead, num_encoder_layers, num_decoder_layers, fh
        )

    def query_pos(self, n: int, dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """[N, H*W, C] query positions from the BiGRU-smoothed table, in
        ``dtype``."""
        with span("tatt.query_gru"):
            fh, fw = self.output_size
            c = self.d_model
            table = self.init_factor.weight.to(dtype).reshape(fh, fw, c)
            cols = table.permute(1, 0, 2).reshape(fw, 1, fh * c)
            gru = self.transformer.gru_encoding
            if self.query_gru_mode == "reference":
                # torch batch_first quirk: rows = W positions, sequence = batch
                cols = gru(cols.expand(fw, n, fh * c))  # [W, N, H*C]
                return cols.reshape(fw, n, fh, c).permute(1, 2, 0, 3).reshape(n, fh * fw, c)
            cols = gru(cols.reshape(1, fw, fh * c))  # [1, W, H*C]
            q = cols.reshape(fw, fh, c).permute(1, 0, 2).reshape(1, fh * fw, c)
            return q.expand(n, fh * fw, c)

    def forward(self, image_feature: torch.Tensor, tp_input: torch.Tensor, rate: float = 0.0, gen=None):
        """``image_feature`` [N, C, H, W], ``tp_input`` [N, text_emb, 1, T]
        -> (prior map [N, C, H, W], attention weights [N, H*W, T]).
        ``rate`` / ``gen``: dropout, identity without a generator."""
        with span("tatt.tp_interpreter"):
            n, c_i, h, w = image_feature.shape
            x = tp_input[:, :, 0, :].transpose(1, 2).to(image_feature.dtype)
            x = self.activation(self.fc_in(x))
            t = x.shape[1]
            pos = torch.as_tensor(
                positional_encoding_table(t, self.d_model), device=x.device
            ).to(x.dtype)[None]
            pos = dropout(pos, rate, gen, batched=False)  # one [1, T, C] mask for the batch
            memory = x
            for layer in self.transformer.encoder.layers:
                memory = layer(memory, pos, rate, gen)
            query_pos = self.query_pos(n, x.dtype)
            tgt = image_feature.reshape(n, c_i, h * w).transpose(1, 2)
            norm = self.transformer.decoder.norm
            out, weights, total = tgt, None, 0.0
            layers = self.transformer.decoder.layers
            for layer in layers:
                out, weights = layer(out, memory, pos, query_pos, rate, gen)
                total = total + norm(out)
            prior = total / len(layers)  # [N, HW, C]
            return prior.transpose(1, 2).reshape(n, self.d_model, h, w), weights
