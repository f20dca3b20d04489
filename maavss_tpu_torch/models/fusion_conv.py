"""AVFusionModelConv — the conv-experiment variant of the fusion model
(counterpart of maavss_tpu/models/fusion_conv.py; avse_model_conv.py in the
reference).

The fusion model's structure with: bias-free convs, (3,9) / (1,9) kernels
with (1,4) / (0,4) padding (the (3,9) family on the STFT stacks; the
phasegram stacks keep their planned (1,9)), the fusion FC sized to
latent_channels * t * s so that the fused vector reshapes into the latent
grids, and a forward that runs the fused latent through BOTH autoencoder
decoders in place of the linear heads. The (3,9)p(1,4) and (5,5)p(2,2)
kernel families give the same shapes, so the closed-form planners are
reused with each spec's kernel rewritten, as the JAX model does.

The phasegram encoder is a plain bias-free `ConvStack` (cuDNN), as the JAX
model builds it (not the fused-layer kernel stack); the BiLSTM without
biases is K1 on the card. No JAX script trains this model: it is ported
for its forward, eval and train mode, with the JAX parameter tree
(`convert.from_flax` carries JAX weights across).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import torch
from torch import nn

from maavss_tpu_torch.models.layers import BiLSTM, ConvStack, dense, leaky
from maavss_tpu_torch.models.shape_plan import (
    plan_phasegram_decoder,
    plan_phasegram_encoder,
    plan_stft_decoder_fusion,
    plan_stft_encoder_fusion,
)

LSTM_HIDDEN = 256


def _conv_kernels(specs, kernel, padding):
    return tuple(dataclasses.replace(s, kernel=kernel, padding=padding)
                 for s in specs)


class AVFusionModelConv(nn.Module):
    """(stft [B,2,T,F], pgram [B,1,Tf,p^2]) -> (ŷ_stft, ŷ_pgram, fused);
    `dtype` the compute dtype as in models/fusion.py."""

    def __init__(self, stft_shape: Sequence[int], pgram_shape: Sequence[int],
                 latent_channels: int = 64, fc_size: int = 4096,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.stft_shape = tuple(stft_shape)
        self.pgram_shape = tuple(pgram_shape)
        self.latent_channels = latent_channels
        pg_enc, pg_hw = plan_phasegram_encoder(pgram_shape, latent_channels,
                                               fc_size)
        pg_dec, _ = plan_phasegram_decoder(pg_hw, pgram_shape,
                                           latent_channels)
        a_enc, a_hw = plan_stft_encoder_fusion(stft_shape, pg_hw,
                                               latent_channels)
        a_dec, _ = plan_stft_decoder_fusion(a_hw, stft_shape,
                                            latent_channels)
        self.latent_hw = pg_hw
        a_enc = _conv_kernels(a_enc, (3, 9), (1, 4))
        a_dec = _conv_kernels(a_dec, (3, 9), (1, 4))
        self.phasegram_encoder = ConvStack(pg_enc, use_bias=False,
                                           dtype=dtype)
        self.phasegram_decoder = ConvStack(pg_dec, use_bias=False,
                                           dtype=dtype)
        self.stft_encoder = ConvStack(a_enc, use_bias=False, dtype=dtype)
        self.stft_decoder = ConvStack(a_dec, use_bias=False, dtype=dtype)
        lstm_in = (pg_enc[-1].out_ch + a_enc[-1].out_ch) * pg_hw[1]
        self.lstm = BiLSTM(lstm_in, LSTM_HIDDEN, dtype=dtype)
        t, s = pg_hw
        self.fc1 = nn.Linear(t * 2 * LSTM_HIDDEN, fc_size // 2)
        # avse_model_conv.py:515-517: the fused vector is a latent grid
        self.fc2 = nn.Linear(fc_size // 2, latent_channels * t * s)

    def audio_ae_forward(self, x_a: torch.Tensor) -> torch.Tensor:
        return self.stft_decoder(self.stft_encoder(x_a))

    def visual_ae_forward(self, x_v: torch.Tensor) -> torch.Tensor:
        return self.phasegram_decoder(self.phasegram_encoder(x_v))

    def forward(self, x_a: torch.Tensor, x_v: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """The fused latent reshaped into both latent grids and decoded
        through the autoencoder decoders (avse_model_conv.py:700-717)."""
        x_a_enc = self.stft_encoder(x_a)
        x_v_enc = self.phasegram_encoder(x_v)
        cat = torch.cat([x_v_enc.permute(0, 2, 1, 3),
                         x_a_enc.permute(0, 2, 1, 3)], dim=2)
        av = self.lstm(cat.reshape(cat.shape[0], cat.shape[1], -1))
        av = av.reshape(av.shape[0], -1)
        av = leaky(dense(self.fc1, av, self.dtype), 0.3, self.dtype)
        fused = leaky(dense(self.fc2, av, self.dtype), 0.3, self.dtype)
        x_a_out = self.stft_decoder(fused.reshape(x_a_enc.shape))
        x_v_out = self.phasegram_decoder(fused.reshape(x_v_enc.shape))
        return x_a_out, x_v_out, fused
