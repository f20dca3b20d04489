"""AVFusionModel — the phasegram-fusion separation model (counterpart of
maavss_tpu/models/fusion.py).

An STFT conv2d autoencoder and a phasegram conv2d autoencoder whose latents
are concatenated time-major, fused by a bidirectional LSTM(256) and two FC
layers into a 512-d latent, from which per-modality linear heads
reconstruct the input-shaped STFT and phasegram (avse_model.py:410-711 in
the reference). Every stack is planned by models/shape_plan.py, the same
closed-form planner the JAX package uses. With `mask_head` (--mask_head)
the audio head predicts a complex ratio mask applied to the noisy input
STFT instead; in the visual-only mode, whose audio input is zeroed, that
head outputs exactly 0.

`dtype` (--dtype) is the compute dtype, float32, bfloat16 or float16, with
flax's mixed-precision semantics (models/layers.py). Below float32 the
`--mask_head` head is JAX's own structure: `a_fc1` in the compute dtype,
the mask cast
to the STFT features' fp32 (maavss_tpu/models/fusion.py:203) and applied
by K4's standalone mask product (ops/cuda_complex.py); the fused fp32 head
(ops/cuda_mask_head.py) is the float32 route.

Under --mesh_model (parallel/mesh.py:shard_model) the heads whose weights
the rule splits, fc1, fc2, a_fc1 and v_fc1, are column-parallel
(models/layers.py:dense), the LSTM's input projection too; the fused mask
head takes a_fc1's weight joined over the model group (`full_param`).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn

from maavss_tpu_torch.exp.profiling import SPANS, annotate
from maavss_tpu_torch.models.layers import (
    ConvStack,
    KernelConvStack1x9,
    dense,
    full_param,
    leaky,
    make_birnn,
)
from maavss_tpu_torch.models.shape_plan import (
    plan_phasegram_decoder,
    plan_phasegram_encoder,
    plan_stft_decoder_fusion,
    plan_stft_encoder_fusion,
)
from maavss_tpu_torch.ops.cuda_complex import complex_mask_apply
from maavss_tpu_torch.ops.cuda_mask_head import mask_head_apply

LSTM_HIDDEN = 256


def resolve_pgenc_kernel(pgenc_kernel: str, device) -> str:
    """'auto' -> 'pallas' (the fused-layer kernel stack) on CUDA, 'xla'
    (ConvStack) elsewhere. The names are the JAX package's flag values."""
    if pgenc_kernel == "auto":
        return "pallas" if torch.device(device or "cpu").type == "cuda" else "xla"
    if pgenc_kernel == "fold":
        raise NotImplementedError(
            "--pgenc_kernel fold is a TPU lane-folding of the same math and "
            "is not carried (ROADMAP queue 1, 'Not carried')")
    if pgenc_kernel not in ("xla", "pallas"):
        raise ValueError(f"unknown pgenc_kernel {pgenc_kernel!r} "
                         "(auto|xla|pallas|fold)")
    return pgenc_kernel


class AVFusionModel(nn.Module):
    """(stft [B,2,T,F], pgram [B,1,Tf,p^2]) -> (ŷ_stft, ŷ_pgram, fused[B,512]).

    `device` picks the 'auto' phasegram-encoder path and is where the
    parameters end up."""

    def __init__(self, stft_shape: Sequence[int], pgram_shape: Sequence[int],
                 latent_channels: int = 64, fc_size: int = 4096,
                 rnn_cell: str = "lstm", mask_head: bool = False,
                 pgenc_kernel: str = "auto", stft_fold: str = "auto",
                 device=None, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        if stft_fold == "fold":
            raise NotImplementedError(
                "--stft_fold fold is a TPU lane-folding of the same math and "
                "is not carried (ROADMAP queue 1, 'Not carried')")
        if stft_fold not in ("auto", "xla"):
            raise ValueError(f"unknown stft_fold {stft_fold!r} (auto|xla|fold)")
        self.stft_shape = tuple(stft_shape)
        self.pgram_shape = tuple(pgram_shape)
        self.latent_channels = latent_channels
        self.fc_size = fc_size
        self.mask_head = mask_head
        pg_enc, pg_hw = plan_phasegram_encoder(pgram_shape, latent_channels,
                                               fc_size)
        pg_dec, _ = plan_phasegram_decoder(pg_hw, pgram_shape, latent_channels)
        a_enc, a_hw = plan_stft_encoder_fusion(stft_shape, pg_hw,
                                               latent_channels)
        a_dec, _ = plan_stft_decoder_fusion(a_hw, stft_shape, latent_channels)
        self.latent_hw = pg_hw
        self.pgenc_kernel = resolve_pgenc_kernel(pgenc_kernel, device)
        enc_cls = KernelConvStack1x9 if self.pgenc_kernel == "pallas" else ConvStack
        self.phasegram_encoder = enc_cls(pg_enc, dtype=dtype)
        self.phasegram_decoder = ConvStack(pg_dec, dtype=dtype)
        self.stft_encoder = ConvStack(a_enc, dtype=dtype)
        self.stft_decoder = ConvStack(a_dec, dtype=dtype)

        lstm_in = (pg_enc[-1].out_ch + a_enc[-1].out_ch) * pg_hw[1]
        self.lstm = make_birnn(rnn_cell, lstm_in, LSTM_HIDDEN, dtype)
        t_stft, f_stft = stft_shape[-2], stft_shape[-1]
        self.fc1 = nn.Linear(pg_hw[0] * 2 * LSTM_HIDDEN, fc_size // 2)
        self.fc2 = nn.Linear(fc_size // 2, 512)
        self.a_fc1 = nn.Linear(512, 2 * t_stft * f_stft)
        self.v_fc1 = nn.Linear(512, pgram_shape[-2] * pgram_shape[-1])
        if device is not None:
            self.to(device)

    def bn_fed_biases(self):
        """state_dict names of every conv bias that feeds a BatchNorm (see
        ConvStack.bn_fed_biases): two implementations of the train step
        legitimately differ there by up to the learning rate per step."""
        return [f"{name}.{leaf}" for name, mod in self.named_children()
                if isinstance(mod, ConvStack) for leaf in mod.bn_fed_biases()]

    def av_fusion_forward(self, x_a_enc: torch.Tensor,
                          x_v_enc: torch.Tensor) -> torch.Tensor:
        """Latents [B,C,t,s] -> fused [B,512] (avse_model.py:658-670)."""
        with annotate(SPANS["fusion_core"]):
            x_v = x_v_enc.permute(0, 2, 1, 3)  # time-major [B,t,C,s]
            x_a = x_a_enc.permute(0, 2, 1, 3)
            cat = torch.cat([x_v, x_a], dim=2)  # [B,t,2C,s]
            cat = cat.reshape(cat.shape[0], cat.shape[1], -1)
            av = self.lstm(cat)  # [B,t,512]
            av = av.reshape(av.shape[0], -1)
            av = leaky(dense(self.fc1, av, self.dtype), 0.3, self.dtype)
            return leaky(dense(self.fc2, av, self.dtype), 0.3, self.dtype)

    def audio_ae_forward(self, x_a: torch.Tensor) -> torch.Tensor:
        """STFT autoencoder path (avse_model.py:676-678)."""
        return self.stft_decoder(self.stft_encoder(x_a))

    def visual_ae_forward(self, x_v: torch.Tensor) -> torch.Tensor:
        """Phasegram autoencoder path (avse_model.py:672-674)."""
        return self.phasegram_decoder(self.phasegram_encoder(x_v))

    def encode_both(self, x_a: torch.Tensor, x_v: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        with annotate(SPANS["encoders"]):
            return self.stft_encoder(x_a), self.phasegram_encoder(x_v)

    def heads_from_latents(self, x_a_enc: torch.Tensor, x_v_enc: torch.Tensor,
                           x_a: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Window latents [B,C,t,s] + the window's STFT input ->
        (ŷ_stft, ŷ_pgram, fused); heads are linear + LeakyReLU(0.3), or,
        with `mask_head`, the audio head's output is a complex ratio mask
        applied to the input STFT, in the head's own kernel
        (ops/cuda_mask_head.py), or below float32 `a_fc1` in the compute
        dtype, then the standalone mask product in the features' fp32."""
        fused = self.av_fusion_forward(x_a_enc, x_v_enc)
        with annotate(SPANS["heads"]):
            if self.mask_head and self.dtype == torch.float32:
                x_a_out = mask_head_apply(
                    fused, full_param(self.a_fc1, "weight"), self.a_fc1.bias,
                    x_a)
            elif self.mask_head:
                mask = dense(self.a_fc1, fused, self.dtype).reshape(x_a.shape)
                x_a_out = complex_mask_apply(x_a, mask.to(x_a.dtype))
            else:
                x_a_out = leaky(dense(self.a_fc1, fused, self.dtype), 0.3,
                                self.dtype).reshape(x_a.shape)
            x_v_out = leaky(dense(self.v_fc1, fused, self.dtype), 0.3,
                            self.dtype)
            x_v_out = x_v_out.reshape((-1,) + self.pgram_shape[1:])
        return x_a_out, x_v_out, fused

    def forward(self, x_a: torch.Tensor, x_v: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        x_a_enc, x_v_enc = self.encode_both(x_a, x_v)
        return self.heads_from_latents(x_a_enc, x_v_enc, x_a)
