"""AVFusionFramesModel — the frames model family (counterpart of
maavss_tpu/models/fusion_frames.py).

Raw attention frames go through a fixed 5-stage conv3d / BatchNorm /
max-pool / LeakyReLU(0.01) encoder; the untrimmed STFT (F = fft_len/2 + 1)
through a bias-free conv2d autoencoder. The two latents are concatenated
along their time axis, a BiLSTM(256) runs over the CHANNEL axis (the
reference's dataflow, avse_model_final.py:124-128), two bias-free FC layers
with tanh fuse them, and linear heads emit the middle frame only:
hops_per_frame STFT columns (tanh) and one attention frame (sigmoid). With
`mask_head` (--mask_head) the audio head is a complex ratio mask applied to
the mixture's columns of that frame, frame `mask_mid_frame` of the window
((num_seq - 1) // 2 as the train step and separator pick it), no tanh.

The visual encoder runs the direct conv3d path. In `.train()` mode, the
stages that `layers.epilogue_eligible` admits (at framesize 256 the 256^2
and 128^2 inputs) run their BN + pool + leaky tail as the fused epilogue
kernels of `ops/cuda_epilogue.py`; every other stage, and eval mode, runs
the unfused tail. The JAX package's space-to-depth fold, which fed the
TPU's matrix unit, is not carried: the pooling windows are read from the
NCDHW conv output directly.

Parameter names follow the flax tree (`visual_encoder.Conv_i`,
`visual_encoder.TorchBatchNorm_i.BatchNorm_0`, `stft_encoder`,
`stft_decoder`, `lstm.fwd|bwd`, `fc1`, `fc2`, `a_fc1`, `v_fc1`), so
`convert.from_flax` carries a JAX checkpoint across.

`dtype` (--dtype) is the compute dtype, as in the fusion model: under
bfloat16 or float16 the conv3d stages run in that dtype and K5 takes their
output, and the `--mask_head` mask is cast to fp32 for K4's standalone
mask product (maavss_tpu/models/fusion_frames.py:284).

Under --mesh_model the split heads (fc1, the 8192 x 8192 layer at full
width, fc2, a_fc1, v_fc1) are column-parallel (models/layers.py:dense) and
the fused mask head takes a_fc1's joined weight (`full_param`).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn

from maavss_tpu_torch.exp.profiling import SPANS, annotate
from maavss_tpu_torch.models.layers import (
    ConvStack,
    TorchBatchNorm,
    dense,
    epilogue_eligible,
    epilogue_min_hw,
    excess_precision,
    frames_conv3d_stage,
    full_param,
    make_birnn,
)
from maavss_tpu_torch.models.shape_plan import (
    frames_visual_encoder_out_hw,
    plan_stft_decoder_frames,
    plan_stft_encoder_frames,
)
from maavss_tpu_torch.ops.cuda_complex import complex_mask_apply
from maavss_tpu_torch.ops.cuda_mask_head import mask_head_apply

LSTM_HIDDEN = 256
# (out channels, spatial conv padding (lo, hi), pool) per stage; None is the
# latent width (maavss_tpu/models/fusion_frames.py:97-103)
STAGES = ((16, (2, 2), 2), (32, (2, 2), 2), (64, (2, 2), 2), (64, (2, 2), 3),
          (None, (3, 3), 3))


class FramesVisualEncoder(nn.Module):
    """[B, 1, T, H, W] -> latent [B, C, T, hw*hw]."""

    def __init__(self, latent_channels: int = 16,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.stages = []
        in_ch = 1
        for i, (out_ch, pad, pool) in enumerate(STAGES):
            out_ch = out_ch or latent_channels
            self.add_module(f"Conv_{i}", nn.Conv3d(
                in_ch, out_ch, (3, 5, 5), padding=(1, pad[0], pad[0]),
                bias=False))
            self.add_module(f"TorchBatchNorm_{i}",
                            TorchBatchNorm(out_ch, dtype))
            self.stages.append((pad, pool))
            in_ch = out_ch

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        min_hw = epilogue_min_hw()
        for i, (pad, pool) in enumerate(self.stages):
            fused = self.training and epilogue_eligible(x.shape, pad, pool,
                                                        min_hw)
            x = frames_conv3d_stage(x, getattr(self, f"Conv_{i}"),
                                    getattr(self, f"TorchBatchNorm_{i}"),
                                    pool, fused, self.dtype)
        b, c, t = x.shape[:3]
        return x.reshape(b, c, t, -1)


def _sigmoid(x: torch.Tensor) -> torch.Tensor:
    """sigmoid as XLA expands it, 1 / (1 + exp(-x)): below float32 the exp
    and the sum round to x's dtype, and the quotient stays fp32 in
    bfloat16 (its consumers upcast, `excess_precision`) and rounds to
    float16 in float16."""
    if x.dtype == torch.float32:
        return torch.sigmoid(x)
    if excess_precision(x.dtype):
        return 1.0 / (1.0 + torch.exp(-x)).float()
    return 1.0 / (1.0 + torch.exp(-x))


class AVFusionFramesModel(nn.Module):
    """(stft [B,2,T,F], frames [B,1,Tf,H,W]) ->
    (ŷ_stft [B,2,hops_per_frame,F], ŷ_frame [B,1,H,W], fused [B,512]).

    The FC widths follow the latent width (the JAX model's fc_size is
    unused). `device` is where the parameters end up."""

    def __init__(self, stft_shape: Sequence[int], frame_shape: Sequence[int],
                 hops_per_frame: int = 8, latent_channels: int = 16,
                 rnn_cell: str = "lstm", mask_head: bool = False,
                 mask_mid_frame: int = 0, device=None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.mask_head = mask_head
        self.mask_mid_frame = mask_mid_frame
        self.stft_shape = tuple(stft_shape)
        self.frame_shape = tuple(frame_shape)
        self.hops_per_frame = hops_per_frame
        hw = frames_visual_encoder_out_hw(self.frame_shape[-1])
        t_frames = self.frame_shape[2]
        target = (t_frames, hw * hw)
        a_enc, a_hw = plan_stft_encoder_frames(stft_shape, target,
                                               latent_channels)
        a_dec, _ = plan_stft_decoder_frames(a_hw, stft_shape, latent_channels)
        self.latent_hw = a_hw
        self.visual_encoder = FramesVisualEncoder(latent_channels, dtype)
        self.stft_encoder = ConvStack(a_enc, use_bias=False, dtype=dtype)
        self.stft_decoder = ConvStack(a_dec, use_bias=False, dtype=dtype)
        self.lstm = make_birnn(rnn_cell, 2 * t_frames * hw * hw, LSTM_HIDDEN,
                               dtype)
        flat = latent_channels * 2 * LSTM_HIDDEN
        self.fc1 = nn.Linear(flat, flat, bias=False)
        self.fc2 = nn.Linear(flat, 512, bias=False)
        self.a_fc1 = nn.Linear(512, 2 * hops_per_frame * self.stft_shape[-1],
                               bias=False)
        self.v_fc1 = nn.Linear(
            512, self.frame_shape[1] * self.frame_shape[-2]
            * self.frame_shape[-1], bias=False)
        if device is not None:
            self.to(device)

    def av_fusion_forward(self, x_a_enc: torch.Tensor,
                          x_v_enc: torch.Tensor) -> torch.Tensor:
        """Latents [B,C,T,S] -> fused [B,512]: the LSTM runs over the
        channel axis C (avse_model_final.py:235-251)."""
        with annotate(SPANS["fusion_core"]):
            cat = torch.cat([x_v_enc, x_a_enc], dim=2)  # [B,C,2T,S]
            av = self.lstm(cat.reshape(cat.shape[0], cat.shape[1], -1))
            av = torch.tanh(dense(self.fc1, av.reshape(av.shape[0], -1),
                                  self.dtype))
            return torch.tanh(dense(self.fc2, av, self.dtype))

    def audio_ae_forward(self, x_a: torch.Tensor) -> torch.Tensor:
        return self.stft_decoder(self.stft_encoder(x_a))

    def encode_frames(self, x_v: torch.Tensor) -> torch.Tensor:
        """Visual trunk only: [B,1,T,H,W] -> latent [B,C,T,S]."""
        with annotate(SPANS["encoders"]):
            return self.visual_encoder(x_v)

    def forward_with_visual_latent(self, x_a: torch.Tensor,
                                   x_v_enc: torch.Tensor
                                   ) -> Tuple[torch.Tensor, torch.Tensor,
                                              torch.Tensor]:
        """The STFT encoder, fusion core and heads given a visual latent
        [B,C,T,S]."""
        with annotate(SPANS["encoders"]):
            x_a_enc = self.stft_encoder(x_a)
        fused = self.av_fusion_forward(x_a_enc, x_v_enc)
        b = x_a.shape[0]
        a_shape = (b, 2, self.hops_per_frame, self.stft_shape[-1])
        with annotate(SPANS["heads"]):
            if self.mask_head:
                # the mask multiplies the mixture's middle-frame columns,
                # read in place by the head's kernel (or, below float32, by
                # the standalone mask product in the features' fp32)
                lo = self.mask_mid_frame * self.hops_per_frame
                x_mid = x_a[:, :, lo:lo + self.hops_per_frame]
                if self.dtype == torch.float32:
                    x_a_out = mask_head_apply(
                        fused, full_param(self.a_fc1, "weight"), None, x_mid)
                else:
                    mask = dense(self.a_fc1, fused,
                                 self.dtype).reshape(a_shape)
                    x_a_out = complex_mask_apply(x_mid, mask.to(x_a.dtype))
            else:
                # in bf16 the heads' activations end in fp32: their
                # consumers (the loss, the separator's stitch) upcast, and
                # XLA drops the round trip through bf16 (excess precision);
                # fp16 rounds
                h = dense(self.a_fc1, fused, self.dtype)
                x_a_out = torch.tanh(h.float() if excess_precision(self.dtype)
                                     else h).reshape(a_shape)
            x_v_out = _sigmoid(dense(self.v_fc1, fused, self.dtype)).reshape(
                b, self.frame_shape[1], self.frame_shape[-2],
                self.frame_shape[-1])
        return x_a_out, x_v_out, fused

    def forward(self, x_a: torch.Tensor, x_v: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        return self.forward_with_visual_latent(x_a, self.encode_frames(x_v))
