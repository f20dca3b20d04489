"""The frames model (avse_model_final.py of carlmoore256/MAAVSS, the
reference's "final" model) in plain float32 PyTorch, and its full-encode
train step with microbatches and Adam.

Raw attention frames run through five conv3d (3, 5, 5) stages, each with
BatchNorm, a (1, pool, pool) max pool and LeakyReLU(0.01); the untrimmed
STFT runs through a bias-free conv2d encoder; a BiLSTM over the channel
axis, two bias-free tanh layers and the heads emit the middle frame's
hops_per_frame STFT columns (tanh) and that attention frame (sigmoid).

Full encode: the visual trunk runs once over the first num_frames +
num_seq - 1 frames, and the num_seq windows fold into B * num_seq rows for
the heads. Microbatches: the step's gradient is the mean of its chunks'
(BatchNorm's statistics per chunk), then one Adam update.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from perfbench.reference import layers as L
from perfbench.reference.shape_plan import (
    frames_visual_encoder_out_hw,
    plan_stft_decoder_frames,
    plan_stft_encoder_frames,
)

LSTM_HIDDEN = 256
# (out channels, spatial conv padding, pool) a stage; None: the latent width
STAGES = ((16, 2, 2), (32, 2, 2), (64, 2, 2), (64, 2, 3), (None, 3, 3))


class VisualEncoder(nn.Module):
    def __init__(self, latent: int):
        super().__init__()
        self.stages = []
        in_ch = 1
        for i, (out_ch, pad, pool) in enumerate(STAGES):
            out_ch = out_ch or latent
            self.add_module(f"Conv_{i}", nn.Conv3d(
                in_ch, out_ch, (3, 5, 5), padding=(1, pad, pad), bias=False))
            self.add_module(f"TorchBatchNorm_{i}", L.BatchNorm(out_ch))
            self.stages.append((pad, pool))
            in_ch = out_ch

    def forward(self, x: torch.Tensor, p: L.Precision) -> torch.Tensor:
        for i, (pad, pool) in enumerate(self.stages):
            conv = getattr(self, f"Conv_{i}")
            y = F.conv3d(p.q(x), p.q(conv.weight), None, 1, (1, pad, pad))
            y = getattr(self, f"TorchBatchNorm_{i}")(y)
            x = L.leaky(F.max_pool3d(y, (1, pool, pool)), 0.01)
        b, c, t = x.shape[:3]
        return x.reshape(b, c, t, -1)


class FramesModel(nn.Module):
    def __init__(self, cfg: Dict):
        super().__init__()
        nf, a = cfg["num_frames"], cfg["hops_per_frame"]
        self.cfg = cfg
        lat, size = cfg["latent_width"], cfg["framesize"]
        self.stft_shape = (1, 2, a * nf, cfg["fft_len"] // 2 + 1)
        hw = frames_visual_encoder_out_hw(size)
        a_enc, a_hw = plan_stft_encoder_frames(self.stft_shape,
                                               (nf, hw * hw), lat)
        a_dec, _ = plan_stft_decoder_frames(a_hw, self.stft_shape, lat)
        self.visual_encoder = VisualEncoder(lat)
        self.stft_encoder = L.ConvStack(a_enc, use_bias=False)
        self.stft_decoder = L.ConvStack(a_dec, use_bias=False)
        self.lstm = L.BiLSTM(2 * nf * hw * hw, LSTM_HIDDEN)
        flat = lat * 2 * LSTM_HIDDEN
        self.fc1 = nn.Linear(flat, flat, bias=False)
        self.fc2 = nn.Linear(flat, 512, bias=False)
        self.a_fc1 = nn.Linear(512, 2 * a * self.stft_shape[-1], bias=False)
        self.v_fc1 = nn.Linear(512, size * size, bias=False)

    def heads(self, x_a: torch.Tensor, v_lat: torch.Tensor, p: L.Precision):
        """STFT windows [N, 2, T, F] and visual latents [N, C, t, S] ->
        (middle-frame columns [N, 2, a, F], middle frame [N, 1, H, W])."""
        a_lat = self.stft_encoder(x_a, p)
        cat = torch.cat([v_lat, a_lat], dim=2)
        av = self.lstm(cat.reshape(cat.shape[0], cat.shape[1], -1), p)
        av = torch.tanh(L.linear(self.fc1, av.reshape(av.shape[0], -1), p))
        fused = torch.tanh(L.linear(self.fc2, av, p))
        n, size = x_a.shape[0], self.cfg["framesize"]
        ya = torch.tanh(L.linear(self.a_fc1, fused, p)).reshape(
            n, 2, self.cfg["hops_per_frame"], self.stft_shape[-1])
        yv = torch.sigmoid(L.linear(self.v_fc1, fused, p)).reshape(
            n, 1, size, size)
        return ya, yv


def build(cfg: Dict, device) -> FramesModel:
    with torch.device(device):
        return FramesModel(cfg)


def chunk_loss(model: FramesModel, frames: torch.Tensor, x_full, y_full,
               p: L.Precision) -> torch.Tensor:
    """One chunk's full-encode loss: frames [b, T, 1, H, W] in [0, 1],
    the STFT pair [b, 2, T*a, F]."""
    cfg = model.cfg
    ns, a, nf = cfg["num_seq"], cfg["hops_per_frame"], cfg["num_frames"]
    mid = (ns - 1) // 2
    v_lat = model.visual_encoder(frames[:, :nf + ns - 1].transpose(1, 2), p)
    yh_a, yh_v = model.heads(L.windows(x_full, ns, a, nf * a),
                             L.windows(v_lat, ns, 1, nf), p)
    a_loss = L.mse(yh_a, L.windows(y_full[:, :, mid * a:], ns, a, a))
    yv = frames[:, mid:mid + ns]
    v_loss = L.mse(yh_v, yv.reshape((-1,) + yv.shape[2:]))
    return a_loss + cfg["loss_coeff"] * v_loss


def train_steps(model: FramesModel, batches: Sequence[Dict[str, torch.Tensor]],
                noises: Sequence[torch.Tensor], p: L.Precision = L.FP32,
                spans: Sequence[Tuple[int, int]] = ((0, 3),)) -> Dict:
    """Adam steps over `batches` ({'audio': [B, S], 'frames': uint8
    [B, T, H, W]}), step i adding noises[i] to its input features, each
    step over cfg['microbatch'] chunks. Returns each step's loss by step
    number, every leaf's gradient norm at step 1 and every leaf's change
    over each (from, to) step of `spans`."""
    cfg = model.cfg
    hop = L.geometry(cfg)[0]
    mb = cfg["microbatch"]
    model.train()
    params = dict(model.named_parameters())
    changes = L.Changes(params, spans)
    opt = L.Adam(params, cfg["learning_rate"], cfg)
    losses: List[float] = []
    grads = None
    for i, batch in enumerate(batches):
        for t in params.values():
            t.grad = None
        y_full = L.stft_features(batch["audio"], cfg["fft_len"], hop,
                                 trim_end=False)
        x_full = y_full + noises[i] * cfg["noise_scalar"]
        rows = y_full.shape[0] // mb
        total = 0.0
        for c in range(mb):
            part = slice(c * rows, (c + 1) * rows)
            frames = batch["frames"][part].float().mul_(1.0 / 255.0)
            loss = chunk_loss(model, frames.unsqueeze(2), x_full[part],
                              y_full[part], p)
            (loss / mb).backward()
            total += float(loss.detach()) / mb
        losses.append(total)
        if i == 0:
            grads = L.leaf_norms({k: t.grad for k, t in params.items()})
        opt.step()
        changes.after(i + 1)
    return {"losses": {i + 1: x for i, x in enumerate(losses)},
            "grad_norms": grads, "changes": changes.out}
