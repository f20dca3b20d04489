"""The fusion model (avse_model.py:410-711 of carlmoore256/MAAVSS) in plain
float32 PyTorch: its full-encode train step and Adam.

Full encode (the configuration's `fusion_encode: full`): both encoders run
once over the first num_frames + num_seq - 1 frames of a clip, the num_seq
latent windows at the encoders' hops and the STFT input windows fold into
B * num_seq rows, and the heads run once over them.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch
from torch import nn

from perfbench.reference import layers as L
from perfbench.reference.shape_plan import (
    plan_phasegram_decoder,
    plan_phasegram_encoder,
    plan_stft_decoder_fusion,
    plan_stft_encoder_fusion,
)

LSTM_HIDDEN = 256


class FusionModel(nn.Module):
    """(stft [N, 2, T, F], phasegram [N, 1, Tf, p^2]) latents -> heads."""

    def __init__(self, cfg: Dict):
        super().__init__()
        nf, a, p = cfg["num_frames"], cfg["hops_per_frame"], cfg["p_size"]
        self.cfg = cfg
        self.stft_shape = (1, 2, a * nf, cfg["fft_len"] // 2)
        self.pgram_shape = (1, 1, nf, p * p)
        lat, fc = cfg["latent_chan"], cfg["fc_size"]
        pg_enc, pg_hw = plan_phasegram_encoder(self.pgram_shape, lat, fc)
        pg_dec, _ = plan_phasegram_decoder(pg_hw, self.pgram_shape, lat)
        a_enc, a_hw = plan_stft_encoder_fusion(self.stft_shape, pg_hw, lat)
        a_dec, _ = plan_stft_decoder_fusion(a_hw, self.stft_shape, lat)
        self.a_enc_specs, self.pg_enc_specs = a_enc, pg_enc
        self.t_win = pg_hw[0]
        self.phasegram_encoder = L.ConvStack(pg_enc)
        self.phasegram_decoder = L.ConvStack(pg_dec)
        self.stft_encoder = L.ConvStack(a_enc)
        self.stft_decoder = L.ConvStack(a_dec)
        lstm_in = (pg_enc[-1].out_ch + a_enc[-1].out_ch) * pg_hw[1]
        self.lstm = L.BiLSTM(lstm_in, LSTM_HIDDEN)
        t_stft, f_stft = self.stft_shape[-2:]
        self.fc1 = nn.Linear(pg_hw[0] * 2 * LSTM_HIDDEN, fc // 2)
        self.fc2 = nn.Linear(fc // 2, 512)
        self.a_fc1 = nn.Linear(512, 2 * t_stft * f_stft)
        self.v_fc1 = nn.Linear(512, nf * p * p)

    def hop_a(self) -> int:
        """The STFT latent's hop between windows: hops_per_frame over the
        encoder's time-stride product."""
        s = 1
        for spec in self.a_enc_specs:
            s *= spec.stride[0]
        return self.cfg["hops_per_frame"] // s

    def heads(self, a_lat: torch.Tensor, v_lat: torch.Tensor,
              p: L.Precision):
        """Window latents [N, C, t, s] -> (stft [N, 2, T, F], phasegram
        [N, 1, t, p^2])."""
        x_v = v_lat.permute(0, 2, 1, 3)
        x_a = a_lat.permute(0, 2, 1, 3)
        cat = torch.cat([x_v, x_a], dim=2)
        cat = cat.reshape(cat.shape[0], cat.shape[1], -1)
        av = self.lstm(cat, p).reshape(cat.shape[0], -1)
        av = L.leaky(L.linear(self.fc1, av, p), 0.3)
        fused = L.leaky(L.linear(self.fc2, av, p), 0.3)
        ya = L.leaky(L.linear(self.a_fc1, fused, p), 0.3)
        yv = L.leaky(L.linear(self.v_fc1, fused, p), 0.3)
        return (ya.reshape((-1,) + self.stft_shape[1:]),
                yv.reshape((-1,) + self.pgram_shape[1:]))

    def full_encode(self, x_full: torch.Tensor, pg_full: torch.Tensor,
                    p: L.Precision):
        """The clip's span through both encoders, then the heads over its
        num_seq windows: (stft [B*ns, ...], phasegram [B*ns, ...])."""
        ns, a, nf = (self.cfg["num_seq"], self.cfg["hops_per_frame"],
                     self.cfg["num_frames"])
        a_lat = self.stft_encoder(x_full[:, :, :(nf + ns - 1) * a], p)
        v_lat = self.phasegram_encoder(pg_full, p)
        return self.heads(L.windows(a_lat, ns, self.hop_a(), self.t_win),
                          L.windows(v_lat, ns, 1, self.t_win), p)


def build(cfg: Dict, device) -> FusionModel:
    with torch.device(device):
        return FusionModel(cfg)


def stft_pair(model: FusionModel, audio: torch.Tensor,
              noise: torch.Tensor = None):
    """(x, y): the clip's STFT features y, and x = y + noise * noise_scalar
    where a noise draw is given."""
    cfg = model.cfg
    hop = L.geometry(cfg)[0]
    y = L.stft_features(audio, cfg["fft_len"], hop, trim_end=True)
    return (y if noise is None else y + noise * cfg["noise_scalar"]), y


def train_steps(model: FusionModel, batches: Sequence[Dict[str, torch.Tensor]],
                noises: Sequence[torch.Tensor], p: L.Precision = L.FP32,
                spans: Sequence[Tuple[int, int]] = ((0, 3),)) -> Dict:
    """Adam steps over `batches` ({'audio': [B, S], 'pgram': [B, T, p^2]}),
    step i adding noises[i] to its input features. Returns each step's
    loss by step number, every leaf's gradient norm at step 1 and every
    leaf's change over each (from, to) step of `spans`."""
    cfg = model.cfg
    ns, a, nf = cfg["num_seq"], cfg["hops_per_frame"], cfg["num_frames"]
    model.train()
    params = dict(model.named_parameters())
    changes = L.Changes(params, spans)
    opt = L.Adam(params, cfg["learning_rate"], cfg)
    losses: List[float] = []
    grads = None
    for i, batch in enumerate(batches):
        for t in params.values():
            t.grad = None
        x_full, y_full = stft_pair(model, batch["audio"], noises[i])
        pg_full = L.phasegram(batch["pgram"].float()[:, :nf + ns - 1])
        yh_a, yh_v = model.full_encode(x_full, pg_full, p)
        a_loss = L.mse(yh_a, L.windows(y_full, ns, a, nf * a))
        v_loss = L.mse(yh_v, L.windows(pg_full, ns, 1, nf))
        loss = a_loss + cfg["loss_coeff"] * v_loss
        loss.backward()
        losses.append(float(loss.detach()))
        if i == 0:
            grads = L.leaf_norms({k: t.grad for k, t in params.items()})
        opt.step()
        changes.after(i + 1)
    return {"losses": {i + 1: x for i, x in enumerate(losses)},
            "grad_norms": grads, "changes": changes.out}
