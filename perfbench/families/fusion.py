"""The fusion family (AV_Fusion_Model): the port's model and train step at
a configuration, the plain reference beside it, and its work by shape."""

from perfbench.core.work import fusion_forward_flops
from perfbench.reference import fusion as reference  # noqa: F401
from perfbench.reference.layers import geometry

forward_flops = fusion_forward_flops


def model(cfg, run, device):
    """The port's AVFusionModel at the RunConfig `cfg`."""
    import torch
    from maavss_tpu_torch.models.fusion import (
        AVFusionModel,
        resolve_pgenc_kernel,
    )
    from maavss_tpu_torch.train.setup import compute_dtype

    b, a, nf, p = (cfg.batch_size, cfg.hops_per_frame, cfg.num_frames,
                   cfg.p_size)
    with torch.device(device):
        return AVFusionModel(
            stft_shape=(b, 2, a * nf, cfg.fft_len // 2),
            pgram_shape=(b, 1, nf, p * p), latent_channels=cfg.latent_chan,
            fc_size=cfg.fc_size, rnn_cell=cfg.rnn_cell,
            mask_head=cfg.mask_head,
            pgenc_kernel=resolve_pgenc_kernel(cfg.pgenc_kernel, device),
            stft_fold=cfg.stft_fold, dtype=compute_dtype(cfg))


def make_step(net, cfg, device):
    from maavss_tpu_torch.train.steps import make_fusion_step

    return make_fusion_step(net, cfg, device=device)


def noise_shape(run, batch):
    """The input noise of a step: the STFT features without the Nyquist
    bin."""
    cols = geometry(run)[2]
    return (batch, 2, cols, run["fft_len"] // 2)


def k1_launches(run, batch):
    """(K1 calls a step, rows, time steps): the BiLSTM over batch * num_seq
    windows of num_frames latent frames, one call."""
    return 1, batch * run["num_seq"], run["num_frames"]
