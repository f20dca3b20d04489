"""The frames family (AV_Fusion_Model_Frames, the reference's final
model): the port's model and train step at a configuration, the plain
reference beside it, and its work by shape."""

from perfbench.core.work import frames_forward_flops
from perfbench.reference import frames as reference  # noqa: F401
from perfbench.reference.layers import geometry

forward_flops = frames_forward_flops


def model(cfg, run, device):
    """The port's AVFusionFramesModel at the RunConfig `cfg`; the latent
    width is the configuration's `latent_width`."""
    import torch
    from maavss_tpu_torch.models.fusion_frames import AVFusionFramesModel
    from maavss_tpu_torch.train.setup import compute_dtype

    b, a, nf, size = (cfg.batch_size, cfg.hops_per_frame, cfg.num_frames,
                      cfg.framesize)
    with torch.device(device):
        return AVFusionFramesModel(
            stft_shape=(b, 2, a * nf, cfg.fft_len // 2 + 1),
            frame_shape=(b, 1, nf, size, size), hops_per_frame=a,
            latent_channels=run["latent_width"], rnn_cell=cfg.rnn_cell,
            mask_head=cfg.mask_head, mask_mid_frame=(cfg.num_seq - 1) // 2,
            dtype=compute_dtype(cfg))


def make_step(net, cfg, device):
    from maavss_tpu_torch.train.steps import make_frames_step

    return make_frames_step(net, cfg, device=device)


def noise_shape(run, batch):
    """The input noise of a step: the STFT features with the Nyquist
    bin."""
    cols = geometry(run)[2]
    return (batch, 2, cols, run["fft_len"] // 2 + 1)


def k1_launches(run, batch):
    """(K1 calls a step, rows, time steps): the BiLSTM runs over the
    latent channels, a call per microbatch."""
    mb = run["microbatch"]
    return mb, batch // mb * run["num_seq"], run["latent_width"]
