from maavss_tpu_torch.utils.hop import calc_hop_size  # noqa: F401
