"""The benchmark of maavss_tpu_torch on NVIDIA GPUs: cells, traffic and
its runners, configurations and their families, the plain reference and
the metrics' readers."""
