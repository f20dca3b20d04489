"""maavss_tpu_torch — the PyTorch + CUDA port of `maavss_tpu` for one NVIDIA
H100 (Hopper, sm_90a).

The JAX package stays the reference. This package imports `torch` and never
`jax`, `flax`, `optax` or `maavss_tpu`: the plain-Python modules it shares
with the JAX package (`config.py`, `utils/hop.py`, `models/shape_plan.py`)
are copies, pinned to their originals by tests/test_torch_package.py.

The slice ported so far is the fusion separator's serving path
(`exp/serving.py` over `exp/export.make_serving_fn`), with two hand-written
CUDA kernels on it: the LSTM recurrence (`ops/cuda_lstm.py`,
`csrc/lstm_fwd.cu`) and the fused phasegram-encoder layer in eval mode
(`ops/cuda_pgenc.py`, `csrc/pgenc_eval.cu`). Each kernel is built by `nvcc`
at first use (`ops/_build.py`) and has a plain PyTorch version beside it,
which is what runs for tensors on the CPU.
"""

__version__ = "0.1.0"

from maavss_tpu_torch.config import RunConfig, model_args  # noqa: F401
from maavss_tpu_torch.utils.hop import calc_hop_size  # noqa: F401
