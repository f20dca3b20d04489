"""exp/profiling.compile_report and tools/cost_report_torch.py: the static
roofline of a step from one pass over fake CPU tensors, on the CPU.

The flops of the tiny fusion train step (tests/test_profiling_report.py's
geometry, vectorized windows, fp32) equal a count made here from the
layers' shapes, read by forward hooks during that same pass: each conv,
transposed conv and dense layer 2 x its multiply-adds forward, once more
for its weight's gradient and once more for its input's where the input
needs one; the BiLSTM's input projections likewise, and its recurrence
one product a step forward and two a step backward, but one at the first
step, whose h_0 is a constant zero (its weight gradient alone). The JAX
package's compile_report of the same step (XLA's cost analysis) is
printed in the assertion message.
"""

import math

import pytest
import torch

from maavss_tpu_torch.exp.profiling import compile_report, format_report
from tests.test_torch_workers import share_cores
from tools import cost_report_torch

share_cores()

SMALL = dict(num_frames=4, num_seq=4, hops_per_frame=4, fft_len=64,
             p_size=16, latent_chan=8, fc_size=256)
VECTORIZED = {"MAAVSS_BENCH_FUSION_ENCODE": "window",
              "MAAVSS_BENCH_WINDOW_MODE": "vectorized",
              "MAAVSS_BENCH_PGRAM": "0"}


def _jax_flops():
    """XLA's flops for the same step (tests/test_profiling_report.py's)."""
    import jax
    import jax.numpy as jnp

    from maavss_tpu.config import RunConfig
    from maavss_tpu.data.synthetic import synthetic_av_batch
    from maavss_tpu.exp.profiling import compile_report as jax_report
    from maavss_tpu.models.fusion import AVFusionModel
    from maavss_tpu.train.setup import jit_init
    from maavss_tpu.train.state import create_train_state, make_optimizer
    from maavss_tpu.train.steps import make_fusion_step

    cfg = RunConfig(**SMALL, batch_size=2)
    model = AVFusionModel(
        stft_shape=(2, 2, cfg.hops_per_frame * cfg.num_frames,
                    cfg.fft_len // 2),
        pgram_shape=(2, 1, cfg.num_frames, cfg.p_size ** 2),
        latent_channels=cfg.latent_chan, fc_size=cfg.fc_size)
    variables = jit_init(model, model.stft_shape, model.pgram_shape,
                         method=model.init_all)
    state = create_train_state(variables, make_optimizer(1e-3, "adam"))
    step = make_fusion_step(model, cfg, window_mode="vectorized")
    return jax_report(step, state, synthetic_av_batch(cfg, 2, seed=0),
                      jax.random.PRNGKey(0), jnp.int32(2))["flops"]


class _LayerFlops:
    """Forward hooks on every module: the count of the module docstring."""

    def __init__(self):
        self.flops = 0
        self.handle = torch.nn.modules.module.register_module_forward_hook(
            self.hook)

    def hook(self, module, inputs, output):
        from maavss_tpu_torch.models.layers import BiLSTM

        x = inputs[0] if inputs else None
        if isinstance(module, torch.nn.Linear):
            fwd = 2 * output.numel() * module.in_features
        elif isinstance(module, (torch.nn.Conv1d, torch.nn.Conv2d,
                                 torch.nn.Conv3d)):
            fwd = 2 * output.numel() * module.in_channels // module.groups \
                * math.prod(module.kernel_size)
        elif isinstance(module, (torch.nn.ConvTranspose2d,
                                 torch.nn.ConvTranspose3d)):
            fwd = 2 * x.numel() * module.out_channels // module.groups \
                * math.prod(module.kernel_size)
        elif isinstance(module, BiLSTM):
            b, t_len, d = x.shape
            h = module.fwd.hidden
            proj = 2 * b * t_len * d * 4 * h
            step = 2 * b * h * 4 * h
            self.flops += 2 * (proj * (2 + x.requires_grad)
                               + step * t_len + step * (2 * t_len - 1))
            return
        else:
            return
        self.flops += fwd * (2 + x.requires_grad)


def test_step_flops_equal_the_layers_count(monkeypatch):
    """tools/cost_report_torch.report on the tiny fusion step: flops equal
    the layers' count; with CUDA unavailable (and any lazy CUDA init an
    error) it still runs, and every field is there."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def no_cuda(*_):
        raise AssertionError("compile_report touched CUDA")

    monkeypatch.setattr(torch.cuda, "_lazy_init", no_cuda)
    layers = _LayerFlops()
    try:
        r = cost_report_torch.report("fusion", 2, "float32", measured_ms=2.0,
                                     env=VECTORIZED, geometry=SMALL)
    finally:
        layers.handle.remove()
    assert (r["regime"], r["batch"], r["dtype"], r["window_mode"]) == \
        ("fusion", 2, "float32", "vectorized")
    assert r["flops"] == layers.flops, (
        f"port {r['flops']:.0f} != layers {layers.flops}; JAX's "
        f"compile_report (XLA cost analysis) {_jax_flops():.0f}")
    assert r["peak_tflops"] == 67.0 and r["hbm_gbps"] == 3350.0
    assert r["bytes_accessed"] > r["argument_bytes"] > 0
    assert r["compute_pct"] == pytest.approx(50.0 * r["sol_compute_ms"])
    assert r["hbm_pct"] == pytest.approx(50.0 * r["sol_memory_ms"])
    assert "measured" in format_report(r) and "GFLOP" in format_report(r)


def test_matmul_flops_and_roofline():
    """tests/test_profiling_report.py's matmul: 2 n^3 flops, at least both
    operands and the product moved; the bf16 peak is the tensor cores'."""
    n = 128
    a = torch.zeros((n, n))
    r = compile_report(lambda x: x @ x, a, peak_tflops=100.0, hbm_gbps=100.0,
                       measured_ms=1.0)
    assert r["flops"] == 2 * n ** 3
    assert r["bytes_accessed"] >= 3 * n * n * 4
    assert r["argument_bytes"] == n * n * 4 and r["output_bytes"] == n * n * 4
    assert r["bound"] in ("compute", "memory")
    assert abs(r["compute_pct"] - 100.0 * r["sol_compute_ms"]) < 1e-9
    bf16 = compile_report(lambda x: x @ x, a.bfloat16(),
                          compute_dtype="bfloat16")
    assert bf16["peak_tflops"] == 989.0


def test_report_leaves_the_arguments_as_they_were():
    """compile_report runs the step on a fake copy of its arguments:
    parameters, buffers, gradients and the optimizer's state keep their
    values."""
    model = torch.nn.Sequential(torch.nn.Linear(8, 4),
                                torch.nn.BatchNorm1d(4)).train()
    model[0].weight.grad = torch.ones_like(model[0].weight)
    opt = torch.optim.Adam(model.parameters(), lr=0.1)
    before = {k: v.clone() for k, v in model.state_dict().items()}

    def step(m, o, x):
        m(x).square().sum().backward()
        o.step()

    r = compile_report(step, model, opt, torch.randn(16, 8))
    assert r["flops"] == 2 * (2 * 16 * 8 * 4)  # forward, dW (x needs none)
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert torch.equal(model[0].weight.grad, torch.ones_like(
        model[0].weight))
    assert model[0].bias.grad is None and not opt.state
