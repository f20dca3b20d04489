"""The port's LSTM recurrence (ops/cuda_lstm.py) and BiLSTM against the JAX
package: the Pallas kernel `_forward` in interpret mode and flax's lax.scan
LSTM (maavss_tpu/models/layers.py:722-737), both directions, fp32, on the
same numpy inputs. Tolerance 1e-5 absolute (h and c are O(1); only the
summation order of h @ w_h differs)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from maavss_tpu.models.layers import BiLSTM as JaxBiLSTM
from maavss_tpu.ops.pallas_lstm import _forward as pallas_forward
from maavss_tpu_torch.models.layers import BiLSTM, lstm_backend
from maavss_tpu_torch.ops.cuda_lstm import lstm_recurrence, lstm_recurrence_plain

ATOL = 1e-5
B, T, D, H = 2, 5, 24, 256  # H is the fusion model's fixed 256


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    xw = rng.standard_normal((B, T, 4 * H)).astype(np.float32)
    w_h = (rng.standard_normal((H, 4 * H)) / np.sqrt(H)).astype(np.float32)
    return xw, w_h


@pytest.mark.parametrize("reverse", [False, True])
def test_plain_recurrence_matches_pallas_interpret(reverse):
    xw, w_h = _inputs()
    ys, cs = lstm_recurrence_plain(torch.from_numpy(xw), torch.from_numpy(w_h),
                                   reverse=reverse)
    # the JAX kernel is time-major and forward only; the reverse direction
    # is the flip around it (layers.py:704-705,718-719)
    xw_tm = np.swapaxes(xw, 0, 1)
    if reverse:
        xw_tm = xw_tm[::-1]
    ys_j, cs_j = pallas_forward(jnp.asarray(np.ascontiguousarray(xw_tm)),
                                jnp.asarray(w_h))
    ys_j, cs_j = np.asarray(ys_j), np.asarray(cs_j)
    if reverse:
        ys_j, cs_j = ys_j[::-1], cs_j[::-1]
    np.testing.assert_allclose(ys.numpy(), np.swapaxes(ys_j, 0, 1), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(cs.numpy(), np.swapaxes(cs_j, 0, 1), atol=ATOL,
                               rtol=0)


def test_bilstm_matches_flax_scan():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    module = JaxBiLSTM(H)
    variables = module.init(jax.random.PRNGKey(0), jnp.asarray(x))
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MAAVSS_LSTM", "scan")
        want = np.asarray(module.apply(variables, jnp.asarray(x)))
    port = BiLSTM(D, H)
    with torch.no_grad():
        for name in ("fwd", "bwd"):
            getattr(port, name).w_i.copy_(torch.tensor(params[name]["w_i"]))
            getattr(port, name).w_h.copy_(torch.tensor(params[name]["w_h"]))
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == (B, T, 2 * H)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_backend_gate():
    x = torch.zeros(1)
    assert lstm_backend(x) in ("scan", "kernel")
    assert lstm_backend(x, "auto") == "scan"  # a CPU tensor
    assert lstm_backend(x, "kernel") == "kernel"
    with pytest.raises(ValueError):
        lstm_backend(x, "pallas")


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode); "
                    "chip_smoke.py runs this comparison on the card")
    xw, w_h = _inputs(2)
    xws = [torch.from_numpy(xw).cuda()] * 2
    whs = [torch.from_numpy(w_h).cuda()] * 2
    got = lstm_recurrence(xws, whs, [False, True], backend="kernel")
    for (ys, cs), rev in zip(got, (False, True)):
        ys_p, cs_p = lstm_recurrence_plain(xws[0], whs[0], rev)
        torch.testing.assert_close(ys, ys_p, atol=ATOL, rtol=0)
        torch.testing.assert_close(cs, cs_p, atol=ATOL, rtol=0)
