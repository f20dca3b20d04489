"""--microbatch in the port's fusion step (maavss_tpu_torch/train/steps.py:
_microbatch_accumulate) against the JAX make_fusion_step with microbatch=2,
on the CPU, in the three step variants: the window scan (raw frames), the
vectorized windows and --fusion_encode full (both with --pgram_cache float16
rows).

Weights, batch and geometry are tests/test_torch_fullenc.py's (seeded
`random_flax_tree` weights carried across by `from_flax`; synthetic batch
seed 11 with broadband frame noise and the JAX package's float16 rows;
num_frames 4, hops_per_frame 4, fft 64, p_size 16, latent 8, fc 256, batch
4, lr 1e-3, noise_scalar 0, mode 2), at num_seq 2. Each case takes one
step on each side, its JAX step compiled once: two chunks of two examples,
BatchNorm statistics carried chunk to chunk, the gradients summed and then
divided by 2.

Tolerances, tests/test_torch_fullenc.py's: losses relative 1e-5; the
gradient and parameter norms, every parameter, BatchNorm statistic and
Adam first moment (0.1 x the gradient) relative L2 1e-4; the conv biases
that feed a train-mode BatchNorm (true gradient 0, autodiff noise that
Adam turns into +-lr) within lr of their start on each side, their
gradients not compared. A batch that the microbatch does not divide raises
JAX's ValueError, word for word.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from maavss_tpu.config import RunConfig as JaxRunConfig
from maavss_tpu.train.steps import make_fusion_step as jax_make_step
from maavss_tpu_torch.config import RunConfig
from maavss_tpu_torch.convert import flatten_tree, from_flax, to_flax
from maavss_tpu_torch.train.setup import build_fusion_state
from maavss_tpu_torch.train.steps import make_fusion_step
from tests.test_torch_fullenc import (
    BASE,
    LOSS_RTOL,
    LR,
    MODE,
    PARAM_RTOL,
    _batch,
    _jax_model,
    _jax_state,
    _rel_l2,
    weights,  # noqa: F401  (the seeded weight fixture)
)
from tests.test_torch_workers import share_cores

share_cores()

NS = 2
# (fusion_encode, window_mode, visual input)
CASES = {"scan": ("window", "scan", "frames"),
         "vectorized": ("window", "vectorized", "pgram"),
         "full": ("full", "vectorized", "pgram")}


def _cfg(case, cls=RunConfig, microbatch=2):
    encode, window_mode, visual = CASES[case]
    return cls(**{**BASE, "num_seq": NS, "fusion_encode": encode,
                  "window_mode": window_mode, "microbatch": microbatch,
                  "pgram_cache": visual == "pgram"})


def _visual_batch(case):
    b = _batch(NS)
    visual = CASES[case][2]
    return {"audio": b["audio"], visual: b[visual]}


def _flat_copy(tree):
    # copies: on the CPU to_flax's arrays share the live tensors' memory
    return {k: np.array(v) for k, v in flatten_tree(tree).items()}


def _np_flat(tree):
    return flatten_tree(jax.tree_util.tree_map(np.asarray, tree))


@pytest.mark.parametrize("case", list(CASES))
def test_microbatch_step_tracks_jax(weights, case):  # noqa: F811
    cfg_j = _cfg(case, JaxRunConfig)
    batch = _visual_batch(case)
    step_j = jax_make_step(_jax_model(cfg_j), cfg_j,
                           window_mode=cfg_j.window_mode)
    state_j, want = step_j(_jax_state(weights),
                           {k: jnp.asarray(v) for k, v in batch.items()},
                           jax.random.PRNGKey(0), jnp.int32(MODE))
    params_j, stats_j = _np_flat(state_j.params), _np_flat(
        state_j.batch_stats)
    mu_j = _np_flat(state_j.opt_state[0].mu)

    cfg = _cfg(case)
    model, state = build_fusion_state(cfg, cfg.batch_size, "cpu")
    model.load_state_dict(from_flax(weights["params"],
                                    weights["batch_stats"]))
    state, got = make_fusion_step(model, cfg, device="cpu")(state, batch,
                                                            MODE)
    assert state.step == 1 and set(got) == set(want)
    for k in ("loss", "a_loss", "v_loss"):
        np.testing.assert_allclose(float(got[k]), float(want[k]),
                                   rtol=LOSS_RTOL, atol=0, err_msg=k)
    for k in want:  # the gradient and parameter norms
        np.testing.assert_allclose(float(got[k]), float(want[k]),
                                   rtol=PARAM_RTOL, atol=1e-9, err_msg=k)
    params, stats = (_flat_copy(t) for t in to_flax(model.state_dict()))
    names = [n for n, _ in model.named_parameters()]
    mu = _flat_copy(to_flax(dict(zip(names, state.tx.m)))[0])
    fed = {k.replace(".", "/") for k in model.bn_fed_biases()}
    init = flatten_tree(weights["params"])
    assert set(params) == set(params_j) and set(stats) == set(stats_j)
    for path, w in params_j.items():
        if path in fed:
            for side in (params[path], w):
                np.testing.assert_allclose(side, init[path], atol=LR * 1.0001,
                                           rtol=0, err_msg=path)
            continue
        assert _rel_l2(params[path], w) <= PARAM_RTOL, path
        assert _rel_l2(mu[path], mu_j[path]) <= PARAM_RTOL, path
    for path, w in stats_j.items():
        assert _rel_l2(stats[path], w) <= PARAM_RTOL, path


def test_microbatch_that_does_not_divide_raises_jax_message(weights):  # noqa: F811,E501
    cfg_j = _cfg("vectorized", JaxRunConfig, microbatch=3)
    batch = _visual_batch("vectorized")
    with pytest.raises(ValueError) as want:
        jax_make_step(_jax_model(cfg_j), cfg_j, window_mode="vectorized")(
            _jax_state(weights),
            {k: jnp.asarray(v) for k, v in batch.items()},
            jax.random.PRNGKey(0), jnp.int32(MODE))
    cfg = _cfg("vectorized", microbatch=3)
    model, state = build_fusion_state(cfg, cfg.batch_size, "cpu")
    with pytest.raises(ValueError) as got:
        make_fusion_step(model, cfg, device="cpu")(state, batch, MODE)
    assert str(got.value) == str(want.value)
    assert str(got.value) == "batch size 4 not divisible by microbatch 3"
