"""tools/bench_torch.py, the port's counterpart of bench.py, on the CPU:
its measure function at a tiny geometry (2 windows of 2 steps, the plain
versions), the JSON line's keys against bench.py's, the variables the port
lacks raising by their ROADMAP labels, MULTISTEP accepted, and the refusal
to time anything without a card."""

import ast
import json
import os
import subprocess
import sys

import pytest

from tools import bench_torch
from tests.test_torch_workers import share_cores

share_cores()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(num_frames=4, num_seq=4, hops_per_frame=4, fft_len=64, p_size=16,
            latent_chan=8, fc_size=256)
NEW_KEYS = {"torch", "cuda", "name", "power_limit", "kernels",
            "peak_memory_bytes", "step_ms", "device", "differs_from_bench_py"}


def bench_py_keys():
    """The keys of the JSON object bench.py's main() prints."""
    tree = ast.parse(open(os.path.join(ROOT, "bench.py")).read())
    main = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    for node in ast.walk(main):
        if (isinstance(node, ast.Call)
                and getattr(node.func, "attr", None) == "dumps"):
            return {k.value for k in node.args[0].keys}
    raise AssertionError("bench.py prints no json.dumps object")


@pytest.fixture(scope="module")
def line():
    result = bench_torch.measure(2, steps=2, windows=2, warmup=1,
                                 device="cpu", env={}, geometry=TINY)
    return json.loads(json.dumps(bench_torch.with_baseline(result)))


def test_line_has_bench_py_keys_and_the_port_s(line):
    keys = bench_py_keys()
    assert {"metric", "value", "spread", "windows", "vs_baseline",
            "fusion_encode", "pgram_cache", "host_load"} <= keys
    # host_load / host_contended are added by main(), around the windows
    assert keys - {"host_load", "host_contended"} <= set(line)
    assert NEW_KEYS <= set(line)
    assert line["metric"] == "av_clips_per_sec_cpu_plain"
    assert line["device"] == {"platform": "cpu", "kind": "cpu", "count": 0}
    assert line["value"] > 0 and len(line["windows"]) == 2
    assert line["vs_baseline"] == pytest.approx(line["value"] / 3.669)
    assert line["vs_baseline_fresh"] is None
    assert line["baseline_pinned_cps"] == 3.669


def test_line_records_the_fusion_defaults(line):
    assert (line["batch"], line["dtype"], line["regime"]) == (2, "bfloat16",
                                                               "fusion")
    assert line["fusion_encode"] == "full" and line["pgram_cache"] is True
    assert line["fullenc_loss_resolved"] == "fold"
    assert (line["steps"], line["n_windows"], line["warmup"]) == (2, 2, 1)
    # the plain versions on the CPU: every counter stays at 0
    assert set(line["kernels"]) >= {"lstm_fwd", "lstm_bwd", "pgenc_train",
                                    "pgenc_bwd", "adam", "stft_feat"}
    assert not any(line["kernels"].values())
    assert line["peak_memory_bytes"] is None


@pytest.mark.parametrize("env, label", [
    (dict(MAAVSS_BENCH_FUSED_OPT="1"), "Not carried"),
])
def test_unported_variables_raise_by_label(env, label):
    with pytest.raises(NotImplementedError, match="ROADMAP") as err:
        bench_torch.bench_config(env, 2, TINY)
    assert label in str(err.value)


@pytest.mark.parametrize("regime", ["fusion", "frames"])
def test_float16_variable_configures(regime):
    """MAAVSS_BENCH_DTYPE=float16 (M5) is ported: the config carries it and
    passes the check (tests/test_torch_fp16.py holds the fp16 path against
    JAX); any other dtype than the three raises."""
    env = dict(MAAVSS_BENCH_DTYPE="float16", MAAVSS_BENCH_REGIME=regime)
    cfg, got, _ = bench_torch.bench_config(env, 2, TINY)
    assert (cfg.dtype, got) == ("float16", regime)
    with pytest.raises(ValueError, match="float64"):
        bench_torch.bench_config(dict(MAAVSS_BENCH_DTYPE="float64"), 2, TINY)


@pytest.mark.parametrize("env", [
    dict(MAAVSS_BENCH_REMAT="1", MAAVSS_BENCH_MICROBATCH="2"),
    dict(MAAVSS_BENCH_REMAT="1", MAAVSS_BENCH_REGIME="frames"),
    dict(MAAVSS_BENCH_REMAT="1"),
])
def test_remat_variable_configures(env):
    """MAAVSS_BENCH_REMAT is ported: the config carries --remat and passes
    the check (tests/test_torch_remat.py runs the steps)."""
    cfg, regime, _ = bench_torch.bench_config(env, 2, TINY)
    assert cfg.remat
    assert regime == env.get("MAAVSS_BENCH_REGIME", "fusion")
    assert cfg.microbatch == int(env.get("MAAVSS_BENCH_MICROBATCH", "1"))


@pytest.mark.parametrize("env", [
    dict(MAAVSS_BENCH_MICROBATCH="2"),
    dict(MAAVSS_BENCH_MICROBATCH="2", MAAVSS_BENCH_REGIME="frames"),
    dict(MAAVSS_BENCH_FRAMES_ENCODE="full", MAAVSS_BENCH_FRAMES_HALO="1",
         MAAVSS_BENCH_REGIME="frames"),
])
def test_ported_variables_configure(env):
    """MICROBATCH, FRAMES_ENCODE and FRAMES_HALO are ported: the config
    carries them (tests/test_torch_frames_full.py and
    tests/test_torch_microbatch.py run the steps)."""
    cfg, _, _ = bench_torch.bench_config(env, 2, TINY)
    assert cfg.microbatch == int(env.get("MAAVSS_BENCH_MICROBATCH", "1"))
    assert cfg.frames_encode == env.get("MAAVSS_BENCH_FRAMES_ENCODE",
                                        "window")
    assert cfg.frames_halo == int(env.get("MAAVSS_BENCH_FRAMES_HALO", "0"))


@pytest.mark.parametrize("env", [
    dict(MAAVSS_BENCH_RNN="gru"),
    dict(MAAVSS_BENCH_RNN="none", MAAVSS_BENCH_REGIME="frames"),
])
def test_rnn_variable_configures(env):
    """MAAVSS_BENCH_RNN (bench.py:64) is ported: --rnn_cell gru|none
    passes the same check and the config carries it
    (tests/test_torch_rnn_options.py runs the steps)."""
    cfg, regime, _ = bench_torch.bench_config(env, 2, TINY)
    assert cfg.rnn_cell == env["MAAVSS_BENCH_RNN"]
    assert regime == env.get("MAAVSS_BENCH_REGIME", "fusion")


def test_multistep_config_is_accepted():
    """MAAVSS_BENCH_MULTISTEP=K (--steps_per_dispatch, ported) configures K
    steps a dispatch (tests/test_torch_multistep.py runs it)."""
    cfg, regime, _ = bench_torch.bench_config(
        dict(MAAVSS_BENCH_MULTISTEP="2"), 2, TINY)
    assert (cfg.steps_per_dispatch, regime) == (2, "fusion")
    cfg, _, _ = bench_torch.bench_config(
        dict(MAAVSS_BENCH_MULTISTEP="4", MAAVSS_BENCH_REGIME="frames"), 2,
        TINY)
    assert cfg.steps_per_dispatch == 4


def test_config_follows_bench_py_defaults():
    cfg, regime, window_mode = bench_torch.bench_config({}, 256)
    assert (regime, window_mode) == ("fusion", "vectorized")
    assert (cfg.fusion_encode, cfg.pgram_cache, cfg.dtype,
            cfg.opt_kernel) == ("full", True, "bfloat16", "auto")
    cfg, regime, window_mode = bench_torch.bench_config(
        dict(MAAVSS_BENCH_REGIME="frames"), 8)
    assert (regime, window_mode, cfg.pgram_cache) == ("frames", None, False)


def _run(env_extra):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(CUDA_VISIBLE_DEVICES="", **env_extra)
    return subprocess.run([sys.executable, "tools/bench_torch.py"], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=120)


def test_refuses_without_a_card():
    out = _run({})
    assert out.returncode != 0 and "CUDA is not available" in out.stderr
    assert out.stdout == ""
    out = _run({"MAAVSS_BENCH_WINDOWS": "scan"})
    assert out.returncode != 0 and "window COUNT" in out.stderr
