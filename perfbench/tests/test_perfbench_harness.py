"""The harness on the CPU: what it imports, how it finds cells,
configurations and metrics, its refusal without a card, the work counts
behind the rooflines, and the trace's reduction."""

import ast
import json
import os
import shutil
import subprocess
import sys
import time

import pytest
import torch

from perfbench.core import spec, work
from perfbench.core.readers import Context
from perfbench.core.trace import kernel_name, reduce

BENCH = os.path.join(spec.ROOT, "perfbench")


def top_level_imports(path):
    tree = ast.parse(open(path).read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split(".")[0])
    return names


def sources(sub=""):
    for d, _, files in os.walk(os.path.join(BENCH, sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_nothing_imports_jax_or_the_jax_package():
    for path in sources():
        found = top_level_imports(path) & {"jax", "jaxlib", "flax",
                                           "maavss_tpu"}
        assert not found, (path, found)


def test_the_reference_imports_nothing_of_the_program():
    for path in sources("reference"):
        assert "maavss_tpu_torch" not in top_level_imports(path), path


def test_only_the_program_and_the_families_import_the_port():
    users = sorted(os.path.relpath(p, BENCH) for p in sources()
                   if "maavss_tpu_torch" in top_level_imports(p)
                   and "tests" not in p)
    assert users == [os.path.join("core", "program.py"),
                     os.path.join("families", "frames.py"),
                     os.path.join("families", "fusion.py")], users


def test_nothing_reads_the_jax_benchmark():
    for path in sources():
        if os.sep + "tests" + os.sep in path:
            continue
        text = open(path).read()
        for name in ("benchmarks/", "bench.py", "BASELINE.json"):
            assert name not in text, (path, name)


def test_every_cell_and_metric_is_found():
    bench = spec.load_json(os.path.join(spec.ROOT, "BENCHMARK.json"))
    for w in bench["workloads"]:
        cell = spec.find_cell(w["name"])
        assert cell.chips == 1
        assert any(m["name"] == "setup_s" for m in cell.end_to_end)
        assert len(cell.end_to_end) >= 2 and cell.per_layer
        assert callable(spec.load("runners", cell.traffic["kind"]).Runner)
        fam = spec.load("families", cell.config["family"])
        assert callable(fam.model) and callable(fam.reference.train_steps)
        for m in cell.per_layer:
            assert callable(spec.metric(m["name"]).read)
        assert os.path.exists(os.path.join(BENCH, "limits",
                                           w["name"] + ".json"))


def test_new_cell_config_and_metric_are_found_without_edits(tmp_path):
    """A later change adds files and entries only: a configuration file, a
    traffic file, a metric's reader, a limits file and the entries that
    name them."""
    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = spec.load_json(os.path.join(spec.ROOT, "BENCHMARK.json"))
    before = {p: open(p).read() for p in sources()}
    cfg = spec.load_json(os.path.join(BENCH, "configs",
                                      "fusion-flagship.json"))
    cfg["name"] = "fusion-wide"
    (root / "perfbench" / "configs" / "fusion-wide.json").write_text(
        json.dumps(cfg))
    (root / "perfbench" / "traffic" / "train-rows-b64.json").write_text(
        json.dumps({"kind": "train", "batch_size": 64}))
    (root / "perfbench" / "metrics" / "busy_ms.train.py").write_text(
        "def read(ctx):\n    return 1e3 * ctx.trace.busy_s / ctx.units\n")
    bench["configs"].append({"name": "fusion-wide", "source": "x",
                             "file": "perfbench/configs/fusion-wide.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "fusion-wide.b64",
                               "config": "fusion-wide",
                               "traffic": "train-rows-b64", "chips": 1,
                               "why": "x"})
    for m in bench["end_to_end"]:
        if m["name"] == "train_clips_per_s":
            m["workloads"].append("fusion-wide.b64")
    bench["per_layer"].append({"name": "busy_ms.train", "unit": "ms",
                               "better": "lower", "source": "device_trace",
                               "layer": "device",
                               "moves": "train_clips_per_s",
                               "workloads": ["fusion-wide.b64"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.find_cell("fusion-wide.b64", str(root))
    assert cell.config["name"] == "fusion-wide"
    assert cell.traffic["batch_size"] == 64
    assert [m["name"] for m in cell.per_layer] == ["busy_ms.train"]
    assert {m["name"] for m in cell.end_to_end} == {"train_clips_per_s",
                                                    "setup_s"}
    read = spec.metric("busy_ms.train", str(root)).read

    class T:
        busy_s = 0.5

    assert read(Context(None, {}, {}, T, 10, {})) == 50.0
    assert before == {p: open(p).read() for p in sources()}


TOY_RUNNER = """
import time
import torch

FAULTS = (None, "altered")


class Runner:
    def __init__(self, fam, run, traffic, seed, device, fault=None):
        g = torch.Generator().manual_seed(seed)
        self.a = torch.randn(run["n"], run["n"], generator=g)
        self.fault, self.done, self.out = fault, 0, None

    def _unit(self):
        self.out = fam_square(self.a)
        if self.fault == "altered":
            self.out = self.out + 1.0
        self.done += 1

    def first_steps(self):
        self._unit()

    def window(self, seconds):
        t0, n = time.perf_counter(), 0
        while n == 0 or time.perf_counter() - t0 < seconds:
            self._unit()
            n += 1
        dt = time.perf_counter() - t0
        return {"squares_per_s": n / dt}, n, {"n": n}

    def traced_units(self):
        def fn():
            for _ in range(3):
                self._unit()
            return 3
        return fn

    def failed(self):
        return 0

    def numbers(self):
        ref = self.a.double() @ self.a.double()
        return {"square_gap": float((self.out - ref).abs().max())}

    def control(self, precision):
        low = (self.a.to(getattr(torch, precision)) @ self.a.to(
            getattr(torch, precision))).double()
        return {"square_gap": float((low - self.a.double()
                                     @ self.a.double()).abs().max())}


def fam_square(a):
    return a @ a
"""

MM_METRIC = """
SEEN = []
RECORD_SHAPES = True


def is_square_mm(event):
    dims = (event.get("args") or {}).get("Input Dims") or [[]]
    hit = event.get("name") == "aten::mm" and len(dims[0]) == 2
    if hit:
        SEEN.append(dims)
    return hit


UNDER = {"mm_ops": is_square_mm}


def read(ctx):
    return float(len(SEEN)) if SEEN else None
"""


def test_new_kind_family_and_op_attributed_metric_run_without_edits(
        tmp_path):
    """A later change adds a traffic of a new kind, the runner of that
    kind, a family, and a per-layer metric that asks the trace for host
    ops with their shapes, as files and entries only; the cell runs (here
    on the CPU, timed and traced) with no file of the harness edited."""
    from perfbench.core.cli import run_cell

    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: open(p).read() for p in sources()}
    pb = root / "perfbench"
    (pb / "runners" / "square.py").write_text(TOY_RUNNER)
    (pb / "families" / "toy.py").write_text('"""A toy family."""\n')
    (pb / "metrics" / "mm_ops.py").write_text(MM_METRIC)
    (pb / "configs" / "toy-64.json").write_text(json.dumps(
        {"name": "toy-64", "family": "toy", "run": {"n": 64}}))
    (pb / "traffic" / "square-loop.json").write_text(json.dumps(
        {"kind": "square"}))
    (pb / "limits" / "toy-64.square.json").write_text(json.dumps(
        {"limits": {"square_gap": 1e-3}}))
    bench = spec.load_json(os.path.join(spec.ROOT, "BENCHMARK.json"))
    bench["configs"].append({"name": "toy-64", "source": "x",
                             "file": "perfbench/configs/toy-64.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "toy-64.square", "config": "toy-64",
                               "traffic": "square-loop", "chips": 1,
                               "why": "x"})
    bench["end_to_end"].insert(0, {
        "name": "squares_per_s", "unit": "1/s", "better": "higher",
        "bound": 0.05, "source": "host_clock",
        "workloads": ["toy-64.square"]})
    bench["per_layer"].append({"name": "mm_ops", "unit": "ops",
                               "better": "lower", "source": "device_trace",
                               "layer": "device", "moves": "squares_per_s",
                               "workloads": ["toy-64.square"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    def go(**kw):
        return run_cell("toy-64.square", 7, 0.05, kw.pop("trace", False),
                        torch.device("cpu"), time.perf_counter(),
                        root=str(root), **kw)

    timed = go()
    assert timed["correct"], timed
    assert set(timed["metrics"]) == {"squares_per_s", "setup_s"}
    assert timed["metrics"]["squares_per_s"]["value"] > 0
    traced = go(trace=True)
    assert traced["correct"], traced
    assert traced["metrics"]["mm_ops"] == {"value": 3.0, "unit": "ops"}
    assert traced["attempted"] == 3
    assert not go(fault="altered")["correct"]
    assert not go(control="float16")["correct"]
    assert before == {p: open(p).read() for p in sources()}


def test_run_fails_rather_than_falls_back_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, os.path.join(BENCH, "run.py"), "--workload",
         "fusion-train-b256", "--seed", "1", "--seconds", "1", "--trace",
         "0"], cwd=spec.ROOT, env=env, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "CUDA" in proc.stderr


def test_run_fails_in_a_checkout_without_the_program(tmp_path):
    shutil.copytree(BENCH, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(spec.ROOT, "BENCHMARK.json"), tmp_path)
    proc = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload",
         "fusion-train-b256", "--seed", "1", "--seconds", "1", "--trace",
         "0"], cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


FUSION = dict(num_frames=8, num_seq=4, hops_per_frame=8, p_size=64,
              latent_chan=64, fc_size=4096, fft_len=256, dtype="bfloat16")
FRAMES = dict(num_frames=8, num_seq=4, hops_per_frame=8, framesize=256,
              latent_width=16, fft_len=256, dtype="bfloat16", microbatch=2)


def test_k2_bounds_at_the_full_encode_span():
    """PERF.md's K2 bounds at R = 2816 in bf16: 0.102 ms forward, 0.252 ms
    backward, both set by the bytes."""
    b = work.k2_bounds(FUSION, 256 * 11)
    assert b["train"] * 1e3 == pytest.approx(0.102, abs=5e-4)
    assert b["bwd"] * 1e3 == pytest.approx(0.252, abs=5e-4)


def test_k1_bounds_at_1024_rows():
    b = work.k1_bounds(2, 1024, 8)
    assert b["fwd"] * 1e3 == pytest.approx(0.0153, abs=5e-5)
    assert b["bwd"] * 1e3 == pytest.approx(0.0282, abs=5e-5)


def test_k5_bounds_at_the_tuned_frames_chunk():
    """PERF.md's tuned K5 bounds (bf16, a 128-row chunk's stages 0 and 1):
    1.322, 1.983, 0.661 and 3.305 ms."""
    shapes = work.frames_k5_shapes(FRAMES, 128)
    assert shapes == [(128, 16, 11, 256, 256), (128, 32, 11, 128, 128)]
    tot = {}
    for s in shapes:
        for k, v in work.k5_bounds(2, s).items():
            tot[k] = tot.get(k, 0.0) + v * 1e3
    want = {"stats": 1.322, "apply": 1.983, "bwd_reduce": 0.661,
            "bwd_dy": 3.305}
    for k, v in want.items():
        assert tot[k] == pytest.approx(v, abs=1e-3), k


def test_model_flops_by_hand():
    """The fusion step's forward by hand: the heads (70.9 GFLOP), the LSTM
    (25.8), the phasegram encoder (25.5) and the STFT encoder (14.4) at
    batch 256; a train step is three forwards."""
    fwd = work.fusion_forward_flops(FUSION, 256)
    assert fwd == pytest.approx(136.6e9, rel=0.005)
    assert spec.load("families", "fusion").forward_flops(FUSION, 256) == fwd
    assert work.frames_forward_flops(FRAMES, 256) == pytest.approx(
        9.62e12, rel=0.01)


def test_trace_reduction():
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "perfbench.window",
         "ts": 0, "dur": 100},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 5, "dur": 30},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaStreamSynchronize",
         "ts": 60, "dur": 40},
        {"ph": "X", "cat": "kernel", "ts": 10, "dur": 20,
         "name": "void (anonymous namespace)::grads_kernel<float>(int)"},
        {"ph": "X", "cat": "kernel", "ts": 20, "dur": 20,
         "name": "void at::native::vectorized_elementwise_kernel<4>(int)"},
        {"ph": "X", "cat": "gpu_memcpy", "ts": 70, "dur": 10,
         "name": "Memcpy DtoH"},
    ]
    tr = reduce(ev)
    assert tr.window_s == pytest.approx(100e-6)
    assert tr.busy_s == pytest.approx(40e-6)  # [10, 40) and [70, 80)
    assert tr.kernels["grads_kernel"] == (1, pytest.approx(20e-6))
    gaps = dict(tr.gaps)
    assert gaps["aten::mm"] == pytest.approx(10e-6)  # [0, 10)
    assert gaps["host"] == pytest.approx(30e-6)  # [40, 70)
    assert gaps["cudaStreamSynchronize"] == pytest.approx(20e-6)
    assert kernel_name("void at::native::foo<1>(int)") == "at::native::foo"


def test_trace_puts_the_device_clock_on_the_host_clock():
    """A kernel stamped 15 us before the call that launched it moves 15 us
    later, with every other device operation."""
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "perfbench.window",
         "ts": 0, "dur": 100},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaGraphLaunch",
         "ts": 20, "dur": 5, "args": {"correlation": 7}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaDeviceSynchronize",
         "ts": 25, "dur": 75},
        {"ph": "X", "cat": "kernel", "name": "void k<1>()", "ts": 5,
         "dur": 80, "args": {"correlation": 7}},
    ]
    tr = reduce(ev)
    assert tr.busy_s == pytest.approx(80e-6)  # [20, 100)
    assert dict(tr.gaps) == {"host": pytest.approx(20e-6)}  # [0, 20)


@pytest.mark.cuda
def test_a_short_run_on_the_card(card):
    proc = subprocess.run(
        [sys.executable, os.path.join(BENCH, "run.py"), "--workload",
         "fusion-train-b256", "--seed", "2147483659", "--seconds", "2",
         "--trace", "0"], cwd=spec.ROOT, capture_output=True, text=True,
        timeout=900)
    assert proc.returncode == 0, proc.stderr[-2000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
