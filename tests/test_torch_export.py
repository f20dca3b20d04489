"""The port's serving export (exp/export.py, exp/artifact.py) and the
serving path's kernels as registered ops (ops/registry.py), on the CPU,
at tests/test_export.py:22-23's tiny geometry.

- Parity with the JAX artifact: one flax weight tree (the seeded recipe
  `convert.random_flax_tree` over the flax model's leaf shapes) goes into
  JAX's `export_separator(..., platforms=("cpu",))`, serialized,
  deserialized and called, and through `convert.from_flax` into the port's
  model, whose `torch.export` artifact is saved, loaded and called: audio
  within relative L2 1e-4 (tests/test_torch_separator.py's bar for the
  live separators), for fusion in window mode, fusion with
  --fusion_encode full --pgram_cache (float16 rows) and the frames family
  (uint8 frames).
- Round trip: the loaded artifact is the live `make_serving_fn` bit for
  bit, in fp32 and bf16; mixture in, no noise (two calls equal).
- Refusals: a geometry mismatch, and a weights file with a missing or
  misshaped leaf (before any call, nothing copied).
- The serve side: a fresh process loads a CPU artifact with another
  checkpoint of its geometry and calls it without loading
  `maavss_tpu_torch.models`, `train`, jax or flax, bitwise the live
  function of a model holding those weights; the HTTP daemon over the
  artifact equals a direct call (atol 1e-6, as
  tests/test_torch_serving.py).
- The card route's graph, traced here on fake CUDA tensors (every
  parameter and buffer a FakeTensor on "cuda", torch.export under that
  FakeTensorMode): it holds the registered ops, K1-fwd once a window,
  K2-eval once a layer a window, the STFT kernel once, the polar kernel
  once under --use_polar, and no call of a Python function (a ctypes
  launch would be one). This CPU build has no CUDA device guard, which
  Python's indexing, `.contiguous()`, `.copy_()` and `.to()` take on a
  CUDA tensor before dispatch: `_cuda_free_methods` routes those calls to
  the aten ops they dispatch, which the fake mode handles.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

import jax
import jax.numpy as jnp

from maavss_tpu.config import RunConfig as JaxRunConfig
from maavss_tpu.exp.export import export_separator as jax_export
from maavss_tpu.models.fusion import AVFusionModel as JaxFusion
from maavss_tpu.models.fusion_frames import AVFusionFramesModel as JaxFrames
from maavss_tpu_torch.config import RunConfig
from maavss_tpu_torch.convert import (
    flatten_tree,
    from_flax,
    random_flax_tree,
    save_npz,
    unflatten_tree,
)
from maavss_tpu_torch.exp.artifact import (
    artifact_serving_fn,
    load_artifact,
    load_weights,
)
from maavss_tpu_torch.exp.export import (
    export_separator,
    graph_op_counts,
    make_serving_fn,
    random_serving_inputs,
    save_artifact,
    serving_input_specs,
)
from maavss_tpu_torch.exp.serving import (
    BatchingExecutor,
    SeparationClient,
    SeparationServer,
)
from maavss_tpu_torch.train.setup import build_frames_model, build_fusion
from tests.test_torch_workers import share_cores
from tools import export_model_torch

share_cores()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(num_frames=4, num_seq=4, hops_per_frame=4, fft_len=64,
             p_size=16, latent_chan=8, fc_size=256, batch_size=2)
FRAMES = dict(num_frames=2, num_seq=2, hops_per_frame=4, fft_len=64,
              framesize=24, batch_size=2)
FRAMES_LATENT = 2
CASES = {"window": (SMALL, False), "fullenc": (dict(
    SMALL, fusion_encode="full", pgram_cache=True), False),
         "frames": (FRAMES, True)}
REL_L2 = 1e-4
aten = torch.ops.aten


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _jax_model(jcfg, frames_model):
    t_stft = jcfg.hops_per_frame * jcfg.num_frames
    b = jcfg.batch_size
    if frames_model:
        return JaxFrames(
            stft_shape=(b, 2, t_stft, jcfg.fft_len // 2 + 1),
            frame_shape=(b, 1, jcfg.num_frames, jcfg.framesize,
                         jcfg.framesize),
            hops_per_frame=jcfg.hops_per_frame,
            latent_channels=FRAMES_LATENT)
    return JaxFusion(stft_shape=(b, 2, t_stft, jcfg.fft_len // 2),
                     pgram_shape=(b, 1, jcfg.num_frames, jcfg.p_size ** 2),
                     latent_channels=jcfg.latent_chan, fc_size=jcfg.fc_size,
                     pgenc_kernel="xla")


def _flax_tree(model, frames_model, seed):
    """{'params', 'batch_stats'} numpy trees: the seeded recipe over the
    model's leaf shapes (jax.eval_shape of its init, nothing compiled)."""
    second = model.frame_shape if frames_model else model.pgram_shape
    abstract = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros(model.stft_shape),
        jnp.zeros(second), method=model.init_all))
    shapes = {k: v.shape for k, v in flatten_tree(jax.tree_util.tree_map(
        lambda s: np.empty(s.shape, s.dtype), {
            "params": abstract["params"],
            "batch_stats": abstract["batch_stats"]})).items()}
    return unflatten_tree(random_flax_tree(shapes, seed))


def _port_model(cfg, frames_model, tree, device="cpu"):
    if frames_model:
        model = build_frames_model(cfg, cfg.batch_size,
                                   latent_channels=FRAMES_LATENT,
                                   device=device)
    else:
        model = build_fusion(cfg, cfg.batch_size, device)
    model.load_state_dict(from_flax(tree["params"], tree["batch_stats"]),
                          strict=True)
    return model


def _inputs(cfg, frames_model, seed=0):
    audio, visual = random_serving_inputs(cfg, cfg.batch_size, frames_model,
                                          seed=seed)
    if not frames_model and not cfg.pgram_cache:  # broadband frames in [0, 1]
        visual = np.random.default_rng(seed + 1).uniform(
            0, 1, visual.shape).astype(np.float32)
    return audio, visual


class _Built:
    """name -> (cfg, frames_model, flax tree, port model, loaded program,
    its sidecar, its path, inputs, the JAX artifact's audio), each case
    exported once a side on first use. Building the fullenc case also
    starts `_serve_side`'s process, which runs beside the tests after it."""

    def __init__(self, tmp_path_factory):
        self.tmp = tmp_path_factory
        self.cases = {}
        self.side = None

    def __call__(self, name):
        if name not in self.cases:
            self.cases[name] = _build_case(name, self.tmp)
            if name == "fullenc":
                self.side = _serve_side(self.cases[name],
                                        self.tmp.mktemp("side"))
        return self.cases[name]


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    made = _Built(tmp_path_factory)
    yield made
    if made.side is not None:
        made.side[0].kill()


def _build_case(name, tmp_path_factory):
    kwargs, frames_model = CASES[name]
    cfg = RunConfig(**kwargs)
    jcfg = JaxRunConfig(**kwargs)
    jmodel = _jax_model(jcfg, frames_model)
    tree = _flax_tree(jmodel, frames_model, seed=7)
    audio, visual = _inputs(cfg, frames_model)
    exported = jax.export.deserialize(jax_export(
        jmodel, jcfg, tree, cfg.batch_size, platforms=("cpu",),
        frames_model=frames_model))
    want = np.asarray(exported.call(tree["params"], tree["batch_stats"],
                                    audio, visual))
    model = _port_model(cfg, frames_model, tree)
    path = save_artifact(
        str(tmp_path_factory.mktemp("art") / name),
        export_separator(model, cfg, cfg.batch_size, frames_model), cfg,
        cfg.batch_size, frames_model)
    program, meta = load_artifact(path, cfg)
    return (cfg, frames_model, tree, model, program, meta, path,
            (audio, visual), want)


_FNS = {}


def _fn(program):
    """The program's serving function, its module made once."""
    if id(program) not in _FNS:
        _FNS[id(program)] = program, artifact_serving_fn(program)
    return _FNS[id(program)][1]


def _call(program, inputs):
    return _fn(program)(*(torch.from_numpy(x) for x in inputs)).numpy()


@pytest.mark.parametrize("name", list(CASES))
def test_artifact_matches_jax_artifact(built, name):
    cfg, frames_model, _, _, program, _, _, inputs, want = built(name)
    got = _call(program, inputs)
    assert got.shape == inputs[0].shape and np.all(np.isfinite(got))
    assert _rel_l2(got, want) < REL_L2, (name, _rel_l2(got, want))


@pytest.mark.parametrize("name", ["window", "frames"])
def test_sidecar_describes_the_artifact(built, name):
    cfg, frames_model, _, model, program, meta, path, _, _ = built(name)
    assert path.endswith(".pt2") and os.path.exists(path + ".json")
    assert meta["device"] == "cpu" and meta["device_name"] == "cpu"
    assert meta["torch_version"] == torch.__version__
    assert (meta["batch"], meta["frames_model"], meta["compute_dtype"]) == \
        (cfg.batch_size, frames_model, "float32")
    assert meta["ops"] == {}  # traced on the CPU: the plain versions
    assert meta["geometry"]["fusion_encode"] == cfg.fusion_encode
    assert meta["weights"] == {k: list(v.shape)
                               for k, v in model.state_dict().items()}
    a_spec, v_spec = serving_input_specs(cfg, cfg.batch_size, frames_model)
    assert meta["visual_dtype"] == str(v_spec.dtype)
    assert tuple(meta["audio_shape"]) == tuple(a_spec.shape)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_round_trip_is_the_live_function(built, dtype, tmp_path, monkeypatch,
                                         capsys):
    """The loaded artifact equals make_serving_fn bit for bit (full encode
    on float16 rows, the smallest graph): fp32 the parity case's, bf16
    through tools/export_model_torch.py --device cpu --selftest."""
    if dtype == "float32":
        cfg, _, _, model, program, meta, _, _, _ = built("fullenc")
        inputs = _inputs(cfg, False, seed=4)
        want = make_serving_fn(model, cfg)(
            *(torch.from_numpy(x) for x in inputs)).numpy()
        np.testing.assert_array_equal(_call(program, inputs), want)
        return
    out = str(tmp_path / "sep")
    monkeypatch.setattr(sys, "argv", [
        "export_model_torch.py", "--device", "cpu", "--out", out, "-b", "2",
        "--num_frames", "4", "--num_seq", "4", "-a", "4", "--fft_len", "64",
        "--p_size", "16", "--latent_chan", "8", "--fc_size", "256",
        "--fusion_encode", "full", "--pgram_cache", "--dtype", dtype,
        "--selftest"])
    export_model_torch.main()
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert lines[0]["artifact"] == out + ".pt2" and lines[0]["ops"] == {}
    assert lines[1] == {"selftest_max_abs_diff": 0.0, "bitwise_equal": True,
                        "ok": True}
    with open(out + ".pt2.json") as f:
        meta = json.load(f)
    assert meta["compute_dtype"] == dtype and meta["batch"] == 2


def test_mixture_in_is_noise_free(built):
    """Serving semantics (tests/test_export.py:70): the input IS the
    mixture; the same audio in gives the same audio out."""
    cfg, frames_model, _, _, program, _, _, _, _ = built("fullenc")
    inputs = _inputs(cfg, frames_model, seed=3)
    np.testing.assert_array_equal(_call(program, inputs),
                                  _call(program, inputs))


def test_geometry_mismatch_raises(built):
    cfg, _, _, _, _, _, path, _, _ = built("window")
    with pytest.raises(ValueError, match="geometry mismatch"):
        load_artifact(path, cfg.replace(fft_len=128))


@pytest.mark.parametrize("fault", ["missing", "misshaped"])
def test_weights_that_do_not_fit_raise_before_any_call(built, fault,
                                                       tmp_path):
    _, _, tree, _, program, _, _, _, _ = built("window")
    flat = flatten_tree(tree)
    key = sorted(k for k in flat if k.startswith("params/"))[0]
    if fault == "missing":
        del flat[key]
    else:
        flat[key] = np.zeros(flat[key].shape + (1,), flat[key].dtype)
    bad = unflatten_tree(flat)
    path = str(tmp_path / "w.npz")
    save_npz(path, bad["params"], bad["batch_stats"])
    before = {k: v.clone() for k, v in program.state_dict.items()}
    with pytest.raises(ValueError, match="do not fit the artifact"):
        load_weights(program, path)
    for k, v in program.state_dict.items():
        assert torch.equal(v, before[k]), k


SERVE_SIDE = (
    "import sys, numpy as np, torch\n"
    "from maavss_tpu_torch.exp.artifact import load_artifact, "
    "artifact_serving_fn\n"
    "program, meta = load_artifact(sys.argv[1], weights=sys.argv[2])\n"
    "z = np.load(sys.argv[3])\n"
    "out = artifact_serving_fn(program)(torch.from_numpy(z['audio']), "
    "torch.from_numpy(z['visual']))\n"
    "np.save(sys.argv[4], out.numpy())\n"
    "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', "
    "'maavss_tpu') or m.startswith(('maavss_tpu_torch.models', "
    "'maavss_tpu_torch.train'))]\n"
    "assert not bad, bad\n")


def _serve_side(case, tmp):
    """(process, another flax tree, its output path): a fresh process that
    loads the case's CPU artifact with another checkpoint of its geometry
    and calls it on the case's inputs (SERVE_SIDE)."""
    cfg, frames_model, _, _, _, _, path, inputs, _ = case
    other = _flax_tree(_jax_model(JaxRunConfig(**CASES["fullenc"][0]),
                                  frames_model), frames_model, seed=8)
    npz, data, out = (str(tmp / f) for f in ("other.npz", "in.npz",
                                            "out.npy"))
    save_npz(npz, other["params"], other["batch_stats"])
    np.savez(data, audio=inputs[0], visual=inputs[1])
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"  # beside the tests, on a core of its own
    proc = subprocess.Popen([sys.executable, "-c", SERVE_SIDE, path, npz,
                             data, out], cwd=ROOT, env=env, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    return proc, other, out


def test_serve_side_loads_another_checkpoint_without_model_code(built):
    """A fresh process loads the CPU artifact with another checkpoint of
    its geometry (load_artifact(weights=): no new export) and calls it,
    loading no `maavss_tpu_torch.models` or `train` module, no jax and no
    flax; its audio is the live function of a model holding those weights,
    bit for bit."""
    cfg, frames_model, _, _, _, _, _, inputs, _ = built("fullenc")
    proc, other, out = built.side
    _, err = proc.communicate(timeout=120)
    assert proc.returncode == 0, err[-2000:]
    live = make_serving_fn(_port_model(cfg, frames_model, other), cfg,
                           frames_model)
    want = live(*(torch.from_numpy(x) for x in inputs)).numpy()
    np.testing.assert_array_equal(np.load(out), want)


def test_daemon_serves_the_artifact(built):
    cfg, _, _, _, program, meta, _, inputs, _ = built("fullenc")
    from maavss_tpu_torch.exp.artifact import input_specs

    a_spec, v_spec = input_specs(meta)
    executor = BatchingExecutor(_fn(program), cfg.batch_size, a_spec, v_spec,
                                "cpu", max_wait_ms=1.0)
    srv = SeparationServer(executor, {"sidecar": meta}, host="127.0.0.1",
                           port=0).start()
    client = SeparationClient("http://%s:%d" % srv.address)
    try:
        out = client.separate(inputs[0][:1], inputs[1][:1])
        pad = [np.zeros_like(x) for x in inputs]
        pad[0][:1], pad[1][:1] = inputs[0][:1], inputs[1][:1]
        np.testing.assert_allclose(out, _call(program, pad)[:1], atol=1e-6,
                                   rtol=0)
        assert client.get_json("/healthz")["sidecar"]["batch"] == \
            cfg.batch_size
    finally:
        client.close()
        srv.stop()


# ------------------------------------------- the card route, on fake CUDA


def _basic_index(x, idx):
    """x[idx] for ints, slices, None and Ellipsis, as aten view ops."""
    idx = idx if isinstance(idx, tuple) else (idx,)
    n_real = sum(1 for i in idx if i is not None and i is not Ellipsis)
    out, dim = x, 0
    for i in idx:
        if i is Ellipsis:
            dim += x.dim() - n_real
        elif i is None:
            out = aten.unsqueeze.default(out, dim)
            dim += 1
        elif isinstance(i, int) and not isinstance(i, bool):
            out = aten.select.int(out, dim, i)
        elif isinstance(i, slice):
            if i != slice(None):
                out = aten.slice.Tensor(out, dim, i.start, i.stop,
                                        1 if i.step is None else i.step)
            dim += 1
        else:
            raise NotImplementedError(f"index {i!r} on a fake CUDA tensor")
    return out


class _cuda_free_methods(TorchFunctionMode):
    """Routes the Tensor methods whose Python bindings take a CUDA device
    guard (which this CPU-only build lacks) to the aten ops they dispatch."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is torch.Tensor.__getitem__:
            return _basic_index(*args)
        if func is torch.Tensor.__setitem__:
            x, idx, value = args
            aten.copy_.default(_basic_index(x, idx), value)
            return None
        if func is torch.Tensor.contiguous:
            x = args[0]
            return x if x.is_contiguous() else aten.clone.default(
                x, memory_format=torch.contiguous_format)
        if func is torch.Tensor.copy_:
            return aten.copy_.default(*args, **kwargs)
        if func is torch.Tensor.to:
            x, rest = args[0], list(args[1:]) + list(kwargs.values())
            dtype = next((a for a in rest if isinstance(a, torch.dtype)),
                         x.dtype)
            return x if dtype == x.dtype else aten._to_copy.default(
                x, dtype=dtype)
        return func(*args, **kwargs)


def _fake_cuda_export(cfg, frames_model):
    """The serving program traced on fake CUDA tensors, the kernel gates
    resolved as on the card."""
    from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode

    if frames_model:
        model = build_frames_model(cfg, cfg.batch_size,
                                   latent_channels=FRAMES_LATENT,
                                   device="cpu")
    else:
        model = build_fusion(cfg.replace(pgenc_kernel="pallas"),
                             cfg.batch_size, "cpu")
    mode = FakeTensorMode()
    cuda = torch.device("cuda")
    for mod in model.modules():
        for n, p in mod._parameters.items():
            if p is not None:
                mod._parameters[n] = torch.nn.Parameter(FakeTensor(
                    mode, torch.empty_like(p, device="meta"), cuda),
                    requires_grad=p.requires_grad)
        for n, b in mod._buffers.items():
            if b is not None:
                mod._buffers[n] = FakeTensor(
                    mode, torch.empty_like(b, device="meta"), cuda)
    with mode, _cuda_free_methods():
        return model, export_separator(model, cfg, cfg.batch_size,
                                       frames_model)


@pytest.mark.parametrize("name", ["window_polar", "fullenc", "frames"])
def test_card_route_graph_holds_registered_ops(name):
    kwargs, frames_model = CASES[name.split("_")[0]]
    cfg = RunConfig(**kwargs, use_polar=name == "window_polar")
    model, program = _fake_cuda_export(cfg, frames_model)
    windows = 1 if cfg.fusion_encode == "full" else cfg.num_seq
    want = {"lstm_fwd": windows, "stft_feat": 1}
    if not frames_model:
        want["pgenc_eval"] = windows * len(model.phasegram_encoder.specs)
    if cfg.use_polar:
        want["polar_spectrum"] = 1
    assert graph_op_counts(program) == want
    targets = [n.target for gm in program.graph_module.modules()
               if isinstance(gm, torch.fx.GraphModule)
               for n in gm.graph.nodes if n.op == "call_function"]
    foreign = [t for t in targets if not isinstance(
        t, (torch._ops.OpOverload, torch._ops.HigherOrderOperator))
        and getattr(t, "__module__", None) != "_operator"]
    assert not foreign, foreign


@pytest.mark.cuda
def test_card_artifact_is_the_live_function():
    """On the card: the exported program of the fusion flagship (window
    mode, batch 8) holds K1-fwd 4, K2-eval 40 and the STFT kernel once,
    and its call after a save and a load equals the live serving function
    bit for bit. chip_smoke.py's export phase holds the same on the card
    without jax."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the registered ops run on CUDA "
                    "alone")
    import tempfile

    cfg = RunConfig(batch_size=8)
    model = build_fusion(cfg, 8, "cuda")
    program = export_separator(model, cfg, 8)
    assert graph_op_counts(program) == {"lstm_fwd": 4, "pgenc_eval": 40,
                                        "stft_feat": 1}
    with tempfile.TemporaryDirectory() as tmp:
        program, _ = load_artifact(save_artifact(
            os.path.join(tmp, "sep"), program, cfg, 8), cfg)
    inputs = [torch.from_numpy(x).cuda() for x in _inputs(cfg, False)]
    assert torch.equal(artifact_serving_fn(program)(*inputs),
                       make_serving_fn(model, cfg)(*inputs))
    with pytest.raises((RuntimeError, NotImplementedError)):
        artifact_serving_fn(program)(*(x.cpu() for x in inputs))
