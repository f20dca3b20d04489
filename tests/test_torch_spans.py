"""The port's spans (maavss_tpu_torch/exp/profiling.py: `annotate`, `SPANS`)
in torch.profiler traces of tiny train steps on the CPU:

- every span name is a `cpu_op` event, never a `user_annotation`;
- `maavss.update` opens and closes each step (the gradients' zeroing, then
  the division, all-reduce, watch metrics and update), whatever the
  microbatch count; `maavss.encoders`, `maavss.fusion_core` and
  `maavss.heads` run once per microbatch chunk (in window mode once per
  window), the frames model's encoders twice (the visual trunk, then the
  STFT encoder beside the heads);
- the spans nest as the layers do: none inside another, each chunk's
  encoders before its fusion core before its heads, and the backward
  (`autograd::engine::evaluate_function`) outside them all;
- `annotate` makes no NVTX call;
- each span reader of the benchmark (perfbench/metrics/) reads exactly one
  of the program's span names, and the backward's reader the autograd
  engine's events, as the trace has them.
"""

import json
import os

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from maavss_tpu_torch.config import RunConfig
from maavss_tpu_torch.data.synthetic import synthetic_av_batch
from maavss_tpu_torch.exp.profiling import SPANS, annotate
from maavss_tpu_torch.train import setup, steps
from perfbench.core import spec
from tests.test_torch_workers import share_cores

share_cores()

FUSION = dict(num_frames=4, num_seq=4, hops_per_frame=4, fft_len=64,
              p_size=16, latent_chan=8, fc_size=256, learning_rate=1e-3,
              batch_size=4, noise_scalar=0.0)
FRAMES = dict(num_frames=2, num_seq=2, hops_per_frame=4, fft_len=64,
              framesize=24, batch_size=4, learning_rate=1e-3,
              noise_scalar=0.0)
STEPS = 2
BACKWARD = "autograd::engine::evaluate_function"
# case -> (frames model?, flags, chunks a step, {span: entries a step})
CASES = {
    "frames_full_mb2": (True, dict(frames_encode="full", microbatch=2), 2,
                        {"frontend": 5, "encoders": 4, "fusion_core": 2,
                         "heads": 2, "update": 2}),
    "fusion_full": (False, dict(fusion_encode="full"), 1,
                    {"frontend": 3, "encoders": 1, "fusion_core": 1,
                     "heads": 1, "update": 2}),
    "fusion_scan": (False, {}, 4,
                    {"frontend": 9, "encoders": 4, "fusion_core": 4,
                     "heads": 4, "update": 2}),
}
# the benchmark's span readers: metric -> the span it reads (None: the
# backward, read by the autograd engine's events)
READERS = {"frontend_ms": "frontend", "encoders_fwd_ms": "encoders",
           "fusion_core_fwd_ms": "fusion_core", "heads_fwd_ms": "heads",
           "update_ms": "update", "backward_ms": None}
_TRACES = {}


def _events(kind, tmp_path_factory):
    """The Chrome trace events of STEPS steps of case `kind`."""
    if kind in _TRACES:
        return _TRACES[kind]
    frames_model, flags, _, _ = CASES[kind]
    mp = pytest.MonkeyPatch()
    try:
        if frames_model:
            mp.setenv("MAAVSS_S2D_MIN_HW", "8")
            cfg = RunConfig(**FRAMES).replace(**flags)
            _, state = setup.build_frames_state(
                cfg, cfg.batch_size, latent_channels=8, device="cpu",
                generator=torch.Generator().manual_seed(0))
            make, fs = steps.make_frames_step, 24
        else:
            cfg = RunConfig(**FUSION).replace(**flags)
            _, state = setup.build_fusion_state(
                cfg, cfg.batch_size, device="cpu",
                generator=torch.Generator().manual_seed(0))
            make, fs = steps.make_fusion_step, None
        step = make(state.model, cfg, device="cpu")
        batches = [synthetic_av_batch(cfg, cfg.batch_size, seed=i,
                                      frame_size=fs) for i in range(STEPS)]
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            for batch in batches:
                state, _ = step(state, batch, 2)
    finally:
        mp.undo()
    path = str(tmp_path_factory.mktemp("spans") / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    os.remove(path)
    _TRACES[kind] = events
    return events


def _spans(events, name):
    return sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                   e.get("tid")) for e in events if e["name"] == name)


@pytest.mark.parametrize("kind", list(CASES))
def test_every_span_is_a_cpu_op(kind, tmp_path_factory):
    events = _events(kind, tmp_path_factory)
    for name in SPANS.values():
        cats = {e.get("cat") for e in events if e["name"] == name}
        assert cats == {"cpu_op"}, (name, cats)


@pytest.mark.parametrize("kind", list(CASES))
def test_spans_run_once_per_step_or_chunk(kind, tmp_path_factory):
    events = _events(kind, tmp_path_factory)
    per_step = CASES[kind][3]
    got = {k: len(_spans(events, SPANS[k])) for k in SPANS}
    assert got == {k: STEPS * n for k, n in per_step.items()}


@pytest.mark.parametrize("kind", list(CASES))
def test_spans_nest_as_the_layers(kind, tmp_path_factory):
    events = _events(kind, tmp_path_factory)
    chunks = CASES[kind][2]
    ours = sorted((a, b, name) for name in SPANS.values()
                  for a, b, _ in _spans(events, name))
    # one thread; no span of the program inside or across another
    assert len({t for n in SPANS.values()
                for _, _, t in _spans(events, n)}) == 1
    for (_, b0, n0), (a1, _, n1) in zip(ours, ours[1:]):
        assert b0 <= a1, (n0, n1)
    model = [n for _, _, n in ours if n in (SPANS["encoders"],
                                              SPANS["fusion_core"],
                                              SPANS["heads"])]
    # each chunk: its encoders (the frames model's trunk and STFT
    # encoder), then the fusion core, then the heads
    enc = SPANS["encoders"]
    per_chunk = [enc] * (len(model) // (STEPS * chunks) - 2) + [
        SPANS["fusion_core"], SPANS["heads"]]
    assert model == per_chunk * (STEPS * chunks)
    backward = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                for e in events if e["name"].startswith(BACKWARD)]
    assert backward
    for a, b in backward:
        for a0, b0, name in ours:
            assert b <= a0 or b0 <= a, name


def test_annotate_makes_no_nvtx_call(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("an NVTX call")

    for fn in ("range_push", "range_pop", "range_start", "range_end",
               "mark", "range"):
        monkeypatch.setattr(torch.cuda.nvtx, fn, refuse)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with annotate(SPANS["heads"]):
            torch.ones(4).sum()
    with annotate(SPANS["heads"]):
        pass
    assert [(e.key, e.count) for e in prof.key_averages()
            if e.key.startswith("maavss.")] == [(SPANS["heads"], 1)]


@pytest.mark.parametrize("metric", list(READERS))
def test_each_reader_reads_one_span_of_the_program(metric, tmp_path_factory):
    """The reader's predicate, over the host events of a frames step's
    trace, picks the events of its one span name of `SPANS` (the backward's,
    the autograd engine's and nothing of the program's)."""
    (key, pred), = spec.metric(metric).UNDER.items()
    assert key == metric
    events = _events("frames_full_mb2", tmp_path_factory)
    picked = {e["name"] for e in events
              if e.get("cat") == "cpu_op" and pred(e)}
    span = READERS[metric]
    if span is None:
        assert picked and all(n.startswith(BACKWARD) for n in picked)
        assert not picked & set(SPANS.values())
    else:
        assert picked == {SPANS[span]}
