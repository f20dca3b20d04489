"""The span readers (metrics/frontend_ms.py, encoders_fwd_ms.py,
fusion_core_fwd_ms.py, heads_fwd_ms.py, update_ms.py, backward_ms.py)
over a synthetic trace reduced by core.trace.reduce: device milliseconds
a step of the kernels launched inside their host events, on the
launching thread, matched by correlation id; None where nothing was
launched inside them."""

import pytest

from perfbench.core import spec
from perfbench.core.readers import Context
from perfbench.core.trace import WINDOW, reduce

# metric -> a host event name its reader reads
READS = {
    "frontend_ms": "maavss.frontend",
    "encoders_fwd_ms": "maavss.encoders",
    "fusion_core_fwd_ms": "maavss.fusion_core",
    "heads_fwd_ms": "maavss.heads",
    "update_ms": "maavss.update",
    "backward_ms": "autograd::engine::evaluate_function: AddmmBackward0",
}
UNITS = 2


def _launch(ts, tid, corr, kernel_ts, kernel_us):
    return [
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": ts, "dur": 2, "pid": 1, "tid": tid,
         "args": {"correlation": corr}},
        {"ph": "X", "cat": "kernel", "name": f"void k{corr}<1>(int)",
         "ts": kernel_ts, "dur": kernel_us, "pid": 0, "tid": 7,
         "args": {"correlation": corr}},
    ]


def _trace(name, launches=True):
    """A window holding host event `name` on thread 1 over [10, 400) with
    one launch inside it (its kernel 30 us), a launch on thread 1 outside
    it (10 us), and a launch on thread 2 inside its time (50 us): thread
    2's event is the backward's own evaluate_function, or, where `name`
    is one, an aten op."""
    other = ("aten::mm" if name.startswith("autograd::")
             else READS["backward_ms"])
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": WINDOW, "ts": 0,
         "dur": 1000, "pid": 1, "tid": 1},
        {"ph": "X", "cat": "cpu_op", "name": name, "ts": 10, "dur": 390,
         "pid": 1, "tid": 1},
        {"ph": "X", "cat": "cpu_op", "name": other, "ts": 100, "dur": 60,
         "pid": 1, "tid": 2},
    ]
    if launches:
        ev += _launch(20, 1, 1, 40, 30)
    ev += _launch(110, 2, 2, 200, 50)
    ev += _launch(500, 1, 3, 510, 10)
    return ev


def _read(metric, events):
    reader = spec.metric(metric)
    tr = reduce(events, reader.UNDER)
    return reader.read(Context(None, {}, {}, tr, UNITS, {}))


@pytest.mark.parametrize("metric", list(READS))
def test_reader_gives_device_ms_a_step_of_its_launches(metric):
    assert _read(metric, _trace(READS[metric])) == pytest.approx(
        1e3 * 30e-6 / UNITS)


@pytest.mark.parametrize("metric", list(READS))
def test_reader_gives_none_where_its_span_launched_nothing(metric):
    assert _read(metric, _trace(READS[metric], launches=False)) is None
    # the other readers' events alone
    others = [e for e in _trace("aten::mm")
              if e["name"] != READS[metric]]
    assert _read(metric, others) is None


def test_span_readers_are_entries_of_the_frames_cell():
    cell = spec.find_cell("frames-train-b256")
    names = [m["name"] for m in cell.per_layer]
    assert set(READS) <= set(names)
    assert not set(READS) & {m["name"] for m in
                             spec.find_cell("fusion-train-b256").per_layer}
