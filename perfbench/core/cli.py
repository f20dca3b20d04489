"""One run of one cell: set-up, the measured window (or, with --trace 1, a
traced window), the check against the plain reference, and the result's
line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
                             --trace <0|1>

Everything that belongs to one cell is found by name (core/spec.py): the
traffic's `kind` names its runner, perfbench/runners/<kind>.py, whose
`Runner(family, run, traffic, seed, device, fault)` does the set-up
(`first_steps`), the window (`window(seconds)`: the end-to-end values by
metric name), the traced units (`traced_units`), the failed units
(`failed`) and the check's numbers (`numbers`; `control`); the
configuration's `family` names perfbench/families/<family>.py; each
per-layer metric is read by perfbench/metrics/<name>.py, which may ask
the trace for the device time under host ops of its choosing (`UNDER`,
`RECORD_SHAPES`).

The last line of standard output is the result: `correct`, `attempted`,
`failed`, `metrics` (the cell's end-to-end metrics, or with --trace 1 its
per-layer ones), `device`, with --trace 1 `breakdown` and the launch
cross-check, and last `check`, each number compared beside its limit
(also the last lines of standard error). A run on a machine without the
CUDA devices the cell asks for exits with 2 and prints no result; a run
whose process holds JAX or the JAX package once the window and the check
are over exits with 3 and prints none either.

For setting limits and looking at the program, never in the benchmark's
runs: `--control float8` puts the plain reference, computed in that
precision, in the program's place and reads the check's numbers alone;
`--fault <name>` plants a fault in the program (the runner's `FAULTS`);
`--set key=value` replaces a key of the configuration's `run` (another
path of the program, as a second witness).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from typing import Dict, List, Optional

import torch

from perfbench.core import check, program, spec
from perfbench.core.readers import Context
from perfbench.core.trace import traced
from perfbench.reference.layers import plain_numerics

FORBIDDEN = ("jax", "jaxlib", "flax", "maavss_tpu")


def forbidden_modules() -> List[str]:
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def card() -> Dict:
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        line = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
        name, limit = (s.strip() for s in line.split(","))
        return {"smi_name": name, "power_limit": limit}
    except (OSError, IndexError, ValueError, subprocess.SubprocessError):
        return {"smi_name": None, "power_limit": None}


def launch_check(counted: Dict[str, int], seen: Dict[str, tuple],
                 table: Dict[str, tuple]) -> Dict[str, List[int]]:
    """{counter: [launches the counters give, launches the profiler saw]}
    for each hand-written kernel that ran and `table` (spec.launches)
    names; a mismatch, or a counter the table lacks, is printed."""
    out = {}
    for name, n in counted.items():
        if n <= 0:
            continue
        if name not in table:
            print(f"perfbench: launch counter {name} ran {n} times and "
                  "perfbench/launches/ names no kernels for it",
                  file=sys.stderr)
            continue
        kernels, per_call = table[name]
        got = sum(seen.get(k, (0, 0.0))[0] for k in kernels)
        out[name] = [n * per_call, got]
        if got != n * per_call:
            print(f"perfbench: launch mismatch {name}: the counters give "
                  f"{n * per_call} launches of {list(kernels)}, the "
                  f"profiler saw {got}", file=sys.stderr)
    return out


def trace_requests(readers: Dict[str, object]):
    """(record shapes?, {key: predicate}) gathered from the metrics'
    readers; two readers asking under one key is an error."""
    under: Dict = {}
    for name, mod in readers.items():
        for key, pred in getattr(mod, "UNDER", {}).items():
            if key in under:
                raise ValueError(f"metric {name} asks the trace under "
                                 f"{key!r}, which another metric uses")
            under[key] = pred
    shapes = any(getattr(mod, "RECORD_SHAPES", False)
                 for mod in readers.values())
    return shapes, under


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device: torch.device, t_start: float, root: str = spec.ROOT,
             fault: Optional[str] = None, control: Optional[str] = None,
             overrides: Optional[Dict] = None) -> Dict:
    """The result's dict of one run. `overrides` replace keys of the
    configuration's `run` and of the traffic (small sizes, for tests)."""
    cell = spec.find_cell(workload, root)
    run = dict(cell.config["run"], **(overrides or {}).get("run", {}))
    traffic = dict(cell.traffic, **(overrides or {}).get("traffic", {}))
    fam = spec.load("families", cell.config["family"], root)
    on_card = device.type == "cuda"
    plain_numerics()
    runner = spec.load("runners", traffic["kind"], root).Runner(
        fam, run, traffic, seed, device, fault)
    lim = check.limits(workload, root)
    if control is not None:
        ok, table = check.verdict(runner.control(control), lim)
        return {"correct": ok, "attempted": 0, "failed": 0, "metrics": {},
                "device": {}, "control": control, "check": table}
    runner.first_steps()
    setup_s = time.perf_counter() - t_start
    metrics: Dict[str, Dict] = {}
    extra: Dict = {}
    if not trace:
        values, attempted, info = runner.window(seconds)
        values["setup_s"] = setup_s
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
        print(f"perfbench: window {json.dumps(info)}", file=sys.stderr)
    else:
        readers = {m["name"]: spec.metric(m["name"], root)
                   for m in cell.per_layer}
        shapes, under = trace_requests(readers)
        before = program.kernel_counters()
        attempted, tr, read_s = traced(runner.traced_units(), device,
                                       record_shapes=shapes, under=under)
        after = program.kernel_counters()
        counted = {k: after[k] - before[k] for k in after}
        ctx = Context(fam, run, traffic, tr, attempted, counted)
        for m in cell.per_layer:
            value = readers[m["name"]].read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        extra["busy_s"] = tr.busy_s
        extra["window_s"] = tr.window_s
        extra["breakdown"] = {
            "device_ops": [[n, s] for n, s in tr.device_ops[:10]],
            "idle_gaps": [[n, s] for n, s in tr.gaps[:10]]}
        extra["launch_check"] = launch_check(counted, tr.kernels,
                                             spec.launches(root))
        print(f"perfbench: traced {attempted} units in {tr.window_s} s, "
              f"busy {tr.busy_s} s; trace read in {read_s} s",
              file=sys.stderr)
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    failed = runner.failed()
    ok, table = check.verdict(runner.numbers(), lim)
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    if trace:
        dev.update(busy_s=extra["busy_s"], window_s=extra["window_s"])
    if on_card:
        dev.update(card())
    result = {"correct": ok and failed == 0, "attempted": int(attempted),
              "failed": int(failed), "metrics": metrics, "device": dev}
    for key in ("breakdown", "launch_check"):
        if key in extra:
            result[key] = extra[key]
    result["check"] = table
    return result


def main(argv=None, t_start: Optional[float] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--fault", default=None)
    p.add_argument("--control", default=None)
    p.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                   help="replace a key of the configuration's run (a look "
                        "at another path of the program; not for the "
                        "benchmark's runs)")
    args = p.parse_args(argv)
    run = {}
    for item in args.set:
        key, value = item.split("=", 1)
        try:
            run[key] = json.loads(value)
        except ValueError:
            run[key] = value
    t_start = time.perf_counter() if t_start is None else t_start
    cell = spec.find_cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"perfbench: {args.workload} needs {cell.chips} CUDA "
              f"device(s); torch.cuda.is_available() is "
              f"{torch.cuda.is_available()}", file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), torch.device("cuda", 0), t_start,
                      fault=args.fault, control=args.control,
                      overrides={"run": run} if run else None)
    found = forbidden_modules()
    if found:
        print(f"perfbench: the process holds {found}", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    return 0
