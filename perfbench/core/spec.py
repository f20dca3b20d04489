"""The benchmark's data, found by name: `BENCHMARK.json` at the checkout's
root names the cells; a cell names its configuration (the `file` of its
`configs` entry) and its traffic (`perfbench/traffic/<traffic>.json`).
Each of these is a file of its own under `perfbench/`:

- `metrics/<m>.py`: the reader of per-layer metric `m`;
- `runners/<kind>.py`: the runner of a traffic's `kind` (its `Runner`);
- `families/<family>.py`: a configuration's `family`: the port's model
  and step, its plain reference, its work by shape;
- `launches/<counter>.json`: the kernels a call counted by one of the
  port's launch counters launches;
- `limits/<cell>.json`: the limits of a cell's check.

Adding a cell, a configuration, a traffic mix, a kind, a family or a
metric adds files and entries and edits none."""

from __future__ import annotations

import importlib.util
import json
import os
import sys
from dataclasses import dataclass
from types import ModuleType
from typing import Dict, List, Tuple

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)


@dataclass
class Cell:
    name: str
    chips: int
    config: Dict  # the configuration file's object
    traffic: Dict  # the traffic file's object
    end_to_end: List[Dict]  # BENCHMARK.json entries reported here
    per_layer: List[Dict]


def load_json(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def _reported(metric: Dict, cell: str, end_to_end: List[str]) -> bool:
    """A metric with `workloads` is reported in those cells; one without,
    in every cell (an end-to-end metric), or in every cell that reports
    the end-to-end metric it moves (a per-layer metric)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in end_to_end


def find_cell(name: str, root: str = ROOT) -> Cell:
    """The cell `name` of `root`/BENCHMARK.json with its files read;
    KeyError names a cell the file lacks."""
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(os.path.join(root, configs[w["config"]]["file"]))
    traffic = load_json(os.path.join(root, "perfbench", "traffic",
                                     w["traffic"] + ".json"))
    e2e = [m for m in bench["end_to_end"] if _reported(m, name, [])]
    names = [m["name"] for m in e2e]
    per = [m for m in bench["per_layer"] if _reported(m, name, names)]
    return Cell(name, int(w["chips"]), config, traffic, e2e, per)


def load(folder: str, name: str, root: str = ROOT) -> ModuleType:
    """The module perfbench/<folder>/<name>.py of the checkout `root`."""
    path = os.path.join(root, "perfbench", folder, name + ".py")
    tag = f"perfbench_{folder}_{name}".replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(tag, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[tag] = module
    spec.loader.exec_module(module)
    return module


def metric(name: str, root: str = ROOT) -> ModuleType:
    """The reader of metric `name`: `read(ctx) -> float | None`, and
    optionally `UNDER` ({key: predicate on a host op of the trace}: the
    trace's `under[key]` is the device seconds launched under matching
    ops) and `RECORD_SHAPES` (the trace records the ops' input shapes)."""
    return load("metrics", name, root)


def launches(root: str = ROOT) -> Dict[str, Tuple[Tuple[str, ...], int]]:
    """{launch counter of the port: (the kernels a counted call launches,
    launches a call)}, from perfbench/launches/<counter>.json."""
    folder = os.path.join(root, "perfbench", "launches")
    out = {}
    for f in sorted(os.listdir(folder)):
        if f.endswith(".json"):
            d = load_json(os.path.join(folder, f))
            out[f[:-5]] = (tuple(d["kernels"]), int(d["per_call"]))
    return out
