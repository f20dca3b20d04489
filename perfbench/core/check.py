"""The numbers that decide `correct`, and their limits.

Training (the program's first steps against the reference's, from the
same weights, batches and noise):
- `loss_gap`: the largest |program loss - reference loss| / |reference
  loss| over steps 1-3 and the first three steps of the warm-up
  dispatch (under CUDA graphs, the first replay);
- `grad_gap`: the median over the counted leaves of each leaf's gap
  between the program's and the reference's L2 norm of the step-1
  gradient, over the reference's norm of that leaf or of the median
  counted leaf, whichever is larger;
- `change_gap`: the same of each leaf's change after the three steps;
- `replay_change_gap` (where a dispatch takes K > 1 steps as a CUDA
  graph): the same of each leaf's change over the warm-up dispatch's K
  steps, the first replay of the graph the window replays: a replay
  that drops or doubles the update reads about 1.
The median leaf and not the worst: in bfloat16 the step-1 gradient of
the phasegram encoder's first layers, after the backward of nine
BatchNorm-tanh layers, swings from seed to seed by up to twice the
reference's on both of the program's encoder paths (its kernel and
cuDNN), and as far as the float8 control's; the median leaf reads a
tenth of the control's, steadily. The worst leaves are printed.
A leaf is counted where the reference's step-1 gradient norm is at least
a thousandth of the median nonzero leaf's: a conv bias ahead of a
train-mode BatchNorm has a gradient of nought but rounding, and the
decoders none at all.

Each cell's limits are in perfbench/limits/<cell>.json; `correct` holds
where every number is finite and within its limit.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import sys
from typing import Dict, List, Tuple

from perfbench.core.spec import ROOT


def limits(cell: str, root: str = ROOT) -> Dict[str, float]:
    with open(os.path.join(root, "perfbench", "limits", cell + ".json")) as f:
        return json.load(f)["limits"]


def counted_leaves(ref_grads: Dict[str, float]) -> List[str]:
    nonzero = [v for v in ref_grads.values() if v > 0.0]
    floor = 1e-3 * statistics.median(nonzero)
    return [k for k, v in ref_grads.items() if v >= floor and v > 0.0]


def _median_gap(prog: Dict[str, float], ref: Dict[str, float],
           leaves: List[str], what: str) -> float:
    med = statistics.median(ref[k] for k in leaves)
    gaps = sorted(((abs(prog[k] - ref[k]) / max(ref[k], med), k)
                   for k in leaves), reverse=True)
    values = sorted(g for g, _ in gaps)
    print(f"perfbench: {what}: median leaf {med!r}; leaves' gaps: median "
          f"{statistics.median(values):.4g}, 90th "
          f"{values[int(0.9 * (len(values) - 1))]:.4g}; largest "
          + ", ".join(f"{k} {g:.4g} ({prog[k]:.4g} vs {ref[k]:.4g})"
                      for g, k in gaps[:3]), file=sys.stderr)
    return statistics.median(values)


def train_numbers(prog: Dict, ref: Dict) -> Dict[str, float]:
    """{number: value} of a program's first steps against the reference's
    (each a dict of `losses` by step, `grad_norms`, and `changes` {(from
    step, to step): each leaf's change norm}). The losses are compared at
    the program's steps; the changes over (0, 3) and, where the program
    reads one, over a later span (the warm-up dispatch)."""
    if set(prog["grad_norms"]) != set(ref["grad_norms"]):
        raise ValueError("the program and the reference name other leaves")
    leaves = counted_leaves(ref["grad_norms"])
    grads = ref["grad_norms"]
    near = sorted((v, k) for k, v in grads.items() if v > 0.0)
    print(f"perfbench: {len(leaves)} leaves counted of {len(grads)}; the "
          "smallest nonzero reference gradients "
          + ", ".join(f"{k} {v:.3g}" for v, k in near[:6]), file=sys.stderr)
    per_step = {i: abs(p - ref["losses"][i]) / abs(ref["losses"][i])
                for i, p in prog["losses"].items()}
    print("perfbench: loss gaps by step "
          + ", ".join(f"{i}: {g:.3g}" for i, g in per_step.items()),
          file=sys.stderr)
    loss = max(per_step.values())
    grad = _median_gap(prog["grad_norms"], grads, leaves, "grad_gap")
    out = {"loss_gap": loss, "grad_gap": grad}
    spans = sorted(prog["changes"])
    if spans[0] != (0, 3) or len(spans) > 2:
        raise ValueError(f"changes read over {spans}")
    for span, name in zip(spans, ("change_gap", "replay_change_gap")):
        out[name] = _median_gap(prog["changes"][span], ref["changes"][span],
                                leaves, f"{name} over steps {span[0] + 1}-"
                                f"{span[1]}")
    return out


def verdict(numbers: Dict[str, float], lim: Dict[str, float]
            ) -> Tuple[bool, Dict[str, Dict[str, float]]]:
    """(correct, {number: {value, limit}}), each number also printed to
    standard error beside its limit. A number without a limit, or a limit
    whose number the run did not read, is an error of the cell."""
    missing = set(numbers) ^ set(lim)
    if missing:
        raise ValueError(f"numbers and limits differ: {sorted(missing)}")
    table, ok = {}, True
    for name, value in numbers.items():
        limit = lim[name]
        good = math.isfinite(value) and value <= limit
        ok = ok and good
        table[name] = {"value": value, "limit": limit}
    for name, row in table.items():
        print(f"check {name} {row['value']!r} limit {row['limit']!r}",
              file=sys.stderr)
    return ok and bool(table), table
