#!/usr/bin/env python
"""Static roofline of the port's train step: the counterpart of
tools/cost_report.py.

Traces (never runs on data, never touches a card) the fusion or frames
train step of tools/bench_torch.py's configuration (its MAAVSS_BENCH_*
variables: full encode on float16 rows by default) at a batch and dtype,
once over fake CPU tensors, and prints exp/profiling.compile_report:
GFLOPs (matrix products and convolutions), bytes moved op by op (an upper
bound), arithmetic intensity, the compute- and memory-bound speed-of-light
step times on an H100 and, with --measured_ms (tools/bench_torch.py's
step_ms at the same configuration, on the card), the achieved compute and
HBM shares. The model is built on the CPU with real weights (seeded);
the batch is the bench's synthetic one.

Usage:
  python tools/cost_report_torch.py --regime fusion --batch 256 --measured_ms 16.61
  python tools/cost_report_torch.py --regime frames --batch 8 --json
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, Mapping, Optional

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def report(regime: str = "fusion", batch: int = 256, dtype: str = "bfloat16",
           measured_ms: Optional[float] = None,
           peak_tflops: Optional[float] = None,
           hbm_gbps: Optional[float] = None,
           env: Optional[Mapping[str, str]] = None,
           geometry: Optional[Mapping] = None) -> Dict:
    """compile_report of one train step of bench_torch's configuration for
    `regime`, `batch` and `dtype` (`env` over os.environ for the other
    MAAVSS_BENCH_* variables, `geometry` RunConfig fields over the
    defaults), with the configuration's fields added."""
    import torch

    from maavss_tpu_torch.data.synthetic import (
        synthetic_av_batch,
        with_pgram_rows,
    )
    from maavss_tpu_torch.exp.profiling import compile_report
    from maavss_tpu_torch.train.setup import (
        build_frames_state,
        build_fusion_state,
    )
    from maavss_tpu_torch.train.steps import make_frames_step, make_fusion_step
    from tools.bench_torch import MODE, bench_config

    env = {**os.environ, **(env or {}), "MAAVSS_BENCH_REGIME": regime,
           "MAAVSS_BENCH_DTYPE": dtype, "MAAVSS_BENCH_MULTISTEP": "1"}
    cfg, regime, window_mode = bench_config(env, batch, geometry)
    init = torch.Generator().manual_seed(cfg.seed)
    if regime == "frames":
        _, state = build_frames_state(cfg, batch, device="cpu",
                                      generator=init)
        step = make_frames_step(state.model, cfg, device="cpu")
        data = synthetic_av_batch(cfg, batch, seed=0,
                                  frame_size=cfg.framesize)
    else:
        _, state = build_fusion_state(cfg, batch, "cpu", init)
        step = make_fusion_step(state.model, cfg, window_mode=window_mode,
                                device="cpu")
        data = synthetic_av_batch(cfg, batch, seed=0)
        if cfg.pgram_cache:
            data = with_pgram_rows(data, torch.device("cpu"))
    data = {k: torch.from_numpy(v) for k, v in data.items()}
    out = compile_report(step, state, data, MODE, peak_tflops=peak_tflops,
                         hbm_gbps=hbm_gbps, measured_ms=measured_ms,
                         compute_dtype=cfg.dtype)
    out.update(regime=regime, batch=batch, dtype=cfg.dtype,
               fusion_encode=cfg.fusion_encode, pgram_cache=cfg.pgram_cache,
               window_mode=window_mode, frames_encode=cfg.frames_encode,
               microbatch=cfg.microbatch)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--regime", choices=("fusion", "frames"), default="fusion")
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--measured_ms", type=float, default=None,
                    help="tools/bench_torch.py's step_ms at this "
                         "configuration, on the card")
    ap.add_argument("--peak_tflops", type=float, default=None,
                    help="peak TFLOP/s (default: the H100's, 67 fp32 or "
                         "989 bf16 on the tensor cores)")
    ap.add_argument("--hbm_gbps", type=float, default=None,
                    help="HBM GB/s (default: the H100's 3350)")
    ap.add_argument("--json", action="store_true", help="print the raw dict")
    args = ap.parse_args()

    from maavss_tpu_torch.exp.profiling import format_report

    r = report(args.regime, args.batch, args.dtype, args.measured_ms,
               args.peak_tflops, args.hbm_gbps)
    if args.json:
        print(json.dumps(r))
    else:
        print(f"== {args.regime} step, b{args.batch} {r['dtype']}"
              + (" (pgram cache)" if r["pgram_cache"] else ""))
        print(format_report(r))


if __name__ == "__main__":
    main()
