#!/usr/bin/env python
"""Export the port's separator as a serving artifact (torch.export): the
counterpart of tools/export_model.py.

Traces the windowed separator of the fusion or frames model (feature prep,
the model over every sliding window, the overlap stitch, the iSTFT) at
`--batch_size` on `--device` into a `torch.export` program, and writes
`<out>.pt2` with its JSON sidecar (geometry, compute dtype, the registered
ops in the graph, the weights' keys and shapes). Traced on the card
(`--device cuda`, the default) the program carries the hand-written
kernels as registered ops and runs on the card alone; `--device cpu`
traces the plain versions. The weights are the program's state: a server
can load another flax checkpoint of the same geometry into it
(`tools/serve_torch.py --artifact m.pt2 --weights w.npz`).

Usage:
  python tools/export_model_torch.py --out runs/sep -b 8 [--weights w.npz]
  python tools/export_model_torch.py --model frames --out runs/frames -b 8
  python tools/export_model_torch.py --out m --selftest   # reload, compare

`--selftest` reloads the artifact in this process and holds one call on
random inputs against the live serving function: bitwise equal, or exit 1.
It prints one JSON line (artifact, bytes, device, model, batch, ops), and
with --selftest a second one.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--model", choices=("fusion", "frames"), default="fusion")
    pre.add_argument("--out", required=True, help="artifact path (.pt2)")
    pre.add_argument("--device", default="cuda")
    pre.add_argument("--weights", default=None,
                     help="flax weights as npz (convert.save_npz)")
    pre.add_argument("--selftest", action="store_true",
                     help="reload the artifact and compare one call with "
                          "the live serving function, bit for bit")
    own, rest = pre.parse_known_args()
    frames_model = own.model == "frames"

    import torch

    from maavss_tpu_torch.config import model_args
    from maavss_tpu_torch.convert import from_flax, load_npz
    from maavss_tpu_torch.exp.artifact import artifact_serving_fn
    from maavss_tpu_torch.exp.export import (
        export_separator, graph_op_counts, load_artifact, make_serving_fn,
        random_serving_inputs, save_artifact,
    )
    from maavss_tpu_torch.train.setup import build_frames_model, build_fusion

    cfg = model_args(rest)
    device = torch.device(own.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("export_model_torch: CUDA is not available "
                             "(pass --device cpu to export the plain "
                             "PyTorch versions)")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    build = build_frames_model if frames_model else build_fusion
    model = build(cfg, cfg.batch_size, device=device)
    if own.weights:
        model.load_state_dict(from_flax(*load_npz(own.weights)), strict=True)
    program = export_separator(model, cfg, cfg.batch_size, frames_model)
    path = save_artifact(own.out, program, cfg, cfg.batch_size, frames_model)
    print(json.dumps({"artifact": path, "bytes": os.path.getsize(path),
                      "device": device.type, "model": own.model,
                      "batch": cfg.batch_size,
                      "ops": graph_op_counts(program)}), flush=True)

    if own.selftest:
        loaded, _ = load_artifact(path, cfg)
        audio, visual = (torch.from_numpy(x).to(device) for x in
                         random_serving_inputs(cfg, cfg.batch_size,
                                               frames_model))
        got = artifact_serving_fn(loaded)(audio, visual)
        want = make_serving_fn(model, cfg, frames_model)(audio, visual)
        same = bool(torch.equal(got, want))
        err = float((got - want).abs().max())
        print(json.dumps({"selftest_max_abs_diff": err, "bitwise_equal": same,
                          "ok": same}), flush=True)
        if not same:
            raise SystemExit(1)


if __name__ == "__main__":
    main()
