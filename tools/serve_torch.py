#!/usr/bin/env python
"""Serving daemon of the PyTorch port: HTTP separation endpoint with dynamic
batching, on one CUDA device (the port's counterpart of tools/serve.py).

Keeps the model's weights on the device, coalesces concurrent requests
into batches of `--batch_size` rows, and serves:

  POST /v1/separate   npz{audio [b,S], visual [b,T,p,p]}  ->  npz{audio_out [b,S]}
                      (--pgram_cache: visual float16 phasegram rows [b,T,p*p];
                      --model frames: visual uint8 [b,T,framesize,framesize])
  GET  /healthz       geometry + input specs
  GET  /stats         request/batch counters + latency percentiles

`--artifact m.pt2` serves a separator exported by
tools/export_model_torch.py: its sidecar's geometry is checked against the
model flags given (and its batch against --batch_size, its family against
--model), it is warmed up and served, /healthz reports its sidecar, and the
process loads no model code (no `maavss_tpu_torch.models` or `train`
module). An artifact traced on the card serves on the card only.
`--weights file.npz` loads a flax checkpoint saved with
maavss_tpu_torch.convert.save_npz (into the artifact's program, strictly,
with --artifact); without it the weights are a seeded init (--seed) or the
artifact's own. `--fusion_encode full` serves the full-encode separator.
`--model` picks the fusion model (default) or the frames
model (latent width 16, frames at --framesize; `--frames_encode full`
serves its full-encode separator). `--dtype bfloat16` serves
the bf16 model (the replies keep their wire dtypes). The CUDA kernels build
at startup, through a warm-up call. TF32 is off on the card.

Usage: python tools/serve_torch.py [--model fusion|frames] [--port 8423]
       [--max_wait_ms 5] [--weights w.npz] [--device cuda]
       [--artifact m.pt2] [model flags...]
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import threading

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--model", choices=("fusion", "frames"), default="fusion")
    pre.add_argument("--host", default="127.0.0.1")
    pre.add_argument("--port", type=int, default=8423)
    pre.add_argument("--max_wait_ms", type=float, default=5.0,
                     help="max time a partial batch waits for more rows")
    pre.add_argument("--weights", default=None,
                     help="flax weights as npz (convert.save_npz)")
    pre.add_argument("--device", default="cuda")
    pre.add_argument("--artifact", default=None,
                     help="a .pt2 of tools/export_model_torch.py to serve")
    own, rest = pre.parse_known_args()
    frames_model = own.model == "frames"

    import torch

    from maavss_tpu_torch.config import model_args
    from maavss_tpu_torch.exp.serving import BatchingExecutor, SeparationServer

    cfg = model_args(rest)
    device = torch.device(own.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("serve_torch: CUDA is not available (pass "
                             "--device cpu to serve with the plain PyTorch "
                             "versions)")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    if own.artifact:
        serving_fn, audio_spec, visual_spec, info = _artifact(
            own, cfg, frames_model)
    else:
        serving_fn, audio_spec, visual_spec, info = _live(
            own, cfg, frames_model, device)
    # warm-up: builds the kernels and the library handles before the first
    # request arrives
    serving_fn(torch.zeros(audio_spec.shape, device=device),
               torch.zeros(visual_spec.shape, device=device,
                           dtype=getattr(torch, visual_spec.dtype.name)))
    executor = BatchingExecutor(serving_fn, audio_spec.shape[0], audio_spec,
                                visual_spec, device,
                                max_wait_ms=own.max_wait_ms)
    info = {"model": own.model, "platform": device.type,
            "device": (torch.cuda.get_device_name(device)
                       if device.type == "cuda" else "cpu"), **info}
    server = SeparationServer(executor, info, host=own.host,
                              port=own.port).start()
    print(json.dumps({"serving": f"http://{own.host}:{server.address[1]}",
                      **info}), flush=True)

    stop = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: stop.set())
    stop.wait()
    print(json.dumps({"shutdown": True, **executor.snapshot()}), flush=True)
    server.stop()


def _artifact(own, cfg, frames_model: bool):
    """(serving fn, audio spec, visual spec, /healthz fields) of an
    exported artifact, its sidecar checked against the flags."""
    from maavss_tpu_torch.exp.artifact import (
        artifact_serving_fn, input_specs, load_artifact,
    )

    program, meta = load_artifact(own.artifact, cfg, own.weights)
    if meta.get("frames_model") != frames_model:
        raise ValueError(f"artifact {own.artifact} is a "
                         f"{'frames' if meta.get('frames_model') else 'fusion'}"
                         f" model, --model {own.model}")
    if meta.get("batch") != cfg.batch_size:
        raise ValueError(f"artifact {own.artifact} was exported at batch "
                         f"{meta.get('batch')}, --batch_size "
                         f"{cfg.batch_size}")
    return (artifact_serving_fn(program), *input_specs(meta),
            {"artifact": os.path.abspath(own.artifact), "sidecar": meta})


def _live(own, cfg, frames_model: bool, device):
    """(serving fn, audio spec, visual spec, /healthz fields) of a model
    built from the flags, with --weights or a seeded init."""
    from maavss_tpu_torch.convert import from_flax, load_npz
    from maavss_tpu_torch.exp.export import (
        make_serving_fn, serving_info, serving_input_specs,
    )
    from maavss_tpu_torch.train.setup import build_frames_model, build_fusion

    build = build_frames_model if frames_model else build_fusion
    model = build(cfg, cfg.batch_size, device=device)
    if own.weights:
        params, batch_stats = load_npz(own.weights)
        model.load_state_dict(from_flax(params, batch_stats), strict=True)
    return (make_serving_fn(model, cfg, frames_model),
            *serving_input_specs(cfg, cfg.batch_size, frames_model),
            serving_info(cfg, cfg.batch_size, frames_model))


if __name__ == "__main__":
    main()
