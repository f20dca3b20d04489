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

`--weights file.npz` loads a flax checkpoint saved with
maavss_tpu_torch.convert.save_npz; without it the weights are a seeded
init (--seed). `--fusion_encode full` serves the full-encode separator.
`--model` picks the fusion model (default) or the frames
model (latent width 16, frames at --framesize; `--frames_encode full`
serves its full-encode separator). `--dtype bfloat16` serves
the bf16 model (the replies keep their wire dtypes). The CUDA kernels build
at startup, through a warm-up call.

Usage: python tools/serve_torch.py [--model fusion|frames] [--port 8423]
       [--max_wait_ms 5] [--weights w.npz] [--device cuda] [model flags...]
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
    own, rest = pre.parse_known_args()
    frames_model = own.model == "frames"

    import torch

    from maavss_tpu_torch.config import model_args
    from maavss_tpu_torch.convert import from_flax, load_npz
    from maavss_tpu_torch.exp.export import (
        make_serving_fn, random_serving_inputs, serving_info,
        serving_input_specs,
    )
    from maavss_tpu_torch.exp.serving import BatchingExecutor, SeparationServer
    from maavss_tpu_torch.train.setup import build_frames_model, build_fusion

    cfg = model_args(rest)
    device = torch.device(own.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("serve_torch: CUDA is not available (pass --device "
                         "cpu to serve with the plain PyTorch versions)")
    build = build_frames_model if frames_model else build_fusion
    model = build(cfg, cfg.batch_size, device=device)
    if own.weights:
        params, batch_stats = load_npz(own.weights)
        model.load_state_dict(from_flax(params, batch_stats), strict=True)
    serving_fn = make_serving_fn(model, cfg, frames_model)
    audio_spec, visual_spec = serving_input_specs(cfg, cfg.batch_size,
                                                  frames_model)
    # warm-up: builds the kernels and the library handles before the first
    # request arrives
    serving_fn(*[torch.from_numpy(x).to(device) for x in
                 random_serving_inputs(cfg, cfg.batch_size, frames_model)])
    executor = BatchingExecutor(serving_fn, cfg.batch_size, audio_spec,
                                visual_spec, device,
                                max_wait_ms=own.max_wait_ms)
    info = {
        "model": own.model,
        "platform": device.type,
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
        **serving_info(cfg, cfg.batch_size, frames_model),
    }
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


if __name__ == "__main__":
    main()
