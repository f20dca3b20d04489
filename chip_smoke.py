#!/usr/bin/env python3
"""Drive the PyTorch port (`maavss_tpu_torch`) once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each, any failure exits non-zero (nothing is caught):

1. device: needs CUDA; prints the card's name and power limit (nvidia-smi),
   the torch / CUDA versions, and turns TF32 off for matmuls and cuDNN so
   the fp32 slice is held in fp32.
2. build: compiles every kernel of the serving path from `csrc/` (nvcc).
3. K1 (LSTM recurrence): the kernel against its plain version at the slice
   shapes (T=8, B=8 and 32, H=256, fp32 and bf16, both directions in one
   launch), with errors, tolerance and median times.
4. K2 (fused phasegram-encoder layer): the kernel against its plain version
   at each of the 10 planned layers of the flagship encoder (R=64 rows).
5. slice: the full-width fusion model (seeded random weights) behind the
   HTTP SeparationServer on 127.0.0.1; 8 requests of 1..8 rows; every
   response checked for shape, finiteness and agreement with the direct
   separator built from the plain versions on the same weights; request
   p50/p90 and both kernels' launch counts from that run; before it, the
   direct serving call's time (kernels vs plain versions) and a
   torch.profiler breakdown of it by CUDA kernel.
6. golden: the small-geometry JAX reference of
   tests/fixtures/torch_port_golden.npz, run through the port's kernels.

The line before the last is one JSON object with each kernel's launches,
error and times; the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, "tests", "fixtures", "torch_port_golden.npz")


def phase(label: str, **fields) -> None:
    print(json.dumps({"phase": label, **fields}), flush=True)


def cuda_ms(fn, reps: int = 5, iters: int = 20) -> float:
    """Median over `reps` of the mean time of `iters` back-to-back calls,
    from CUDA events, after a warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop) / iters)
    return statistics.median(times)


def max_err(got, want):
    d = (got.float() - want.float()).abs()
    return d.max().item(), (d / want.float().abs().clamp(min=1e-3)).max().item()


def device_phase():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; the "
                         "port's kernels need an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase("device", nvidia_smi=smi, torch=torch.__version__,
          cuda=torch.version.cuda, name=torch.cuda.get_device_name(0),
          count=torch.cuda.device_count(), tf32="off (matmul and cuDNN)")
    return smi


def build_phase():
    from maavss_tpu_torch.ops import _build

    res = _build.build()
    _build.library()
    regs = [ln.strip() for ln in res.log.splitlines() if "registers" in ln]
    phase("build", seconds=round(res.seconds, 3), library=os.path.relpath(
        res.path, ROOT), ptxas=regs)


def lstm_phase():
    import torch

    from maavss_tpu_torch.ops.cuda_lstm import (
        lstm_recurrence,
        lstm_recurrence_plain,
    )

    g = torch.Generator(device="cuda").manual_seed(1)
    t_len, h = 8, 256
    report = None
    for b in (8, 32):
        for dtype, atol, rtol in ((torch.float32, 1e-5, 1e-5),
                                  (torch.bfloat16, 1e-5, 2.0 ** -7)):
            xws = [torch.randn(b, t_len, 4 * h, device="cuda", generator=g)
                   .to(dtype) for _ in range(2)]
            whs = [(torch.randn(h, 4 * h, device="cuda", generator=g) / 16)
                   .to(dtype) for _ in range(2)]
            rev = [False, True]

            def kernel():
                return lstm_recurrence(xws, whs, rev, backend="kernel")

            def plain():
                return [lstm_recurrence_plain(x, w, r)
                        for x, w, r in zip(xws, whs, rev)]

            got, want = kernel(), plain()
            torch.cuda.synchronize()
            err = 0.0
            for (ys, cs), (ys_r, cs_r) in zip(got, want):
                for a, w in ((ys, ys_r), (cs, cs_r)):
                    ok = torch.allclose(a.float(), w.float(), atol=atol,
                                        rtol=rtol)
                    if not ok:
                        raise SystemExit(f"K1 lstm disagrees at B={b} "
                                         f"{dtype}: {max_err(a, w)}")
                    err = max(err, max_err(a, w)[0])
            ms, plain_ms = cuda_ms(kernel), cuda_ms(plain)
            phase("k1_lstm", B=b, T=t_len, H=h, dtype=str(dtype),
                  directions=2, max_abs_err=err, atol=atol, rtol=rtol,
                  ms=ms, plain_ms=plain_ms)
            if b == 8 and dtype == torch.float32:
                report = (err, ms, plain_ms)
    return report


def pgenc_phase():
    import torch

    from maavss_tpu_torch.config import RunConfig
    from maavss_tpu_torch.models.shape_plan import plan_phasegram_encoder
    from maavss_tpu_torch.ops.cuda_pgenc import pgenc_layer, pgenc_layer_plain

    cfg = RunConfig()
    specs, _ = plan_phasegram_encoder(
        (8, 1, cfg.num_frames, cfg.p_size ** 2), cfg.latent_chan, cfg.fc_size)
    if len(specs) != 10:
        raise SystemExit(f"expected the 10-layer flagship encoder, got "
                         f"{len(specs)}")
    g = torch.Generator(device="cuda").manual_seed(2)
    r = 8 * cfg.num_frames
    totals = {"err": 0.0, "ms": 0.0, "plain_ms": 0.0}
    for dtype, atol in ((torch.float32, 1e-5), (torch.bfloat16, 2.0 ** -7)):
        s = cfg.p_size ** 2
        for i, sp in enumerate(specs):
            c, co = sp.in_ch, sp.out_ch
            x = torch.randn(c, r, s, device="cuda", generator=g).to(dtype)
            w2 = (torch.randn(co, 9 * c, device="cuda", generator=g)
                  / (3.0 * c ** 0.5)).to(dtype)
            cb, beta, mean = (torch.randn(co, device="cuda", generator=g)
                              * 0.1 for _ in range(3))
            gamma = 1.0 + 0.1 * torch.randn(co, device="cuda", generator=g)
            var = 0.5 + torch.rand(co, device="cuda", generator=g)
            vecs = (cb, gamma, beta, mean, var)
            y = pgenc_layer(x, w2, *vecs, backend="kernel")
            y_ref = pgenc_layer_plain(x, w2, *vecs)
            torch.cuda.synchronize()
            err = max_err(y, y_ref)[0]
            if not torch.allclose(y.float(), y_ref.float(), atol=atol, rtol=0):
                raise SystemExit(f"K2 pgenc disagrees at layer {i} {dtype}: "
                                 f"{err} > {atol}")
            ms = cuda_ms(lambda: pgenc_layer(x, w2, *vecs, backend="kernel"))
            plain_ms = cuda_ms(lambda: pgenc_layer_plain(x, w2, *vecs))
            phase("k2_pgenc", layer=i, C=c, Co=co, R=r, S=s, dtype=str(dtype),
                  max_abs_err=err, atol=atol, ms=ms, plain_ms=plain_ms)
            if dtype == torch.float32:
                totals["err"] = max(totals["err"], err)
                totals["ms"] += ms
                totals["plain_ms"] += plain_ms
            s //= 2
    phase("k2_pgenc_stack", layers=len(specs), R=r, dtype="torch.float32",
          ms=totals["ms"], plain_ms=totals["plain_ms"])
    return totals


def profile_phase(serve, dev, calls: int = 3):
    """Where a direct batch-8 serving call spends its time: torch.profiler's
    CUDA kernel events over `calls` calls, summed by kernel name, against the
    host-clock wall time of the same window (the device's idle share)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            serve(*dev)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.device_time_total > 0]
    busy_ms = sum(e.device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.device_time_total)[:12]
    phase("profile", calls=calls, wall_ms=wall_ms, device_busy_ms=busy_ms,
          idle_share=(1.0 - busy_ms / wall_ms) if busy_ms else None,
          kernel_launches=sum(e.count for e in kernels),
          top=[{"kernel": e.key[:80], "ms": e.device_time_total / 1e3,
                "count": e.count} for e in top])


def _rel_l2(a, b) -> float:
    import numpy as np

    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12))


def slice_phase():
    import numpy as np
    import torch

    from maavss_tpu_torch.config import RunConfig
    from maavss_tpu_torch.exp.export import (
        make_serving_fn,
        random_serving_inputs,
        serving_input_specs,
    )
    from maavss_tpu_torch.exp.serving import (
        BatchingExecutor,
        SeparationClient,
        SeparationServer,
    )
    from maavss_tpu_torch.ops.cuda_lstm import lstm_recurrence
    from maavss_tpu_torch.ops.cuda_pgenc import pgenc_layer
    from maavss_tpu_torch.train.setup import build_fusion

    batch, tol = 8, 1e-4
    cfg = RunConfig(batch_size=batch)
    t0 = time.perf_counter()
    model = build_fusion(cfg, batch, "cuda",
                         torch.Generator().manual_seed(cfg.seed))
    ref = build_fusion(cfg.replace(pgenc_kernel="xla"), batch, "cuda",
                       torch.Generator().manual_seed(cfg.seed + 1))
    ref.load_state_dict(model.state_dict())
    ref.lstm.backend = "scan"
    build_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    if model.pgenc_kernel != "pallas":
        raise SystemExit("the auto phasegram-encoder gate did not take the "
                         "kernel stack on CUDA")
    serve, serve_ref = make_serving_fn(model, cfg), make_serving_fn(ref, cfg)
    a_spec, v_spec = serving_input_specs(cfg, batch)
    n_layers = len(model.phasegram_encoder.specs)

    # requests: 1..8 rows of gaussian audio and broadband frames in [0, 1]
    rng = np.random.default_rng(7)
    rows_list = [1, 8, 3, 5, 2, 8, 4, 7]
    requests = []
    for i, rows in enumerate(rows_list):
        audio, _ = random_serving_inputs(cfg, rows, seed=100 + i)
        frames = rng.uniform(0, 1, (rows,) + v_spec.shape[1:]).astype(
            np.float32)
        requests.append((audio, frames))

    # warm-up outside the counted run (cuDNN / cuBLAS handles, allocator)
    dev = [torch.from_numpy(x).cuda() for x in random_serving_inputs(cfg, batch)]
    serve(*dev)
    torch.cuda.synchronize()
    direct_ms = cuda_ms(lambda: serve(*dev), reps=3, iters=5)
    direct_plain_ms = cuda_ms(lambda: serve_ref(*dev), reps=3, iters=5)
    profile_phase(serve, dev)

    executor = BatchingExecutor(serve, batch, a_spec, v_spec, "cuda",
                                max_wait_ms=5.0)
    server = SeparationServer(executor, {"model": "fusion", "batch": batch},
                              host="127.0.0.1", port=0).start()
    host, port = server.address
    client = SeparationClient(f"http://{host}:{port}")
    lstm_recurrence.launches = 0
    pgenc_layer.launches = 0
    responses, lat_ms = [], []
    try:
        for audio, frames in requests:
            t = time.perf_counter()
            responses.append(client.separate(audio, frames))
            lat_ms.append((time.perf_counter() - t) * 1e3)
        launches = {"lstm": lstm_recurrence.launches,
                    "pgenc": pgenc_layer.launches}
        stats = client.get_json("/stats")
    finally:
        client.close()
        server.stop()

    batches = stats["batches"]
    want = {"lstm": batches * cfg.num_seq,
            "pgenc": batches * cfg.num_seq * n_layers}
    if launches != want or batches < 1:
        raise SystemExit(f"kernel launches {launches} != {want} for "
                         f"{batches} batches of {cfg.num_seq} windows")
    worst = 0.0
    for (audio, frames), out in zip(requests, responses):
        rows = audio.shape[0]
        if out.shape != audio.shape or not np.all(np.isfinite(out)):
            raise SystemExit(f"bad response {out.shape} for {audio.shape}")
        pad_a = np.zeros(a_spec.shape, np.float32)
        pad_v = np.zeros(v_spec.shape, np.float32)
        pad_a[:rows], pad_v[:rows] = audio, frames
        exp = serve_ref(torch.from_numpy(pad_a).cuda(),
                        torch.from_numpy(pad_v).cuda())[:rows].cpu().numpy()
        worst = max(worst, _rel_l2(out, exp))
    if worst > tol:
        raise SystemExit(f"served audio vs plain separator rel L2 {worst} > "
                         f"{tol}")
    lat = sorted(lat_ms)
    phase("slice", requests=len(requests), rows=rows_list, batches=batches,
          params=n_params, build_s=round(build_s, 3),
          rel_l2_vs_plain=worst, tol=tol,
          p50_ms=statistics.median(lat),
          p90_ms=lat[min(len(lat) - 1, int(0.9 * len(lat)))],
          direct_batch8_ms=direct_ms, direct_batch8_plain_ms=direct_plain_ms,
          launches=launches)
    return launches


def golden_phase():
    import numpy as np
    import torch

    from maavss_tpu_torch.config import RunConfig
    from maavss_tpu_torch.convert import from_flax, random_flax_tree, unflatten_tree
    from maavss_tpu_torch.exp.export import make_serving_fn
    from maavss_tpu_torch.ops.cuda_lstm import lstm_recurrence
    from maavss_tpu_torch.ops.cuda_pgenc import pgenc_layer
    from maavss_tpu_torch.train.setup import build_fusion

    tol = 1e-4
    with np.load(GOLDEN) as z:
        meta = json.loads(str(z["meta"]))
        audio, visual, want = z["audio"], z["visual"], z["audio_out"]
    flat = random_flax_tree({k: tuple(v) for k, v in meta["shapes"].items()},
                            meta["seed"])
    for path, total in meta["checksums"].items():
        if not np.isclose(float(flat[path].astype(np.float64).sum()), total,
                          rtol=1e-6, atol=1e-6):
            raise SystemExit(f"golden weights do not regenerate: {path}")
    tree = unflatten_tree(flat)
    cfg = RunConfig(**meta["cfg"])
    model = build_fusion(cfg, audio.shape[0], "cuda")
    model.load_state_dict(from_flax(tree["params"], tree["batch_stats"]))
    before = (lstm_recurrence.launches, pgenc_layer.launches)
    got = make_serving_fn(model, cfg)(torch.from_numpy(audio).cuda(),
                                      torch.from_numpy(visual).cuda())
    got = got.cpu().numpy()
    if (lstm_recurrence.launches, pgenc_layer.launches) <= before:
        raise SystemExit("the golden run did not go through both kernels")
    err = _rel_l2(got, want)
    if got.shape != want.shape or not np.all(np.isfinite(got)) or err > tol:
        raise SystemExit(f"port vs JAX golden: rel L2 {err} > {tol}")
    phase("golden", cfg=meta["cfg"], rel_l2_vs_jax=err, tol=tol)


def main() -> None:
    sys.path.insert(0, ROOT)
    smi = device_phase()
    build_phase()
    k1 = lstm_phase()
    k2 = pgenc_phase()
    launches = slice_phase()
    golden_phase()
    if any(m in sys.modules for m in ("jax", "flax", "maavss_tpu")):
        raise SystemExit("the port loaded jax or maavss_tpu")
    import torch

    print(json.dumps({"kernels": [
        {"name": "lstm_fwd", "route": "cuda",
         "source": "maavss_tpu_torch/csrc/lstm_fwd.cu",
         "replaces": "maavss_tpu/ops/pallas_lstm.py:80",
         "launches": launches["lstm"], "max_abs_err": k1[0],
         "ms": k1[1], "plain_ms": k1[2]},
        {"name": "pgenc_eval", "route": "cuda",
         "source": "maavss_tpu_torch/csrc/pgenc_eval.cu",
         "replaces": "maavss_tpu/ops/pallas_pgenc.py:171",
         "launches": launches["pgenc"], "max_abs_err": k2["err"],
         "ms": k2["ms"], "plain_ms": k2["plain_ms"]},
    ]}))
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
