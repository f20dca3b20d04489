"""K optimizer steps in one dispatch: --steps_per_dispatch (counterpart of
maavss_tpu/train/steps.py:_multistep and _multistep_noise).

`make_k_step(step, k, device, noise_schedule, noise_scalar)` wraps a train
step `step(state, batch, mode, generator=None, noise=None) -> (state,
metrics)` of train/steps.py into `kstep(state, batches, mode,
generator=None, noise=None) -> (state, metrics)`. Every leaf of `batches`
carries a leading K axis ([K, B, ...], numpy arrays or tensors); the K steps
run in order, each the unchanged single step on slot i of the stack, and
each metric comes back stacked [K] on the device; state.step and the
optimizer's count grow by K. One noise value covers the dispatch, as JAX's
_multistep_noise documents. k == 1 returns `step` itself.

On the CPU the K steps run eagerly. On CUDA a dispatch is one CUDA-graph
replay:

- The first call for a key (mode, noise form, batch layout) runs that
  dispatch's K steps eagerly on a side stream (the warm-up of PyTorch's
  whole-network capture: it builds the kernels, the lru-cached tables and
  K5's counters, makes every `.grad`, and gives the optimizer its gradient
  table), then captures the same K steps, reading static buffers: the
  [K, B, ...] batch and, for a tensor noise, a 0-d fp32 noise scalar.
  Capturing runs nothing, so that first dispatch's result is the eager
  steps'. The step zeroes the gradients in place, so every `.grad` keeps
  the address the graph holds, and the optimizer's gradient table is frozen
  before the capture (`FusedAdam.freeze_grad_table`).
- Every later dispatch copies `batches` into the static buffer, writes the
  noise value into the static scalar with `fill_` (outside the graph: a new
  value never re-captures) and replays the graph once.
- The random generator (`generator`, or the default CUDA generator, which
  PyTorch registers itself) is registered with the graph, so that a replay
  draws what eager steps draw from the same generator state.
- The kernels' launch counters (ops/counters.py) count what runs: what
  the capture added to them is taken back and added again on every replay.
  state.step and the optimizer's host count likewise.
- A capture or a replay that fails raises; nothing falls back to eager
  steps.

A float noise is part of the graph (its value is part of the key); under
--noise_schedule, or for a tensor noise, the graph reads the static scalar.
Another generator than the captured one raises.

Under a mesh (parallel/) a dispatch is still one replay: each rank
captures its K steps with the NCCL collectives inside (the gradient
all-reduce, the split routes' statistics), in thread-local capture mode
so that NCCL's watchdog thread may query its events meanwhile. gloo
cannot be captured (its CUDA collectives copy through the host), so a
process group over gloo with CUDA tensors raises NotImplementedError
naming "M11 (graphs over gloo)"; on CPU tensors the K steps run eagerly,
as without a mesh.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch

from maavss_tpu_torch.ops.counters import kernel_counters
from maavss_tpu_torch.parallel.mesh import current as current_mesh

Metrics = Dict[str, torch.Tensor]


def _run_steps(step: Callable, k: int, state, batches, mode, generator,
               noise) -> Tuple[object, Metrics]:
    """`step` on slots 0..k-1 of `batches`, in order; metrics stacked
    [k]."""
    per: List[Metrics] = []
    for i in range(k):
        state, m = step(state, {key: v[i] for key, v in batches.items()},
                        mode, generator, noise=noise)
        per.append(m)
    return state, {key: torch.stack([m[key] for m in per]) for key in per[0]}


def _as_stack(batches, k: int) -> Dict[str, torch.Tensor]:
    out = {key: torch.as_tensor(v) for key, v in batches.items()}
    for key, v in out.items():
        if v.ndim < 1 or v.shape[0] != k:
            raise ValueError(f"steps_per_dispatch={k}: batch leaf {key!r} "
                             f"has shape {tuple(v.shape)}, want a leading "
                             f"axis of {k} (stack_batches)")
    return out


class _Captured:
    """One captured dispatch: the graph, its static inputs and outputs, and
    what its replay adds to the launch counters."""

    def __init__(self, graph, batches, noise, packs, grown, generator):
        self.graph = graph
        self.batches = batches  # {key: [K, B, ...]} the graph reads
        self.noise = noise  # 0-d fp32 the graph reads, or None
        self.packs = packs  # [(metric names, [n, K] stacked)] it writes
        self.grown = grown  # [((object, attribute), launches a replay)]
        self.generator = generator

    def metrics(self) -> Metrics:
        """The replay's metrics, copied out of the graph's outputs (the
        next replay overwrites those)."""
        out = {}
        for names, stacked in self.packs:
            copy = stacked.clone()
            out.update(zip(names, copy))
        return out


def _pack(metrics: Metrics):
    """Metrics stacked [n, K] by dtype, so that a replay's are copied out in
    one copy a dtype."""
    groups: Dict[torch.dtype, List[str]] = {}
    for key, v in metrics.items():
        groups.setdefault(v.dtype, []).append(key)
    return [(names, torch.stack([metrics[n] for n in names]))
            for names in groups.values()]


def _copy_into(static: Dict[str, torch.Tensor], batches) -> None:
    for key, dst in static.items():
        src = batches[key]
        if src.data_ptr() != dst.data_ptr():
            dst.copy_(src)


def _set_noise(dst: torch.Tensor, value) -> None:
    if isinstance(value, torch.Tensor):
        dst.copy_(value)
    else:
        dst.fill_(float(value))


class KStep:
    """The K-step dispatch of the module docstring; `captures` counts the
    graphs captured."""

    def __init__(self, step: Callable, k: int, device, noise_schedule: bool,
                 noise_scalar: float):
        self.step, self.k = step, k
        self.device = torch.device(device)
        self.noise_schedule = noise_schedule
        self.noise_scalar = float(noise_scalar)
        self.graphs: Dict[tuple, _Captured] = {}
        self.captures = 0

    def __call__(self, state, batches, mode, generator=None, noise=None):
        batches = _as_stack(batches, self.k)
        if self.device.type != "cuda":
            return _run_steps(self.step, self.k, state, batches, mode,
                              generator, noise)
        mesh = current_mesh()
        if mesh is not None and mesh.backend == "gloo":
            raise NotImplementedError(
                "--steps_per_dispatch > 1 on the card under a gloo process "
                "group: gloo's CUDA collectives copy through the host and "
                "cannot be captured in a CUDA graph (ROADMAP M11 (graphs "
                "over gloo)); use NCCL, or --steps_per_dispatch 1")
        if isinstance(noise, torch.Tensor) or self.noise_schedule:
            form = "tensor"
            value = self.noise_scalar if noise is None else noise
        else:
            value = self.noise_scalar if noise is None else float(noise)
            form = ("float", value)
        layout = tuple((key, tuple(v.shape), v.dtype)
                       for key, v in sorted(batches.items()))
        key = (int(mode), form, layout)
        entry = self.graphs.get(key)
        if entry is None:
            return self._capture(key, state, batches, int(mode), generator,
                                 form, value)
        if generator is not entry.generator:
            raise ValueError("a K-step dispatch replays the generator it "
                             "captured; pass the same torch.Generator")
        _copy_into(entry.batches, batches)
        if entry.noise is not None:
            _set_noise(entry.noise, value)
        entry.graph.replay()
        for (obj, attr), n in entry.grown:
            setattr(obj, attr, getattr(obj, attr) + n)
        state.step += self.k
        state.tx.note_steps(self.k)
        return state, entry.metrics()

    def _capture(self, key, state, batches, mode, generator, form, value):
        dev = self.device
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        static = {name: torch.empty(v.shape, dtype=v.dtype, device=dev)
                  for name, v in batches.items()}
        _copy_into(static, batches)
        s_noise = None
        if form == "tensor":
            s_noise = torch.empty((), dtype=torch.float32, device=dev)
            _set_noise(s_noise, value)
        noise = s_noise if s_noise is not None else value
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            state, metrics = _run_steps(self.step, self.k, state, static,
                                        mode, generator, noise)
        torch.cuda.current_stream(dev).wait_stream(side)
        state.tx.freeze_grad_table()
        counters = list(kernel_counters().values())
        before = [getattr(obj, attr) for obj, attr in counters]
        host_step = state.step
        graph = torch.cuda.CUDAGraph()
        if generator is not None:
            graph.register_generator_state(generator)
        capture = "global" if current_mesh() is None else "thread_local"
        with torch.cuda.graph(graph, stream=side, capture_error_mode=capture):
            _, out = _run_steps(self.step, self.k, state, static, mode,
                                generator, noise)
            packs = _pack(out)
        grown = []
        for (obj, attr), was in zip(counters, before):
            if getattr(obj, attr) != was:
                grown.append(((obj, attr), getattr(obj, attr) - was))
                setattr(obj, attr, was)
        state.tx.note_steps(host_step - state.step)
        state.step = host_step
        self.graphs[key] = _Captured(graph, static, s_noise, packs, grown,
                                     generator)
        self.captures += 1
        return state, metrics


def make_k_step(step: Callable, k: int, device, noise_schedule: bool = False,
                noise_scalar: float = 0.0):
    """`step` for k == 1, else its K-step dispatch (`KStep`);
    `noise_schedule` and `noise_scalar` as the step's config has them."""
    if k == 1:
        return step
    return KStep(step, k, device, noise_schedule, noise_scalar)
