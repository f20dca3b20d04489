"""The training traffic (`kind: train`): the port's train step at the
traffic's batch, fed the traffic's distinct batches from the device.

Set-up makes the weights and batches from the seed, builds the program's
train state and step, and drives that same step through its first
dispatch: its first three optimizer steps are read for the check (each
step's loss, every leaf's step-1 gradient as the optimizer gets it, every
leaf's change after step 3). Under steps_per_dispatch K > 1 the first
dispatch runs its K steps eagerly and captures them in a CUDA graph, and
every later dispatch replays it over the same [K, B, ...] feed; K = 1
steps cycle through the batches. One more dispatch warms up, the first
that runs as the window's do (under K > 1 the first replay): the first
three of its losses are read and, under K > 1, every leaf's change over
its K steps. Then the window dispatches for `seconds`, at most two
dispatches ahead of the device, and ends with a synchronize.

After the window the program is freed and the plain reference follows
the same steps from the same weights, batches and noise draws
(`check.train_numbers` compares them).

End to end: `train_clips_per_s`, every clip trained in the window over
the window's wall time.

Faults, planted for setting limits (never in the benchmark's runs):
`unchanged` (the optimizer's step does nothing), `half_batch` (the step
is fed the first half of each batch), `replay_unchanged` (every dispatch
after the first leaves the parameters as it found them: under K > 1 a
graph replay that drops the update).
"""

from __future__ import annotations

import gc
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

from perfbench.core import check, inputs, program
from perfbench.core.weights import make_weights
from perfbench.reference import layers as L

FAULTS = (None, "unchanged", "half_batch", "replay_unchanged")


def weights_for(fam, run: Dict, seed: int, device):
    with torch.device("meta"):
        spec = fam.reference.build(run, "meta")
    pred, dtype = L.stored_low(run)
    return make_weights(spec, inputs.mix(seed, 0), device, pred, dtype)


def _norms(a: Dict[str, torch.Tensor], b: Dict[str, torch.Tensor]
           ) -> Dict[str, torch.Tensor]:
    return {k: (a[k].double() - b[k].double()).norm() for k in a}


class Recorder:
    """Reads the program's state after each of its first three steps, and
    around the warm-up dispatch."""

    def __init__(self, model: torch.nn.Module, start: Dict[str, torch.Tensor]):
        self.model, self.start = model, start
        self.calls = 0
        self.losses: List[torch.Tensor] = []
        self.grads: Dict[str, torch.Tensor] = {}
        self.changes: Dict[Tuple[int, int], Dict[str, torch.Tensor]] = {}
        self.later: List[torch.Tensor] = []  # losses of the warm-up dispatch
        self.later_step = 0  # the step number of its first
        self.steps = 0  # steps taken when the readings close
        self.mark: Optional[Tuple[int, Dict[str, torch.Tensor]]] = None

    def params(self) -> Dict[str, torch.Tensor]:
        return {k: p.detach() for k, p in self.model.named_parameters()}

    @torch.no_grad()
    def __call__(self, metrics: Dict[str, torch.Tensor]) -> None:
        self.calls += 1
        if self.calls > 3:
            return
        self.losses.append(metrics["loss"].detach().float().clone())
        if self.calls == 1:
            self.grads = {k: (torch.zeros((), device=p.device,
                                          dtype=torch.float64)
                              if p.grad is None
                              else p.grad.double().norm())
                          for k, p in self.model.named_parameters()}
        if self.calls == 3:
            self.changes[(0, 3)] = _norms(self.params(), self.start)
            self.start = None

    @torch.no_grad()
    def snapshot(self, step: int) -> None:
        self.mark = (step, {k: p.clone() for k, p in self.params().items()})

    @torch.no_grad()
    def change_since_snapshot(self, step: int) -> None:
        first, then = self.mark
        self.changes[(first, step)] = _norms(self.params(), then)
        self.mark = None

    def result(self) -> Dict:
        """The readings: `losses` by step number (1-3, and the warm-up
        dispatch's first three), step-1 `grad_norms`, `changes` {(from
        step, to step): each leaf's change norm}, and `steps` taken."""
        losses = {i + 1: float(x) for i, x in enumerate(self.losses)}
        losses.update({self.later_step + i: float(x)
                       for i, x in enumerate(self.later)})
        return {"losses": losses,
                "grad_norms": {k: float(v) for k, v in self.grads.items()},
                "changes": {span: {k: float(v) for k, v in norms.items()}
                            for span, norms in self.changes.items()},
                "steps": self.steps}


def recorded(step: Callable, rec: Recorder) -> Callable:
    def call(state, batch, mode, generator=None, noise=None):
        state, metrics = step(state, batch, mode, generator, noise=noise)
        rec(metrics)
        return state, metrics

    return call


class Runner:
    """One run of a training cell; see the module docstring."""

    def __init__(self, fam, run: Dict, traffic: Dict, seed: int, device,
                 fault: Optional[str] = None):
        if fault not in FAULTS:
            raise ValueError(f"unknown fault {fault!r}")
        self.fam, self.run, self.traffic = fam, run, traffic
        self.seed, self.device, self.fault = seed, device, fault
        self.mode = int(traffic["mode"])
        self.batches = inputs.train_batches(run, traffic, seed, device)
        weights = weights_for(fam, run, seed, device)
        self.state, self.step, self.k = program.train(fam, run, traffic,
                                                      weights, device)
        self.generator = inputs.generator(seed, 2, device)
        self.feed = self._feed()
        self.rec = Recorder(self.state.model, weights)
        self.bad = torch.zeros((), dtype=torch.int64, device=device)
        self.calls = 0
        if fault == "unchanged":
            self.state.tx.step = lambda: None

    def _feed(self):
        n, b = len(self.batches), self.traffic["batch_size"]
        cut = b // 2 if self.fault == "half_batch" else b
        if self.k > 1:
            if n != self.k:
                raise ValueError("a K-step dispatch feeds K distinct batches")
            return [{key: torch.stack([bt[key][:cut] for bt in self.batches])
                     for key in self.batches[0]}]
        if n < 3:
            raise ValueError("the first three steps need three distinct "
                             "batches")
        return [{key: v[:cut] for key, v in bt.items()}
                for bt in self.batches]

    def dispatch(self) -> Dict[str, torch.Tensor]:
        feed = self.feed[self.calls % len(self.feed)]
        keep = None
        if self.fault == "replay_unchanged" and self.calls > 0:
            keep = [p.detach().clone() for p in self.state.model.parameters()]
        self.state, m = self.step(self.state, feed, self.mode, self.generator)
        if keep is not None:
            with torch.no_grad():
                for p, v in zip(self.state.model.parameters(), keep):
                    p.copy_(v)
        self.bad += (~torch.isfinite(m["loss"])).sum()
        self.calls += 1
        return m

    def first_steps(self) -> None:
        """The first three steps through the window's own call: the first
        K-step dispatch (its eager steps are read), or three calls. Then
        the warm-up dispatch (see the module docstring)."""
        if self.k > 1:
            inner = self.step.step
            self.step.step = recorded(inner, self.rec)
            try:
                self.dispatch()
            finally:
                self.step.step = inner
            self.rec.snapshot(self.calls * self.k)
        else:
            inner = self.step
            self.step = recorded(inner, self.rec)
            try:
                for _ in range(3):
                    self.dispatch()
            finally:
                self.step = inner
        self.rec.later_step = self.calls * self.k + 1
        later = self.dispatch()["loss"].reshape(-1)[:3]
        self.rec.later = [x.detach().float().clone() for x in later]
        self.rec.steps = self.calls * self.k
        if self.k > 1:
            self.rec.change_since_snapshot(self.rec.steps)
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def window(self, seconds: float) -> Tuple[Dict[str, float], int, Dict]:
        """Dispatch for `seconds` (at least once), the collector paused:
        ({end-to-end metric: value}, steps, what the window did)."""
        sync = self.device.type == "cuda"
        events: List = []
        start_calls = self.calls
        gc.collect()
        gc.disable()
        try:
            t0 = time.perf_counter()
            while True:
                self.dispatch()
                if sync:
                    ev = torch.cuda.Event()
                    ev.record()
                    events.append(ev)
                    if len(events) > 2:
                        events.pop(0).synchronize()
                if time.perf_counter() - t0 >= seconds:
                    break
            if sync:
                torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        finally:
            gc.enable()
        steps = (self.calls - start_calls) * self.k
        clips = steps * self.traffic["batch_size"]
        return ({"train_clips_per_s": clips / dt}, steps,
                {"steps": steps, "seconds": dt, "clips": clips})

    def traced_units(self) -> Callable[[], int]:
        n = int(self.traffic["trace_dispatches"])

        def fn():
            for _ in range(n):
                self.dispatch()
            return n * self.k

        return fn

    def failed(self) -> int:
        return int(self.bad)

    def free(self) -> Dict:
        """Drop the program (its state, step and feed); return the first
        steps' readings."""
        out = self.rec.result()
        del self.state, self.step, self.feed, self.rec
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
        return out

    def reference(self, steps: int, spans, precision: str = "float32"
                  ) -> Dict:
        """The plain reference's first `steps` steps on this run's weights,
        batches (in the order the window feeds them) and noise draws, with
        each leaf's change over each (from, to) step of `spans`."""
        model = self.fam.reference.build(self.run, self.device)
        model.load_state_dict(weights_for(self.fam, self.run, self.seed,
                                          self.device))
        gen = inputs.generator(self.seed, 2, self.device)
        shape = self.fam.noise_shape(self.run, self.traffic["batch_size"])
        noises = [torch.randn(shape, generator=gen, device=self.device)
                  for _ in range(steps)]
        order = [self.batches[i % len(self.batches)] for i in range(steps)]
        return self.fam.reference.train_steps(model, order, noises,
                                              L.Precision(precision),
                                              spans=spans)

    def numbers(self) -> Dict[str, float]:
        """Free the program; its first steps against the reference's."""
        prog = self.free()
        return check.train_numbers(
            prog, self.reference(prog["steps"], sorted(prog["changes"])))

    def control(self, precision: str) -> Dict[str, float]:
        """The reference in `precision` in the program's place: the same
        steps, losses and changes read as the program's are."""
        k = self.k
        if k > 1:
            steps, spans = 2 * k, [(0, 3), (k, 2 * k)]
            read = [1, 2, 3] + list(range(k + 1, k + 1 + min(3, k)))
        else:
            steps, spans, read = 4, [(0, 3)], [1, 2, 3, 4]
        self.free()
        low = self.reference(steps, spans, precision)
        low["losses"] = {i: low["losses"][i] for i in read}
        return check.train_numbers(low, self.reference(steps, spans))
