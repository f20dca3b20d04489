"""Trainer: the epoch loop of every training entry (counterpart of
maavss_tpu/train/trainer.py:40-312, call for call).

- epochs x steps_per_epoch over an (infinite) host batch iterator, K steps
  a dispatch under --steps_per_dispatch;
- the modality curriculum: 'cycle' increments mode 0 -> 1 -> 2 every
  `mode_freq` epochs (train.py:239-241); 'random01' draws mode in {0, 1}
  (train_avse_frames.py:219-220, the reference's randint(0, 2) quirk);
  'random:<pa>,<pv>,<pav>' a weighted draw over the three; 'fixed' pins
  one mode. The draws come from numpy's `default_rng(cfg.seed)`, as JAX's;
- per-step metrics to JSONL (+ optional wandb) with the reference's names
  and the clips/s/chip meter, drained from the device every cb_freq steps
  and at epoch end (one record per step, K per dispatch);
- checkpoints: 'epoch' and 'best' val-loss policies, every cp_freq steps,
  and resume through cfg.c / cfg.checkpoint (exp/checkpoint.py);
- validation every epoch over val_steps batches;
- SIGTERM / SIGINT: the handler sets a flag; fit() finishes the dispatch
  in flight, drains the metrics, saves a checkpoint and returns, so `-c`
  resumes; a second SIGINT raises KeyboardInterrupt;
- MAAVSS_WATCH=1: parameter histograms every cb_freq steps into
  histograms.jsonl, one per top-level group of the flax tree
  (`convert.to_flax`), under JAX's names;
- `media_fn(state, batch, generator, global_step)` every cb_freq steps.

The steps are the port's: `step_fn(state, batch, mode, generator,
noise=None) -> (state, metrics)` and `eval_fn(state, batch, mode,
generator) -> metrics` (train/steps.py), metrics 0-d (or [K]) tensors on
the device. One `torch.Generator` on the parameters' device, seeded with
cfg.seed, feeds every step, eval and media call (JAX splits one PRNG key
for each). --noise_schedule is evaluated on the host at the global step
before each dispatch and handed to the step.

Quirks kept from JAX: a checkpoint saved at the end of epoch e resumes AT
epoch e (`load_checkpoint` returns the saved epoch and fit() loops from
it), and the mode is not saved, so 'cycle' restarts at mode 0 after a
resume.
"""

from __future__ import annotations

import dataclasses
import os
import signal
from typing import Callable, Iterator, Mapping, Optional

import numpy as np
import torch

from maavss_tpu_torch.config import RunConfig
from maavss_tpu_torch.convert import flatten_tree, to_flax
from maavss_tpu_torch.exp.checkpoint import load_checkpoint, save_checkpoint
from maavss_tpu_torch.exp.metrics import Meter, MetricsLogger
from maavss_tpu_torch.train.setup import resolve_noise_schedule
from maavss_tpu_torch.train.state import TrainState


def _host(metrics) -> dict:
    """Metrics (0-d or [K] tensors, or numbers) -> numpy arrays."""
    return {key: np.asarray(v.detach().float().cpu()
                            if isinstance(v, torch.Tensor) else v)
            for key, v in metrics.items()}


class Trainer:
    def __init__(
        self,
        cfg: RunConfig,
        step_fn: Callable,
        state: TrainState,
        run_name: str = "run",
        eval_fn: Optional[Callable] = None,
        mode_schedule: str = "cycle",  # cycle | random01 | fixed | random:..
        fixed_mode: int = 2,
        checkpoint_policy: str = "epoch",  # epoch | best | none
        n_chips: int = 1,
        logger: Optional[MetricsLogger] = None,
        media_fn: Optional[Callable] = None,
        generator: Optional[torch.Generator] = None,
    ):
        # generator: the run's noise generator, reseeded with cfg.seed; by
        # default a new one on the parameters' device. Pass the one a
        # K-step dispatch (train/cuda_graph.py) captured to go on with its
        # graphs in this process, e.g. after a checkpoint load.
        self.cfg = cfg
        self.step_fn = step_fn
        self.state = state
        self.eval_fn = eval_fn
        self.run_name = run_name
        self.mode_schedule = mode_schedule
        self.checkpoint_policy = checkpoint_policy
        self.media_fn = media_fn
        self.mode = 0 if mode_schedule == "cycle" else fixed_mode
        self._mode_probs = None
        if mode_schedule.startswith("random:"):
            ws = np.asarray([float(x) for x in
                             mode_schedule[len("random:"):].split(",")],
                            np.float64)
            if ws.shape != (3,) or (ws < 0).any() or ws.sum() <= 0:
                raise ValueError(
                    f"bad mode_schedule {mode_schedule!r}: want "
                    "random:<pa>,<pv>,<pav>")
            self._mode_probs = ws / ws.sum()
            self.mode = 2  # start in AV, like 'fixed'
        self._noise_fn = resolve_noise_schedule(cfg)
        self.logger = logger or MetricsLogger(
            cfg.log_dir, run_name, use_wandb=cfg.wandb,
            config=dataclasses.asdict(cfg),
        )
        self.meter = Meter(n_chips)
        self._watch = os.environ.get("MAAVSS_WATCH") == "1"
        self.epoch = 0
        if generator is None:
            generator = torch.Generator(
                device=next(state.model.parameters()).device)
        self.generator = generator.manual_seed(cfg.seed)
        self._np_rng = np.random.default_rng(cfg.seed)
        self._preempted: Optional[int] = None

        if cfg.c or cfg.checkpoint is not None:
            self.state, self.epoch = load_checkpoint(
                cfg.cp_dir, self.state, auto=cfg.c, path=cfg.checkpoint,
                load_opt=cfg.cp_load_opt,
            )

    def _param_histograms(self, bins: int = 64):
        """64-bin histogram of every top-level parameter group, host-side."""
        params, _ = to_flax(self.state.model.state_dict())
        hists = {}
        for k, group in params.items():
            leaves = (flatten_tree(group).values()
                      if isinstance(group, Mapping) else [group])
            flat = np.concatenate(
                [np.asarray(l, np.float32).ravel() for l in leaves])
            counts, edges = np.histogram(flat, bins=bins)
            hists[f"params/{k}"] = (counts, edges)
        return hists

    def _advance_mode(self) -> None:
        if self.mode_schedule == "cycle":
            if self.epoch % self.cfg.mode_freq == 0:
                self.mode = (self.mode + 1) % 3  # train.py:239-241
        elif self.mode_schedule == "random01":
            if self.epoch % self.cfg.mode_freq == 0:
                # reference quirk: randint(0,2) -> {0,1} only
                self.mode = int(self._np_rng.integers(0, 2))
        elif self._mode_probs is not None:
            if self.epoch % self.cfg.mode_freq == 0:
                self.mode = int(self._np_rng.choice(3, p=self._mode_probs))

    def _install_signal_handlers(self):
        """SIGTERM/SIGINT -> set the preempt flag (main thread only: from
        another thread signal.signal raises and the feature is off). A
        SECOND SIGINT restores the previous handlers and raises
        KeyboardInterrupt at once, so repeated Ctrl+C still kills a run
        whose dispatch never finishes."""
        previous = {}

        def handler(signum, frame):
            del frame
            if signum == signal.SIGINT and self._preempted is not None:
                self._restore_signal_handlers(previous)
                raise KeyboardInterrupt
            self._preempted = signum

        try:
            for s in (signal.SIGTERM, signal.SIGINT):
                previous[s] = signal.signal(s, handler)
        except ValueError:  # not in the main thread
            pass
        return previous

    def _restore_signal_handlers(self, previous) -> None:
        for s, h in previous.items():
            try:
                signal.signal(s, h)
            except ValueError:
                pass

    def _preempt_exit(self, drain, global_step: int,
                      last_metrics) -> TrainState:
        drain()
        if not self.cfg.no_save:
            save_checkpoint(self.cfg.cp_dir, self.run_name, self.state,
                            self.epoch, last_metrics.get("loss", 0.0))
        name = signal.Signals(self._preempted).name
        self.logger.log({"preempted": 1.0, "epoch": self.epoch},
                        step=global_step)
        print(f"{name} received: checkpoint saved at epoch {self.epoch} "
              f"step {global_step}; resume with -c")
        return self.state

    def fit(self, train_batches: Iterator,
            val_batches: Optional[Iterator] = None) -> TrainState:
        previous_handlers = self._install_signal_handlers()
        try:
            return self._fit(train_batches, val_batches)
        finally:
            self._restore_signal_handlers(previous_handlers)

    def _fit(self, train_batches: Iterator,
             val_batches: Optional[Iterator] = None) -> TrainState:
        cfg = self.cfg
        best_val = float("inf")
        global_step = int(self.state.step)
        k = max(1, cfg.steps_per_dispatch)
        if cfg.steps_per_epoch % k:
            raise ValueError(
                f"steps_per_epoch={cfg.steps_per_epoch} must be a multiple of "
                f"steps_per_dispatch={k}")

        # deferred metrics: reading a device scalar waits for its step, so
        # the dispatches are enqueued back to back and their metrics (the
        # step's own tensors, or a graph replay's copies) drained every
        # cb_freq steps and at epoch end, one JSONL record per step
        pending = []  # [(gstep_of_first, epoch, mode, step_in_epoch, metrics)]

        def drain():
            host = {}
            for gstep, pe, pmode, pi, m in pending:
                hm = _host(m)
                for j in range(k):
                    host = {key: float(v[j] if v.ndim else v)
                            for key, v in hm.items()}
                    self.logger.log(
                        {**host, "mode": pmode, "epoch": pe,
                         "clips_per_sec_per_chip":
                             self.meter.clips_per_sec_per_chip},
                        step=gstep + j,
                    )
                if pi % cfg.cb_freq == 0:
                    print(f"epoch {pe} step {pi}/{cfg.steps_per_epoch} "
                          f"loss {host.get('loss', float('nan')):.6f} "
                          f"mode {pmode} "
                          f"{self.meter.clips_per_sec_per_chip:.2f} "
                          "clips/s/chip")
            pending.clear()
            return host

        last_metrics = {}
        for e in range(self.epoch, cfg.epochs):
            self.epoch = e
            self.meter.reset()
            for i in range(0, cfg.steps_per_epoch, k):
                batch = next(train_batches)
                noise = (None if self._noise_fn is None
                         else float(self._noise_fn(global_step)))
                self.state, metrics = self.step_fn(
                    self.state, batch, self.mode, self.generator,
                    noise=noise)
                lead = batch[sorted(batch)[0]]
                bsz = lead.shape[1] if k > 1 else lead.shape[0]
                self.meter.update(bsz * k)
                pending.append((global_step + 1, e, self.mode, i, metrics))
                global_step += k
                if i % cfg.cb_freq < k:  # a cb boundary falls in this dispatch
                    last_metrics = drain() or last_metrics
                    if self._watch:
                        self.logger.log_histograms(
                            self._param_histograms(), step=global_step)
                    if self.media_fn is not None:
                        try:
                            mbatch = batch if k == 1 else {
                                key: v[0] for key, v in batch.items()}
                            self.media_fn(self.state, mbatch, self.generator,
                                          global_step)
                        except Exception as err:  # media must never kill a run
                            print(f"media callback failed: {err}")
                if cfg.cp_freq and not cfg.no_save and \
                        global_step // cfg.cp_freq > (global_step - k) // cfg.cp_freq:
                    save_checkpoint(cfg.cp_dir, self.run_name, self.state, e,
                                    last_metrics.get("loss", 0.0))
                if self._preempted is not None:
                    return self._preempt_exit(drain, global_step, last_metrics)
            last_metrics = drain() or last_metrics  # flush the epoch tail
            if self._preempted is not None:
                return self._preempt_exit(drain, global_step, last_metrics)

            val_loss = None
            if self.eval_fn is not None and val_batches is not None \
                    and cfg.val_steps > 0:
                vals = []
                for _ in range(cfg.val_steps):
                    # bail between eval batches too, not only at train
                    # dispatches: a grace window may be shorter than a sweep
                    if self._preempted is not None:
                        return self._preempt_exit(drain, global_step,
                                                  last_metrics)
                    vmetrics = self.eval_fn(self.state, next(val_batches),
                                            self.mode, self.generator)
                    vals.append(float(vmetrics["loss"]))
                val_loss = float(np.mean(vals))
                self.logger.log({"val_loss": val_loss, "epoch": e},
                                step=global_step)
                print(f"epoch {e} val_loss {val_loss:.6f}")

            if not cfg.no_save:
                if self.checkpoint_policy == "epoch":
                    save_checkpoint(cfg.cp_dir, self.run_name, self.state, e,
                                    last_metrics.get("loss", 0.0))
                elif self.checkpoint_policy == "best" and val_loss is not None:
                    if val_loss < best_val:
                        best_val = val_loss
                        save_checkpoint(cfg.cp_dir, self.run_name, self.state,
                                        e, val_loss)

            if self._preempted is not None:
                return self._preempt_exit(drain, global_step, last_metrics)
            self._advance_mode()
        return self.state
