"""Fault-tolerant training loop — the port of ``repro.train.trainer``.

Scale features (designed for 1000+ nodes, exercised here at CPU scale):

* checkpoint/restart: async sharded checkpoints every `ckpt_every` steps;
  on (re)start the loop resumes from the latest durable step and the
  deterministic data pipeline replays from that exact cursor;
* failure handling: a step that throws (device OOM, preempted host, NaN
  loss with `halt_on_nan`) triggers restore-from-last-checkpoint instead
  of killing the job; `max_failures` bounds the retry budget;
* straggler mitigation: per-step wall times feed an EWMA; steps slower
  than `straggler_factor` x EWMA are counted and surfaced in metrics —
  the deployment hook for backup-task dispatch (and the network-level
  mitigation is REPS load balancing inside the UET fabric, see
  repro/core/lb); on this container it degrades to monitoring;
* elastic rescale: the restore accepts another device than the
  checkpoint was written from (see repro_torch/ckpt).

Resume is deterministic: ``try_resume`` first joins the checkpoint write
in flight (``AsyncCheckpointer.wait``, which re-raises a failed write),
so it restores the newest step the run has checkpointed. The reference
reads ``latest`` without joining, so the step it resumes from depends on
thread timing, and a replay that saves a step again can collide with
the write still publishing it.

The port's train step updates params and moments in place, as the
reference's launcher donates them, so a failed step leaves them to the
restore from the last checkpoint (or, with none, retries from where the
step left them).
"""
from __future__ import annotations

import os
import tempfile
import time
from dataclasses import dataclass
from typing import Any, Callable

import numpy as np

from repro_torch.ckpt import checkpointing as ckpt


@dataclass
class TrainerConfig:
    total_steps: int = 300
    ckpt_every: int = 100
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")
    log_every: int = 10
    halt_on_nan: bool = True
    max_failures: int = 3
    straggler_factor: float = 2.5


@dataclass
class TrainerState:
    step: int = 0
    failures: int = 0
    straggler_steps: int = 0
    step_time_ewma: float = 0.0


class Trainer:
    def __init__(self, cfg: TrainerConfig, train_step: Callable,
                 data_fn: Callable[[int], dict],
                 params: Any, opt_state: Any,
                 param_shardings: Any = None, opt_shardings: Any = None):
        """``param_shardings`` / ``opt_shardings``: the device (or tree
        of devices) a restore places params and optimizer state on;
        by default each leaf's current device."""
        self.cfg = cfg
        self.train_step = train_step
        self.data_fn = data_fn
        self.params = params
        self.opt_state = opt_state
        self.param_shardings = param_shardings
        self.opt_shardings = opt_shardings
        self.state = TrainerState()
        self.checkpointer = ckpt.AsyncCheckpointer(cfg.ckpt_dir)
        os.makedirs(cfg.ckpt_dir, exist_ok=True)
        self.history: list[dict] = []

    # ------------------------------------------------------------------
    def try_resume(self) -> bool:
        self.checkpointer.wait()
        step = ckpt.latest_step(self.cfg.ckpt_dir)
        if step is None:
            return False
        tree = {"params": self.params, "opt": self.opt_state}
        sh = None
        if self.param_shardings is not None:
            sh = {"params": self.param_shardings, "opt": self.opt_shardings}
        restored = ckpt.restore(self.cfg.ckpt_dir, step, tree, sh)
        self.params = restored["params"]
        self.opt_state = restored["opt"]
        self.state.step = step
        return True

    def _checkpoint(self):
        self.checkpointer.save(self.state.step,
                               {"params": self.params,
                                "opt": self.opt_state})

    # ------------------------------------------------------------------
    def run(self) -> list[dict]:
        cfg, st = self.cfg, self.state
        while st.step < cfg.total_steps:
            batch = self.data_fn(st.step)
            t0 = time.time()
            try:
                params, opt_state, metrics = self.train_step(
                    self.params, self.opt_state, batch)
                loss = float(metrics["loss"])
                if cfg.halt_on_nan and not np.isfinite(loss):
                    raise FloatingPointError(f"non-finite loss {loss} at "
                                             f"step {st.step}")
                self.params, self.opt_state = params, opt_state
            except Exception as e:  # noqa: BLE001 — failure domain boundary
                st.failures += 1
                if st.failures > cfg.max_failures:
                    raise
                resumed = self.try_resume()
                print(f"[trainer] step {st.step} failed ({e!r}); "
                      f"{'resumed from checkpoint' if resumed else 'retrying'}"
                      f" (failure {st.failures}/{cfg.max_failures})")
                continue

            dt = time.time() - t0
            if st.step_time_ewma == 0.0:
                st.step_time_ewma = dt
            else:
                if dt > cfg.straggler_factor * st.step_time_ewma:
                    st.straggler_steps += 1
                st.step_time_ewma = 0.9 * st.step_time_ewma + 0.1 * dt

            st.step += 1
            rec = {"step": st.step, "loss": loss,
                   "grad_norm": float(metrics["grad_norm"]),
                   "dt": dt, "stragglers": st.straggler_steps}
            self.history.append(rec)
            if st.step % cfg.log_every == 0:
                print(f"[trainer] step {st.step:5d} loss {loss:8.4f} "
                      f"gnorm {rec['grad_norm']:7.3f} {dt*1e3:7.1f} ms")
            if st.step % cfg.ckpt_every == 0:
                self._checkpoint()
        self.checkpointer.wait()
        return self.history
