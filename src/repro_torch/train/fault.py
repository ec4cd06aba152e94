"""Fault-tolerant training runner: checkpoint/restart, stragglers, elasticity.

Pure Python over the port's ``StaticPartitioner`` and ``train/checkpoint``,
the reference's runner (``repro/train/fault.py``):
  * step failure / chip loss -> restore the newest complete checkpoint, ask
    the StaticPartitioner for the largest still-free slice, rebuild the step
    for it and resume from the restored step with the deterministic
    pipeline's batch_at();
  * straggler -> per-step deadline = straggler_factor x EWMA(step time);
    overruns are counted.

The step clock is the host's: on CUDA the step must return Python numbers
(which wait for the card), so that the clock times finished work.
``RunnerStats.step_seconds`` keeps each completed step's time.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from repro_torch.core.partitioner import StaticPartitioner
from repro_torch.core.slices import SliceProfile
from repro_torch.train import checkpoint as ckpt

PyTree = Any


class StepFailure(Exception):
    """Raised by the step (or injected) to signal a lost chip/host."""


@dataclass
class RunnerConfig:
    ckpt_dir: str
    ckpt_every: int = 25
    keep: int = 3
    straggler_factor: float = 3.0
    max_restarts: int = 3


@dataclass
class RunnerStats:
    steps_done: int = 0
    restarts: int = 0
    straggler_events: int = 0
    repartitions: List[str] = field(default_factory=list)
    losses: List[float] = field(default_factory=list)
    step_seconds: List[float] = field(default_factory=list)


class FaultTolerantRunner:
    """Drives (build_step, state) through failures.

    build_step(profile) -> (step_fn, state) — rebuilds the step and state for
    a slice profile (restoring from the newest checkpoint when one exists).
    step_fn(state, batch) -> (state, metrics), metrics as Python numbers.
    """

    def __init__(self, cfg: RunnerConfig,
                 partitioner: StaticPartitioner,
                 initial_profile: SliceProfile,
                 build_step: Callable[[SliceProfile], Any],
                 get_batch: Callable[[int], Dict],
                 save_state: Callable[[Any], PyTree],
                 fail_hook: Optional[Callable[[int], None]] = None):
        self.cfg = cfg
        self.partitioner = partitioner
        self.profile = initial_profile
        self.build_step = build_step
        self.get_batch = get_batch
        self.save_state = save_state
        self.fail_hook = fail_hook or (lambda step: None)
        self.stats = RunnerStats()
        self._ewma: Optional[float] = None

    # ------------------------------------------------------------------
    def run(self, total_steps: int) -> RunnerStats:
        step_fn, state, start = self._admit(self.profile)
        step = start
        while step < total_steps:
            batch = self.get_batch(step)
            t0 = time.monotonic()
            try:
                self.fail_hook(step)  # test injection point
                state, metrics = step_fn(state, batch)
            except StepFailure:
                step_fn, state, step = self._recover()
                continue
            dt = time.monotonic() - t0
            self._track_stragglers(dt)
            self.stats.steps_done += 1
            self.stats.step_seconds.append(dt)
            if "loss" in metrics:
                self.stats.losses.append(float(metrics["loss"]))
            step += 1
            if step % self.cfg.ckpt_every == 0:
                ckpt.save(self.cfg.ckpt_dir, step, self.save_state(state),
                          keep=self.cfg.keep)
        ckpt.save(self.cfg.ckpt_dir, step, self.save_state(state),
                  keep=self.cfg.keep)
        return self.stats

    # ------------------------------------------------------------------
    def _admit(self, profile: SliceProfile):
        step_fn, state = self.build_step(profile)
        start = ckpt.latest_step(self.cfg.ckpt_dir) or 0
        return step_fn, state, start

    def _recover(self):
        self.stats.restarts += 1
        if self.stats.restarts > self.cfg.max_restarts:
            raise RuntimeError("restart budget exhausted")
        # elastic: take the largest profile that still fits in the pod
        new_profile = self.partitioner.largest_free_profile() or self.profile
        self.stats.repartitions.append(
            f"{self.profile.name}->{new_profile.name}")
        self.profile = new_profile
        step_fn, state = self.build_step(self.profile)
        start = ckpt.latest_step(self.cfg.ckpt_dir) or 0
        return step_fn, state, start

    def _track_stragglers(self, dt: float) -> None:
        if self._ewma is None:
            self._ewma = dt
            return
        if dt > self.cfg.straggler_factor * self._ewma:
            self.stats.straggler_events += 1
        self._ewma = 0.9 * self._ewma + 0.1 * dt
