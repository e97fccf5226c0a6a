"""Fault tolerance / straggler harness (DESIGN.md sec. 8), a copy of
`repro/runtime/fault.py` (framework-free, so it is copied unchanged).

On a real cluster the failure signals come from the runtime (XLA ICI errors,
host heartbeats); in this container they are injected (FaultInjector) so the
recovery logic is unit-testable:

  StepRunner: wraps a step fn with (1) retry w/ exponential backoff,
  (2) checkpoint-restore on unrecoverable error, (3) straggler statistics.

  StragglerWatchdog: per-step latency EWMA + p99 tracking; steps slower than
  `factor` x p99 are flagged (on a real deployment: drain + re-slice; the
  level-batching in the BFS while_loop amortises the sync points).
"""
from __future__ import annotations

import random
import time
from dataclasses import dataclass


class FaultInjector:
    """Deterministic failure schedule: fail step k with exception cls."""

    def __init__(self, schedule: dict[int, type] | None = None):
        self.schedule = dict(schedule or {})
        self.calls = 0

    def check(self, step: int):
        if step in self.schedule:
            exc = self.schedule.pop(step)
            self.calls += 1
            raise exc(f"injected failure at step {step}")


@dataclass
class RetryPolicy:
    """Exponential backoff with deterministic, seedable jitter.

    `jitter_s` spreads the attempt delays uniformly over [0, jitter_s) so
    concurrent serve retries hitting the same execution lock do not
    stampede in lockstep; the offset is a pure function of
    (seed, step, attempt), so two runs with one seed sleep identically and
    distinct seeds (one per worker) de-correlate.
    """
    max_retries: int = 3
    backoff_s: float = 0.01
    backoff_mult: float = 2.0
    jitter_s: float = 0.0
    seed: int = 0

    def delay_for(self, step: int, attempt: int) -> float:
        """Backoff before retrying `step` after failed attempt `attempt`
        (0-based): backoff_s * mult^attempt plus the deterministic jitter."""
        d = self.backoff_s * self.backoff_mult ** attempt
        if self.jitter_s:
            # integer mix (no PYTHONHASHSEED dependence), so this is
            # reproducible across processes
            mix = (self.seed * 1_000_003 + step) * 1_000_003 + attempt
            d += self.jitter_s * random.Random(mix).random()
        return d


class StragglerWatchdog:
    def __init__(self, factor: float = 3.0, window: int = 256):
        self.factor = factor
        self.lat = []
        self.window = window
        self.flagged = []

    def record(self, step: int, seconds: float):
        flagged = False
        if len(self.lat) >= 16:
            srt = sorted(self.lat)  # p99 of the PRIOR window
            p99 = srt[min(len(srt) - 1, int(0.99 * len(srt)))]
            if seconds > self.factor * p99 and seconds > 1e-4:
                self.flagged.append(step)
                flagged = True
        self.lat.append(seconds)
        self.lat = self.lat[-self.window:]
        return flagged


class StepRunner:
    """run(state, batch) -> state with retry/restore semantics.

    Accounting is label-aware (DESIGN.md sec. 13): `run(..., labels=)`
    attributes every retry / straggler flag of those batches to each label
    (the serve layer passes the batch's tenants), accumulated in
    `retries_by` / `straggler_by` and mirrored to the optional `on_retry` /
    `on_straggler` callbacks (what the GraphServer wires into its metrics
    registry + event log).  `reset_stats()` zeroes everything, so a load
    generator's per-point windows (and a fresh server over a long-lived
    graph) start clean.
    """

    def __init__(self, step_fn, *, policy: RetryPolicy = RetryPolicy(),
                 ckpt=None, ckpt_every: int = 50,
                 injector: FaultInjector | None = None,
                 watchdog: StragglerWatchdog | None = None,
                 on_retry=None, on_straggler=None):
        self.step_fn = step_fn
        self.policy = policy
        self.ckpt = ckpt
        self.ckpt_every = ckpt_every
        self.injector = injector
        self.watchdog = watchdog or StragglerWatchdog()
        self.on_retry = on_retry        # called (labels) per retry
        self.on_straggler = on_straggler  # called (labels, seconds) per flag
        self.restores = 0
        self.retries = 0
        self.retries_by: dict = {}      # label -> retries attributed
        self.straggler_by: dict = {}    # label -> straggler flags attributed
        self.delays: list = []          # backoff actually slept, per retry

    def reset_stats(self) -> None:
        """Zero the retry/restore/straggler accounting (watchdog latency
        window included), leaving policy and hooks in place."""
        self.restores = 0
        self.retries = 0
        self.retries_by = {}
        self.straggler_by = {}
        self.delays = []
        self.watchdog.lat = []
        self.watchdog.flagged = []

    def _count_retry(self, labels):
        self.retries += 1
        for lab in labels:
            self.retries_by[lab] = self.retries_by.get(lab, 0) + 1
        if self.on_retry is not None:
            self.on_retry(labels)

    def _count_straggler(self, labels, seconds):
        for lab in labels:
            self.straggler_by[lab] = self.straggler_by.get(lab, 0) + 1
        if self.on_straggler is not None:
            self.on_straggler(labels, seconds)

    def run(self, state, batches, *, start_step: int = 0, labels=()):
        step = start_step
        infos = []
        for batch in batches:
            t0 = time.perf_counter()
            for attempt in range(self.policy.max_retries + 1):
                try:
                    if self.injector is not None:
                        self.injector.check(step)
                    state, info = self.step_fn(state, batch)
                    break
                except Exception:
                    if attempt == self.policy.max_retries:
                        # unrecoverable: restore from checkpoint if we can
                        if self.ckpt is not None:
                            restored, mani = self.ckpt.restore(state)
                            if restored is not None:
                                self.restores += 1
                                state = restored
                                break
                        raise
                    self._count_retry(labels)
                    delay = self.policy.delay_for(step, attempt)
                    self.delays.append(delay)
                    time.sleep(delay)
            else:
                pass
            seconds = time.perf_counter() - t0
            if self.watchdog.record(step, seconds):
                self._count_straggler(labels, seconds)
            if self.ckpt is not None and step % self.ckpt_every == 0:
                self.ckpt.save(step, state)
            infos.append(info if "info" in dir() else None)
            step += 1
        if self.ckpt is not None:
            self.ckpt.wait()
        return state, infos
