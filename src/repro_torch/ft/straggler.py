"""Straggler detection + simulated-failure machinery.

The monitor tracks per-step (or per-query) wall times and flags >k-sigma
outliers (slow data feed, GC pause, a slow device).  The design service
(:mod:`repro_torch.serving.engine`) feeds it every warm reply's wall time and
re-primes it after a cold build.  A copy of the reference's module: the
monitor is framework-free, and the port imports nothing of the reference.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Optional


@dataclass
class StragglerMonitor:
    alpha: float = 0.1  # EWMA weight
    k_sigma: float = 4.0
    warmup_steps: int = 5
    ewma: float = 0.0
    ewvar: float = 0.0
    n: int = 0
    flagged: list = field(default_factory=list)

    def record(self, step: int, dt: float) -> bool:
        """Record a step time; returns True if this step is a straggler."""
        self.n += 1
        if self.n <= self.warmup_steps:
            # warmup covers the first, cold steps; re-prime at the steady state so
            # the (huge) compile step never inflates the baseline
            self.ewma = dt if self.n == 1 else (1 - self.alpha) * self.ewma + self.alpha * dt
            self.ewvar = max(self.ewvar, (dt - self.ewma) ** 2)
            if self.n == self.warmup_steps:
                self.ewma = dt
                self.ewvar = (0.25 * dt) ** 2
            return False
        resid = dt - self.ewma
        is_straggler = resid > self.k_sigma * max(self.ewvar, 1e-12) ** 0.5 and dt > 1.5 * self.ewma
        self.ewma = (1 - self.alpha) * self.ewma + self.alpha * dt
        self.ewvar = (1 - self.alpha) * self.ewvar + self.alpha * resid * resid
        if is_straggler:
            self.flagged.append((step, dt))
        return is_straggler

    def reprime(self, dt: float) -> None:
        """Reset the baseline to ``dt``, exactly like the end-of-warmup reset
        above: used when a known regime change (a cold compile in the serving
        path, a device swap) makes the old EWMA meaningless — the expensive
        step is recorded as the new steady state, never flagged."""
        self.n = max(self.n + 1, self.warmup_steps)
        self.ewma = dt
        self.ewvar = (0.25 * dt) ** 2


class SimulatedFailure(RuntimeError):
    """Raised by fault-injection hooks to emulate device/host loss."""


@dataclass
class FailureInjector:
    """Deterministic failure schedule for tests: fail at given steps."""

    fail_at: tuple = ()
    slow_at: tuple = ()
    slow_secs: float = 0.05
    fired: set = field(default_factory=set)

    def maybe_fail(self, step: int):
        if step in self.fail_at and step not in self.fired:
            self.fired.add(step)
            raise SimulatedFailure(f"injected device loss at step {step}")
        if step in self.slow_at:
            time.sleep(self.slow_secs)
