"""Resilience layer for the design service.

A serving engine answering design queries for a fleet must degrade
gracefully: one malformed ``.dhd``, one NaN-diverging descent or one slow
cold build must cost *one structured error reply*, never a crashed or
stalled batch.  This module is the policy layer :class:`DesignService`
(serving/engine.py) runs every query through:

  * a **typed fault taxonomy** — :class:`ClientError` /
    :class:`TransientFault` / :class:`DeadlineExceeded` /
    :class:`NumericFault` (plus :class:`CircuitOpen` for the degraded
    fast-fail path), each carrying a stable ``code`` and a ``retryable``
    bit, serialized into replies as :class:`FaultInfo`;
  * **bounded retry** (:class:`RetryPolicy`) — exponential backoff with
    *deterministic* jitter (hash-derived from ``(token, attempt)``, so a
    replay of the same query stream backs off identically);
  * **per-query wall-clock deadlines** (:class:`DeadlineConfig`) — separate
    cold and warm budgets: the first query of a (kind, spec, bucket,
    objective) shape pays the program's build and, on the card, the kernel
    libraries' load, while the warm path replays a built program;
  * a **per-key circuit breaker** (:class:`CircuitBreaker`) — keyed by
    ``(kind, bucket)``, trips after repeated consecutive failures and
    fast-fails further queries with a structured ``circuit-open`` reply
    until a cooldown expires, so a poisoned program shape cannot cascade
    into every lane of a batch.

Everything takes injectable ``clock``/``sleep`` callables so tests and the
chaos harness (serving/chaos.py) can drive time deterministically.  The
policy is framework-free and the same as the reference's, fault codes,
backoff and schedules included; only :func:`nonfinite_in` reads the port's
report types.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np

# --------------------------------------------------------------------------- #
# fault taxonomy
# --------------------------------------------------------------------------- #


class ServingFault(Exception):
    """Base of the typed serving faults.  ``code`` is the stable wire
    identifier (what replies and stats key on); ``retryable`` is the retry
    loop's decision bit."""

    code: str = "fault"
    retryable: bool = False


class ClientError(ServingFault):
    """The query itself is bad (unparseable ``.dhd``, non-finite graph
    tensors, empty workload set, unknown kind, invalid engine knobs).
    Never retried — the same input fails the same way — and never counted
    against the circuit breaker: the server is healthy."""

    code = "client-error"
    retryable = False


class TransientFault(ServingFault):
    """A fault expected to clear on retry: an injected/infra exception, a
    failed build or kernel launch, a flaky dependency.  Retried under the
    deadline."""

    code = "transient"
    retryable = True


class DeadlineExceeded(ServingFault):
    """The per-query wall-clock budget is gone (the answer arrived late, or
    the remaining budget cannot cover another backoff+attempt).  Not
    retryable by definition."""

    code = "deadline-exceeded"
    retryable = False


class NumericFault(ServingFault):
    """The engine produced a non-finite answer (NaN/inf leaked through a
    descent or a simulation).  Retryable once — transient numeric
    corruption (e.g. injected) clears; a deterministic divergence exhausts
    its attempts and degrades to a structured error reply."""

    code = "numeric"
    retryable = True


class CircuitOpen(ServingFault):
    """Degraded fast-fail: the breaker for this (kind, bucket) is open."""

    code = "circuit-open"
    retryable = False


@dataclass(frozen=True)
class FaultInfo:
    """The structured error a reply carries when ``ok=False`` — JSON-able,
    stable codes, enough to route/alert on without parsing messages."""

    code: str
    message: str
    attempts: int
    retryable: bool

    def to_json(self) -> dict:
        return dict(code=self.code, message=self.message,
                    attempts=self.attempts, retryable=self.retryable)


def classify_exception(exc: BaseException) -> ServingFault:
    """Map a foreign exception onto the taxonomy: engine argument errors are
    the client's (``ValueError``/``TypeError``/``KeyError`` → ClientError),
    numeric traps are NumericFault, anything else is assumed transient (the
    retry loop will prove or disprove that)."""
    if isinstance(exc, ServingFault):
        return exc
    if isinstance(exc, FloatingPointError):
        return NumericFault(f"{type(exc).__name__}: {exc}")
    if isinstance(exc, (ValueError, TypeError, KeyError)):
        return ClientError(f"{type(exc).__name__}: {exc}")
    return TransientFault(f"{type(exc).__name__}: {exc}")


# --------------------------------------------------------------------------- #
# bounded retry with deterministic jitter
# --------------------------------------------------------------------------- #


def _unit_hash(token: int, attempt: int, salt: int = 0) -> float:
    """Deterministic uniform in [0, 1) from ``(token, attempt, salt)`` —
    NumPy's SeedSequence is a stable, platform-independent hash, so jitter
    (and the chaos schedule built on the same primitive) replays exactly."""
    ss = np.random.SeedSequence([token & 0xFFFFFFFF, attempt & 0xFFFFFFFF, salt & 0xFFFFFFFF])
    return float(np.random.default_rng(ss).random())


@dataclass(frozen=True)
class RetryPolicy:
    """Bounded retry: at most ``max_attempts`` total tries, exponential
    backoff ``base_s * multiplier**retry`` capped at ``max_backoff_s``,
    shrunk by a deterministic jitter fraction so replayed streams neither
    thundering-herd nor diverge between runs."""

    max_attempts: int = 4
    base_s: float = 0.01
    multiplier: float = 2.0
    max_backoff_s: float = 0.25
    jitter: float = 0.5  # backoff is scaled into [1 - jitter, 1] deterministically

    def backoff_s(self, retry: int, token: int = 0) -> float:
        raw = min(self.base_s * self.multiplier ** retry, self.max_backoff_s)
        return raw * (1.0 - self.jitter * _unit_hash(token, retry, salt=7))


# --------------------------------------------------------------------------- #
# per-query deadlines (cold vs warm budgets)
# --------------------------------------------------------------------------- #


@dataclass(frozen=True)
class DeadlineConfig:
    """Wall-clock budgets per query.  ``cold_s`` covers the first query of a
    (kind, spec, bucket, objective) shape — which pays the build and, in a
    new process on the card, the kernel libraries' load — ``warm_s`` covers
    the cached steady state.
    ``optimize_scale`` multiplies both for optimize/frontier queries, whose
    useful work is a whole descent rather than one dispatch."""

    warm_s: float = 2.0
    cold_s: float = 30.0
    optimize_scale: float = 4.0

    def budget_s(self, cold: bool, kind: str = "simulate") -> float:
        base = self.cold_s if cold else self.warm_s
        return base * (self.optimize_scale if kind in ("optimize", "frontier") else 1.0)


# --------------------------------------------------------------------------- #
# per-(kind, bucket) circuit breaker
# --------------------------------------------------------------------------- #


@dataclass
class _BreakerState:
    failures: int = 0  # consecutive server-side failures
    opened_at: float | None = None
    trips: int = 0
    rejected: int = 0


class CircuitBreaker:
    """Consecutive-failure breaker, one independent state per key.

    Closed → ``failure_threshold`` consecutive failures → open (fast-fail)
    → after ``cooldown_s`` one probe query is let through (half-open) →
    success closes the breaker, failure re-opens it with a fresh cooldown.
    Single-threaded by design, matching the service's serve loop."""

    def __init__(self, failure_threshold: int = 4, cooldown_s: float = 5.0,
                 clock: Callable[[], float] = time.monotonic):
        self.failure_threshold = failure_threshold
        self.cooldown_s = cooldown_s
        self._clock = clock
        self._states: dict = {}

    def _state(self, key) -> _BreakerState:
        return self._states.setdefault(key, _BreakerState())

    def allow(self, key) -> bool:
        st = self._state(key)
        if st.opened_at is not None and (self._clock() - st.opened_at) < self.cooldown_s:
            st.rejected += 1
            return False
        return True  # closed, or open past cooldown: the half-open probe

    def record(self, key, ok: bool) -> None:
        st = self._state(key)
        if ok:
            st.failures = 0
            st.opened_at = None
        else:
            st.failures += 1
            if st.failures >= self.failure_threshold or st.opened_at is not None:
                if st.opened_at is None:
                    st.trips += 1
                st.opened_at = self._clock()

    def snapshot(self) -> dict:
        """Per-key breaker state for stats: open?, consecutive failures,
        lifetime trips and fast-fail rejections."""
        now = self._clock()
        return {
            key: dict(
                open=st.opened_at is not None and (now - st.opened_at) < self.cooldown_s,
                failures=st.failures, trips=st.trips, rejected=st.rejected,
            )
            for key, st in self._states.items()
        }


# --------------------------------------------------------------------------- #
# result validation: non-finite containment at the reply boundary
# --------------------------------------------------------------------------- #


def nonfinite_in(result: Any) -> str | None:
    """Name of the first non-finite headline field of a result object, or
    None when the reply is clean.  This is the serving-side containment
    net: the engines already roll back non-finite descent steps (dopt) and
    mark diverging members infeasible (popsim), so anything caught here is
    either injected chaos or a genuinely new numeric escape — both become
    a typed :class:`NumericFault`, never a NaN shipped to a client.

    Budget fields are deliberately not checked: ``inf`` is the valid
    spelling of "no budget"."""
    from repro_torch.core.report import FrontierResult, OptResult, SimReport

    if isinstance(result, SimReport):
        if not math.isfinite(result.area_mm2):
            return "area_mm2"
        for wl in result.workloads:
            for f in ("runtime_s", "energy_j", "power_w", "edp"):
                if not math.isfinite(getattr(wl, f)):
                    return f"{wl.label}.{f}"
        return None
    if isinstance(result, OptResult):
        if not math.isfinite(result.improvement):
            return "improvement"
        for i, v in enumerate(result.objective_history):
            if not math.isfinite(v):
                return f"objective_history[{i}]"
        for sub, nm in ((result.baseline, "baseline"), (result.optimized, "optimized")):
            if sub is not None:
                hit = nonfinite_in(sub)
                if hit:
                    return f"{nm}.{hit}"
        return None
    if isinstance(result, FrontierResult):
        if not math.isfinite(result.hypervolume):
            return "hypervolume"
        for p in result.front:
            for f in ("time_s", "energy_j", "area_mm2", "power_w", "edp"):
                if not math.isfinite(getattr(p, f)):
                    return f"front[{p.index}].{f}"
        return None
    return None


# --------------------------------------------------------------------------- #
# the guarded call: retry x deadline x validation, one outcome
# --------------------------------------------------------------------------- #


@dataclass
class GuardedOutcome:
    """What one guarded call produced: either ``result`` (fault is None) or
    a terminal :class:`FaultInfo`.  ``attempts`` counts tries made."""

    result: Any = None
    fault: FaultInfo | None = None
    attempts: int = 0
    wall_s: float = 0.0
    deadline_s: float = float("inf")

    @property
    def ok(self) -> bool:
        return self.fault is None

    @property
    def retries(self) -> int:
        return max(0, self.attempts - 1)


def run_guarded(
    fn: Callable[[int], Any],
    *,
    policy: RetryPolicy,
    deadline_s: float,
    token: int = 0,
    clock: Callable[[], float] = time.monotonic,
    sleep: Callable[[float], None] = time.sleep,
    validate: Callable[[Any], str | None] = nonfinite_in,
    classify: Callable[[BaseException], ServingFault] = classify_exception,
) -> GuardedOutcome:
    """Run ``fn(attempt)`` under the full guard stack.

    Per attempt: call, validate the result (non-finite headline fields
    raise :class:`NumericFault`), then check the wall clock — an answer
    that lands past ``deadline_s`` is a :class:`DeadlineExceeded` outcome,
    not a success.  Faults are classified; retryable ones retry with
    deterministic backoff, but only while the remaining budget covers the
    pause (a retry that cannot finish in budget degrades to
    ``deadline-exceeded`` immediately instead of burning the sleep).
    Never raises: every path returns a :class:`GuardedOutcome`.
    """
    t0 = clock()
    attempt = 0
    fault: ServingFault = TransientFault("no attempt made")
    while attempt < policy.max_attempts:
        try:
            result = fn(attempt)
            hit = validate(result) if validate is not None else None
            if hit is not None:
                raise NumericFault(f"non-finite result field {hit!r}")
            wall = clock() - t0
            if wall > deadline_s:
                raise DeadlineExceeded(
                    f"answered after {wall:.3f}s > {deadline_s:.3f}s budget"
                )
            return GuardedOutcome(result=result, attempts=attempt + 1,
                                  wall_s=wall, deadline_s=deadline_s)
        except BaseException as e:  # noqa: B036 — classified, never swallowed
            if isinstance(e, (KeyboardInterrupt, SystemExit)):
                raise
            fault = classify(e)
        attempt += 1
        if not fault.retryable or attempt >= policy.max_attempts:
            break
        pause = policy.backoff_s(attempt - 1, token)
        if (clock() - t0) + pause >= deadline_s:
            fault = DeadlineExceeded(
                f"budget exhausted after {attempt} attempt(s): remaining "
                f"{max(0.0, deadline_s - (clock() - t0)):.3f}s < backoff {pause:.3f}s"
            )
            break
        sleep(pause)
    return GuardedOutcome(
        fault=FaultInfo(code=fault.code, message=str(fault),
                        attempts=attempt, retryable=fault.retryable),
        attempts=attempt, wall_s=clock() - t0, deadline_s=deadline_s,
    )
