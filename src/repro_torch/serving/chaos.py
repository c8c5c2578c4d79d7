"""Seeded, deterministic chaos harness for the design service.

Resilience claims are only as good as the faults they were tested under, so
the fault source must be *replayable*: :class:`ChaosInjector` derives every
injection decision from ``SeedSequence([seed, qid])`` — a stable hash that
does not depend on arrival order, retry interleaving, or wall clock.  The
same seed therefore produces the identical fault schedule on every run and
every platform (the port's schedules equal the reference's, draw for draw),
which is what lets ``chip_smoke.py``'s chaos phase assert exact
availability numbers and lets tests diff two runs bit-for-bit.

Fault repertoire (per query, mutually composable):

  * **transient exception** — the attempt raises
    :class:`~repro_torch.serving.resilience.TransientFault` before the engine
    runs;
  * **compile failure** — same raise, labelled as a failed build (the service
    observes it pre-result, like a kernel library that fails to build or
    load);
  * **latency spike** — the first attempt sleeps ``latency_s`` before the
    engine runs, stressing deadlines and the straggler monitor;
  * **NaN poisoning** — the attempt's *result* has a headline field replaced
    with NaN (``SimReport.area_mm2`` / ``OptResult.improvement`` /
    ``FrontierResult.hypervolume``), exercising the service's non-finite
    containment and retry instead of the engines' own guards;
  * **cache corruption** — the attempt raises
    :class:`~repro_torch.serving.aotcache.CacheCorruption` before the engine
    runs, modelling a torn/bit-flipped persistent cache record discovered at
    program-load time (the real reader quarantines the file and falls back
    to a fresh build — transient by construction, so retry clears it);
  * **worker kill** — not injected by :meth:`ChaosInjector.call` at all: a
    multi-process coordinator reads ``plan(qid).worker_kill`` and kills the
    worker process a marked query was assigned to, once per qid.  The
    in-process services of this package ignore the flag; it is drawn so the
    schedules stay the reference's, draw for draw.

Faults fire on the *leading* attempts of a query only (bounded depth), so a
retry policy with enough attempts always clears transient-class chaos —
this is the property the chaos gates hold at availability == 1.0.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import Counter
from dataclasses import dataclass
from typing import Any, Callable

import numpy as np

from repro_torch.serving.aotcache import CacheCorruption
from repro_torch.serving.resilience import TransientFault

_NAN = float("nan")


@dataclass(frozen=True)
class ChaosConfig:
    """Per-fault marginal probabilities (independent draws per query) and
    shape knobs.  ``depth`` is how many leading attempts each drawn fault
    consumes — keep ``depth * (number of fault classes) < max_attempts`` if
    availability must stay 1.0 under retry."""

    seed: int = 0
    p_transient: float = 0.0
    p_compile_fail: float = 0.0
    p_latency: float = 0.0
    p_nan: float = 0.0
    latency_s: float = 0.05
    depth: int = 1
    p_cache_corrupt: float = 0.0
    p_worker_kill: float = 0.0


@dataclass(frozen=True)
class FaultPlan:
    """The chaos verdict for one query: how many leading attempts raise a
    transient, then a compile failure, then a corrupt-cache-entry fault,
    then how many return a NaN-poisoned result; ``latency`` delays the
    first attempt."""

    qid: int
    transient: int
    compile_fail: int
    nan: int
    latency: bool
    cache_corrupt: int = 0
    # coordinator-enacted (process death), not an attempt fault: the query
    # is re-enqueued and re-served whole, so it does not affect clean /
    # min_attempts — a killed-and-requeued query still answers bit-identically
    worker_kill: bool = False

    @property
    def clean(self) -> bool:
        return not (
            self.transient or self.compile_fail or self.cache_corrupt
            or self.nan or self.latency
        )

    @property
    def min_attempts(self) -> int:
        """Attempts a retrying client needs to get a clean answer."""
        return self.transient + self.compile_fail + self.cache_corrupt + self.nan + 1

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


def poison(result: Any) -> Any:
    """Return ``result`` with one headline metric NaN'd (frozen dataclasses
    are rebuilt via ``dataclasses.replace``); non-report objects pass
    through untouched."""
    from repro_torch.core.report import FrontierResult, OptResult, SimReport

    if isinstance(result, SimReport):
        return dataclasses.replace(result, area_mm2=_NAN)
    if isinstance(result, OptResult):
        return dataclasses.replace(result, improvement=_NAN)
    if isinstance(result, FrontierResult):
        return dataclasses.replace(result, hypervolume=_NAN)
    return result


class ChaosInjector:
    """Wraps a query handler with the seeded fault schedule.

    The service calls :meth:`call` once per attempt; everything the injector
    does is a pure function of ``(config.seed, qid, attempt)`` plus the
    handler's own (deterministic) result, so two services configured with
    the same seed observe the same chaos regardless of timing.
    """

    def __init__(self, config: ChaosConfig, *, sleep: Callable[[float], None] = time.sleep):
        self.config = config
        self.sleep = sleep
        self.injected: Counter = Counter()
        # a pooled service runs attempts from several threads; the ledger
        # (not the schedule, which is pure) needs the lock
        self._lock = threading.Lock()

    # ----------------------------------------------------------- schedule --
    def plan(self, qid: int) -> FaultPlan:
        c = self.config
        # new fault classes always draw LAST: PCG64 generates uniforms
        # sequentially, so draws 0-3 are identical to the historical 4-draw
        # schedule and draw 4 to the 5-draw one — adding a fault class
        # never reshuffles existing seeded schedules (cache_corrupt joined
        # at index 4, worker_kill at index 5)
        u = np.random.default_rng(
            np.random.SeedSequence([c.seed & 0xFFFFFFFF, qid & 0xFFFFFFFF])
        ).random(6)
        d = c.depth
        return FaultPlan(
            qid=qid,
            transient=d * int(u[0] < c.p_transient),
            compile_fail=d * int(u[1] < c.p_compile_fail),
            nan=d * int(u[2] < c.p_nan),
            latency=bool(u[3] < c.p_latency),
            cache_corrupt=d * int(u[4] < c.p_cache_corrupt),
            worker_kill=bool(u[5] < c.p_worker_kill),
        )

    def schedule(self, qids) -> list[FaultPlan]:
        """The full fault schedule for a batch — what determinism tests and
        the chaos gates' bit-identity check compare against."""
        return [self.plan(q) for q in qids]

    # --------------------------------------------------------------- inject --
    def call(self, handler: Callable[[], Any], *, qid: int, attempt: int) -> Any:
        """Run one attempt of ``handler`` under the query's fault plan."""
        p = self.plan(qid)
        if p.latency and attempt == 0:
            self._count("latency")
            self.sleep(self.config.latency_s)
        if attempt < p.transient:
            self._count("transient")
            raise TransientFault(f"chaos: injected transient fault (q{qid} attempt {attempt})")
        if attempt - p.transient < p.compile_fail:
            self._count("compile_fail")
            raise TransientFault(f"chaos: injected compile failure (q{qid} attempt {attempt})")
        if attempt - p.transient - p.compile_fail < p.cache_corrupt:
            # pre-engine, like the real thing: a torn entry surfaces at
            # program-load time, before any dispatch
            self._count("cache_corrupt")
            raise CacheCorruption(
                f"chaos: injected corrupt cache entry (q{qid} attempt {attempt})"
            )
        result = handler()
        if attempt - p.transient - p.compile_fail - p.cache_corrupt < p.nan:
            bad = poison(result)
            if bad is not result:
                self._count("nan")
                return bad
            # nothing poisonable in this result type: no injection recorded
        return result

    def _count(self, fault: str, n: int = 1) -> None:
        with self._lock:
            self.injected[fault] += n

    # ----------------------------------------------------------------- info --
    def summary(self) -> dict:
        return dict(self.injected)
