"""Cross-request batching mechanics: intake queue, flush policy, coalescing.

The façade's bucket convention makes same-``(kind, spec, bucket,
objective)`` query stacks *structurally identical*, so one program with a
leading request axis can answer a whole group in one dispatch (on the card
the mapper runs once on [nb, W, V] and K1 takes nb·W rows in one launch).
This module owns the plumbing around that fact:

* :class:`FlushPolicy` — when a queued batch is dispatched (size or age);
* :class:`IntakeQueue` — the arrival-ordered queue with an injectable
  clock, so tests drive flush timing deterministically;
* :func:`plan_chunks` — group admitted queries by batch key into dispatch
  chunks (arrival order preserved, chunk size capped);
* :func:`make_chunk_handlers` — per-lane handlers over ONE lazily
  memoized coalesced dispatch, shaped so the existing resilience stack
  (retry / deadline / chaos injection) wraps each query unchanged.

The lazy memo is the contract that keeps the guard stack's guarantees
intact: the coalesced dispatch runs inside the *first* lane's guarded
attempt (so the cold deadline applies to the query that pays it), later lanes read
their slice for free, and a chaos fault injected into one lane never
touches the memo — retries of that lane return its clean slice.

:class:`repro_torch.serving.BatchingDesignService` composes these with the
``DesignService`` guard stack.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Optional

#: query kinds that may share a coalesced dispatch (pure, stateless
#: evaluations; optimize/frontier carry per-query engine knobs and loops)
BATCHABLE_KINDS = ("simulate", "explain")


@dataclass(frozen=True)
class FlushPolicy:
    """When does a queued batch flush?

    * immediately once ``max_batch`` queries wait (size trigger);
    * once the *oldest* queued query is ``max_delay_s`` old and at least
      ``min_batch`` queries wait (deadline trigger — bounds the latency a
      query can pay for the privilege of being coalesced).

    ``max_batch`` doubles as the service's pinned request bucket: every
    dispatch pads its request axis to it, so one program serves
    every batch size and replies are bit-identical however queries were
    coalesced.
    """

    max_batch: int = 8
    max_delay_s: float = 0.002
    min_batch: int = 1

    def __post_init__(self):
        if self.max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {self.max_batch}")
        if not 1 <= self.min_batch <= self.max_batch:
            raise ValueError(
                f"min_batch must be in [1, max_batch], got {self.min_batch}"
            )
        if self.max_delay_s < 0:
            raise ValueError(f"max_delay_s must be >= 0, got {self.max_delay_s}")


class IntakeQueue:
    """Arrival-ordered intake queue with enqueue timestamps.

    The clock is injectable so tests (and the deterministic bench) can
    drive the age-based flush trigger without sleeping.  Push/drain are
    lock-guarded: a pooled service pushes from caller threads while its
    dispatcher thread drains.
    """

    def __init__(self, clock: Callable[[], float] = time.monotonic):
        self._clock = clock
        self._lock = threading.Lock()
        self._items: list = []  # (t_enqueue, query)

    def __len__(self) -> int:
        return len(self._items)

    def push(self, query: Any) -> None:
        with self._lock:
            self._items.append((self._clock(), query))

    def oldest_age(self) -> float:
        with self._lock:
            if not self._items:
                return 0.0
            return self._clock() - self._items[0][0]

    def due(self, policy: FlushPolicy) -> bool:
        n = len(self._items)
        if n == 0:
            return False
        if n >= policy.max_batch:
            return True
        return n >= policy.min_batch and self.oldest_age() >= policy.max_delay_s

    def drain(self) -> list:
        """Pop everything, in arrival order, as ``(t_enqueue, query)``."""
        with self._lock:
            items, self._items = self._items, []
        return items


def batch_key(adm) -> Optional[tuple]:
    """The coalescing key for an admitted query — queries sharing it are
    answerable by one request-axis program — or None if the kind cannot
    batch.  Tenant is deliberately absent: parameter values are call
    arguments and programs are shared, so cross-tenant coalescing is exact."""
    q = adm.q
    if q.kind not in BATCHABLE_KINDS:
        return None
    objective = q.objective if q.kind == "explain" else None
    return (q.kind, adm.arch.spec, adm.w.bucket, objective)


def plan_chunks(admitted: list, max_batch: int) -> list:
    """Group ``(idx, adm)`` pairs into dispatch chunks.

    Same-key queries share a chunk (capped at ``max_batch``, overflow
    starts a fresh chunk); unbatchable queries become singleton chunks.
    Chunk order follows each chunk's first arrival, and members keep
    arrival order inside the chunk — the scatter back to per-query replies
    is by the original ``idx``, so reply order never depends on grouping.
    """
    chunks: list = []
    open_chunk: dict = {}  # key -> index into chunks of the unfilled chunk
    for idx, adm in admitted:
        key = batch_key(adm)
        if key is None:
            chunks.append([(idx, adm)])
            continue
        at = open_chunk.get(key)
        if at is None or len(chunks[at]) >= max_batch:
            open_chunk[key] = len(chunks)
            chunks.append([(idx, adm)])
        else:
            chunks[at].append((idx, adm))
    return chunks


def make_chunk_handlers(chunk: list, dispatch: Callable[[list], list]) -> dict:
    """Per-lane handlers over one lazily memoized coalesced dispatch.

    ``dispatch(adms)`` must return one result per admitted query, in order.
    It runs at most once per *successful* attempt-chain: the first lane
    whose guarded attempt reaches its handler pays the dispatch (and any
    cold build — its deadline is the cold one precisely because the
    warmth ledger said so); every other lane reads its memoized slice.
    If the dispatch itself raises, the memo stays empty and the next
    attempt — same lane's retry, or the next lane — tries again, so a
    transient dispatch fault degrades exactly like a sequential one.
    Chaos NaN-poisoning copies (``dataclasses.replace``) the returned
    slice, never the memo, so one lane's injected fault cannot leak into a
    batchmate's reply.
    """
    memo: dict = {}
    adms = [adm for _, adm in chunk]

    def lane(i: int) -> Callable[[], Any]:
        def handler():
            if "results" not in memo:
                memo["results"] = dispatch(adms)
            return memo["results"][i]

        return handler

    return {idx: lane(i) for i, (idx, _) in enumerate(chunk)}
