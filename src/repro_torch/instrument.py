"""Build-count instrumentation for the program cache.

The port runs eagerly: no call is traced or compiled, so there is no trace to
count.  What a warm call must never repeat is the one-time work for a
configuration, a *build*, and that is what these counters count.  A counter is
bumped where the work happens, exactly once per build, and never where a built
thing is merely used:

  * ``{session}.{kind}`` — a :class:`repro_torch.api.Session` program cache
    key missed and ``build()`` ran (kinds ``simulate``, ``report``,
    ``explain``, ``report_batched``, ``explain_batched``); calling the built
    program counts nothing;
  * ``runtime.build`` — ``kernels.runtime.library`` loaded a kernel library
    for the first time in the process (built by ``nvcc`` or found in the
    build directory), one count per library;
  * ``dgen.spec_arrays`` — ``dgen.specialize`` copied an ``ArchSpec``'s
    arrays to a device for the first time (one host-to-device copy per new
    ``(spec, device)``).

``Session.stats`` and the cache tests read the counters back: "warm
same-bucket calls build nothing" is asserted, not assumed.  The engines
themselves (DOpt, the population step) build nothing per configuration, so
they have no tag of their own; a warm optimize or frontier is checked against
every tag at once (:func:`trace_count` with no arguments).
"""
from __future__ import annotations

from collections import Counter
from contextlib import contextmanager

_counts: Counter = Counter()
_loops: list | None = None  # the active loop recorder (launch.hlo_stats), if any


def count_trace(tag: str) -> None:
    """Record one build of ``tag``.  Call this where the one-time work runs,
    never on the path that reuses its result."""
    _counts[tag] += 1


def trace_count(tag: str | None = None, prefix: str | None = None) -> int:
    """Total builds recorded for ``tag``, for all tags starting with
    ``prefix``, or for everything."""
    if tag is not None:
        return _counts[tag]
    if prefix is not None:
        return sum(v for k, v in _counts.items() if k.startswith(prefix))
    return sum(_counts.values())


def snapshot() -> dict:
    """Immutable copy of all counters (for before/after deltas in tests)."""
    return dict(_counts)


def reset(prefix: str | None = None) -> None:
    """Clear counters (optionally only those under ``prefix``).  Test-only:
    resetting does not discard anything built."""
    if prefix is None:
        _counts.clear()
    else:
        for k in [k for k in _counts if k.startswith(prefix)]:
            del _counts[k]


@contextmanager
def record_loops():
    """Collect the (name, trip count) of every layer loop a program notes
    (:func:`note_loop`) while the context is open: an eager program has no
    loop of its own to read them from."""
    global _loops
    prev, _loops = _loops, []
    try:
        yield _loops
    finally:
        _loops = prev


def note_loop(name: str, trips: int) -> None:
    """A loop over ``trips`` layers (or chunks) is about to run; free when no
    recorder is open."""
    if _loops is not None:
        _loops.append((name, int(trips)))
