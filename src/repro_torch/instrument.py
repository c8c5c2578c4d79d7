"""Build counts for the program cache, loop notes, and the layers' spans.

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

Spans time the layers of a call, and only while a ``torch.profiler`` session
is active ("tracing on").  ``with span("mapper.map", device):`` then opens the
``torch.profiler.record_function`` range ``repro_torch::mapper.map`` (on the
profiler's timeline, beside the kernels), reads the host clock at entry and
exit, records a pair of CUDA timing events on the device's current stream when
``device`` is a CUDA device, and appends one record to an in-memory table: the
name, its parent (the innermost span open on the same thread), its root (the
outermost one; every span under one chunk or one request shares it) and the
times.  Tracing off, a span is one flag check and does nothing else.  Nothing
here synchronises.

To get each layer's host and device-stream time, the operator runs the calls
under ``torch.profiler.profile``, synchronises, and reads :func:`spans`:
``host_s`` is the host's time inside the span; ``stream_s`` the stream's time
from the work enqueued before the span to the span's last work, that is the
layer's kernels plus any wait for the host inside it (``None`` off CUDA).
Sibling spans on one stream partition their parent.  :func:`reset_spans`
empties the table.  The spans (their counts are the counters: one
``popsim.epoch`` an epoch, one ``popsim.log_metrics`` a request):

  * ``popsim.chunk`` (``population_chunk``): ``popsim.epoch`` each epoch, then
    ``popsim.readback``, the history's copy to the host;
  * ``popsim.epoch``: ``popsim.forward`` (the objective, holding
    ``dsim.simulate``), ``popsim.backward`` (``torch.autograd.grad``) and
    ``popsim.update`` (the finite checks, Adam, the clamp, the rollback, the
    row);
  * ``popsim.log_metrics`` (``population_log_metrics``): ``dsim.simulate``;
  * ``dsim.simulate``: ``dgen.specialize``, then ``mapper.map``, which on the
    prefix-scan path holds ``mapper.intrinsics``, ``mapper.carries`` (K1) and
    ``mapper.finish``;
  * ``selective_scan_backward``, ``ssd_chunk_scan_backward`` and
    ``chunked_attention_backward``: the plain backwards of the scans and of
    attention; autograd may run them on its own thread, where they are roots.
"""
from __future__ import annotations

import itertools
import threading
import time
from collections import Counter
from contextlib import contextmanager, nullcontext
from dataclasses import dataclass

import torch
from torch.autograd import profiler as _profiler

RANGE_PREFIX = "repro_torch::"  # a span's torch.profiler range is RANGE_PREFIX + its name

_counts: Counter = Counter()
_loops: list | None = None  # the active loop recorder (launch.hlo_stats), if any
_spans: list = []  # the span table: every _Open entered while tracing, in order of entry
_span_ids = itertools.count()


class _Stacks(threading.local):
    def __init__(self):
        self.open = []  # this thread's open spans, innermost last


_stacks = _Stacks()
_OFF = nullcontext()


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


@dataclass(frozen=True)
class Span:
    """One closed span of the table: ``parent`` is None for a root, and
    ``root`` is the id of the outermost span it ran under (its own for a
    root); ``start_ns``/``end_ns`` are ``time.perf_counter_ns()`` readings."""

    name: str
    id: int
    parent: int | None
    root: int
    start_ns: int
    end_ns: int
    stream_s: float | None  # None off CUDA

    @property
    def host_s(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


class _Open:
    """A span while tracing is on (see the module docstring)."""

    def __init__(self, name: str, device: torch.device | None):
        self.name = name
        cuda = device is not None and torch.device(device).type == "cuda"
        self.stream = torch.cuda.current_stream(device) if cuda else None
        self.start = self.end = self.end_ns = None

    def __enter__(self):
        self.range = torch.profiler.record_function(RANGE_PREFIX + self.name)
        self.range.__enter__()
        stack = _stacks.open
        self.id = next(_span_ids)
        self.parent = stack[-1].id if stack else None
        self.root = stack[0].id if stack else self.id
        stack.append(self)
        _spans.append(self)
        self.start_ns = time.perf_counter_ns()
        if self.stream is not None:
            self.start, self.end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            self.start.record(self.stream)
        return self

    def __exit__(self, *exc):
        if self.end is not None:
            self.end.record(self.stream)
        self.end_ns = time.perf_counter_ns()
        _stacks.open.pop()
        self.range.__exit__(*exc)
        return False


def span(name: str, device: torch.device | None = None):
    """A context manager timing one layer of a call as span ``name`` while
    tracing is on; ``device`` is where the layer's work runs (a CUDA device
    gives the span its stream time).  Tracing off, it does nothing."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Open(name, device)


def spans() -> list[Span]:
    """The closed spans recorded since the last :func:`reset_spans`, in order
    of entry, with their device events resolved (waiting for them if the
    caller has not synchronised)."""
    out = []
    for s in list(_spans):
        if s.end_ns is None:
            continue
        stream_s = None
        if s.end is not None:
            s.end.synchronize()
            stream_s = s.start.elapsed_time(s.end) / 1e3
        out.append(Span(s.name, s.id, s.parent, s.root, s.start_ns, s.end_ns, stream_s))
    return out


def reset_spans() -> None:
    """Empty the span table."""
    _spans.clear()
