"""Per-layer times the program records itself: the spans of
``repro_torch.instrument`` (``instrument.span``), which the program keeps in
memory while a ``torch.profiler`` session is on, so over the traced window.
Each record carries its device stream's time (``stream_s``): the layer's
kernels and any wait for the host inside it.

A program without spans (one older than them), a span never recorded, or a
record without a stream time (a run off CUDA) gives ``None``: no number."""
from __future__ import annotations


def table() -> list | None:
    """The program's span records, or None when it keeps none."""
    try:
        from repro_torch import instrument

        return instrument.spans()
    except (ImportError, AttributeError):
        return None


def ms_per(span: str, per: str, records: list | None = None) -> float | None:
    """The stream time of every ``span`` record summed, in ms, over the
    number of ``per`` records (``popsim.epoch`` for an epoch,
    ``popsim.log_metrics`` for a request)."""
    records = table() if records is None else records
    if not records:
        return None
    got = [r for r in records if r.name == span]
    counted = [r for r in records if r.name == per]
    if not got or not counted or any(r.stream_s is None for r in got + counted):
        return None
    return 1e3 * sum(r.stream_s for r in got) / len(counted)
