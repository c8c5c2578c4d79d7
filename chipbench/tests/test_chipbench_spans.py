"""The readers of the program's spans (``metrics/_spans.py`` and the six
per-layer metrics built on it), on a made-up span table, and on the tiny
cells' traced runs, where the CPU gives no stream time to read."""
from __future__ import annotations

import importlib.util

import pytest

from chipbench.tests.conftest import ROOT, run_cell
from repro_torch import instrument

# metric: (the span it sums, the span it counts)
READERS = {
    "forward_ms.descent": ("popsim.forward", "popsim.epoch"),
    "backward_ms.descent": ("popsim.backward", "popsim.epoch"),
    "update_ms.descent": ("popsim.update", "popsim.epoch"),
    "dgen_ms.sweep": ("dgen.specialize", "popsim.log_metrics"),
    "mapper_intrinsics_ms.sweep": ("mapper.intrinsics", "popsim.log_metrics"),
    "mapper_finish_ms.sweep": ("mapper.finish", "popsim.log_metrics"),
}
DESCENT = ["popsim.epoch", "popsim.forward", "popsim.backward", "popsim.update"]
SWEEP = ["popsim.log_metrics", "dgen.specialize", "mapper.intrinsics", "mapper.finish"]


def reader(name):
    spec = importlib.util.spec_from_file_location(name, ROOT / "chipbench" / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def table(units: int, stream=True) -> list:
    """``units`` epochs and ``units`` requests: the k-th record of a name has
    a stream time of (its place in DESCENT or SWEEP + 1) * (k + 1) ms."""
    out, i = [], 0
    for names in (DESCENT, SWEEP):
        for k in range(units):
            for j, name in enumerate(names):
                ms = (j + 1) * (k + 1)
                out.append(instrument.Span(name, i, None, i, 0, 1000, ms / 1e3 if stream else None))
                i += 1
    return out


@pytest.mark.parametrize("metric", sorted(READERS))
def test_a_reader_gives_the_mean_over_the_units(metric, monkeypatch):
    span, _ = READERS[metric]
    j = (DESCENT if span in DESCENT else SWEEP).index(span) + 1
    monkeypatch.setattr(instrument, "spans", lambda: table(3))
    # (1 + 2 + 3) * j ms over 3 epochs or requests
    assert reader(metric)(None) == pytest.approx(2.0 * j)


@pytest.mark.parametrize("metric", sorted(READERS))
def test_no_stream_time_no_number(metric, monkeypatch):
    monkeypatch.setattr(instrument, "spans", lambda: table(3, stream=False))
    assert reader(metric)(None) is None


@pytest.mark.parametrize("metric", sorted(READERS))
def test_no_span_no_number(metric, monkeypatch):
    """An empty table, a table without the unit, and a program without spans
    (one older than them) give no number, and raise nothing."""
    per = READERS[metric][1]
    monkeypatch.setattr(instrument, "spans", lambda: [])
    assert reader(metric)(None) is None
    monkeypatch.setattr(instrument, "spans", lambda: [r for r in table(2) if r.name != per])
    assert reader(metric)(None) is None
    monkeypatch.delattr(instrument, "spans")
    assert reader(metric)(None) is None


@pytest.mark.parametrize("cell, unit", [("tiny_lm.tiny_descent", "popsim.epoch"),
                                        ("tiny_classic.tiny_sweep", "popsim.log_metrics")])
def test_a_cpu_run_reads_no_span(checkout, cell, unit, capsys):
    """The tiny cells take the six metrics from the real ones; their traced
    runs record spans (the profiler is on) without stream times, so none of
    the six is reported."""
    instrument.reset_spans()
    rc, res = run_cell(checkout, cell, trace=1, capsys=capsys)
    assert rc == 0 and res["correct"] is True
    assert not set(READERS) & set(res["metrics"])
    records = [r for r in instrument.spans() if r.name == unit]
    assert records and all(r.stream_s is None for r in records)
