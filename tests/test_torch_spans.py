"""The port's spans (repro_torch.instrument.span) on the DSE path, on the CPU.

Under a ``torch.profiler`` session a population chunk and a design sweep's
evaluation record the span tree of each layer boundary, each span a
``repro_torch::<name>`` range on the profiler's timeline; with no session
they record nothing and open no range, and the results are the same bits
either way.  Off CUDA a span has no stream time.
"""
from __future__ import annotations

import threading

import numpy as np
import pytest
import torch

import repro_torch.workloads as twl
from repro_torch import instrument
from repro_torch.core import popsim
from repro_torch.core.graph import Graph
from repro_torch.models.layers import chunked_attention

CPU = "cpu"
P = 4
EPOCH = ["popsim.forward", "popsim.backward", "popsim.update"]
SIMULATE = ["dgen.specialize", "mapper.map"]
MAP = ["mapper.intrinsics", "mapper.carries", "mapper.finish"]
DSE_SPANS = {"popsim.chunk", "popsim.epoch", *EPOCH, "popsim.readback", "popsim.log_metrics", "dsim.simulate",
             *SIMULATE, *MAP}


@pytest.fixture(scope="module")
def dse():
    """A small population on lstm + bert_base (V >= 32: the prefix-scan mapper)."""
    gs = Graph.stack([twl.get_workload(n, device=CPU) for n in ("lstm", "bert_base")])
    assert gs.n_vertices >= 32
    (tech, arch), spec, _ = popsim.seed_population(P, ("base", "edge"), key=0, device=CPU)
    inf = torch.full((P,), float("inf"))
    mixes = (popsim.sample_objective_mixes(P, key=1, device=CPU), inf, inf)
    return dict(gs=gs, tech=tech, arch=arch, spec=spec, mixes=mixes,
                state=popsim.init_population_state(tech, arch), sched=torch.tensor([2.0, 1.0]))


def _chunk(d):
    return popsim.population_chunk(d["state"], d["mixes"], d["gs"], 0.1, d["sched"], spec=d["spec"])


def _log_metrics(d):
    return popsim.population_log_metrics(d["tech"], d["arch"], d["gs"], d["spec"])


def _traced(fn, *args):
    instrument.reset_spans()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn(*args)
    return out, instrument.spans(), {e.key for e in prof.key_averages()}


def _tree(records) -> list:
    """Each root as (name, [children's trees]), children in order of entry."""
    kids = {r.id: [] for r in records}
    roots = []
    for r in records:
        (kids[r.parent] if r.parent is not None else roots).append(r)

    def node(r):
        return (r.name, [node(c) for c in kids[r.id]])

    return [node(r) for r in roots]


SIM_TREE = ("dsim.simulate", [("dgen.specialize", []), ("mapper.map", [(n, []) for n in MAP])])
EPOCH_TREE = ("popsim.epoch", [("popsim.forward", [SIM_TREE]), ("popsim.backward", []), ("popsim.update", [])])


def test_a_chunk_records_its_tree(dse):
    _, records, _ = _traced(_chunk, dse)
    assert _tree(records) == [("popsim.chunk", [EPOCH_TREE, EPOCH_TREE, ("popsim.readback", [])])]


def test_a_sweep_request_records_its_tree(dse):
    _, records, _ = _traced(_log_metrics, dse)
    assert _tree(records) == [("popsim.log_metrics", [SIM_TREE])]


@pytest.mark.parametrize("call", [_chunk, _log_metrics])
def test_records_nest_by_parent_and_root(dse, call):
    _, records, _ = _traced(call, dse)
    ids = {r.id: r for r in records}
    assert len(ids) == len(records)
    root = records[0]
    assert root.parent is None and root.root == root.id
    for r in records:
        assert r.root == root.id and r.host_s >= 0 and r.stream_s is None
        if r is not root:
            p = ids[r.parent]
            assert p.start_ns <= r.start_ns <= r.end_ns <= p.end_ns


@pytest.mark.parametrize("call", [_chunk, _log_metrics])
def test_the_profile_holds_each_range(dse, call):
    _, records, keys = _traced(call, dse)
    names = {r.name for r in records}
    assert names <= DSE_SPANS
    assert {instrument.RANGE_PREFIX + n for n in names} <= keys


def test_no_profiler_no_span_and_no_range(dse, monkeypatch):
    entered = []

    class Counting(torch.profiler.record_function):
        def __enter__(self):
            entered.append(self.name)
            return super().__enter__()

    monkeypatch.setattr(torch.profiler, "record_function", Counting)
    instrument.reset_spans()
    _chunk(dse)
    _log_metrics(dse)
    assert instrument.spans() == [] and entered == []
    _, records, _ = _traced(_log_metrics, dse)  # the count works: traced, every span enters its range
    assert sorted(entered) == sorted(instrument.RANGE_PREFIX + r.name for r in records) and records


def test_tracing_changes_no_bit(dse):
    (state_off, rows_off), metrics_off = _chunk(dse), _log_metrics(dse)
    (state_on, rows_on), _, _ = _traced(_chunk, dse)
    metrics_on, _, _ = _traced(_log_metrics, dse)
    assert np.array_equal(rows_off, rows_on, equal_nan=True)
    for off, on in zip(popsim._state_leaves(state_off), popsim._state_leaves(state_on)):
        assert torch.equal(off, on)
    for off, on in zip(metrics_off, metrics_on):
        assert torch.equal(off, on)


def test_another_thread_keeps_its_own_stack():
    """A span opened on another thread (as autograd's device threads do) is
    a root there, whatever is open on the caller's."""
    instrument.reset_spans()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with instrument.span("outer"):
            t = threading.Thread(target=lambda: instrument.span("elsewhere").__enter__().__exit__(None, None, None))
            t.start()
            t.join(timeout=30)
            with instrument.span("inner"):
                pass
    assert not t.is_alive()
    by = {r.name: r for r in instrument.spans()}
    assert by["elsewhere"].parent is None and by["elsewhere"].root == by["elsewhere"].id
    assert by["inner"].parent == by["outer"].id and by["inner"].root == by["outer"].id


def test_reset_empties_the_table():
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with instrument.span("probe"):
            pass
    assert any(r.name == "probe" for r in instrument.spans())
    instrument.reset_spans()
    assert instrument.spans() == []


def test_the_attention_backward_is_a_span():
    """The attention backward's range (one of the three ranges the port had
    before its spans) is a span of the same name."""
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 2, 16, 8, generator=g, requires_grad=True) for _ in range(3))
    instrument.reset_spans()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        chunked_attention(q, k, v, block_q=8, block_k=8).sum().backward()
    assert [r.name for r in instrument.spans()] == ["chunked_attention_backward"]
    assert "repro_torch::chunked_attention_backward" in {e.key for e in prof.key_averages()}
