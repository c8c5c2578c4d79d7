"""Port conformance: the build counter (core/instrument.py).

The reference counts JAX traces; the port runs eagerly, so it counts builds:
one-time work for a configuration that a warm call must never repeat.  Pinned
here: the counter functions behave as the reference's (prefix isolation,
session1 against session10, reset and snapshot), a build counts and a call
does not, and each of the port's three kinds of build counts once.
"""
from __future__ import annotations

import uuid

import pytest
import torch

import repro.core.instrument as jinstrument
import repro_torch.api as tapi
from repro_torch.core import dgen, instrument
from repro_torch.core.params import ArchParams, ArchSpec, TechParams
from repro_torch.kernels import runtime

CPU = "cpu"


def _tag() -> str:
    return f"test.instrument.{uuid.uuid4().hex[:8]}"


@pytest.mark.parametrize("name", ["count_trace", "trace_count", "snapshot", "reset"])
def test_same_functions_as_the_reference(name):
    import inspect

    assert list(inspect.signature(getattr(instrument, name)).parameters) == \
        list(inspect.signature(getattr(jinstrument, name)).parameters)


class TestPrefixIsolation:
    def test_prefix_sums_only_matching_tags(self):
        base = _tag()
        instrument.count_trace(f"{base}.a")
        instrument.count_trace(f"{base}.b")
        instrument.count_trace(f"{base}.b")
        assert instrument.trace_count(prefix=f"{base}.") == 3
        assert instrument.trace_count(tag=f"{base}.b") == 2

    def test_session1_does_not_see_session10(self):
        base = _tag()
        instrument.count_trace(f"{base}1.simulate")
        instrument.count_trace(f"{base}10.simulate")
        instrument.count_trace(f"{base}10.report")
        assert instrument.trace_count(prefix=f"{base}1.") == 1
        assert instrument.trace_count(prefix=f"{base}10.") == 2

    def test_total_counts_every_tag(self):
        before = instrument.trace_count()
        instrument.count_trace(_tag())
        instrument.count_trace(_tag())
        assert instrument.trace_count() == before + 2

    def test_per_session_cachestats_isolation(self):
        w = tapi.Workload("bfs_graph", device=CPU)
        s1, s2 = tapi.Session(device=CPU), tapi.Session(device=CPU)
        s1.perf(w)
        assert s1.stats.traces == 1
        assert s2.stats.traces == 0 and s2.stats.programs == 0
        s2.perf(w)
        # each session has its own program cache: s2 builds its own program
        assert s2.stats.traces == 1 and s1.stats.traces == 1
        s1.perf(w)  # warm: no new build anywhere
        assert s1.stats.traces == 1 and s1.stats.hits == 1


class TestResetAndSnapshot:
    def test_reset_prefix_scoped(self):
        a, b = _tag(), _tag()
        instrument.count_trace(a)
        instrument.count_trace(b)
        instrument.reset(prefix=a)
        assert instrument.trace_count(a) == 0
        assert instrument.trace_count(b) == 1

    def test_snapshot_is_immutable_copy(self):
        tag = _tag()
        instrument.count_trace(tag)
        snap = instrument.snapshot()
        assert snap[tag] == 1
        snap[tag] = 99
        assert instrument.trace_count(tag) == 1

    def test_reset_does_not_discard_builds(self):
        sess = tapi.Session(device=CPU)
        sess.simulate("lstm")
        instrument.reset(prefix=f"{sess._tag}.")
        sess.simulate("lstm")  # the built program is still cached: no new build
        assert sess.stats.traces == 0 and sess.stats.programs == 1


class TestBuildsNotCalls:
    def test_a_build_counts_and_a_call_does_not(self):
        sess = tapi.Session(device=CPU)
        tag = f"{sess._tag}.report"
        assert instrument.trace_count(tag) == 0
        sess.simulate("lstm")
        assert instrument.trace_count(tag) == 1
        before = instrument.snapshot()
        for name in ("lstm", "merge_sort", "dlrm"):  # warm calls of the built program
            sess.simulate(name)
        assert instrument.snapshot() == before

    @pytest.mark.parametrize("kind,call", [
        ("simulate", lambda s: s.perf("lstm")),
        ("report", lambda s: s.simulate("lstm")),
        ("explain", lambda s: s.explain("lstm")),
        ("report_batched", lambda s: s.simulate_batch(["lstm", "dlrm"])),
        ("explain_batched", lambda s: s.explain_batch(["lstm", "dlrm"])),
    ])
    def test_each_program_kind_counts_under_its_tag(self, kind, call):
        sess = tapi.Session(device=CPU)
        call(sess)
        call(sess)
        assert instrument.trace_count(f"{sess._tag}.{kind}") == 1

    def test_spec_arrays_count_once_per_spec_and_device(self):
        # a spec no other test uses, so its arrays are not cached yet
        spec = ArchSpec(comp_units=("vector", "fpu"), mem_type=("rram", "sram", "sram"))
        tech, arch = TechParams.default(CPU), ArchParams.default(CPU)
        before = instrument.trace_count("dgen.spec_arrays")
        dgen.specialize(tech, arch, spec)
        assert instrument.trace_count("dgen.spec_arrays") == before + 1
        dgen.specialize(tech, arch, spec)
        assert instrument.trace_count("dgen.spec_arrays") == before + 1

    def test_library_loads_count_once_each(self, monkeypatch):
        # the loader's accounting, with the build and the dynamic loader
        # stubbed (no nvcc here): each library counts once, at its first load
        monkeypatch.setattr(runtime, "_LIBS", {})
        monkeypatch.setattr(runtime, "build_all", lambda: {n: f"{n}.so" for n in runtime.SOURCES})
        monkeypatch.setattr(runtime.ctypes, "CDLL", lambda path: object())
        monkeypatch.setattr(runtime, "_bind", lambda name, lib: None)
        before = instrument.trace_count("runtime.build")
        runtime.library("affine_scan")
        assert instrument.trace_count("runtime.build") == before + len(runtime.SOURCES)
        runtime.library("popsim")
        runtime.library("affine_scan")
        assert instrument.trace_count("runtime.build") == before + len(runtime.SOURCES)

    def test_core_name_is_the_same_counter(self):
        # kernels.runtime counts through repro_torch.instrument; the reference's
        # name, repro_torch.core.instrument, reads the same counts
        import repro_torch.instrument as top

        tag = f"probe.{uuid.uuid4().hex}"
        top.count_trace(tag)
        assert instrument.trace_count(tag) == 1 and instrument.count_trace is top.count_trace

    def test_no_engine_probe_tags(self):
        sess = tapi.Session(device=CPU)
        sess.optimize("lstm", steps=2, report=False)
        assert not any(k.startswith(("dopt.", "popsim.")) for k in instrument.snapshot())

    def test_trace_programs_keep_no_build(self):
        sess = tapi.Session(device=CPU)
        sess.simulate("lstm")
        before = sess.stats
        graphs = sess.trace_programs("lstm")
        assert all(isinstance(g, torch.fx.GraphModule) for g in graphs.values())
        assert sess.stats.traces == before.traces and sess.stats.programs == before.programs
