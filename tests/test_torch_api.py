"""Port conformance: the Session façade (api.py) and its reports (core/report.py).

Three contracts:

  * surface — the port's façade has the reference's exports, report
    dataclasses (fields, frozenness), methods and signatures;
  * against the reference — the same queries through both façades agree at
    the ground rules' tolerances (totals rtol 1e-5, per-vertex times within
    the vertex's tile count in cycles, elasticities rtol 1e-4, histories and
    fronts 1e-3);
  * within the port, bit for bit — every Session reply equals the engine call
    on the same stack, batched replies are equal as ``to_json`` strings
    whatever the batch's composition, and warm calls build nothing
    (``core.instrument``).

Everything runs on the CPU with ``device="cpu"``; one module-scoped fixture
per reference call.
"""
import dataclasses
import inspect
import json
import math
import os

import numpy as np
import pytest
import torch

import repro.api as japi
import repro.core.report as jreport
from repro.core.mapper import MapperCfg as jMapperCfg
import repro_torch
import repro_torch.api as tapi
import repro_torch.core.report as treport
from repro_torch.core import dhdl as tdhdl
from repro_torch.core import dopt as tdopt
from repro_torch.core import dsim as tdsim
from repro_torch.core import instrument
from repro_torch.core import pareto as tpareto
from repro_torch.core import popsim as tpop
from repro_torch.core.graph import Graph
from repro_torch.core.params import ArchParams, TechParams
from repro_torch.workloads import get_workload
from tools.make_torch_pareto_ref import noise_of, reference_draws

CPU = "cpu"
REPORT_CLASSES = ("Attribution", "MemoryLevelReport", "ComputeClassReport", "VertexReport", "WorkloadReport",
                  "SimReport", "OptResult", "FrontierPoint", "FrontierResult")
SESSION_METHODS = ("simulate", "explain", "simulate_batch", "explain_batch", "optimize", "frontier",
                   "tech_targets", "perf", "trace_programs", "preheat")
FRONTIER_SEEDS = ("base", "edge", "datacenter")


def _session(arch="base", **kw) -> tapi.Session:
    return tapi.Session(arch, device=CPU, **kw)


def _keys(obj):
    """The key structure of a parsed to_json document."""
    if isinstance(obj, dict):
        return {k: _keys(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_keys(v) for v in obj[:1]]
    return None


def _leaves_equal(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a.leaves(), b.leaves()))


# --------------------------------------------------------------------------- #
# surface
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("name", REPORT_CLASSES)
def test_report_dataclass_matches_reference(name):
    port, ref = getattr(treport, name), getattr(jreport, name)
    assert [f.name for f in dataclasses.fields(port)] == [f.name for f in dataclasses.fields(ref)]
    assert [f.default for f in dataclasses.fields(port)] == [f.default for f in dataclasses.fields(ref)]
    assert port.__dataclass_params__.frozen


def test_report_methods_pinned():
    for cls in (treport.SimReport, treport.OptResult, treport.FrontierResult):
        assert callable(cls.to_json)
    for cls in (treport.OptResult, treport.FrontierResult):
        assert callable(cls.to_dhd)
    for prop in ("runtime_s", "energy_j", "power_w", "edp"):
        assert isinstance(getattr(treport.SimReport, prop), property)
    assert callable(treport.WorkloadReport.top_vertices) and callable(treport.SimReport.bottlenecks)


def test_api_all_equals_reference():
    assert tapi.__all__ == japi.__all__
    for name in tapi.__all__:
        assert getattr(tapi, name) is not None
    for name in ("SimReport", "OptResult", "FrontierResult", "Attribution"):
        assert getattr(tapi, name) is getattr(treport, name)


def test_top_level_exports():
    import warnings

    for name in ("Session", "Architecture", "Workload", "CacheStats", "SimReport", "OptResult",
                 "FrontierResult", "Attribution"):
        assert name in repro_torch.__all__ and getattr(repro_torch, name) is getattr(tapi, name)
    # the engine names stay exported, and warn not
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert repro_torch.simulate is tdsim.simulate
        assert repro_torch.optimize is tdopt.optimize
        assert repro_torch.pareto_dse is tpop.pareto_dse


@pytest.mark.parametrize("name", SESSION_METHODS + ("__init__",))
def test_session_signature_matches_reference(name):
    port = list(inspect.signature(getattr(tapi.Session, name)).parameters)
    ref = list(inspect.signature(getattr(japi.Session, name)).parameters)
    assert port == ref + (["device"] if name == "__init__" else [])


def test_session_surface():
    assert isinstance(tapi.Session.stats, property)
    assert [f.name for f in dataclasses.fields(tapi.CacheStats)] == ["programs", "hits", "misses", "traces"]
    assert tapi.CacheStats.__dataclass_params__.frozen


def test_workload_architecture_surface():
    for prop in ("bucket", "stacked", "n_workloads"):
        assert hasattr(tapi.Workload, prop)
    for prop in ("name", "spec", "arch", "tech", "compiled", "device"):
        assert isinstance(getattr(tapi.Architecture, prop), property)
    assert callable(tapi.Architecture.to_dhd) and callable(tapi.Architecture.peaks)
    assert "device" in inspect.signature(tapi.Workload).parameters
    assert "device" in inspect.signature(tapi.Architecture).parameters


@pytest.mark.parametrize("n,want", [(1, 32), (9, 32), (32, 32), (33, 64), (109, 128), (1024, 1024)])
def test_vertex_bucket_matches_reference(n, want):
    assert tapi._bucket_vertices(n) == japi._bucket_vertices(n) == want


@pytest.mark.parametrize("n", [1, 2, 3, 5, 8, 9, 64])
def test_request_bucket_matches_reference(n):
    assert tapi._bucket_requests(n) == japi._bucket_requests(n)


@pytest.mark.parametrize("name", ["edge", "scale-sim 32x32", "4chip", "", "a.b"])
def test_dhd_ident_matches_reference(name):
    assert tapi._dhd_ident(name) == japi._dhd_ident(name)


def test_param_names_match_reference():
    assert tapi._arch_param_names() == japi._arch_param_names()
    assert tapi._param_names()[:len(tdopt.tech_param_names())] == [f"tech.{n}" for n in tdopt.tech_param_names()]


# --------------------------------------------------------------------------- #
# Workload and Architecture
# --------------------------------------------------------------------------- #


class TestWorkload:
    def test_bucketing_pow2_min32(self):
        assert tapi.Workload("lstm", device=CPU).bucket == (1, 32)
        assert tapi.Workload("bert_base", device=CPU).bucket == (1, 128)
        assert tapi.Workload(["lstm", "merge_sort"], device=CPU).bucket == (2, 32)

    def test_same_bucket_same_shapes(self):
        a, b = tapi.Workload("lstm", device=CPU).stacked, tapi.Workload("merge_sort", device=CPU).stacked
        assert [x.shape for x in (getattr(a, f) for f in ("n_comp", "dims", "op_kind", "edges"))] == \
               [x.shape for x in (getattr(b, f) for f in ("n_comp", "dims", "op_kind", "edges"))]
        assert a.names == b.names == ()

    def test_sources(self):
        g = get_workload("lstm", device=CPU)
        assert tapi.Workload(g, device=CPU).n_workloads == 1
        assert tapi.Workload([g, "dlrm"], device=CPU).labels == ("workload0", "dlrm")
        w = tapi.Workload(["lstm"], device=CPU)
        assert tapi.Workload(w, device=CPU).labels == w.labels

    def test_validation(self):
        with pytest.raises(ValueError):
            tapi.Workload([], device=CPU)
        with pytest.raises((KeyError, TypeError)):
            tapi.Workload("no_such_workload", device=CPU)
        g = get_workload("lstm", device=CPU)
        bad = dataclasses.replace(g, n_read=g.n_read.clone())
        bad.n_read[0, 0] = -1.0
        with pytest.raises(ValueError, match="n_read must be finite and >= 0"):
            tapi.Workload(bad, device=CPU)
        with pytest.raises(ValueError, match="already stacked"):
            tapi.Workload(Graph.stack([g, g]), device=CPU)

    def test_graph_on_another_device_is_refused(self):
        g = get_workload("lstm", device="meta")
        with pytest.raises(ValueError, match="meta.*cpu"):
            tapi.Workload(g, device=CPU)

    def test_padding_is_exact(self):
        g = get_workload("lstm", device=CPU)
        w = tapi.Workload(g, device=CPU)
        tech, arch = TechParams.default(CPU), ArchParams.default(CPU)
        padded = tdsim.simulate_stacked(tech, arch, w.stacked)
        raw = tdsim.simulate(tech, arch, g, mcfg=tdsim.MapperCfg(scan_impl="assoc"))
        np.testing.assert_allclose(padded.cycles[0].item(), raw.cycles.item(), rtol=1e-6)


class TestArchitecture:
    def test_one_constructor_all_spellings(self):
        lib = tapi.Architecture("edge", device=CPU)
        ca = tdhdl.load_arch("edge", device=CPU)
        txt = tapi.Architecture(lib.to_dhd(), device=CPU)
        raw = tapi.Architecture(tech=ca.tech, arch=ca.arch, spec=ca.spec, name="edge", device=CPU)
        for other in (tapi.Architecture(ca, device=CPU), txt, raw):
            assert _leaves_equal(lib.tech, other.tech) and _leaves_equal(lib.arch, other.arch)
        assert lib.spec == txt.spec == raw.spec

    @pytest.mark.parametrize("name", tdhdl.library_archs())
    def test_to_dhd_byte_identical_to_reference(self, name):
        port = tapi.Architecture(name, device=CPU)
        assert port.to_dhd() == japi.Architecture(name).to_dhd()
        again = tapi.Architecture(port.to_dhd(), device=CPU)
        assert _leaves_equal(port.tech, again.tech) and _leaves_equal(port.arch, again.arch)

    @pytest.mark.parametrize("name", ["base", "edge", "rram_cim"])
    def test_peaks_match_reference(self, name):
        port, ref = tapi.Architecture(name, device=CPU).peaks(), japi.Architecture(name).peaks()
        np.testing.assert_allclose(port["peak_flops"], ref["peak_flops"], rtol=1e-6)
        np.testing.assert_allclose(port["frequency"], ref["frequency"], rtol=1e-6)
        assert list(port["mem_bw"]) == list(ref["mem_bw"])
        np.testing.assert_allclose(list(port["mem_bw"].values()), list(ref["mem_bw"].values()), rtol=1e-5)

    def test_validation(self):
        bad = ArchParams.default(CPU)
        bad.frequency = torch.tensor(-1.0)
        with pytest.raises(ValueError, match="non-positive"):
            tapi.Architecture(arch=bad, device=CPU)
        nan = TechParams.default(CPU)
        nan.node = torch.full_like(nan.node, float("nan"))
        with pytest.raises(ValueError, match="non-finite"):
            tapi.Architecture(tech=nan, device=CPU)
        with pytest.raises(TypeError):
            tapi.Architecture(123, device=CPU)

    def test_trees_on_another_device_are_refused(self):
        with pytest.raises(ValueError, match="meta.*cpu"):
            tapi.Architecture(tech=TechParams.default("meta"), device=CPU)


def _elsewhere(obj, attr: str):
    """``obj`` as if it lived on another device (a second device stands in
    for the card, which this machine may not have)."""
    setattr(obj, attr, torch.device("meta"))
    return obj


def test_session_refuses_objects_on_another_device():
    sess = _session()
    arch = _elsewhere(tapi.Architecture("edge", device=CPU), "_device")
    with pytest.raises(ValueError, match="'edge'.* meta, not on cpu"):
        sess.simulate("lstm", architecture=arch)
    with pytest.raises(ValueError, match="meta, not on cpu"):
        _session(arch)
    wl = _elsewhere(tapi.Workload("lstm", device=CPU), "device")
    with pytest.raises(ValueError, match="meta, not on cpu"):
        sess.simulate(wl)
    with pytest.raises(ValueError, match="meta, not on cpu"):
        sess.simulate_batch([wl])

    def test_names_sanitized_to_dhd_identifiers(self):
        a = tapi.Architecture("base", name="scale-sim 32x32", device=CPU)
        assert a.name == "scale_sim_32x32"
        assert tapi.Architecture(a.to_dhd(), device=CPU).name == a.name
        assert tapi.Architecture("base", name="4chip", device=CPU).name == "_4chip"


def test_no_device_means_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None resolves to it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tapi.Session("base")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tapi.Workload("lstm")


def test_cache_dir_not_ported(tmp_path):
    # ported since the design-serving tier: an empty cache_dir constructs, loads
    # nothing and persists what preheat builds (tests/test_torch_aot_cache.py)
    sess = tapi.Session("base", cache_dir=str(tmp_path / "cache"), device=CPU)
    assert sess.disk_loaded == 0 and sess.programs == {} and os.path.isdir(tmp_path / "cache")
    assert sess.preheat([(1, 32)], kinds=("simulate",))["persisted"] == 1


# --------------------------------------------------------------------------- #
# against the reference
# --------------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def sim_pair():
    port = _session("edge").simulate(["lstm", "bert_base"])
    ref = japi.Session("edge").simulate(["lstm", "bert_base"])
    return port, ref


class TestSimulateAgainstReference:
    def test_totals(self, sim_pair):
        port, ref = sim_pair
        assert port.architecture == ref.architecture and port.objective == ref.objective == ""
        np.testing.assert_allclose(port.area_mm2, ref.area_mm2, rtol=1e-5)
        for p, r in zip(port.workloads, ref.workloads):
            assert p.label == r.label
            for f in ("runtime_s", "energy_j", "power_w", "edp", "cycles", "energy_mem_j", "energy_comp_j",
                      "energy_leak_j"):
                np.testing.assert_allclose(getattr(p, f), getattr(r, f), rtol=1e-5, err_msg=f)

    def test_levels_and_compute(self, sim_pair):
        port, ref = sim_pair
        for p, r in zip(port.workloads, ref.workloads):
            assert [lv.level for lv in p.levels] == [lv.level for lv in r.levels]
            assert [c.unit for c in p.compute] == [c.unit for c in r.compute]
            for a, b in zip(p.levels + p.compute, r.levels + r.compute):
                for f in dataclasses.fields(a):
                    if f.name not in ("level", "unit"):
                        np.testing.assert_allclose(getattr(a, f.name), getattr(b, f.name), rtol=1e-5, atol=1e-30,
                                                   err_msg=f.name)

    def test_vertices_within_their_tile_count_in_cycles(self, sim_pair):
        port, ref = sim_pair
        a = tapi.Architecture("edge", device=CPU)
        freq = a.peaks()["frequency"]
        w = tapi.Workload(["lstm", "bert_base"], device=CPU)
        tiles = tdsim.simulate_breakdown(a.tech, a.arch, w.stacked, a.spec)[1]["tiles_v"].numpy()
        for i, (p, r) in enumerate(zip(port.workloads, ref.workloads)):
            assert [v.name for v in p.vertices] == [v.name for v in r.vertices]
            got = np.array([v.time_s for v in p.vertices])
            want = np.array([v.time_s for v in r.vertices])
            slack = tiles[i, :len(got)] / freq + 1e-5 * np.abs(want)
            assert np.all(np.abs(got - want) <= slack)

    def test_json_keys_and_text(self, sim_pair):
        port, ref = sim_pair
        assert _keys(json.loads(port.to_json())) == _keys(json.loads(ref.to_json()))
        assert str(port).splitlines()[0] == str(ref).splitlines()[0]
        assert [v.name for v in port.workloads[1].top_vertices(3)] == \
               [v.name for v in ref.workloads[1].top_vertices(3)]

    def test_breakdowns_consistent(self, sim_pair):
        port, _ = sim_pair
        for wr in port.workloads:
            np.testing.assert_allclose(sum(v.time_s for v in wr.vertices), wr.runtime_s, rtol=1e-4)
            np.testing.assert_allclose(sum(v.energy_j for v in wr.vertices), wr.energy_j, rtol=1e-4)
            total = sum(lv.dynamic_energy_j + lv.leakage_energy_j for lv in wr.levels) + sum(
                c.dynamic_energy_j + c.leakage_energy_j for c in wr.compute)
            np.testing.assert_allclose(total, wr.energy_j, rtol=1e-4)


@pytest.fixture(scope="module")
def explain_pair():
    return _session().explain("lstm"), japi.Session("base").explain("lstm")


class TestExplainAgainstReference:
    def test_same_parameters(self, explain_pair):
        port, ref = explain_pair
        assert port.objective == ref.objective == "edp"
        assert sorted(a.parameter for a in port.attribution) == sorted(a.parameter for a in ref.attribution)
        assert len(port.attribution) == len(tapi._param_names())

    def test_elasticities(self, explain_pair):
        port, ref = explain_pair
        want = {a.parameter: a.elasticity for a in ref.attribution}
        for a in port.attribution:
            np.testing.assert_allclose(a.elasticity, want[a.parameter], rtol=1e-4, atol=1e-6, err_msg=a.parameter)

    def test_ranked_by_magnitude(self, explain_pair):
        port, _ = explain_pair
        mags = [abs(a.elasticity) for a in port.attribution]
        assert mags == sorted(mags, reverse=True)
        assert port.bottlenecks(3) == port.attribution[:3]


@pytest.fixture(scope="module")
def optimize_pair():
    port = _session().optimize(["lstm", "dlrm"], steps=8, lr=0.05)
    ref = japi.Session("base").optimize(japi.Workload(["lstm", "dlrm"]), steps=8, lr=0.05)
    return port, ref


class TestOptimizeAgainstReference:
    def test_history(self, optimize_pair):
        port, ref = optimize_pair
        assert (port.objective, port.opt_over, port.epochs) == (ref.objective, ref.opt_over, ref.epochs) == \
               ("edp", "both", 8)
        np.testing.assert_allclose(port.objective_history, ref.objective_history, rtol=1e-3)
        np.testing.assert_allclose(port.improvement, ref.improvement, rtol=1e-3)

    def test_design_reparsed(self, optimize_pair):
        port, ref = optimize_pair
        got = tdhdl.parse_arch(port.to_dhd(), device=CPU)
        want = japi.Architecture(ref.to_dhd())
        assert got.name == want.name == "base_opt"
        for f in dataclasses.fields(want.tech):
            np.testing.assert_allclose(getattr(got.tech, f.name).numpy(), np.asarray(getattr(want.tech, f.name)),
                                       rtol=1e-3, err_msg=f.name)
        for f in dataclasses.fields(want.arch):
            np.testing.assert_allclose(getattr(got.arch, f.name).numpy(), np.asarray(getattr(want.arch, f.name)),
                                       rtol=1e-3, err_msg=f.name)

    def test_reports(self, optimize_pair):
        port, ref = optimize_pair
        for p, r in ((port.baseline, ref.baseline), (port.optimized, ref.optimized)):
            for a, b in zip(p.workloads, r.workloads):
                np.testing.assert_allclose(a.edp, b.edp, rtol=1e-3)
        assert _keys(json.loads(port.to_json())) == _keys(json.loads(ref.to_json()))
        assert [a.parameter for a in port.importance][:3] == [a.parameter for a in ref.importance][:3]


@pytest.fixture(scope="module")
def frontier_pair():
    """The port's frontier with the reference's draws, the reference's, and
    the reference's own spread per member: how far its history and final log
    metrics move when the same run goes through its sequential mapper, an
    exact reformulation of the same arithmetic."""
    draws = reference_draws(0, 6, FRONTIER_SEEDS)
    kw = dict(noise=noise_of(draws), mix_draws=draws["mix_draws"], hv_samples=draws["hv_samples"])
    port = _session().frontier("lstm", population=6, steps=3, **kw)
    ref = japi.Session().frontier("lstm", population=6, steps=3, key=0)
    seq = japi.Session(mcfg=jMapperCfg(scan_impl="ref")).frontier("lstm", population=6, steps=3, key=0)
    spread = np.maximum(_rel(seq.raw.history, ref.raw.history).max(axis=(0, 2)),
                        _rel(seq.raw.log_metrics, ref.raw.log_metrics).max(axis=1))
    return port, ref, kw, spread


def _rel(got, want) -> np.ndarray:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want) / np.maximum(np.abs(want), 1e-30)


class TestFrontierAgainstReference:
    """Members whose start gradient turns on a coordinate below float32's
    rounding noise take a first Adam step by the sign the rounding gives, so
    the reference does not determine them (its own spread exceeds the
    tolerance).  As ``chip_smoke.hold_pareto`` does, they are held at the first
    epoch and to finiteness, and the front and hypervolume are held against the
    reference's with those members where the port put them."""

    RTOL = 1e-3

    def test_members(self, frontier_pair):
        port, ref, _, spread = frontier_pair
        held = spread <= self.RTOL
        assert held.sum() >= len(held) - 1  # at most one member decided by rounding
        assert (port.metrics, port.population, port.epochs) == (ref.metrics, ref.population, ref.epochs)
        h = _rel(port.raw.history, ref.raw.history)
        assert h[:, held].max() <= self.RTOL and h[0].max() <= self.RTOL
        assert _rel(port.raw.log_metrics, ref.raw.log_metrics)[held].max() <= self.RTOL
        assert np.isfinite(port.raw.history).all() and np.isfinite(port.raw.log_metrics).all()
        np.testing.assert_array_equal(port.raw.feasible[held], ref.raw.feasible[held])
        np.testing.assert_array_equal(port.raw.weights, ref.raw.weights)

    def test_front_and_hypervolume(self, frontier_pair):
        port, ref, kw, spread = frontier_pair
        free = spread > self.RTOL
        pts = np.asarray(ref.raw.log_metrics, np.float32).copy()
        feas = np.asarray(ref.raw.feasible).copy()
        pts[free], feas[free] = port.raw.log_metrics[free], port.raw.feasible[free]
        midx = [tdsim.PARETO_METRICS.index(m) for m in ref.metrics]
        pts = torch.as_tensor(pts[:, midx])
        front = np.nonzero(tpareto.non_dominated_mask(pts, torch.as_tensor(feas)).numpy())[0]
        assert [p.index for p in port.front] == front.tolist()
        assert port.feasible == int(feas.sum())
        feas_pts = pts[torch.as_tensor(np.nonzero(feas)[0])]
        hv_ref = tpareto.hv_ref_point(feas_pts)
        want = tpareto.hypervolume(pts[torch.as_tensor(front)], hv_ref,
                                   lo=torch.minimum(torch.amin(feas_pts, 0), hv_ref), samples=kw["hv_samples"])
        np.testing.assert_allclose(port.hypervolume, float(want), rtol=self.RTOL)
        for p, r in zip(port.front, ref.front):
            assert p.index == r.index and p.seed == r.seed and p.weights == r.weights
            if not free[p.index]:
                for f in ("time_s", "energy_j", "area_mm2", "power_w", "edp"):
                    np.testing.assert_allclose(getattr(p, f), getattr(r, f), rtol=self.RTOL, err_msg=f)

    def test_json_and_dhd(self, frontier_pair):
        port, ref, _, _ = frontier_pair
        assert _keys(json.loads(port.to_json())) == _keys(json.loads(ref.to_json()))
        assert "raw" not in json.loads(port.to_json())
        assert port.to_dhd().count("arch pareto_") == len(port.front)
        assert isinstance(port.raw, tpop.ParetoResult)


def test_tech_targets_against_reference():
    got = _session().tech_targets("lstm", goal_factor=1e9, steps=2)
    want = japi.Session().tech_targets("lstm", goal_factor=1e9, steps=2)
    assert got["epochs"] == want["epochs"] == 2
    assert list(got["targets"]) == list(want["targets"])
    for k, t in want["targets"].items():
        np.testing.assert_allclose([got["targets"][k][f] for f in ("start", "target", "factor")],
                                   [t[f] for f in ("start", "target", "factor")], rtol=1e-4, err_msg=k)
    np.testing.assert_allclose(got["achieved_factor"], want["achieved_factor"], rtol=1e-4)


# --------------------------------------------------------------------------- #
# within the port, bit for bit
# --------------------------------------------------------------------------- #


class TestParity:
    def test_perf_equals_engine(self):
        w, a = tapi.Workload(["lstm", "bert_base"], device=CPU), tapi.Architecture("edge", device=CPU)
        sess = _session(a)
        assert _leaves_equal(sess.perf(w), tdsim.simulate_stacked(a.tech, a.arch, w.stacked, a.spec))
        oracle = tdsim.simulate_stacked(a.tech, a.arch, w.stacked, a.spec)
        rep = sess.simulate(w)
        assert [wr.runtime_s for wr in rep.workloads] == oracle.runtime.tolist()
        assert [wr.cycles for wr in rep.workloads] == oracle.cycles.tolist()

    def test_report_program_equals_breakdown(self):
        w, a = tapi.Workload(["lstm", "merge_sort"], device=CPU), tapi.Architecture("base", device=CPU)
        sess = _session(a)
        perfs, extras = sess._report_program(w.bucket, a.spec, sess.mcfg)(a.tech, a.arch, w.stacked)
        want_p, want_x = tdsim.simulate_breakdown(a.tech, a.arch, w.stacked, a.spec)
        assert _leaves_equal(perfs, want_p)
        for k in ("t_level", "e_level_dyn", "e_level_leak", "e_comp_dyn", "e_comp_leak", "time_v", "energy_v"):
            assert extras[k].shape[0] == 2 and torch.equal(extras[k], want_x[k]), k

    def test_optimize_equals_engine(self):
        w = tapi.Workload(["lstm", "dlrm"], device=CPU)
        res = _session().optimize(w, steps=4, lr=0.05)
        oracle = tdopt.optimize(w.stacked, objective="edp", steps=4, lr=0.05, device=CPU)
        assert list(res.objective_history) == [math.exp(v) for v in oracle.history["objective"]]
        assert [a.parameter for a in res.importance] == [f"tech.{n}" for n, _ in oracle.importance]
        ca = tdhdl.parse_arch(res.to_dhd(), device=CPU)
        assert _leaves_equal(ca.tech, oracle.tech) and _leaves_equal(ca.arch, oracle.arch)

    def test_optimize_without_reports(self):
        res = _session().optimize("lstm", steps=2, report=False)
        assert res.baseline is None and res.optimized is None and res.epochs == 2

    def test_frontier_equals_engine(self, frontier_pair):
        port, _, kw, _ = frontier_pair
        oracle = tpop.pareto_dse(tapi.Workload("lstm", device=CPU).stacked, population=6, steps=3, device=CPU,
                                 **kw)
        assert [p.dhd for p in port.front] == [win["dhd"] for win in oracle.winners]
        assert [p.time_s for p in port.front] == [win["time_s"] for win in oracle.winners]
        assert port.hypervolume == oracle.hypervolume
        np.testing.assert_array_equal(port.raw.history, oracle.history)

    def test_explain_equals_direct_gradient(self):
        w, a = tapi.Workload("lstm", device=CPU), tapi.Architecture("base", device=CPU)
        rep = _session(a).explain(w, objective="energy")
        tz = tdopt.to_log(a.tech).map(lambda x: x.detach().requires_grad_(True))
        az = tdopt.to_log(a.arch).map(lambda x: x.detach().requires_grad_(True))
        val, _ = tdsim.stacked_log_objective(tdopt.from_log(tz), tdopt.from_log(az), w.stacked, "energy",
                                             spec=a.spec)
        grads = torch.autograd.grad(val, tz.leaves() + az.leaves(), allow_unused=True)
        flat = torch.cat([(torch.zeros_like(x) if g is None else g).reshape(-1)
                          for x, g in zip(tz.leaves() + az.leaves(), grads)]).tolist()
        assert rep.objective == "energy"
        assert {at.parameter: at.elasticity for at in rep.attribution} == dict(zip(tapi._param_names(), flat))


QUERIES = (("lstm", "base"), ("merge_sort", "edge"), ("dlrm", "datacenter"))


def _batch(method, queries, **kw):
    sess = _session()
    return {q: r for q, r in zip(queries, getattr(sess, method)([w for w, _ in queries],
                                                                architectures=[a for _, a in queries],
                                                                request_bucket=4, **kw))}


@pytest.mark.parametrize("method", ["simulate_batch", "explain_batch"])
def test_batched_replies_equal_across_compositions(method):
    alone = {q: _batch(method, [q])[q] for q in QUERIES}
    together = _batch(method, QUERIES)
    reversed_ = _batch(method, QUERIES[::-1])
    for q in QUERIES:
        assert alone[q].to_json() == together[q].to_json() == reversed_[q].to_json(), q
        assert alone[q].architecture == q[1] and alone[q].workloads[0].label == q[0]


def test_batched_replies_agree_with_sequential():
    sess = _session()
    batched = sess.explain_batch([w for w, _ in QUERIES], architectures=[a for _, a in QUERIES])
    for (w, a), rep in zip(QUERIES, batched):
        seq = sess.explain(w, architecture=a)
        for a_, b_ in ((rep.workloads[0], seq.workloads[0]), *zip(rep.workloads[0].vertices,
                                                                  seq.workloads[0].vertices)):
            for f in ("runtime_s", "energy_j", "time_s"):
                if hasattr(a_, f):
                    np.testing.assert_allclose(getattr(a_, f), getattr(b_, f), rtol=1e-6, err_msg=f)
        want = {at.parameter: at.elasticity for at in seq.attribution}
        for at in rep.attribution:
            np.testing.assert_allclose(at.elasticity, want[at.parameter], rtol=1e-5, atol=1e-7)


def test_batch_validation():
    sess = _session()
    with pytest.raises(ValueError, match="shape buckets"):
        sess.simulate_batch(["lstm", "bert_base"])
    with pytest.raises(ValueError, match="ArchSpecs"):
        sess.simulate_batch(["lstm", "dlrm"], architectures=["base", "rram_cim"])
    with pytest.raises(ValueError, match="request_bucket=1"):
        sess.simulate_batch(["lstm", "dlrm"], request_bucket=1)
    with pytest.raises(ValueError, match="at least one"):
        sess.simulate_batch([])


# --------------------------------------------------------------------------- #
# the program-cache contract
# --------------------------------------------------------------------------- #


class TestCache:
    def test_warm_same_bucket_builds_nothing(self):
        sess = _session()
        sess.simulate("lstm")  # cold: builds
        t0, total = sess.stats.traces, instrument.trace_count()
        assert t0 == 1
        sess.simulate("lstm")  # warm, identical
        sess.simulate("merge_sort")  # warm: same (1, 32) bucket, new workload
        sess.simulate("dlrm", architecture=tapi.Architecture("edge", device=CPU))  # new design point
        assert sess.stats.traces == t0 and instrument.trace_count() == total
        assert sess.stats.hits >= 3
        sess.simulate("bert_base")  # (1, 128): a new bucket builds once
        assert sess.stats.traces == t0 + 1
        sess.simulate("bert_base")
        assert sess.stats.traces == t0 + 1

    def test_changed_objective_mix_builds_nothing(self):
        sess = _session()
        w = tapi.Workload(["lstm", "dlrm"], device=CPU)
        sess.optimize(w, objective="mixed", objective_weights=[1.0, 0.0, 0.0, 0.0], steps=2, report=False)
        before = instrument.trace_count()
        r2 = sess.optimize(w, objective="mixed", objective_weights=[0.0, 1.0, 0.0, 0.0], area_budget=900.0,
                           penalty_weight=2.0, steps=2, report=False)
        assert instrument.trace_count() == before and r2.epochs == 2

    def test_warm_optimize_builds_nothing_across_workloads(self):
        sess = _session()
        sess.optimize("lstm", steps=2)
        before = instrument.trace_count()
        sess.optimize("merge_sort", steps=2)  # same bucket
        assert instrument.trace_count() == before
        assert sess.stats.hits >= 1

    def test_explain_program_cached(self):
        sess = _session()
        sess.explain("lstm")
        t0 = sess.stats.traces
        sess.explain("merge_sort")  # same bucket
        assert sess.stats.traces == t0
        sess.explain("lstm", objective="time")  # a new objective builds once
        assert sess.stats.traces == t0 + 1

    def test_sessions_do_not_share_stats(self):
        s1, s2 = _session(), _session()
        s1.simulate("lstm")
        assert s2.stats.traces == 0 and s2.stats.programs == 0

    def test_shared_programs_are_warm_for_a_second_session(self):
        s1 = _session()
        s1.simulate("lstm")
        s2 = _session(programs=s1.programs)
        before = instrument.trace_count()
        rep = s2.simulate("merge_sort")
        assert instrument.trace_count() == before
        assert s2.stats.traces == 0 and s2.stats.hits == 1 and s2.stats.programs == 1
        assert rep.to_json() == s1.simulate("merge_sort").to_json()

    def test_preheat(self):
        sess = _session()
        out = sess.preheat([(1, 20), "lstm"], kinds=("simulate", "explain"), request_buckets=(2,))
        # one bucket, (1, 32): report, explain, batched report, batched explain
        assert (out["programs"], out["built"], out["reused"], out["persisted"]) == (4, 4, 0, 0)
        assert out["seconds"] >= 0 and sess.stats.traces == 4
        again = sess.preheat("merge_sort", request_buckets=(2,))
        assert (again["built"], again["reused"]) == (0, 4)
        before = instrument.trace_count()
        sess.explain("dlrm")
        sess.explain_batch(["lstm", "dlrm"])
        assert instrument.trace_count() == before
        assert sess.preheat((2, 32), kinds=("perf",))["built"] == 1
        with pytest.raises(ValueError, match="preheat kinds"):
            sess.preheat("lstm", kinds=("frontier",))

    def test_preheated_program_equals_lazy_one(self):
        a, b = _session(), _session()
        a.preheat((1, 32))
        assert a.simulate("lstm").to_json() == b.simulate("lstm").to_json()


# --------------------------------------------------------------------------- #
# introspection
# --------------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def traced():
    return _session().trace_programs("lstm")


@pytest.mark.parametrize("kind,backward", [("simulate", False), ("explain", True), ("optimize", True),
                                           ("frontier", True)])
def test_trace_programs_hold_the_carries_kernel(traced, kind, backward):
    gm = traced[kind]
    assert isinstance(gm, torch.fx.GraphModule)
    targets = {str(n.target) for n in gm.graph.nodes if n.op == "call_function"}
    assert "repro_torch.mapper_carries.default" in targets
    assert ("repro_torch.mapper_carries_backward.default" in targets) == backward
