"""Port conformance: the design services, against the reference and within the port.

One mixed stream — simulate and explain over lstm and merge_sort at bucket
(1, 32), on base and edge, with one 3-step optimize — goes through the
reference's and the port's ``BatchingDesignService`` on the CPU, both under
the same seeded full chaos configuration, a fake clock, a no-op sleep and
deadlines that cannot expire.

  * across packages: the same ``(qid, ok, error code, attempts, batched,
    batch_size)`` for every reply and the same ``ServiceStats`` ledger; ok
    reports agree at the simulator's tolerances (values rtol 1e-5,
    ``tests/test_mapper_equiv.py:63-72``; elasticities rtol 1e-4, atol 1e-6;
    the DOpt history rtol 1e-3);
  * within the port, bit for bit as ``to_json``: batched equals sequential,
    clean chaos queries equal the no-chaos run, the seeded replay is
    identical, cross-tenant coalescing is exact, and tenants share one
    program cache (a second tenant's first query builds nothing);
  * the warmth ledger: a failed cold query does not grant the warm deadline,
    and a preheated shape is warm from its first serve;
  * ``ServiceStats.merge`` is partition-invariant over a split stream.

One module-scoped fixture per service run.
"""
import json

import numpy as np
import pytest

import repro.serving as jserving
import repro_torch.serving as tserving
from repro_torch.core import instrument

CPU = "cpu"
SEED = 20260808
FULL = dict(seed=SEED, p_transient=0.3, p_compile_fail=0.1, p_nan=0.25, p_latency=0.2, latency_s=0.02)
N = 24
OPTIMIZE_AT = 12
LEDGER = ("queries", "ok", "retries", "errors", "degraded", "deadline_misses", "batches", "batched_queries")


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        self.t += 0.001
        return self.t


def _queries(mod, tenants=False) -> list:
    kinds, loads, archs = ("simulate", "explain"), ("lstm", "merge_sort"), (None, "edge")
    qs = []
    for i in range(N):
        tenant = ("a", "b")[i % 2] if tenants else None
        if i == OPTIMIZE_AT:
            qs.append(mod.DesignQuery(i, "optimize", "lstm", params=dict(steps=3, report=False), tenant=tenant))
        else:
            qs.append(mod.DesignQuery(i, kinds[i % 2], loads[(i // 2) % 2], architecture=archs[(i // 4) % 2],
                                      tenant=tenant))
    return qs


def _service(mod, *, batching=True, chaos=None, device=True, **kw):
    clock = FakeClock()
    args = dict(retry=mod.RetryPolicy(max_attempts=4, base_s=0.005), clock=clock, sleep=lambda s: None,
                deadlines=mod.DeadlineConfig(warm_s=1e9, cold_s=1e9),
                chaos=None if chaos is None else mod.ChaosInjector(mod.ChaosConfig(**chaos), sleep=lambda s: None))
    if device:
        args["device"] = CPU
    args.update(kw)
    if batching:
        return mod.BatchingDesignService("base", policy=mod.FlushPolicy(max_batch=8, max_delay_s=0.005), **args)
    return mod.DesignService("base", request_bucket=8, **args)


def _outcomes(replies) -> list:
    return [(r.qid, r.ok, r.error.code if r.error else None, r.attempts, r.batched, r.batch_size) for r in replies]


def _ledger(stats) -> dict:
    return {f: getattr(stats, f) for f in LEDGER}


def _texts(replies) -> dict:
    return {r.qid: r.result.to_json() for r in replies if r.ok}


@pytest.fixture(scope="module")
def ref_chaos():
    svc = _service(jserving, chaos=FULL, device=False)
    replies = svc.serve(_queries(jserving))
    return replies, svc.stats


@pytest.fixture(scope="module")
def port_chaos():
    svc = _service(tserving, chaos=FULL)
    replies = svc.serve(_queries(tserving))
    return replies, svc.stats, svc.chaos


@pytest.fixture(scope="module")
def port_clean():
    svc = _service(tserving)
    return svc.serve(_queries(tserving)), svc.stats


@pytest.fixture(scope="module")
def port_sequential():
    svc = _service(tserving, batching=False)
    return svc.serve(_queries(tserving)), svc.stats


# --------------------------------------------------------------------------- #
# across packages
# --------------------------------------------------------------------------- #


def test_same_outcomes(ref_chaos, port_chaos):
    assert _outcomes(port_chaos[0]) == _outcomes(ref_chaos[0])
    assert sum(r.attempts > 1 for r in ref_chaos[0]) > 0 and any(r.batched for r in ref_chaos[0])


def test_same_ledger(ref_chaos, port_chaos):
    assert _ledger(port_chaos[1]) == _ledger(ref_chaos[1])
    assert port_chaos[1].retries > 0 and port_chaos[1].availability == 1.0


@pytest.mark.parametrize("qid", range(N))
def test_reports_within_tolerance(qid, ref_chaos, port_chaos):
    ref, port = ref_chaos[0][qid], port_chaos[0][qid]
    assert port.ok and ref.ok and port.kind == ref.kind
    if port.kind == "optimize":
        np.testing.assert_allclose(port.result.objective_history, ref.result.objective_history, rtol=1e-3)
        np.testing.assert_allclose(port.result.improvement, ref.result.improvement, rtol=1e-3)
        return
    p, r = port.result, ref.result
    assert (p.architecture, p.objective) == (r.architecture, r.objective)
    np.testing.assert_allclose(p.area_mm2, r.area_mm2, rtol=1e-5)
    for pw, rw in zip(p.workloads, r.workloads, strict=True):
        assert pw.label == rw.label
        for f in ("runtime_s", "energy_j", "power_w", "edp", "cycles", "energy_mem_j", "energy_comp_j",
                  "energy_leak_j"):
            np.testing.assert_allclose(getattr(pw, f), getattr(rw, f), rtol=1e-5, err_msg=f)
    want = {a.parameter: a.elasticity for a in r.attribution}
    assert sorted(want) == sorted(a.parameter for a in p.attribution)
    for a in p.attribution:
        np.testing.assert_allclose(a.elasticity, want[a.parameter], rtol=1e-4, atol=1e-6, err_msg=a.parameter)


# --------------------------------------------------------------------------- #
# within the port, bit for bit
# --------------------------------------------------------------------------- #


def test_batched_equals_sequential(port_clean, port_sequential):
    bat, seq = _texts(port_clean[0]), _texts(port_sequential[0])
    assert len(bat) == len(seq) == N and bat == seq
    assert port_clean[1].batches > 0 and port_sequential[1].batches == 0


def test_batched_equals_simulate_batch_alone(port_clean):
    from repro_torch.api import Session

    sess = Session("base", device=CPU)
    for r in port_clean[0][:8]:
        if r.kind == "simulate":
            q = _queries(tserving)[r.qid]
            alone = sess.simulate_batch([q.workload], architectures=[q.architecture], request_bucket=8)[0]
            assert r.result.to_json() == alone.to_json()


def test_clean_chaos_queries_equal_the_no_chaos_run(port_chaos, port_clean):
    plans = port_chaos[2].schedule(range(N))
    clean = [p.qid for p in plans if p.clean]
    got, want = _texts(port_chaos[0]), _texts(port_clean[0])
    assert clean and all(got[q] == want[q] for q in clean)
    assert got == want  # faulted queries recover the same bits too


def test_seeded_replay_is_identical(port_chaos):
    svc = _service(tserving, chaos=FULL)
    replies = svc.serve(_queries(tserving))
    assert [p.to_json() for p in svc.chaos.schedule(range(N))] == \
        [p.to_json() for p in port_chaos[2].schedule(range(N))]
    assert _outcomes(replies) == _outcomes(port_chaos[0]) and _texts(replies) == _texts(port_chaos[0])
    assert svc.chaos.summary() == port_chaos[2].summary()


def test_cross_tenant_coalescing_is_exact(port_clean):
    svc = _service(tserving)
    replies = svc.serve(_queries(tserving, tenants=True))
    assert _texts(replies) == _texts(port_clean[0])
    assert _outcomes(replies) == _outcomes(port_clean[0])
    assert svc.stats.tenants == 3 and svc.stats.programs == port_clean[1].programs


def test_tenants_share_one_program_cache():
    svc = _service(tserving, batching=False)
    first = svc.submit(tserving.DesignQuery(0, "simulate", "lstm", tenant="a"))
    before = instrument.snapshot()
    second = svc.submit(tserving.DesignQuery(1, "simulate", "merge_sort", tenant="b"))
    assert first.compiled and not second.compiled and instrument.snapshot() == before
    assert svc._session_for("b").stats.traces == 0 and svc._session_for("a").stats.traces == 1


def test_build_failure_is_transient_and_retried():
    svc = _service(tserving, batching=False)
    real, calls = svc.session.simulate_batch, []

    def flaky(*a, **kw):
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("repro_torch: launch of kernel 'affine_scan' failed with CUDA error 700")
        return real(*a, **kw)

    svc.session.simulate_batch = flaky
    r = svc.submit(tserving.DesignQuery(0, "simulate", "lstm"))
    assert r.ok and r.attempts == 2 and svc.stats.retries == 1


# --------------------------------------------------------------------------- #
# warmth ledger
# --------------------------------------------------------------------------- #


def test_failed_cold_query_keeps_the_shape_cold():
    svc = _service(tserving, batching=False, chaos=dict(seed=1, p_transient=1.0, depth=4),
                   deadlines=tserving.DeadlineConfig(warm_s=100.0, cold_s=1000.0))
    failed = svc.submit(tserving.DesignQuery(0, "explain", "lstm"))
    assert not failed.ok and failed.error.code == "transient" and not failed.compiled
    svc.chaos = None
    again = svc.submit(tserving.DesignQuery(1, "explain", "lstm"))
    assert again.ok and again.compiled and again.deadline_s == 1000.0
    warm = svc.submit(tserving.DesignQuery(2, "explain", "merge_sort"))
    assert warm.ok and not warm.compiled and warm.deadline_s == 100.0


def test_preheated_shape_is_warm_from_its_first_serve():
    svc = _service(tserving, deadlines=tserving.DeadlineConfig(warm_s=100.0, cold_s=1000.0))
    info = svc.warmup(["lstm"], kinds=("simulate", "explain"))
    assert info["built"] == 4
    before = instrument.snapshot()
    replies = svc.serve([tserving.DesignQuery(0, "simulate", "merge_sort"), tserving.DesignQuery(1, "explain", "lstm")])
    assert [r.deadline_s for r in replies] == [100.0, 100.0] and not any(r.compiled for r in replies)
    assert instrument.snapshot() == before


# --------------------------------------------------------------------------- #
# fleet ledger
# --------------------------------------------------------------------------- #


def test_merge_is_partition_invariant(port_chaos):
    qs = _queries(tserving)
    parts = []
    for chunk in (qs[:7], qs[7:16], qs[16:]):
        svc = _service(tserving, batching=False, chaos=FULL)
        svc.serve(chunk)
        parts.append(svc.stats)
    whole = parts[0] + parts[1] + parts[2]
    seq = _service(tserving, batching=False, chaos=FULL)
    seq.serve(qs)
    for f in ("queries", "ok", "retries", "errors", "degraded", "deadline_misses"):
        assert getattr(whole, f) == getattr(seq.stats, f), f
    assert whole.tenants == 3 and whole.availability == seq.stats.availability == 1.0
    assert json.dumps(whole.errors, sort_keys=True) == json.dumps(seq.stats.errors, sort_keys=True)
