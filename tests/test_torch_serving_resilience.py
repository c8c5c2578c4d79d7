"""Port conformance: the design service's policy layer, exactly the reference's.

``repro_torch.serving.resilience``, ``.chaos``, ``.batching`` and
``repro_torch.ft.straggler`` are framework-free copies of the reference's
modules; only the report types they inspect are the port's.  So every check
here is exact: the same fault codes and retry bits, the same classification,
backoff, budgets, breaker states, guarded outcomes (attempts, codes, walls
under a fake clock), straggler flags, chaos schedules (also against
``tests/data/torch_chaos_schedule.json``, which ``chip_smoke.py`` holds the
card to), the same non-finite containment and poisoning on each package's
report types, and the same flush triggers and coalescing chunks.

Everything runs on the CPU; no engine runs here.
"""
import dataclasses
import json
import math
import pathlib
import types

import numpy as np
import pytest

import repro.core.report as jreport
import repro.ft.straggler as jstraggler
import repro.serving.aotcache as jaot
import repro.serving.batching as jbatching
import repro.serving.chaos as jchaos
import repro.serving.resilience as jres
import repro_torch.core.report as treport
import repro_torch.ft.straggler as tstraggler
import repro_torch.serving.aotcache as taot
import repro_torch.serving.batching as tbatching
import repro_torch.serving.chaos as tchaos
import repro_torch.serving.resilience as tres

SEED = 20260808  # benchmarks/bench_serving.py's
FIXTURE = pathlib.Path(__file__).parent / "data" / "torch_chaos_schedule.json"
BENCH_CONFIGS = {
    "transient_only": dict(seed=SEED, p_transient=0.35, p_compile_fail=0.2, p_cache_corrupt=0.2),
    "full": dict(seed=SEED, p_transient=0.3, p_compile_fail=0.1, p_nan=0.25, p_latency=0.2, latency_s=0.02),
    "worker_kill": dict(seed=SEED, p_worker_kill=0.1),
}


class FakeClock:
    """A clock that advances ``step`` seconds at every read, plus sleeps."""

    def __init__(self, step: float = 0.001):
        self.t, self.step = 0.0, step

    def __call__(self) -> float:
        self.t += self.step
        return self.t

    def sleep(self, s: float) -> None:
        self.t += s


# --------------------------------------------------------------------------- #
# fault taxonomy
# --------------------------------------------------------------------------- #

FAULTS = ("ServingFault", "ClientError", "TransientFault", "DeadlineExceeded", "NumericFault", "CircuitOpen")


@pytest.mark.parametrize("name", FAULTS + ("CacheCorruption",))
def test_fault_code_and_retryable_bit(name):
    ref = getattr(jaot if name == "CacheCorruption" else jres, name)
    port = getattr(taot if name == "CacheCorruption" else tres, name)
    assert (port.code, port.retryable) == (ref.code, ref.retryable)
    assert [c.__name__ for c in port.__mro__[:-2]] == [c.__name__ for c in ref.__mro__[:-2]]


FOREIGN = {
    "ValueError": lambda: ValueError("bad knob"),
    "TypeError": lambda: TypeError("not a graph"),
    "KeyError": lambda: KeyError("nosuchworkload"),
    "FloatingPointError": lambda: FloatingPointError("overflow"),
    "RuntimeError": lambda: RuntimeError("CUDA error 700"),
    "OSError": lambda: OSError(5, "I/O error"),
    "ZeroDivisionError": lambda: ZeroDivisionError("division by zero"),
    "IndexError": lambda: IndexError("list index out of range"),
}


@pytest.mark.parametrize("name", list(FOREIGN) + [f"typed:{n}" for n in FAULTS])
def test_classify_exception(name):
    def fault(mod):
        exc = getattr(mod, name[6:])("typed fault") if name.startswith("typed:") else FOREIGN[name]()
        got = mod.classify_exception(exc)
        return type(got).__name__, got.code, got.retryable, str(got), got is exc

    assert fault(tres) == fault(jres)


def test_fault_info_to_json():
    kw = dict(code="numeric", message="non-finite result field 'area_mm2'", attempts=3, retryable=True)
    assert tres.FaultInfo(**kw).to_json() == jres.FaultInfo(**kw).to_json()


# --------------------------------------------------------------------------- #
# retry, deadlines, breaker
# --------------------------------------------------------------------------- #

POLICIES = (dict(), dict(max_attempts=4, base_s=0.005), dict(base_s=0.1, multiplier=3.0, max_backoff_s=1.0, jitter=0.9))


@pytest.mark.parametrize("policy", range(len(POLICIES)))
def test_backoff_grid(policy):
    tokens = (0, 1, 7, 96, 12345, 2**31 - 1, 2**33 + 5)
    grid = [(r, t) for r in range(6) for t in tokens]
    ref, port = jres.RetryPolicy(**POLICIES[policy]), tres.RetryPolicy(**POLICIES[policy])
    assert [port.backoff_s(r, t) for r, t in grid] == [ref.backoff_s(r, t) for r, t in grid]


@pytest.mark.parametrize("cfg", [dict(), dict(warm_s=0.5, cold_s=10.0, optimize_scale=2.5)])
def test_deadline_budgets(cfg):
    grid = [(c, k) for c in (False, True) for k in ("simulate", "explain", "optimize", "frontier")]
    ref, port = jres.DeadlineConfig(**cfg), tres.DeadlineConfig(**cfg)
    assert [port.budget_s(c, k) for c, k in grid] == [ref.budget_s(c, k) for c, k in grid]


# (op, key, arg, clock advance): allow / record under a fake clock, two lanes
BREAKER_SCRIPT = (
    [("record", "a", False, 0.1)] * 3 + [("allow", "a", None, 0.1), ("record", "a", False, 0.1),
                                         ("allow", "a", None, 0.5), ("allow", "b", None, 0.1),
                                         ("record", "b", True, 0.1), ("allow", "a", None, 2.0),
                                         ("allow", "a", None, 0.1), ("record", "a", False, 0.1),
                                         ("allow", "a", None, 1.0), ("allow", "a", None, 2.5),
                                         ("record", "a", True, 0.1), ("allow", "a", None, 0.1)]
    + [("record", "b", False, 0.05)] * 5 + [("allow", "b", None, 3.1), ("record", "b", False, 0.0)]
)


def _breaker_trace(mod) -> list:
    t = [0.0]
    br = mod.CircuitBreaker(failure_threshold=4, cooldown_s=3.0, clock=lambda: t[0])
    out = []
    for op, key, arg, dt in BREAKER_SCRIPT:
        t[0] += dt
        res = br.allow(key) if op == "allow" else br.record(key, arg)
        out.append((res, br.snapshot()))
    return out


def test_circuit_breaker_script():
    ref, port = _breaker_trace(jres), _breaker_trace(tres)
    assert port == ref
    assert any(snap["a"]["open"] for _, snap in ref) and any(r is False for r, _ in ref)


def _guarded(mod, script, deadline_s=1.0, max_attempts=4, step=0.01):
    """run_guarded over ``fn(attempt)`` following ``script``: per attempt an
    exception to raise, a value to return, or a wall time to burn."""
    clock = FakeClock(step)

    def fn(attempt):
        what = script[min(attempt, len(script) - 1)]
        if isinstance(what, tuple) and what[0] == "burn":
            clock.t += what[1]
            return "late"
        if isinstance(what, tuple) and what[0] == "raise":
            exc = getattr(mod, what[1], None) or {"RuntimeError": RuntimeError, "ValueError": ValueError,
                                                  "FloatingPointError": FloatingPointError}[what[1]]
            raise exc(f"scripted {what[1]} at attempt {attempt}")
        return what

    out = mod.run_guarded(fn, policy=mod.RetryPolicy(max_attempts=max_attempts, base_s=0.05), deadline_s=deadline_s,
                          token=17, clock=clock, sleep=clock.sleep)
    fault = out.fault.to_json() if out.fault else None
    return out.ok, out.result, fault, out.attempts, out.retries, round(out.wall_s, 12), out.deadline_s


GUARDED = {
    "first_try": (["answer"], {}),
    "transient_then_ok": ([("raise", "RuntimeError"), ("raise", "TransientFault"), "answer"], {}),
    "client_error": ([("raise", "ValueError")], {}),
    "numeric_exhausts": ([("raise", "FloatingPointError")], {}),
    "all_transient": ([("raise", "RuntimeError")], {"max_attempts": 3}),
    "late_answer": ([("burn", 2.0)], {}),
    "budget_short_for_backoff": ([("raise", "RuntimeError")], {"deadline_s": 0.06}),
    "circuit_open_not_retried": ([("raise", "CircuitOpen")], {}),
}


@pytest.mark.parametrize("case", list(GUARDED))
def test_run_guarded_script(case):
    script, kw = GUARDED[case]
    assert _guarded(tres, script, **kw) == _guarded(jres, script, **kw)


def test_run_guarded_reraises_interrupts():
    for mod in (jres, tres):
        def fn(attempt):
            raise KeyboardInterrupt

        with pytest.raises(KeyboardInterrupt):
            mod.run_guarded(fn, policy=mod.RetryPolicy(), deadline_s=1.0)


# --------------------------------------------------------------------------- #
# straggler monitor
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_straggler_monitor_flags(seed):
    rng = np.random.default_rng(seed)
    dts = (0.01 * (1.0 + 0.1 * rng.standard_normal(200))).tolist()
    for i in rng.choice(np.arange(10, 200), 12, replace=False):
        dts[i] *= float(rng.uniform(2.0, 8.0))  # spikes
    dts[0] = 3.0  # a cold first step

    def run(mod):
        m = mod.StragglerMonitor()
        flags = [m.record(i, dt) for i, dt in enumerate(dts[:120])]
        m.reprime(0.5)  # a regime change
        flags += [m.record(i, dt) for i, dt in enumerate(dts[120:], 120)]
        return flags, m.flagged, m.ewma, m.ewvar, m.n

    ref, port = run(jstraggler), run(tstraggler)
    assert port == ref and sum(ref[0]) > 0


def test_failure_injector():
    for mod in (jstraggler, tstraggler):
        inj = mod.FailureInjector(fail_at=(2,), slow_at=(), slow_secs=0.0)
        inj.maybe_fail(1)
        with pytest.raises(mod.SimulatedFailure, match="step 2"):
            inj.maybe_fail(2)
        inj.maybe_fail(2)  # fires once
    assert issubclass(tstraggler.SimulatedFailure, RuntimeError)


# --------------------------------------------------------------------------- #
# chaos
# --------------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def ref_schedules():
    return {name: [p.to_json() for p in jchaos.ChaosInjector(jchaos.ChaosConfig(**kw)).schedule(range(200))]
            for name, kw in BENCH_CONFIGS.items()}


@pytest.mark.parametrize("name", list(BENCH_CONFIGS))
def test_chaos_schedule_equals_reference(name, ref_schedules):
    port = [p.to_json() for p in tchaos.ChaosInjector(tchaos.ChaosConfig(**BENCH_CONFIGS[name])).schedule(range(200))]
    assert port == ref_schedules[name]
    assert any(not tchaos.FaultPlan(**p).clean or p["worker_kill"] for p in port)


@pytest.mark.parametrize("name", list(BENCH_CONFIGS))
def test_chaos_fixture_is_the_reference_schedule(name, ref_schedules):
    doc = json.loads(FIXTURE.read_text())
    assert doc["configs"][name] == BENCH_CONFIGS[name] and doc["seed"] == SEED
    assert doc["schedules"][name] == ref_schedules[name]


def test_fault_plan_properties():
    cfg = dict(seed=3, p_transient=0.5, p_compile_fail=0.5, p_nan=0.5, p_latency=0.5, depth=2, p_cache_corrupt=0.5)
    for qid in range(40):
        r, p = jchaos.ChaosInjector(jchaos.ChaosConfig(**cfg)).plan(qid), tchaos.ChaosInjector(
            tchaos.ChaosConfig(**cfg)).plan(qid)
        assert (p.clean, p.min_attempts, p.to_json()) == (r.clean, r.min_attempts, r.to_json())


def _sim_report(mod, area=120.5, runtime=1e-3, label="lstm"):
    wl = mod.WorkloadReport(label=label, runtime_s=runtime, energy_j=2e-3, power_w=2.0, edp=2e-6, cycles=1e6,
                            energy_mem_j=1e-3, energy_comp_j=5e-4, energy_leak_j=5e-4, levels=(), compute=(),
                            vertices=())
    return mod.SimReport(architecture="base", objective="", area_mm2=area, workloads=(wl,))


def _opt_result(mod, improvement=3.0, hist=(9.0, 3.0), baseline=None):
    return mod.OptResult(objective="edp", opt_over="both", epochs=len(hist), improvement=improvement,
                         objective_history=hist, importance=(), baseline=baseline, optimized=None, dhd="")


def _frontier(mod, hv=0.5, t=1e-3):
    pt = mod.FrontierPoint(index=4, seed="edge", weights=(1.0, 0.0, 0.0), time_s=t, energy_j=1e-3,
                           area_mm2=10.0, power_w=1.0, edp=1e-6, dhd="")
    return mod.FrontierResult(metrics=("time", "energy", "area"), population=4, epochs=2, feasible=4,
                              hypervolume=hv, area_budget=math.inf, power_budget=math.inf, front=(pt,))


NAN = float("nan")
RESULTS = {
    "clean_sim": lambda m: _sim_report(m),
    "area_nan": lambda m: _sim_report(m, area=NAN),
    "runtime_inf": lambda m: _sim_report(m, runtime=math.inf),
    "clean_opt": lambda m: _opt_result(m),
    "improvement_nan": lambda m: _opt_result(m, improvement=NAN),
    "history_nan": lambda m: _opt_result(m, hist=(9.0, NAN)),
    "baseline_nan": lambda m: _opt_result(m, baseline=_sim_report(m, area=NAN)),
    "clean_front": lambda m: _frontier(m),
    "hypervolume_nan": lambda m: _frontier(m, hv=NAN),
    "front_point_nan": lambda m: _frontier(m, t=NAN),
    "not_a_report": lambda m: {"area_mm2": NAN},
}


@pytest.mark.parametrize("case", list(RESULTS))
def test_nonfinite_in_and_poison(case):
    ref, port = RESULTS[case](jreport), RESULTS[case](treport)
    assert tres.nonfinite_in(port) == jres.nonfinite_in(ref)
    pr, pp = jchaos.poison(ref), tchaos.poison(port)
    assert (pp is port) == (pr is ref)
    assert tres.nonfinite_in(pp) == jres.nonfinite_in(pr)
    if pp is not port:
        assert type(pp) is type(port) and tres.nonfinite_in(pp) in ("area_mm2", "improvement", "hypervolume")


@pytest.mark.parametrize("name", ["transient_only", "full"])
def test_chaos_call_outcomes(name):
    """Per attempt of each query, the same outcome: the fault raised (its
    type and code), or the handler's result, poisoned or clean."""

    def run(mod, report):
        clock = FakeClock()
        inj = mod.ChaosInjector(mod.ChaosConfig(**BENCH_CONFIGS[name]), sleep=clock.sleep)
        out = []
        for qid in range(48):
            for attempt in range(4):
                try:
                    res = inj.call(lambda: _sim_report(report), qid=qid, attempt=attempt)
                    out.append((qid, attempt, "ok", math.isnan(res.area_mm2)))
                except Exception as e:  # noqa: BLE001 — the outcome under test
                    out.append((qid, attempt, type(e).__name__, e.code, str(e)))
        return out, inj.summary(), round(clock.t, 12)

    assert run(tchaos, treport) == run(jchaos, jreport)


# --------------------------------------------------------------------------- #
# batching
# --------------------------------------------------------------------------- #

BAD_POLICIES = (dict(max_batch=0), dict(max_batch=4, min_batch=5), dict(min_batch=0), dict(max_delay_s=-1.0))


@pytest.mark.parametrize("kw", BAD_POLICIES)
def test_flush_policy_validation(kw):
    msgs = []
    for mod in (jbatching, tbatching):
        with pytest.raises(ValueError) as e:
            mod.FlushPolicy(**kw)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_flush_policy_defaults():
    assert dataclasses.asdict(tbatching.FlushPolicy()) == dataclasses.asdict(jbatching.FlushPolicy())
    assert tbatching.BATCHABLE_KINDS == jbatching.BATCHABLE_KINDS


def _queue_trace(mod):
    """Push / advance / due / drain under a fake clock: size and age triggers."""
    t = [0.0]
    q = mod.IntakeQueue(clock=lambda: t[0])
    pol = mod.FlushPolicy(max_batch=4, max_delay_s=0.005, min_batch=2)
    out = []
    for i, dt in enumerate([0.0, 0.001, 0.006, 0.0, 0.001, 0.001, 0.001, 0.002, 0.004, 0.01]):
        t[0] += dt
        if i in (2, 9):
            out.append(("due-before-push", q.due(pol), len(q)))
        q.push(i)
        out.append((i, q.due(pol), len(q), round(q.oldest_age(), 12)))
        if q.due(pol):
            out.append(("drain", [(round(a, 12), b) for a, b in q.drain()]))
    return out


def test_intake_queue_triggers():
    assert _queue_trace(tbatching) == _queue_trace(jbatching)


def _admitted(i: int) -> types.SimpleNamespace:
    kinds = ("simulate", "explain", "simulate", "optimize", "explain", "frontier")
    q = types.SimpleNamespace(kind=kinds[i % 6], objective=("edp", "energy")[(i // 6) % 2])
    return types.SimpleNamespace(q=q, arch=types.SimpleNamespace(spec=("specA", "specB")[(i // 4) % 2]),
                                 w=types.SimpleNamespace(bucket=((1, 32), (1, 1024))[(i // 3) % 2]))


@pytest.mark.parametrize("max_batch", [1, 2, 3, 16])
def test_plan_chunks(max_batch):
    stream = [(i, _admitted(i)) for i in range(60)]

    def plan(mod):
        return [[idx for idx, _ in chunk] for chunk in mod.plan_chunks(stream, max_batch)], \
            [mod.batch_key(adm) for _, adm in stream]

    assert plan(tbatching) == plan(jbatching)


def test_chunk_handlers_dispatch_once():
    chunk = [(i, _admitted(0)) for i in (3, 5, 9)]
    for mod in (jbatching, tbatching):
        calls = []

        def dispatch(adms):
            calls.append(len(adms))
            return [f"r{k}" for k in range(len(adms))]

        handlers = mod.make_chunk_handlers(chunk, dispatch)
        assert [handlers[i]() for i in (9, 3, 5, 3)] == ["r2", "r0", "r1", "r0"] and calls == [3]
