"""Port conformance: the design-serving tier past one thread and one process.

Mirrors ``tests/test_serving_pool.py`` for ``repro_torch.serving``, on the
CPU (``device="cpu"``, request bucket 8):

  * the frame protocol — every reference case on the port's copy, and the
    wire format shared across packages: a frame either package encodes
    decodes with the other's ``recv_frame``, and equal plain payloads
    encode to equal bytes;
  * staged assembly — every staged leaf equals ``Session._assemble_batch``'s
    (values, dtype, shape, strides), replies are bit-identical to
    ``DesignService``'s sequential ones, singletons route through the staged
    dispatch, buffers are reused and lane memos are weak;
  * the pooled service — replies bit-identical and in order, the ticket
    API, a poison query isolated, enqueue after close refused;
  * across packages under chaos — the reference's and the port's
    ``PooledDesignService(workers=2)`` under one seeded configuration give
    the same ``(qid, ok, error code, attempts)``, the same ledger and the
    same injected faults, ok reports at the simulator's tolerances (values
    rtol 1e-5, ``tests/test_mapper_equiv.py:63-72``; elasticities rtol 1e-4,
    atol 1e-6); the same seed gives the same schedule at 1, 2 and 4 pool
    workers, and the worker-kill draw appends to the schedule;
  * multi-process — two spawned workers over a preheated ``cache_dir``
    reply bit-identically with zero builds, answer a query that carries a
    ``Workload`` object as the in-process service does, and import nothing
    of ``jax`` or ``repro``; a seeded worker kill is requeued with every
    query ok; heartbeat silence is death; ``cache_dir`` is required and the
    architecture must be a string;
  * the persistent cache under two processes racing the same keys, and
    ``runtime.count_launch`` under 8 threads.

The batch counts of a pooled run (``batches``, ``batched_queries``) follow
when the dispatcher thread drains the intake queue, so the ledgers compared
here leave them out.  One module-scoped fixture per service run.
"""
import json
import os
import socket
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

import repro.serving as jserving
import repro_torch.serving as tserving
from repro.serving import protocol as jprotocol
from repro_torch.api import Architecture, Workload
from repro_torch.kernels import runtime
from repro_torch.serving import protocol
from repro_torch.workloads import get_workload

CPU = "cpu"
NB = 8
N = 16
POLICY = tserving.FlushPolicy(max_batch=NB, max_delay_s=0.001)
CHAOS = dict(seed=11, p_transient=0.3, p_nan=0.2, p_latency=0.3, latency_s=0.001)
KILL = dict(seed=7, p_worker_kill=0.15)
LEDGER = ("queries", "ok", "retries", "errors", "degraded", "deadline_misses")
_SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))

#: one program cache for every in-process port service here: parameter
#: values are call arguments, so sharing is exact
_PROGRAMS: dict = {}


def _mk(cls=tserving.BatchingDesignService, **kw):
    kw.setdefault("programs", _PROGRAMS)
    return cls("base", policy=POLICY, device=CPU, **kw)


def _queries(mod=tserving, n=N, workloads=("lstm", "gcn")) -> list:
    archs = [None, "edge", "datacenter", "mobile"]
    return [
        mod.DesignQuery(qid=i, kind="simulate" if i % 2 == 0 else "explain",
                        workload=workloads[(i // 2) % len(workloads)], architecture=archs[(i // 2) % 4])
        for i in range(n)
    ]


def _texts(replies) -> list:
    return [r.result.to_json() for r in replies]


def _outcomes(replies) -> list:
    return [(r.qid, r.ok, r.error.code if r.error else None, r.attempts) for r in sorted(replies, key=lambda r: r.qid)]


def _ledger(stats) -> dict:
    return {f: getattr(stats, f) for f in LEDGER}


def _guarded(mod) -> dict:
    """Retry and deadlines under which a faulted query always recovers."""
    return dict(retry=mod.RetryPolicy(max_attempts=4, base_s=0.005),
                deadlines=mod.DeadlineConfig(warm_s=1e9, cold_s=1e9))


@pytest.fixture(scope="module")
def sequential():
    """``DesignService``'s sequential replies: the yardstick of every tier."""
    qs = _queries()
    svc = tserving.DesignService("base", request_bucket=NB, device=CPU, programs=_PROGRAMS)
    return qs, _texts(svc.serve(qs))


# --------------------------------------------------------------------------- #
# frame protocol
# --------------------------------------------------------------------------- #


class TestProtocol:
    def test_roundtrip_over_socketpair(self):
        a, b = socket.socketpair()
        try:
            protocol.send_frame(a, "chunk", (7, ["q0", "q1"]))
            protocol.send_frame(a, "hb", 3)
            assert protocol.recv_frame(b) == ("chunk", (7, ["q0", "q1"]))
            assert protocol.recv_frame(b) == ("hb", 3)
        finally:
            a.close(), b.close()

    def test_eof_mid_frame_raises(self):
        a, b = socket.socketpair()
        try:
            frame = protocol.encode_frame("chunk", list(range(100)))
            a.sendall(frame[: len(frame) // 2])
            a.close()
            with pytest.raises(protocol.ProtocolError, match="mid-frame"):
                protocol.recv_frame(b)
        finally:
            b.close()

    def test_clean_eof_between_frames_raises(self):
        a, b = socket.socketpair()
        a.close()
        try:
            with pytest.raises(protocol.ProtocolError):
                protocol.recv_frame(b)
        finally:
            b.close()

    def test_bad_magic_rejected(self):
        a, b = socket.socketpair()
        try:
            a.sendall(b"XXXX" + (0).to_bytes(4, "big"))
            with pytest.raises(protocol.ProtocolError, match="magic"):
                protocol.recv_frame(b)
        finally:
            a.close(), b.close()

    def test_absurd_length_rejected(self):
        a, b = socket.socketpair()
        try:
            a.sendall(protocol.MAGIC + (protocol.MAX_FRAME + 1).to_bytes(4, "big"))
            with pytest.raises(protocol.ProtocolError, match="exceeds"):
                protocol.recv_frame(b)
        finally:
            a.close(), b.close()

    def test_unpicklable_payload_fails_before_any_bytes_hit_the_wire(self):
        a, b = socket.socketpair()
        try:
            with pytest.raises(Exception):
                protocol.send_frame(a, "replies", lambda: None)
            b.settimeout(0.05)
            with pytest.raises(socket.timeout):
                b.recv(1)  # stream is still clean: nothing was written
        finally:
            a.close(), b.close()


_PLAIN = [("hello", {"worker": 3, "pid": 4242}), ("chunk", (7, ["q0", "q1"])), ("hb", 1), ("shutdown", None),
          ("replies", (2, [1.5, float("inf"), "x" * 5000], {"a": (1, 2)}))]


@pytest.mark.parametrize("payload", _PLAIN, ids=[t for t, _ in _PLAIN])
@pytest.mark.parametrize("direction", ["port->reference", "reference->port"])
def test_frames_cross_packages(direction, payload):
    send, recv = (protocol, jprotocol) if direction == "port->reference" else (jprotocol, protocol)
    a, b = socket.socketpair()
    try:
        send.send_frame(a, *payload)
        assert recv.recv_frame(b) == payload
    finally:
        a.close(), b.close()


@pytest.mark.parametrize("payload", _PLAIN, ids=[t for t, _ in _PLAIN])
def test_equal_payloads_equal_bytes(payload):
    assert protocol.encode_frame(*payload) == jprotocol.encode_frame(*payload)
    assert (protocol.MAGIC, protocol.MAX_FRAME) == (jprotocol.MAGIC, jprotocol.MAX_FRAME)


def test_protocol_is_pure_stdlib():
    """A worker stub loads the file alone: it imports nothing of the port,
    of torch, of jax or of the reference."""
    code = ("import importlib.util, sys\n"
            f"spec = importlib.util.spec_from_file_location('p', {os.path.join(_SRC, 'repro_torch', 'serving', 'protocol.py')!r})\n"
            "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in ('torch', 'jax', 'repro', 'repro_torch', 'numpy')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


# --------------------------------------------------------------------------- #
# staged assembly
# --------------------------------------------------------------------------- #


def _leaves(techs, arch_ps, g) -> list:
    return techs.leaves() + arch_ps.leaves() + [g.n_comp, g.n_read, g.n_write, g.n_alloc, g.dims, g.op_kind, g.edges]


_SETS = {
    "one lane": (["lstm"], [None]),
    "five lanes, four designs": (["lstm", "gcn", "lstm", "merge_sort", "gcn"], [None, "edge", "datacenter", "mobile", "edge"]),
    "full bucket": (["gcn"] * NB, ["mobile"] * NB),
    "two-graph sets at (2, 32)": ([["lstm", "gcn"], ["merge_sort", "stencil2d"]], ["edge", None]),
}


@pytest.mark.parametrize("name", sorted(_SETS))
def test_staged_leaves_equal_assemble_batch(name):
    svc = _mk(tserving.StagedBatchingService)
    sess = svc.session
    loads, designs = _SETS[name]
    ws = [sess._workload(Workload(x, device=CPU) if isinstance(x, list) else x) for x in loads]
    archs = [sess._arch(a) for a in designs]
    _, _, nb, (techs, arch_ps, gstacks) = sess._assemble_batch(ws, archs, NB)
    for _ in range(2):  # the second pass reuses the buffers
        staged = svc._assembler.stage(ws, archs)
        assert type(staged[0]) is type(techs) and type(staged[1]) is type(arch_ps)
        assert staged[2].names == gstacks.names
        for want, got in zip(_leaves(techs, arch_ps, gstacks), _leaves(*staged), strict=True):
            assert (got.dtype, got.shape, got.stride(), got.device) == (want.dtype, want.shape, want.stride(), want.device)
            assert got.is_contiguous() and torch.equal(got, want)
            assert got.storage_offset() * got.element_size() % 256 == 0  # each run starts on 256 bytes


@pytest.fixture(scope="module")
def staged(sequential):
    qs, _ = sequential
    svc = _mk(tserving.StagedBatchingService)
    return svc, svc.serve(qs)


def test_staged_replies_bit_identical_to_sequential(staged, sequential):
    svc, replies = staged
    assert [r.qid for r in replies] == [q.qid for q in sequential[0]] and all(r.ok for r in replies)
    assert _texts(replies) == sequential[1]
    assert svc.stats.batches > 0


def test_singleton_queries_route_through_staged_dispatch(sequential):
    qs, want = sequential
    svc = _mk(tserving.StagedBatchingService)
    real, calls = svc._dispatch_chunk, []
    svc._dispatch_chunk = lambda adms: calls.append(len(adms)) or real(adms)
    got = _texts([svc.submit(q) for q in qs])
    assert got == want and calls == [1] * len(qs)
    # a size-1 staged dispatch is not a coalesce: stats must not claim one
    assert svc.stats.batches == 0 and svc.stats.batched_queries == 0


def test_staging_buffers_are_reused_not_leaked(staged, sequential):
    svc, _ = staged
    bufs = svc._assembler._tls.bufs
    ptrs = {k: [h.data_ptr() for h in st.host.values()] for k, st in bufs.items()}
    assert len(bufs) >= 1
    svc.serve(sequential[0])
    # one buffer set per (spec, bucket), not per call: repeats neither grow
    # the set nor reallocate a buffer
    assert {k: [h.data_ptr() for h in st.host.values()] for k, st in bufs.items()} == ptrs


def test_lane_memos_are_weak():
    svc = _mk(tserving.StagedBatchingService)
    w = Workload([get_workload("lstm", device=CPU)], labels=("transient",), device=CPU)
    a = Architecture("edge", device=CPU)
    svc._assembler.stage([w], [a])
    asm = svc._assembler
    assert w in asm._graph_np and a in asm._design_np
    n_graph, n_design = len(asm._graph_np), len(asm._design_np)
    del w, a
    assert (len(asm._graph_np), len(asm._design_np)) == (n_graph - 1, n_design - 1)


# --------------------------------------------------------------------------- #
# pooled service
# --------------------------------------------------------------------------- #


def test_pooled_replies_bit_identical_and_ordered(sequential):
    qs, want = sequential
    with _mk(tserving.PooledDesignService, workers=2) as pool:
        replies = pool.serve(qs)
    assert [r.qid for r in replies] == [q.qid for q in qs]
    assert all(r.ok for r in replies)
    assert _texts(replies) == want


def test_ticket_api(sequential):
    qs, want = sequential
    with _mk(tserving.PooledDesignService, workers=2) as pool:
        tickets = [pool.enqueue(q) for q in qs]
        assert pool.join(timeout=60)
        replies = [pool.take(t) for t in tickets]
        assert _texts(replies) == want
        assert pool.take(tickets[0]) is None  # a reply pops exactly once


def test_poison_query_is_isolated():
    qs = _queries(n=6)
    qs[2] = tserving.DesignQuery(qid=2, kind="simulate", workload="no_such_workload_xyz")
    with _mk(tserving.PooledDesignService, workers=2) as pool:
        replies = pool.serve(qs)
    assert [r.qid for r in replies] == [0, 1, 2, 3, 4, 5]
    assert not replies[2].ok and replies[2].error.code == "client-error"
    assert all(r.ok for i, r in enumerate(replies) if i != 2)
    st = pool.stats
    assert st.queries == 6 and st.ok == 5


def test_enqueue_after_close_raises():
    pool = _mk(tserving.PooledDesignService, workers=1)
    pool.close()
    pool.close()  # idempotent
    with pytest.raises(RuntimeError, match="closed"):
        pool.enqueue(_queries(n=1)[0])


# --------------------------------------------------------------------------- #
# across packages under chaos; determinism under concurrency
# --------------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def ref_pooled_chaos():
    inj = jserving.ChaosInjector(jserving.ChaosConfig(**CHAOS))
    with jserving.PooledDesignService("base", policy=jserving.FlushPolicy(max_batch=NB, max_delay_s=0.001),
                                      workers=2, chaos=inj, **_guarded(jserving)) as pool:
        replies = pool.serve(_queries(jserving))
    return replies, pool.stats, dict(inj.injected)


@pytest.fixture(scope="module")
def port_pooled_chaos():
    """The port's pooled service under CHAOS at 1, 2 and 4 pool workers."""
    runs = {}
    for workers in (1, 2, 4):
        inj = tserving.ChaosInjector(tserving.ChaosConfig(**CHAOS))
        with _mk(tserving.PooledDesignService, workers=workers, chaos=inj, **_guarded(tserving)) as pool:
            replies = pool.serve(_queries())
        runs[workers] = (replies, pool.stats, dict(inj.injected))
    return runs


def test_pooled_chaos_matches_the_reference(ref_pooled_chaos, port_pooled_chaos):
    ref, port = ref_pooled_chaos, port_pooled_chaos[2]
    assert _outcomes(port[0]) == _outcomes(ref[0])
    assert _ledger(port[1]) == _ledger(ref[1])
    assert port[2] == ref[2] and port[1].retries > 0 and port[1].availability == 1.0


@pytest.mark.parametrize("qid", range(N))
def test_pooled_chaos_reports_within_tolerance(qid, ref_pooled_chaos, port_pooled_chaos):
    ref = {r.qid: r for r in ref_pooled_chaos[0]}[qid]
    port = {r.qid: r for r in port_pooled_chaos[2][0]}[qid]
    assert port.ok and ref.ok and port.kind == ref.kind
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


@pytest.mark.parametrize("workers", [1, 4])
def test_same_seed_same_schedule_regardless_of_worker_count(workers, port_pooled_chaos):
    """The chaos schedule is a pure function of (seed, qid): every pool
    width observes the same per-query faults, retries and (bit-identical)
    results — completion order is the only thing allowed to differ."""
    base, run = port_pooled_chaos[2], port_pooled_chaos[workers]
    assert _outcomes(run[0]) == _outcomes(base[0])
    assert sorted(zip((r.qid for r in run[0]), _texts(run[0]))) == sorted(zip((r.qid for r in base[0]), _texts(base[0])))
    assert run[2] == base[2] and _ledger(run[1]) == _ledger(base[1])


def test_pooled_chaos_outcomes_match_sequential(port_pooled_chaos):
    seq = tserving.DesignService("base", request_bucket=NB, device=CPU, programs=_PROGRAMS,
                                 chaos=tserving.ChaosInjector(tserving.ChaosConfig(**CHAOS)), **_guarded(tserving))
    replies = seq.serve(_queries())
    pooled = sorted(port_pooled_chaos[2][0], key=lambda r: r.qid)
    assert (_outcomes(pooled), _texts(pooled)) == (_outcomes(replies), _texts(replies))


def test_worker_kill_draw_appends_to_the_schedule():
    """Adding p_worker_kill must not reshuffle the fault schedule — new
    fault classes draw LAST."""
    base = tserving.ChaosInjector(tserving.ChaosConfig(seed=3, p_transient=0.4, p_nan=0.3))
    extended = tserving.ChaosInjector(tserving.ChaosConfig(seed=3, p_transient=0.4, p_nan=0.3, p_worker_kill=0.5))
    for qid in range(64):
        a, b = base.plan(qid), extended.plan(qid)
        assert (a.transient, a.compile_fail, a.nan, a.latency, a.cache_corrupt) == \
            (b.transient, b.compile_fail, b.nan, b.latency, b.cache_corrupt)
    assert any(extended.plan(q).worker_kill for q in range(64))
    assert not any(base.plan(q).worker_kill for q in range(64))


# --------------------------------------------------------------------------- #
# multi-process serving
# --------------------------------------------------------------------------- #

# runs the worker entry point and records, at exit, what of jax and the
# reference package the worker process imported
_WRAPPER = """
import atexit, json, os, runpy, sys
out = sys.argv.pop(1)

def record():
    foreign = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro"))
    with open(os.path.join(out, "worker-%d.json" % os.getpid()), "w") as f:
        json.dump(foreign, f)

atexit.register(record)
runpy.run_module("repro_torch.serving.worker", run_name="__main__", alter_sys=True)
"""


#: the LM cells the design path serves on the card, each a Workload object
#: padded to (1, 1024): they have no library name
LM_CELLS = (("qwen2.5-32b", "prefill_32k"), ("granite-3-8b", "train_4k"), ("kimi-k2-1t-a32b", "decode_32k"),
            ("falcon-mamba-7b", "long_500k"), ("zamba2-1.2b", "train_4k"))


def _object_queries() -> list:
    """Queries whose workload is a ``Workload`` object built from a graph:
    it has no library name, so it crosses the socket pickled."""
    w = Workload([get_workload("lstm", device=CPU)], labels=("lstm-object",), device=CPU)
    return [tserving.DesignQuery(100, "explain", w, architecture="edge"),
            tserving.DesignQuery(101, "simulate", w)]


def _lm_queries() -> list:
    """24 queries over the 5 LM cells at (1, 1024): four chunks, so each of
    two workers holds two in flight, and both directions carry frames larger
    than a socket's buffer (a chunk of distinct cells ~0.4 MB, a chunk's
    per-vertex reports ~0.9 MB)."""
    from repro_torch.workloads import lm_cell

    ws = [Workload(lm_cell(a, s, device=CPU).pad_to(1024), labels=(f"{a}:{s}",), device=CPU) for a, s in LM_CELLS]
    archs = [None, "edge", "datacenter", "mobile"]
    return [tserving.DesignQuery(200 + i, ("simulate", "explain")[i % 2], ws[(i // 2) % 5], architecture=archs[i % 4])
            for i in range(24)]


@pytest.fixture(scope="module")
def cache_dir(tmp_path_factory):
    """A cache directory preheated by a parent service at (1, 32) and (1, 1024)."""
    d = str(tmp_path_factory.mktemp("pool-cache"))
    parent = tserving.BatchingDesignService("base", policy=POLICY, cache_dir=d, device=CPU)
    info = parent.warmup(["lstm", "gcn", (1, 1024)])
    assert info["persisted"] == 8
    return d


@pytest.fixture(scope="module")
def fleet(cache_dir, sequential, tmp_path_factory):
    qs = sequential[0][:12]
    oq, lq = _object_queries(), _lm_queries()
    out = tmp_path_factory.mktemp("worker-imports")
    wrapper = out / "wrapper.py"
    wrapper.write_text(_WRAPPER)
    with tserving.MultiProcessDesignService("base", workers=2, cache_dir=cache_dir, policy=POLICY, device=CPU,
                                            worker_cmd=[sys.executable, str(wrapper), str(out)]) as mp:
        info = mp.pool_info
        replies = mp.serve(qs)
        obj_replies = mp.serve(oq)
        lm_replies = mp.serve(lq)
        alive = mp.pool_info["alive"]
        stats = mp.stats
    records = [json.loads(p.read_text()) for p in out.glob("worker-*.json")]
    in_process = tserving.DesignService("base", request_bucket=NB, device=CPU, programs=_PROGRAMS).serve(oq)
    lm_in_process = _mk(tserving.StagedBatchingService).serve(lq)
    return dict(qs=qs, replies=replies, obj_replies=obj_replies, in_process=in_process, lm_replies=lm_replies,
                lm_in_process=lm_in_process, alive=alive, stats=stats, info=info, records=records)


def test_two_workers_bit_identical_zero_builds(fleet, sequential):
    qs, replies = fleet["qs"], fleet["replies"]
    assert [r.qid for r in replies] == [q.qid for q in qs]
    assert all(r.ok for r in replies)
    assert _texts(replies) == sequential[1][:12]
    # both workers rehydrated the parent's programs at construction: no
    # build after ready, and no query labelled as one
    st = fleet["stats"]
    assert st.traces == 0 and st.misses == 0 and not any(r.compiled for r in replies)
    assert fleet["info"]["disk_loaded"] == 16 and fleet["info"]["ready"] == 2 and fleet["info"]["kernels_built"] == 0
    assert st.queries == len(qs) + 2 + 24 and st.ok == len(qs) + 2 + 24


def test_frames_beyond_the_socket_buffer_in_both_directions(fleet):
    """Two chunks in flight per worker with large frames each way: no worker
    is declared dead, and the LM-cell replies equal the in-process ones."""
    got, want = fleet["lm_replies"], fleet["lm_in_process"]
    assert fleet["alive"] == 2 and all(r.ok for r in got)
    assert [r.qid for r in got] == list(range(200, 224))
    assert _texts(got) == _texts(want) and not any(r.compiled for r in got)


def test_workload_object_query_equals_in_process_reply(fleet):
    got, want = fleet["obj_replies"], fleet["in_process"]
    assert all(r.ok for r in got) and [r.qid for r in got] == [100, 101]
    assert _texts(got) == _texts(want)
    assert got[0].result.workloads[0].label == "lstm-object"


def test_workers_import_nothing_of_jax_or_the_reference(fleet):
    assert len(fleet["records"]) == 2
    assert fleet["records"] == [[], []]


@pytest.fixture(scope="module")
def kill_fleet(cache_dir, sequential):
    qs = sequential[0][:12]
    with tserving.MultiProcessDesignService("base", workers=2, cache_dir=cache_dir, policy=POLICY, device=CPU,
                                            chaos=tserving.ChaosConfig(**KILL)) as mp:
        replies = mp.serve(qs)
        info = mp.pool_info
    return qs, replies, info


def test_worker_kill_is_requeued_and_availability_holds(kill_fleet, sequential):
    qs, replies, info = kill_fleet
    assert info["kills"] >= 1 and info["requeues"] >= 1 and info["alive"] == 1
    assert len(replies) == len(qs) and all(r.ok for r in replies)  # availability 1.0
    assert _texts(replies) == sequential[1][:12]  # requeued answers are exact


_STUB = """
import argparse, importlib.util, os, socket, time

spec = importlib.util.spec_from_file_location("protocol", {path!r})
protocol = importlib.util.module_from_spec(spec)
spec.loader.exec_module(protocol)
ap = argparse.ArgumentParser()
ap.add_argument("--socket"), ap.add_argument("--id", type=int)
args = ap.parse_args()
conn = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
conn.connect(args.socket)
protocol.send_frame(conn, "hello", {{"worker": args.id, "pid": os.getpid()}})
tag, cfg = protocol.recv_frame(conn)
protocol.send_frame(conn, "ready", {{"worker": args.id, "disk_loaded": 0}})
time.sleep(60)  # hang: no heartbeats, no replies
"""


def test_heartbeat_silence_is_worker_death(cache_dir, sequential, tmp_path):
    """A hung worker (handshakes, then never beacons) must be detected by
    heartbeat timeout and its in-flight queries resolved — here to
    structured errors, since no live worker remains."""
    stub = tmp_path / "stub_worker.py"
    stub.write_text(_STUB.format(path=os.path.join(_SRC, "repro_torch", "serving", "protocol.py")))
    mp = tserving.MultiProcessDesignService(
        "base", workers=2, cache_dir=cache_dir, policy=POLICY, device=CPU,
        heartbeat_s=0.1, worker_timeout_s=0.8, worker_cmd=[sys.executable, str(stub)],
    )
    with mp:
        replies = mp.serve(sequential[0][:4])
    assert mp.pool_info["alive"] == 0
    assert len(replies) == 4  # serve() returned instead of hanging
    assert all(not r.ok for r in replies)
    assert all(r.error.code == "transient" for r in replies)


def test_cache_dir_is_required():
    with pytest.raises(ValueError, match="cache_dir"):
        tserving.MultiProcessDesignService("base", workers=2, device=CPU)


def test_architecture_must_cross_the_process_boundary(cache_dir):
    with pytest.raises(TypeError, match="process boundary"):
        tserving.MultiProcessDesignService(Architecture("edge", device=CPU), cache_dir=cache_dir, device=CPU)


def test_worker_that_exits_before_its_handshake_fails_the_start(cache_dir):
    mp = tserving.MultiProcessDesignService("base", workers=2, cache_dir=cache_dir, policy=POLICY, device=CPU,
                                            worker_cmd=[sys.executable, "-c", "raise SystemExit(3)"])
    with pytest.raises(protocol.ProtocolError, match="before its handshake"):
        mp.start()
    assert all(w.proc.poll() is not None for w in mp._workers.values())


# --------------------------------------------------------------------------- #
# the persistent cache under two writers; launch counts under threads
# --------------------------------------------------------------------------- #

_HAMMER = """
import sys
sys.path.insert(0, {src!r})
from repro_torch.serving.aotcache import AotCache

cache = AotCache({path!r}, device="cpu")
ok = 0
for r in range(4):
    for k in range(50):
        cache.put(("stress", k))
        ok += 1
print(ok, sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro")))
"""


def test_two_processes_racing_the_same_keys_never_tear(tmp_path):
    from repro_torch.serving.aotcache import AotCache

    path = str(tmp_path / "shared-cache")
    script = _HAMMER.format(src=_SRC, path=path)
    procs = [subprocess.Popen([sys.executable, "-c", script], stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for _ in range(2)]
    for p in procs:
        out, err = p.communicate(timeout=120)
        assert p.returncode == 0, err.decode()
        assert out.strip() == b"200 []"
    cache = AotCache(path, device=CPU)
    keys = cache.load_all()
    # every key readable, no torn entries quarantined, no tmp litter
    assert sorted(k for _, k in keys) == list(range(50))
    assert cache.quarantined == 0
    assert [n for n in os.listdir(path) if n.endswith(".tmp")] == []
    assert not any(n.endswith(".quarantined") for n in os.listdir(path))


def test_count_launch_loses_no_launch_under_threads():
    name = "affine_scan"
    before = runtime.LAUNCHES[name]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    barrier = threading.Barrier(8)

    def work():
        barrier.wait()
        for _ in range(10_000):
            runtime.count_launch(name)

    try:
        threads = [threading.Thread(target=work) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        counted = runtime.LAUNCHES[name] - before
    finally:
        sys.setswitchinterval(interval)
        runtime.LAUNCHES[name] = before
    assert counted == 80_000
