"""Async worker-pool serving: staged assembly, overlapped dispatch, worker processes.

The single-thread :class:`~repro_torch.serving.engine.BatchingDesignService`
assembles every coalesced chunk with ``Session._assemble_batch``: one
``torch.stack`` per leaf of the tech, arch and graph trees on the device,
about 40 small launches a chunk before the program runs, then device
dispatch and report construction, all on one thread.  This module is the
serving tier above it, in three layers:

* :class:`StagedBatchingService` — the same coalescing service with a
  **staging-buffer** chunk dispatcher (:class:`_StagedAssembler`): each
  lane's leaves are memoized on the host once per (Architecture, Workload)
  object, written into a reusable leaf-major host buffer, and moved to the
  device in one copy per dtype; the program gets contiguous views of that
  copy, with the pad convention unchanged (lane 0 repeated).  Same program
  + the same input values, dtypes, shapes and contiguity = bit-identical
  replies.

* :class:`PooledDesignService` — async intake: callers ``enqueue`` and a
  dispatcher thread pulls flushed chunks from the :class:`IntakeQueue`,
  hands each to a bounded thread pool, and completions scatter back by
  ticket.  Host assembly and report construction of one chunk overlap the
  device work of another; the guard stack still wraps every query
  individually (``_complete`` bookkeeping is mutex-guarded, the engine call
  runs outside the lock).  The threads share one session and launch on the
  current stream.

* :class:`MultiProcessDesignService` — N worker *processes*, each a
  :class:`StagedBatchingService` over ``Session(cache_dir=...)`` against
  one shared :class:`~repro_torch.serving.aotcache.AotCache` directory (a
  preheated directory makes a worker's programs arrive by rehydration at
  construction, so it builds nothing after ``ready``).  The coordinator owns
  a private Unix socket (:mod:`repro_torch.serving.protocol`), shards
  flushed chunks to the least-loaded live worker, tracks worker heartbeats,
  detects crashes (process exit, EOF, heartbeat silence) and **re-enqueues
  in-flight queries** of a dead worker; per-worker :class:`ServiceStats`
  piggyback on reply frames and aggregate losslessly via
  :meth:`ServiceStats.merge`.  ``ChaosConfig.p_worker_kill`` marks queries
  whose assigned worker the coordinator SIGKILLs (once per qid) — the
  injectable crash fault.

Workers are spawned with ``subprocess`` (``python -m
repro_torch.serving.worker``), never ``fork``: a CUDA context does not
survive a fork (the ``fork-unsafe`` lint rule pins this repo-wide).  Each
worker opens the device itself.

Determinism under concurrency: chaos schedules, retry jitter and deadline
classes are all pure functions of the query (qid, retry index, shape) —
never of thread identity, worker count or completion order — so the same
seed replays the same per-query faults on 1 worker or 8, and per-worker
stats summed over any partition equal the sequential ledger
(``tests/test_torch_serving_pool.py`` pins both).
"""
from __future__ import annotations

import dataclasses
import itertools
import os
import selectors
import shutil
import socket
import subprocess
import sys
import tempfile
import threading
import time
import weakref
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from repro_torch.core.graph import Graph
from repro_torch.kernels import runtime
from repro_torch.serving import protocol
from repro_torch.serving.batching import FlushPolicy, IntakeQueue, batch_key, make_chunk_handlers, plan_chunks
from repro_torch.serving.chaos import ChaosConfig, ChaosInjector
from repro_torch.serving.engine import (
    BatchingDesignService,
    DesignQuery,
    DesignReply,
    ServiceStats,
)
from repro_torch.serving.resilience import FaultInfo, TransientFault

__all__ = [
    "StagedBatchingService",
    "PooledDesignService",
    "MultiProcessDesignService",
]


# --------------------------------------------------------------------------- #
# staging-buffer assembly
# --------------------------------------------------------------------------- #

#: every leaf's run starts at a multiple of this many bytes in its buffer,
#: as a block of the caching allocator does: a kernel that picks vectorized
#: loads by the base pointer's alignment (and so a reduction order) sees
#: the same alignment as on a freshly stacked leaf
_ALIGN = 256
#: the graph's data leaves, in the order the assembler writes them
_GRAPH_FLOAT = ("n_comp", "n_read", "n_write", "n_alloc", "dims")
_GRAPH_INT = ("op_kind",)


@dataclass
class _Leaf:
    """Where one leaf's ``(nb, *shape)`` block sits: its lane segment
    (``group``, ``[start, stop)`` of each lane's memoized host vector) and
    its run in the staging buffer of its dtype."""

    tree: str  # "tech" | "arch" | "graph"
    name: str
    group: str  # "design" | "graph_f" | "graph_i"
    start: int
    stop: int
    shape: tuple
    dtype: torch.dtype
    offset: int  # in elements of its buffer


@dataclass
class _Staging:
    """One thread's staging buffers for one ``(spec, bucket)``."""

    leaves: list
    host: dict  # dtype -> 1-D host tensor (pinned when the device is the card)
    host_np: dict  # dtype -> numpy view of it
    edges: torch.Tensor  # the stacked graph's empty [nb, 0, 2] edge list
    event: Optional[object] = None  # the card: recorded after the last copy out of ``host``


class _StagedAssembler:
    """Fast host-side batch assembly for one session.

    ``Session._assemble_batch`` stacks each leaf on the device per chunk.
    This assembler memoizes each lane's leaves once per Architecture and
    Workload object as host numpy (weak keys: a transient Architecture or a
    query's own Workload never pins memory or risks an id-reuse collision),
    writes a chunk's lanes into a thread-local host buffer per
    ``(spec, bucket)`` and dtype, laid out leaf-major so that each leaf's
    ``(nb, ...)`` block is one contiguous, 256-byte aligned run, and moves
    each dtype's buffer to the device in **one copy**.  The program gets
    contiguous views of that copy, the pad lanes repeating lane 0: every
    leaf equals what ``_assemble_batch`` gives in values, dtype, shape and
    contiguity (pinned by test), so replies are bit-identical.

    Buffers are thread-local: pool threads stage concurrently without
    racing on a buffer.
    """

    def __init__(self, request_bucket: int, device: torch.device):
        self.nb = int(request_bucket)
        self.device = torch.device(device)
        self._lock = threading.Lock()
        self._design_np: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
        self._graph_np: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
        self._tls = threading.local()

    # ------------------------------------------------------------ lane memos --
    def _memo(self, table, obj, make):
        with self._lock:
            out = table.get(obj)
        if out is None:
            out = make(obj)
            with self._lock:
                table[obj] = out
        return out

    @staticmethod
    def _design_host(a) -> np.ndarray:
        # every tech and arch leaf is float32: one host copy for the design
        return torch.cat([a.tech.flatten(), a.arch.flatten()]).detach().cpu().numpy()

    @staticmethod
    def _graph_host(w) -> tuple:
        g = w.stacked
        flo = torch.cat([getattr(g, f).reshape(-1) for f in _GRAPH_FLOAT]).detach().cpu().numpy()
        ints = torch.cat([getattr(g, f).reshape(-1) for f in _GRAPH_INT]).detach().cpu().numpy()
        return flo, ints

    # --------------------------------------------------------------- layout --
    def _layout(self, a, w) -> _Staging:
        nb = self.nb
        trees = [("tech", "design", a.tech), ("arch", "design", a.arch)]
        g = w.stacked
        spans = [(tree, group, f.name, getattr(obj, f.name))
                 for tree, group, obj in trees for f in dataclasses.fields(obj)]
        spans += [("graph", "graph_f", f, getattr(g, f)) for f in _GRAPH_FLOAT]
        spans += [("graph", "graph_i", f, getattr(g, f)) for f in _GRAPH_INT]
        starts: dict = {}
        totals: dict = {}
        leaves = []
        for tree, group, name, x in spans:
            n = x.numel()
            start = starts.get(group, 0)
            starts[group] = start + n
            step = _ALIGN // x.element_size()
            off = -(-totals.get(x.dtype, 0) // step) * step
            totals[x.dtype] = off + nb * n
            leaves.append(_Leaf(tree, name, group, start, start + n, tuple(x.shape), x.dtype, off))
        pin = self.device.type == "cuda"
        host = {dt: torch.empty(n, dtype=dt, pin_memory=pin) for dt, n in totals.items()}
        return _Staging(
            leaves=leaves, host=host, host_np={dt: h.numpy() for dt, h in host.items()},
            edges=torch.zeros((nb, 0, 2), dtype=torch.int32, device=self.device),
        )

    # ---------------------------------------------------------------- stage --
    def stage(self, ws, archs) -> tuple:
        """``(techs, arch_ps, gstacks)`` staged to the request bucket —
        drop-in for the stacked trees ``Session._assemble_batch`` returns
        (callers grouped the chunk by spec and bucket already)."""
        nb, n = self.nb, len(ws)
        key = (archs[0].spec, ws[0].bucket)
        bufs = getattr(self._tls, "bufs", None)
        if bufs is None:
            bufs = self._tls.bufs = {}
        st = bufs.get(key)
        if st is None:
            st = bufs[key] = self._layout(archs[0], ws[0])
        lanes = list(range(n)) + [0] * (nb - n)  # pad = repeat lane 0
        design = [self._memo(self._design_np, archs[i], self._design_host) for i in range(n)]
        graph = [self._memo(self._graph_np, ws[i], self._graph_host) for i in range(n)]
        rows = {
            "design": np.stack([design[i] for i in lanes]),
            "graph_f": np.stack([graph[i][0] for i in lanes]),
            "graph_i": np.stack([graph[i][1] for i in lanes]),
        }
        if st.event is not None:
            # the host buffer is pinned and its last copy to the card was
            # asynchronous: wait for that copy before overwriting the buffer
            # (long done in practice — the chunk that made it ended in a copy
            # of its results back to the host)
            st.event.synchronize()
        for lf in st.leaves:
            size = lf.stop - lf.start
            dst = st.host_np[lf.dtype][lf.offset:lf.offset + nb * size].reshape(nb, size)
            np.copyto(dst, rows[lf.group][:, lf.start:lf.stop])
        on_card = self.device.type == "cuda"
        dev = {}
        for dt, h in st.host.items():
            # one copy per dtype; on the card it is queued on the current
            # stream (the pinned source lets it run asynchronously) ahead of
            # the program that reads it
            dev[dt] = torch.empty(h.numel(), dtype=dt, device=self.device)
            dev[dt].copy_(h, non_blocking=on_card)
        if on_card:
            if st.event is None:
                st.event = torch.cuda.Event()
            st.event.record()
        views: dict = {"tech": {}, "arch": {}, "graph": {}}
        for lf in st.leaves:
            size = lf.stop - lf.start
            views[lf.tree][lf.name] = dev[lf.dtype][lf.offset:lf.offset + nb * size].view((nb,) + lf.shape)
        a0 = archs[0]
        techs = type(a0.tech)(**views["tech"])
        arch_ps = type(a0.arch)(**views["arch"])
        gstacks = Graph(**views["graph"], edges=st.edges, names=((),) * nb)
        return techs, arch_ps, gstacks


class StagedBatchingService(BatchingDesignService):
    """:class:`BatchingDesignService` whose chunk dispatch assembles via
    :class:`_StagedAssembler` — bit-identical replies, one host-to-device
    copy per dtype a chunk instead of one stack per leaf.  Also routes
    *singleton* batchable chunks through the staged dispatcher
    (``_coalesce_min = 1``): a lone query costs one staging pass instead of
    the stacked path.  This is the service a pool worker process runs."""

    _coalesce_min = 1

    def __init__(self, architecture="base", *, policy=None, **kw):
        super().__init__(architecture, policy=policy, **kw)
        self._assembler = _StagedAssembler(self.request_bucket, self.session.device)

    def _dispatch_chunk(self, adms: list) -> list:
        """The calls ``Session.simulate_batch`` / ``explain_batch`` make,
        on staged inputs: the same programs, the same report and
        attribution code."""
        kind = adms[0].q.kind
        sess = self.session
        ws = [a.w for a in adms]
        archs = [a.arch for a in adms]
        bucket, spec = ws[0].bucket, archs[0].spec
        staged = self._assembler.stage(ws, archs)
        prog = sess._batched_report_program(self.request_bucket, bucket, spec, sess.mcfg)
        perfs, extras = prog(*staged)
        reports = sess._reports_from_batch(ws, archs, perfs, extras)
        if kind == "simulate":
            return reports
        objective = adms[0].q.objective
        eprog = sess._batched_explain_program(self.request_bucket, bucket, spec, sess.mcfg, objective)
        g_techs, g_archs = eprog(*staged)
        return sess._attribute_batch(reports, g_techs, g_archs, objective)


# --------------------------------------------------------------------------- #
# threaded pool: dispatcher thread + bounded worker pool
# --------------------------------------------------------------------------- #


class PooledDesignService(StagedBatchingService):
    """Async serving over one process: a dispatcher thread drains the
    intake queue per the flush policy and hands each planned chunk to a
    bounded thread pool, so one chunk's host assembly and report
    construction overlap another's device work.

    * :meth:`enqueue` is non-blocking and returns a **ticket**; replies
      scatter into an internal map as chunks complete.
    * :meth:`serve` keeps the synchronous contract — enqueue all, barrier
      on :meth:`join`, return replies in query order.
    * :meth:`join` forces a drain of sub-policy stragglers and blocks until
      every enqueued query has a reply.
    * Guard-stack semantics are unchanged: every query runs
      ``_complete`` individually (retry / deadline / chaos / breaker /
      non-finite checks), chunk-locally memoized exactly like the
      synchronous flush.  Bookkeeping races are closed by the service
      mutex; the engine call runs outside any lock.
    * The threads share one session (its program cache is lock-guarded)
      and launch on the current stream.

    One caveat inherited from concurrency: ``DesignReply.compiled`` (and
    the straggler monitor's cold-reprime) keys on a service-wide build
    counter — the port counts builds, not traces — so with several chunks
    *building* simultaneously a query can be labelled compiled because its
    neighbor built.  Preheated fleets — the deployment this tier exists
    for — build nothing on the query path, where the label is exact.
    """

    def __init__(self, architecture="base", *, workers: int = 2, policy=None,
                 poll_s: Optional[float] = None, **kw):
        super().__init__(architecture, policy=policy, **kw)
        self.workers = max(1, int(workers))
        self._ticket = itertools.count()
        self._cond = threading.Condition()
        self._pending = 0
        self._results: dict[int, DesignReply] = {}
        self._stop = threading.Event()
        self._wake = threading.Event()
        self._drain_now = False
        self._poll_s = poll_s if poll_s is not None else max(self.policy.max_delay_s, 0.001)
        self._exec = ThreadPoolExecutor(
            max_workers=self.workers, thread_name_prefix="dragon-pool"
        )
        self._dispatcher = threading.Thread(
            target=self._dispatch_loop, name="dragon-dispatcher", daemon=True
        )
        self._dispatcher.start()

    # ------------------------------------------------------------- intake --
    def enqueue(self, q: DesignQuery) -> int:
        """Queue one query, non-blocking; returns a ticket for
        :meth:`take`.  (The synchronous parent returns flushed replies
        here — the async tier never blocks intake on a flush.)"""
        if self._stop.is_set():
            raise RuntimeError("PooledDesignService is closed")
        ticket = next(self._ticket)
        with self._cond:
            self._pending += 1
        self._queue.push((ticket, q))
        if self._queue.due(self.policy):
            self._wake.set()
        return ticket

    def pump(self) -> list:
        return []  # the dispatcher thread owns flushing

    def submit(self, q: DesignQuery) -> DesignReply:
        return self.serve([q])[0]

    def serve(self, queries: list[DesignQuery]) -> list[DesignReply]:
        tickets = [self.enqueue(q) for q in queries]
        self.join()
        return [self.take(t) for t in tickets]

    def flush(self) -> list:
        """Force-drain; returns [] (replies arrive via tickets)."""
        self.join()
        return []

    # ------------------------------------------------------------ results --
    def take(self, ticket: int) -> Optional[DesignReply]:
        """Pop the reply for a ticket (None if not finished yet)."""
        with self._cond:
            return self._results.pop(ticket, None)

    def join(self, timeout: Optional[float] = None) -> bool:
        """Force a drain and block until every enqueued query has a reply.
        Returns False on timeout."""
        self._drain_now = True
        self._wake.set()
        with self._cond:
            return self._cond.wait_for(lambda: self._pending == 0, timeout=timeout)

    def close(self) -> None:
        """Drain, then stop the dispatcher and the worker pool."""
        if self._stop.is_set():
            return
        self.join()
        self._stop.set()
        self._wake.set()
        self._dispatcher.join(timeout=10)
        self._exec.shutdown(wait=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # --------------------------------------------------------- dispatcher --
    def _dispatch_loop(self) -> None:
        while True:
            self._wake.wait(self._poll_s)
            self._wake.clear()
            drain = self._drain_now
            self._drain_now = False
            if drain or self._queue.due(self.policy):
                items = self._queue.drain()
                if items:
                    self._process(items)
            if self._stop.is_set() and not len(self._queue):
                return

    def _process(self, items: list) -> None:
        """Intake + plan one drained batch, then fan chunks out to the
        pool.  Mirrors the synchronous ``flush`` accounting exactly."""
        admitted: list = []
        ticket_of: dict[int, int] = {}
        for i, (t_enq, (ticket, q)) in enumerate(items):
            ticket_of[i] = ticket
            try:
                prep = self._prepare(q)
            except Exception as e:
                prep = self._last_ditch(q, e)
            if isinstance(prep, DesignReply):
                self._finish(ticket, prep)
            else:
                prep.t0 = t_enq  # wall time includes the queue wait
                admitted.append((i, prep))
        for chunk in plan_chunks(admitted, self.policy.max_batch):
            handler_of: dict = {}
            if len(chunk) >= self._coalesce_min and batch_key(chunk[0][1]) is not None:
                handler_of = make_chunk_handlers(chunk, self._dispatch_chunk)
                if len(chunk) > 1:
                    with self._mutex:
                        self._batches += 1
                        self._batched_queries += len(chunk)
            try:
                self._exec.submit(self._run_chunk, chunk, handler_of, ticket_of)
            except RuntimeError:  # pool shut down mid-close: finish inline
                self._run_chunk(chunk, handler_of, ticket_of)

    def _run_chunk(self, chunk: list, handler_of: dict, ticket_of: dict) -> None:
        n = len(chunk)
        for i, adm in chunk:
            try:
                reply = self._complete(
                    adm, handler_of.get(i),
                    batched=n > 1 and i in handler_of,
                    batch_size=n if i in handler_of else 1,
                )
            except Exception as e:
                reply = self._last_ditch(adm.q, e)
            self._finish(ticket_of[i], reply)

    def _finish(self, ticket: int, reply: DesignReply) -> None:
        self._account(reply)
        with self._cond:
            self._results[ticket] = reply
            self.replies.append(reply)
            self._pending -= 1
            self._cond.notify_all()


# --------------------------------------------------------------------------- #
# multi-process coordinator
# --------------------------------------------------------------------------- #


@dataclass
class _Worker:
    """Coordinator-side state for one worker process."""

    wid: int
    proc: Optional[subprocess.Popen] = None
    conn: Optional[socket.socket] = None
    last_seen: float = 0.0
    ready: bool = False
    alive: bool = True
    inflight: dict = field(default_factory=dict)  # chunk id -> [(ticket, query)]
    stats: Optional[ServiceStats] = None
    disk_loaded: int = 0  # programs its session rehydrated from cache_dir
    kernels_built: tuple = ()  # kernel libraries it compiled rather than loaded


_EMPTY_STATS = ServiceStats(
    programs=0, hits=0, misses=0, traces=0, queries=0, ok=0, retries=0,
    deadline_misses=0, degraded=0, errors={}, stragglers=(), breakers={},
)


class MultiProcessDesignService:
    """N worker processes draining design queries from one coordinator.

    Each worker is a :class:`StagedBatchingService` over
    ``Session(cache_dir=...)`` against the **shared** cache directory, on
    the coordinator's ``device`` (the card unless the caller names another;
    each worker opens it itself), so a preheated directory gives every
    worker spin-up without a build after ``ready`` and bit-identical
    programs.  The coordinator is deliberately engine-free: it resolves
    queries only far enough to group them by batch key (a resolver
    ``Session`` on the same device that never dispatches), shards full
    chunks to the least-loaded live worker over the frame protocol, and
    scatters replies back by ticket.  A query's ``Workload`` object crosses
    the socket pickled; its tensors restore on the worker's device.

    Fault containment extends the guard stack across the process boundary:

    * **heartbeats** — workers beacon every ``heartbeat_s`` from a daemon
      thread; silence beyond ``worker_timeout_s`` marks the worker dead
      (hung processes count as dead, not just exited ones);
    * **crash detection** — process exit, socket EOF and framing errors
      all route to the same death path;
    * **requeue** — a dead worker's in-flight, unanswered queries re-enter
      the intake queue and are re-planned onto surviving workers; replies
      are deduplicated by ticket (first answer wins), so a worker killed
      *after* replying costs nothing;
    * **worker-kill chaos** — with ``chaos=ChaosConfig(p_worker_kill=...)``
      the coordinator SIGKILLs the assigned worker of each marked qid
      (once per qid, deterministically seeded like every other fault) and
      the requeue path must restore availability.

    ``stats`` merges the latest per-worker :class:`ServiceStats` (workers
    piggyback a snapshot on every reply frame, so even a crashed worker's
    ledger survives to its last answered chunk); ``pool_info`` carries the
    coordinator's own counters (kills, requeues, worker liveness, programs
    the workers rehydrated).
    """

    def __init__(self, architecture: str = "base", *, workers: int = 2,
                 cache_dir=None, policy: Optional[FlushPolicy] = None,
                 retry=None, deadlines=None, chaos: Optional[ChaosConfig] = None,
                 request_bucket: Optional[int] = None,
                 heartbeat_s: float = 0.25, worker_timeout_s: float = 10.0,
                 ready_timeout_s: float = 600.0, max_inflight_chunks: int = 2,
                 warm: Optional[list] = None, objectives: tuple = ("edp",),
                 kinds: tuple = ("simulate", "explain"),
                 worker_cmd: Optional[list] = None, device=None):
        if cache_dir is None:
            raise ValueError(
                "multi-process serving requires cache_dir= (the shared AotCache "
                "directory workers rehydrate their programs from)"
            )
        if not isinstance(architecture, str):
            raise TypeError(
                "MultiProcessDesignService takes the architecture as a library "
                "name or .dhd text (it must cross a process boundary)"
            )
        self.architecture = architecture
        self.device = runtime.resolve_device(device)
        self.workers = max(1, int(workers))
        self.cache_dir = str(cache_dir)
        self.policy = policy or FlushPolicy()
        self.retry = retry
        self.deadlines = deadlines
        self.chaos_config = chaos
        self.request_bucket = int(request_bucket or self.policy.max_batch)
        self.heartbeat_s = float(heartbeat_s)
        self.worker_timeout_s = float(worker_timeout_s)
        self.ready_timeout_s = float(ready_timeout_s)
        self.max_inflight_chunks = max(1, int(max_inflight_chunks))
        self.warm = list(warm) if warm else None
        self.objectives = tuple(objectives)
        self.kinds = tuple(kinds)
        self.worker_cmd = list(worker_cmd) if worker_cmd else None
        # plan() only — the coordinator never injects attempt faults itself
        self._chaos_planner = ChaosInjector(chaos) if chaos is not None else None
        self.kills = 0
        self.requeues = 0
        self._killed: set[int] = set()
        self._queue = IntakeQueue()
        self._backlog: deque = deque()  # planned chunks awaiting a worker slot
        self._ticket = itertools.count()
        self._cid = itertools.count()
        self._cond = threading.Condition()
        self._pending = 0
        self._results: dict[int, DesignReply] = {}
        self._resolved: set[int] = set()
        self.replies: list[DesignReply] = []
        self._workers: dict[int, _Worker] = {}
        self._resolver = None  # lazy Session for batch-key grouping
        self._stop = threading.Event()
        self._drain_now = False
        self._started = False
        self._closed = False
        self._dir: Optional[str] = None
        self._listener: Optional[socket.socket] = None
        self._loop_thread: Optional[threading.Thread] = None

    # -------------------------------------------------------------- start --
    def start(self) -> "MultiProcessDesignService":
        """Spawn workers, handshake, wait until all are warmed and taking
        traffic, then start the coordinator loop.  A worker that exits or
        misbehaves before ``ready`` fails the start, and every worker
        spawned so far is stopped."""
        if self._started:
            return self
        try:
            self._spawn_and_handshake()
        except BaseException:
            self._reap(kill=True)
            raise
        self._started = True
        self._loop_thread = threading.Thread(
            target=self._loop, name="dragon-coordinator", daemon=True
        )
        self._loop_thread.start()
        return self

    def _spawn_and_handshake(self) -> None:
        import repro_torch

        self._dir = tempfile.mkdtemp(prefix="dragon-pool-")
        sock_path = os.path.join(self._dir, "pool.sock")
        self._listener = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._listener.bind(sock_path)
        self._listener.listen(self.workers)
        self._listener.settimeout(min(self.ready_timeout_s, 0.5))
        # the child must import repro_torch the same way we did, wherever
        # the parent was launched from
        env = dict(os.environ)
        src_root = os.path.dirname(os.path.dirname(os.path.abspath(repro_torch.__file__)))
        env["PYTHONPATH"] = src_root + os.pathsep + env.get("PYTHONPATH", "")
        base_cmd = self.worker_cmd or [sys.executable, "-m", "repro_torch.serving.worker"]
        for wid in range(self.workers):
            proc = subprocess.Popen(
                base_cmd + ["--socket", sock_path, "--id", str(wid)], env=env
            )
            self._workers[wid] = _Worker(wid=wid, proc=proc)
        cfg = dict(
            architecture=self.architecture, policy=self.policy,
            retry=self.retry, deadlines=self.deadlines,
            request_bucket=self.request_bucket, cache_dir=self.cache_dir,
            device=str(self.device),
            chaos=self.chaos_config, heartbeat_s=self.heartbeat_s,
            warm=self.warm, objectives=self.objectives, kinds=self.kinds,
        )
        deadline = time.monotonic() + self.ready_timeout_s
        for _ in range(self.workers):
            conn = self._accept(deadline)
            conn.settimeout(self.ready_timeout_s)
            tag, payload = protocol.recv_frame(conn)
            if tag != "hello":
                conn.close()
                raise protocol.ProtocolError(f"expected hello, got {tag!r}")
            w = self._workers[payload["worker"]]
            w.conn = conn
            w.last_seen = time.monotonic()
            protocol.send_frame(conn, "cfg", cfg)
        for w in self._workers.values():
            tag, payload = protocol.recv_frame(w.conn)
            while tag == "hb":  # beacons may precede readiness
                tag, payload = protocol.recv_frame(w.conn)
            if tag != "ready":
                raise protocol.ProtocolError(f"worker {w.wid}: expected ready, got {tag!r}")
            w.ready = True
            w.disk_loaded = int(payload.get("disk_loaded", 0))
            w.kernels_built = tuple(payload.get("kernels_built", ()))
            w.last_seen = time.monotonic()
            # liveness now rides on heartbeats; a blocking recv must not
            # stall the loop longer than one beacon interval
            w.conn.settimeout(self.worker_timeout_s)

    def _accept(self, deadline: float) -> socket.socket:
        """The next worker's connection; fails fast when a spawned worker
        exits before connecting instead of waiting out the ready timeout."""
        while True:
            try:
                conn, _addr = self._listener.accept()
                return conn
            except socket.timeout:
                for w in self._workers.values():
                    if w.conn is None and w.proc.poll() is not None:
                        raise protocol.ProtocolError(
                            f"worker {w.wid} exited with code {w.proc.returncode} before its handshake"
                        ) from None
                if time.monotonic() > deadline:
                    raise

    # ------------------------------------------------------------- intake --
    def enqueue(self, q: DesignQuery) -> int:
        if not self._started:
            self.start()
        if self._stop.is_set():
            raise RuntimeError("MultiProcessDesignService is closed")
        ticket = next(self._ticket)
        with self._cond:
            self._pending += 1
        self._queue.push((ticket, q))
        return ticket

    def serve(self, queries: list[DesignQuery]) -> list[DesignReply]:
        tickets = [self.enqueue(q) for q in queries]
        self.join()
        with self._cond:
            return [self._results.pop(t) for t in tickets]

    def take(self, ticket: int) -> Optional[DesignReply]:
        with self._cond:
            return self._results.pop(ticket, None)

    def join(self, timeout: Optional[float] = None) -> bool:
        self._drain_now = True
        with self._cond:
            return self._cond.wait_for(lambda: self._pending == 0, timeout=timeout)

    # ------------------------------------------------------------ results --
    @property
    def stats(self) -> ServiceStats:
        """The merged fleet ledger (latest snapshot per worker)."""
        per = [w.stats for w in self._workers.values() if w.stats is not None]
        if not per:
            return _EMPTY_STATS
        out = per[0]
        for s in per[1:]:
            out = out.merge(s)
        return out

    @property
    def pool_info(self) -> dict:
        """Coordinator-side counters: worker liveness, chaos kills, requeues,
        the programs the workers rehydrated at construction, and the kernel
        libraries they compiled instead of loading the parent's."""
        return dict(
            workers=self.workers,
            alive=sum(1 for w in self._workers.values() if w.alive),
            ready=sum(1 for w in self._workers.values() if w.ready),
            kills=self.kills,
            requeues=self.requeues,
            disk_loaded=sum(w.disk_loaded for w in self._workers.values()),
            kernels_built=sum(len(w.kernels_built) for w in self._workers.values()),
        )

    # ------------------------------------------------------------ shutdown --
    def close(self, timeout: float = 30.0) -> None:
        """Drain, stop the loop, collect final worker stats, reap."""
        if self._closed:
            return
        self._closed = True
        if self._started:
            self.join(timeout=timeout)
            self._stop.set()
            if self._loop_thread is not None:
                self._loop_thread.join(timeout=timeout)
            for w in self._workers.values():
                if not (w.alive and w.conn):
                    continue
                try:
                    protocol.send_frame(w.conn, "shutdown", None)
                    w.conn.settimeout(5.0)
                    tag, payload = protocol.recv_frame(w.conn)
                    while tag != "bye":
                        tag, payload = protocol.recv_frame(w.conn)
                    w.stats = payload
                except (OSError, protocol.ProtocolError):
                    continue  # worker left early; last piggybacked snapshot stands
        self._reap(kill=False)

    def _reap(self, *, kill: bool) -> None:
        """Close every connection, wait for (or kill) every worker process,
        and remove the socket directory."""
        for w in self._workers.values():
            if w.conn is not None:
                try:
                    w.conn.close()
                except OSError:
                    pass
            if w.proc is not None:
                if kill and w.proc.poll() is None:
                    w.proc.kill()
                try:
                    w.proc.wait(timeout=5)
                except subprocess.TimeoutExpired:
                    w.proc.kill()
                    w.proc.wait(timeout=5)
        if self._listener is not None:
            try:
                self._listener.close()
            except OSError:
                pass
        if self._dir is not None:
            shutil.rmtree(self._dir, ignore_errors=True)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.close()
        return False

    # ----------------------------------------------------------- the loop --
    def _loop(self) -> None:
        sel = selectors.DefaultSelector()
        for w in self._workers.values():
            if w.alive and w.conn is not None:
                sel.register(w.conn, selectors.EVENT_READ, w)
        poll_s = max(self.policy.max_delay_s, 0.002)
        try:
            while not self._stop.is_set():
                self._maybe_dispatch(sel)
                for key, _ev in sel.select(timeout=poll_s):
                    self._read_worker(key.data, sel)
                self._check_liveness(sel)
        finally:
            sel.close()

    def _maybe_dispatch(self, sel) -> None:
        drain = self._drain_now
        self._drain_now = False
        if drain or self._queue.due(self.policy):
            for chunk in self._plan(self._queue.drain()):
                self._backlog.append(chunk)
        self._pump(sel)

    def _pump(self, sel) -> None:
        """Backpressured assignment: at most ``max_inflight_chunks`` chunks
        outstanding per worker.  Blasting the whole backlog down the pipes
        deadlocks at scale — the coordinator blocks in ``sendall`` while
        every worker blocks sending a reply frame nobody is reading, the
        worker's heartbeat thread starves behind its send lock, and
        ``worker_timeout_s`` later the whole fleet reads as hung.  Bounding
        in-flight chunks keeps both socket directions shallow and caps how
        much a crashed worker can strand."""
        while self._backlog:
            live = [w for w in self._workers.values() if w.alive and w.ready]
            if live and min(len(w.inflight) for w in live) >= self.max_inflight_chunks:
                return  # every live worker saturated: resume on next reply
            self._assign(self._backlog.popleft(), sel)

    # ------------------------------------------------------------- planning --
    def _resolve_key(self, q: DesignQuery):
        """The batch key, via a resolver Session (on the service's device)
        that never dispatches.  Unresolvable queries group as singletons —
        the worker owns the actual quarantine (and emits the structured
        client-error reply)."""
        if q.kind not in ("simulate", "explain"):
            return None
        if self._resolver is None:
            from repro_torch.api import Session

            self._resolver = Session(self.architecture, device=self.device)
        try:
            w = self._resolver._workload(q.workload)
            a = self._resolver._arch(q.architecture)
        except Exception:
            return None
        return (q.kind, a.spec, w.bucket, q.objective if q.kind == "explain" else None)

    def _plan(self, items: list) -> list:
        """Group drained ``(t, (ticket, q))`` items into same-key chunks
        capped at the request bucket — ``plan_chunks`` over wire queries
        instead of admitted records."""
        chunks: list = []
        open_chunk: dict = {}
        for _t, (ticket, q) in items:
            key = self._resolve_key(q)
            if key is None:
                chunks.append([(ticket, q)])
                continue
            at = open_chunk.get(key)
            if at is None or len(chunks[at]) >= self.request_bucket:
                open_chunk[key] = len(chunks)
                chunks.append([(ticket, q)])
            else:
                chunks[at].append((ticket, q))
        return chunks

    # ----------------------------------------------------------- assignment --
    def _assign(self, chunk: list, sel) -> None:
        live = [w for w in self._workers.values() if w.alive and w.ready]
        if not live:
            for ticket, q in chunk:
                self._finish(ticket, self._no_worker_reply(q))
            return
        w = min(live, key=lambda h: len(h.inflight))
        cid = next(self._cid)
        w.inflight[cid] = chunk
        kill = False
        if self._chaos_planner is not None and len(live) >= 2:
            # enact a planned kill only while a survivor remains: the fault
            # models one process crashing out of a fleet, not the fleet
            # evaporating (a marked qid on the last live worker is skipped
            # permanently — the plan stays deterministic, enactment is
            # capacity-bounded)
            for _ticket, q in chunk:
                if q.qid not in self._killed and self._chaos_planner.plan(q.qid).worker_kill:
                    self._killed.add(q.qid)  # at most one kill per qid
                    kill = True
        try:
            protocol.send_frame(w.conn, "chunk", (cid, [q for _, q in chunk]))
        except (OSError, protocol.ProtocolError):
            self._dead(w, sel)  # requeues this chunk with the rest
            return
        if kill and w.proc is not None:
            # the seeded crash fault: SIGKILL the worker this chunk just
            # landed on, then take the death path immediately — the chunk
            # (and anything else unanswered) requeues onto survivors
            self.kills += 1
            self._chaos_planner._count("worker_kill")
            try:
                w.proc.kill()
            except OSError:
                pass
            self._dead(w, sel)

    def _no_worker_reply(self, q: DesignQuery) -> DesignReply:
        fault = TransientFault("no live workers (all worker processes died)")
        return DesignReply(
            qid=q.qid, kind=q.kind, wall_s=0.0, compiled=False, result=None,
            ok=False, error=FaultInfo(code=fault.code, message=str(fault),
                                      attempts=0, retryable=True),
            attempts=0, deadline_s=0.0,
        )

    # -------------------------------------------------------------- events --
    def _read_worker(self, w: _Worker, sel) -> None:
        try:
            tag, payload = protocol.recv_frame(w.conn)
        except (OSError, protocol.ProtocolError):
            self._dead(w, sel)
            return
        w.last_seen = time.monotonic()
        if tag == "hb":
            return
        if tag == "replies":
            cid, replies, stats = payload
            w.stats = stats
            chunk = w.inflight.pop(cid, None)
            if chunk is None:
                return  # chunk was already requeued (kill/reply race)
            if len(replies) == len(chunk):
                pairs = list(zip((t for t, _ in chunk), replies))
            else:  # defensive: match by qid if the worker reordered
                by_qid = {q.qid: t for t, q in chunk}
                pairs = [(by_qid.get(r.qid), r) for r in replies]
            for ticket, reply in pairs:
                if ticket is None:
                    continue
                self._finish(ticket, reply)
            self._pump(sel)  # a slot freed: hand this worker its next chunk
        elif tag == "bye":
            w.stats = payload

    def _finish(self, ticket: int, reply: DesignReply) -> None:
        with self._cond:
            if ticket in self._resolved:
                return  # duplicate answer after a requeue race: first wins
            self._resolved.add(ticket)
            self._results[ticket] = reply
            self.replies.append(reply)
            self._pending -= 1
            self._cond.notify_all()

    def _dead(self, w: _Worker, sel) -> None:
        """One death path for every detection mode: unregister, reap, and
        re-enqueue whatever the worker never answered."""
        if not w.alive:
            return
        w.alive = False
        w.ready = False
        try:
            sel.unregister(w.conn)
        except (KeyError, ValueError, OSError):
            pass
        try:
            w.conn.close()
        except OSError:
            pass
        if w.proc is not None and w.proc.poll() is None:
            try:
                w.proc.kill()
            except OSError:
                pass
        for _cid, chunk in w.inflight.items():
            for ticket, q in chunk:
                with self._cond:
                    done = ticket in self._resolved
                if done:
                    continue
                self.requeues += 1
                self._queue.push((ticket, q))
        w.inflight.clear()
        self._drain_now = True

    def _check_liveness(self, sel) -> None:
        now = time.monotonic()
        for w in list(self._workers.values()):
            if not w.alive:
                continue
            if w.proc is not None and w.proc.poll() is not None:
                self._dead(w, sel)
            elif now - w.last_seen > self.worker_timeout_s:
                self._dead(w, sel)  # hung counts as dead
