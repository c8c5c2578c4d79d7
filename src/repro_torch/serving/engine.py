"""Serving engines: continuous token batching + DRAGON design queries.

**Token engine** (:class:`Engine`): a free slot is prefilled with an
incoming prompt (the prefill cache is written into that slot's rows of the
engine's cache, in place), then joins the batched decode step; a finished
sequence (eos or max_tokens) frees its slot.  Per-slot cache lengths make
ragged decoding exact.

Prompts of the causal kv-cache families (dense, audio, moe, vlm) are
right-padded to a bucket (the next power of two, at least 8, at most
``max_len``) and prefilled with their true length: decode's length-masked
attention never reads a padded position.  The recurrent families (ssm,
hybrid) fold every prompt position into their state, so they prefill at the
exact length.  The vlm's vision tower is a stub: every request sees zero
patch embeddings, as in the reference.  An audio request's prompt is
``[S, ncb]`` and each step samples one token a codebook.  With ``mesh=`` (a
``DeviceMesh``) the weights, the cache and every step's tokens are laid out
on the mesh (``Model.specs``, ``Model.cache_specs``, ``batch_specs``) and
prefill and decode run there; a prefill's cache is written into each rank's
shard of its slot.

Sampling is greedy (argmax) or by temperature with Gumbel noise drawn from a
``torch.Generator`` seeded from (seed, rid, position): deterministic within
this package, and not the reference's ``jax.random`` stream.

**Design service** (:class:`DesignService`, :class:`BatchingDesignService`)
— the same serving pattern for hardware-simulation queries: many
simulate/explain/optimize requests answered against one program cache, via
the :class:`repro_torch.api.Session` façade.  Every query runs through the
resilience stack (:mod:`repro_torch.serving.resilience`); replies record
wall time and whether the query built anything, so a fleet operator can see
the cold/warm split that the cache-key semantics guarantee.
"""
from __future__ import annotations

import hashlib
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.kernels import runtime
from repro_torch.models.model import Model
from repro_torch.models.sharding import batch_spec, distribute, is_dtensor, repair_spec, shard_ranges
from repro_torch.serving.resilience import (
    CircuitBreaker,
    CircuitOpen,
    ClientError,
    DeadlineConfig,
    DeadlineExceeded,
    FaultInfo,
    RetryPolicy,
    classify_exception,
    run_guarded,
)


@dataclass
class Request:
    rid: int
    prompt: np.ndarray  # [S] or [S, ncb]
    max_tokens: int = 32
    temperature: float = 0.0
    eos: Optional[int] = None
    seed: int = 0
    # filled by the engine (host clock, seconds; prefill time is t_first - t_admit)
    generated: list = field(default_factory=list)
    done: bool = False
    t_submit: float = 0.0
    t_admit: float = 0.0
    t_first: float = 0.0
    t_done: float = 0.0


_MIN_PROMPT_BUCKET = 8


def _bucket_prompt(s: int) -> int:
    """Prompt-length bucket: next power of two, at least ``_MIN_PROMPT_BUCKET``."""
    return max(_MIN_PROMPT_BUCKET, 1 << (max(s, 1) - 1).bit_length())


def _stream_seed(*parts: int) -> int:
    digest = hashlib.blake2b(":".join(map(str, parts)).encode(), digest_size=8).digest()
    return int.from_bytes(digest, "little") & ((1 << 63) - 1)


class Engine:
    def __init__(self, model: Model, params: dict, *, slots: int = 4, max_len: int = 512, device=None, mesh=None):
        self.device = runtime.resolve_device(device)
        self.model = model
        self.mesh = mesh
        self.slots, self.max_len = slots, max_len
        # prompt bucketing is exact only for causal kv-cache families; the
        # recurrent ones keep exact-length prefill
        self._bucket_prompts = model.cache_dims()["kind"] in ("kv", "kv+x")
        # cast once here, not at every step
        self.params = model.precast(params)
        self.cache = model.init_cache(slots, max_len, device=self.device)
        if mesh is not None:
            from repro_torch.launch.specs import distribute_tree

            self.params = distribute_tree(self.params, mesh, model.specs(mesh))
            self.cache = distribute_tree(self.cache, mesh, model.cache_specs(mesh, slots, max_len))
        self.slot_req: list[Optional[Request]] = [None] * slots
        self.queue: list[Request] = []
        self.finished: list[Request] = []
        cfg = model.cfg
        self._next_tok = np.zeros((slots, 1, cfg.audio.n_codebooks) if cfg.audio else (slots, 1), np.int64)
        # the vision stub: zero patch embeddings for every request, as in the reference
        self._vision = (torch.zeros((1, cfg.vision.n_patches, cfg.vision.d_vision), device=self.device)
                        if cfg.vision else None)

    # ------------------------------------------------------------ intake --
    def submit(self, req: Request):
        req.t_submit = time.perf_counter()
        self.queue.append(req)

    # ------------------------------------------------------- cache plumb --
    def _write_slot(self, slot: int, src_cache: dict):
        """Copy one request's prefill cache (batch 1) into slot ``slot``, in place."""
        if self.mesh is not None:
            self._write_slot_sharded(slot, src_cache)
            return
        for k, dst in self.cache.items():
            if k == "len":
                dst[slot] = src_cache[k][0]
            else:  # [L, B, ...]
                dst[:, slot] = src_cache[k][:, 0]

    def _write_slot_sharded(self, slot: int, src_cache: dict):
        """:meth:`_write_slot` on a cache of DTensors: each rank copies, from
        the whole prefill cache, the part of slot ``slot`` that its shard holds."""
        for k, dst in self.cache.items():
            src = src_cache[k].full_tensor() if is_dtensor(src_cache[k]) else src_cache[k]
            bdim = 0 if k == "len" else 1
            ranges = shard_ranges(dst)
            lo, hi = ranges[bdim]
            if not lo <= slot < hi:
                continue
            at = [slice(a, b) for a, b in ranges]
            at[bdim] = 0
            local = [slice(None)] * dst.ndim
            local[bdim] = slot - lo
            dst.to_local()[tuple(local)] = src[tuple(at)]

    def _on_mesh(self, x: torch.Tensor) -> torch.Tensor:
        """A batch of tokens laid out over the mesh's batch axes (replicated
        where they do not divide it)."""
        if self.mesh is None:
            return x
        return distribute(x, self.mesh, repair_spec(batch_spec(self.mesh, x.ndim - 1), tuple(x.shape), self.mesh))

    @staticmethod
    def _host(x: torch.Tensor) -> np.ndarray:
        return (x.full_tensor() if is_dtensor(x) else x).cpu().numpy()

    # --------------------------------------------------------------- step --
    def step(self) -> bool:
        """One engine iteration: admit and prefill new requests, then one
        batched decode step for all active slots."""
        for slot in range(self.slots):
            if self.slot_req[slot] is None and self.queue:
                req = self.queue.pop(0)
                req.t_admit = time.perf_counter()
                logits, cache1 = self._prefill(np.asarray(req.prompt, np.int64))
                self._write_slot(slot, cache1)
                tok = self._sample(req, self._host(logits)[0])
                req.t_first = time.perf_counter()
                req.generated.append(tok)
                self._next_tok[slot] = np.reshape(tok, self._next_tok[slot].shape)
                self.slot_req[slot] = req
        active = [s for s in range(self.slots) if self.slot_req[s] is not None]
        if not active:
            return False
        # batched decode (inactive slots decode garbage into their own lane)
        tokens = self._on_mesh(torch.as_tensor(self._next_tok, device=self.device))
        logits, self.cache = self.model.decode_step(self.params, tokens, self.cache, mesh=self.mesh)
        logits = self._host(logits)
        for slot in active:
            req = self.slot_req[slot]
            tok = self._sample(req, logits[slot])
            req.generated.append(tok)
            self._next_tok[slot] = np.reshape(tok, self._next_tok[slot].shape)
            if len(req.generated) >= req.max_tokens or (req.eos is not None and np.all(np.asarray(tok) == req.eos)):
                req.done = True
                req.t_done = time.perf_counter()
                self.finished.append(req)
                self.slot_req[slot] = None
        return True

    def _prefill(self, prompt: np.ndarray):
        """One prompt ([S] or [S, ncb]) through the model's prefill, batch 1:
        right-padded to its bucket for the kv-cache families."""
        length = None
        if self._bucket_prompts:
            length = prompt.shape[0]
            sb = min(self.max_len, _bucket_prompt(length))
            if sb > length:
                prompt = np.pad(prompt, ((0, sb - length),) + ((0, 0),) * (prompt.ndim - 1))
        tokens = self._on_mesh(torch.as_tensor(prompt, device=self.device)[None])
        vision = self._vision if self._vision is None else self._on_mesh(self._vision)
        return self.model.prefill(self.params, tokens, max_len=self.max_len, vision=vision, mesh=self.mesh,
                                  length=length)

    def run(self, max_steps: int = 10_000):
        steps = 0
        while (self.queue or any(r is not None for r in self.slot_req)) and steps < max_steps:
            self.step()
            steps += 1
        return self.finished

    # ------------------------------------------------------------ sample --
    def _sample(self, req: Request, logits: np.ndarray):
        """logits: [V] float32, or [ncb, V] for audio.  Returns an int, or an
        int64 array [ncb] (one token a codebook)."""
        if req.temperature > 0.0:
            gen = torch.Generator().manual_seed(_stream_seed(req.seed, req.rid, len(req.generated)))
            gumbel = -torch.empty(logits.shape, dtype=torch.float64).exponential_(generator=gen).log()
            logits = logits / req.temperature + gumbel.numpy()
        tok = logits.argmax(-1)
        return int(tok) if tok.ndim == 0 else tok.astype(np.int64)


# --------------------------------------------------------------------------- #
# DRAGON design queries as a service (DSE-as-a-service, via the façade)
# --------------------------------------------------------------------------- #


@dataclass
class DesignQuery:
    """One design question: simulate / explain / optimize a workload set
    against an architecture, or sweep the Pareto ``frontier``.  ``workload``
    and ``architecture`` accept anything :class:`repro_torch.api.Workload` /
    :class:`repro_torch.api.Architecture` accept (names, ``.dhd`` text,
    graphs, trees); ``architecture=None`` uses the service default.  ``params``
    forwards engine knobs (``steps``, ``lr``, ``opt_over``, ...);
    ``deadline_s`` overrides the service's cold/warm budget for this query."""

    qid: int
    kind: str  # "simulate" | "explain" | "optimize" | "frontier"
    workload: Any
    architecture: Any = None
    objective: str = "edp"
    params: dict = field(default_factory=dict)
    deadline_s: Optional[float] = None
    tenant: Optional[str] = None  # None = the service's default session


@dataclass
class DesignReply:
    """Every submitted query gets exactly one reply — success or a typed,
    structured failure.  ``ok=True``: ``result`` holds the report and
    ``error`` is None.  ``ok=False``: ``result`` is None and ``error``
    carries the :class:`~repro_torch.serving.resilience.FaultInfo` (stable
    ``code``, human message, attempts made, whether the fault class is
    retryable).

    ``compiled`` means *this query caused a build*: a program-cache miss of
    one of the service's sessions, or a kernel library loaded into the
    process (``instrument`` tag ``runtime.build``).  The port runs eagerly
    and traces nothing, so a build is what a cold query pays; the name is
    the reference's."""

    qid: int
    kind: str
    wall_s: float  # total time in the service, retries and backoff included
    compiled: bool  # did answering build anything (a program, a kernel library)?
    result: Any  # SimReport | OptResult | FrontierResult, or None on error
    ok: bool = True
    error: Optional[FaultInfo] = None
    attempts: int = 1
    deadline_s: float = float("inf")  # the budget this query was held to
    straggler: bool = False  # flagged by the latency monitor (warm path only)
    batched: bool = False  # answered from a coalesced cross-request dispatch
    batch_size: int = 1  # queries sharing that dispatch (1 = sequential)


@dataclass(frozen=True)
class ServiceStats:
    """Cache counters (same fields :class:`repro_torch.api.CacheStats`
    exposes; ``traces`` counts builds) + the serving-health ledger."""

    programs: int
    hits: int
    misses: int
    traces: int
    queries: int
    ok: int
    retries: int  # extra attempts beyond the first, summed over queries
    deadline_misses: int
    degraded: int  # fast-failed by an open circuit breaker
    errors: dict  # fault code -> count
    stragglers: tuple  # (qid, wall_s) pairs flagged by the latency monitor
    breakers: dict  # (kind, bucket) -> breaker state snapshot
    batches: int = 0  # coalesced dispatches flushed (batching service only)
    batched_queries: int = 0  # queries answered from a coalesced dispatch
    tenants: int = 1  # sessions sharing this service's program cache

    @property
    def availability(self) -> float:
        """Fraction of queries answered ok within their deadline."""
        return self.ok / self.queries if self.queries else 1.0

    def merge(self, other: "ServiceStats") -> "ServiceStats":
        """Lossless aggregation of two workers' ledgers (the coordinator's
        fleet view).  Query counters, cache lookups and error codes sum;
        stragglers concatenate; breaker lanes merge key-wise (a lane is open
        fleet-wide if any worker's is; trips/rejections sum).  ``programs``
        and ``tenants`` sum *resident* programs/sessions — right for
        worker processes with private caches, an overcount when services
        share one programs dict (each reports the same residency).

        Partition-invariance — per-worker stats summed over any split of a
        query stream equal the sequential run's ledger — holds because every
        per-query outcome (chaos schedule, retry jitter, deadline class) is
        keyed on the query, never on worker identity or completion order;
        ``tests/test_torch_design_service.py`` pins it over a split stream.
        """
        errors = dict(self.errors)
        for code, n in other.errors.items():
            errors[code] = errors.get(code, 0) + n
        breakers = {k: dict(v) for k, v in self.breakers.items()}
        for key, st in other.breakers.items():
            if key in breakers:
                mine = breakers[key]
                breakers[key] = dict(
                    open=bool(mine["open"] or st["open"]),
                    failures=mine["failures"] + st["failures"],
                    trips=mine["trips"] + st["trips"],
                    rejected=mine["rejected"] + st["rejected"],
                )
            else:
                breakers[key] = dict(st)
        return ServiceStats(
            programs=self.programs + other.programs,
            hits=self.hits + other.hits, misses=self.misses + other.misses,
            traces=self.traces + other.traces,
            queries=self.queries + other.queries, ok=self.ok + other.ok,
            retries=self.retries + other.retries,
            deadline_misses=self.deadline_misses + other.deadline_misses,
            degraded=self.degraded + other.degraded,
            errors=errors, stragglers=self.stragglers + other.stragglers,
            breakers=breakers,
            batches=self.batches + other.batches,
            batched_queries=self.batched_queries + other.batched_queries,
            tenants=self.tenants + other.tenants,
        )

    def __add__(self, other: "ServiceStats") -> "ServiceStats":
        return self.merge(other)


@dataclass
class _Admitted:
    """A query that cleared intake: resolved inputs + the guard parameters
    :meth:`DesignService._complete` needs.  The seam between sequential
    answering and the batching layer's coalesced dispatch."""

    q: DesignQuery
    t0: float
    w: Any  # resolved Workload
    arch: Any  # resolved Architecture
    sess: Any  # the tenant's Session
    bkey: tuple  # circuit-breaker lane (kind, bucket)
    shape: tuple  # warmth key (kind, spec, bucket, objective)
    deadline: float


class DesignService:
    """Answer many design queries against one program cache, fault-contained.

    The hardware-simulation twin of the token :class:`Engine`: a
    :class:`repro_torch.api.Session` owns the program cache, so the steady
    state — repeated queries over same-bucket workloads — replays built
    programs and the service runs as fast as the hardware allows.  This is
    the seam async batching / multi-tenant serving / remote workers plug
    into.  ``device`` (the card unless the caller names another) goes to
    the service's sessions.

    Every query runs through the resilience stack:

    * **isolation** — :meth:`submit` never raises; a batch always completes
      with one :class:`DesignReply` per query;
    * **intake quarantine** — unparseable ``.dhd``, non-finite graph
      tensors, empty workload sets and unknown kinds become structured
      ``client-error`` replies before any engine runs;
    * **deadlines** — per-query wall budgets, cold vs warm
      (:class:`DeadlineConfig`), predicted from whether this
      (kind, spec, bucket, objective) shape has been served before;
    * **bounded retry** — transient/numeric faults retry with deterministic
      backoff while budget remains (:class:`RetryPolicy`);
    * **non-finite containment** — results with NaN/inf headline fields are
      typed ``numeric`` faults, never shipped;
    * **circuit breaker** — repeated failures on one (kind, bucket) trip to
      fast-fail replies until a cooldown (:class:`CircuitBreaker`);
    * **latency tracking** — per-query wall times feed a
      :class:`repro_torch.ft.straggler.StragglerMonitor`; cold builds re-prime
      its EWMA (their cost is expected), warm outliers are flagged on the
      reply and in :attr:`stats`.

    ``chaos`` accepts a :class:`repro_torch.serving.chaos.ChaosInjector` —
    the seeded fault harness ``chip_smoke.py``'s chaos gates drive.  ``clock``/``sleep``
    are injectable for deterministic tests.
    """

    _KINDS = ("simulate", "explain", "optimize", "frontier")

    def __init__(self, architecture="base", *, retry: Optional[RetryPolicy] = None,
                 deadlines: Optional[DeadlineConfig] = None,
                 breaker: Optional[CircuitBreaker] = None, chaos=None,
                 monitor=None, clock=time.monotonic, sleep=time.sleep,
                 request_bucket: int = 8, device=None, **session_kw):
        from repro_torch.api import Session
        from repro_torch.ft.straggler import StragglerMonitor

        session_kw["device"] = device
        self.session = Session(architecture, **session_kw)
        self._default_architecture = architecture
        self._session_kw = dict(session_kw)
        self._session_kw.pop("programs", None)
        # tenants share the default session's programs dict, which already
        # holds everything cache_dir rehydrated — reloading per tenant would
        # only burn construction time
        self._session_kw.pop("cache_dir", None)
        # every serving dispatch — sequential or coalesced — pads its request
        # axis to this one bucket, so ONE program serves every batch size and
        # replies are bit-identical however queries were batched (reduction
        # order may follow the shape; two request buckets can differ in the
        # last ulp)
        self.request_bucket = int(request_bucket)
        # tenant name -> Session; all share self.session's programs,
        # each keeps its own stats/workload memos (per-tenant isolation)
        self._tenants: dict = {}
        self.retry = retry or RetryPolicy()
        self.deadlines = deadlines or DeadlineConfig()
        self.breaker = breaker or CircuitBreaker(clock=clock)
        self.chaos = chaos
        self.monitor = monitor or StragglerMonitor()
        self._clock = clock
        self._sleep = sleep
        # guards shared mutable state (ledger, breaker, monitor, warmth) when
        # the pooled service completes queries from several threads; the
        # engine dispatch itself runs OUTSIDE this lock so chunks overlap
        self._mutex = threading.RLock()
        self._warm: set = set()  # (kind, spec, bucket, objective) shapes served
        self.replies: list[DesignReply] = []
        self._queries = 0
        self._ok = 0
        self._retries = 0
        self._deadline_misses = 0
        self._degraded = 0
        self._errors: dict = {}
        self._batches = 0
        self._batched_queries = 0

    # ------------------------------------------------------------ tenants --
    def _session_for(self, tenant: Optional[str]):
        """The tenant's own :class:`~repro_torch.api.Session` over the shared
        program cache — a program any tenant builds is warm for every other,
        but stats and memos never leak across tenants."""
        if tenant is None:
            return self.session
        with self._mutex:
            sess = self._tenants.get(tenant)
            if sess is None:
                from repro_torch.api import Session

                sess = self._tenants[tenant] = Session(
                    self._default_architecture,
                    programs=self.session.programs,
                    **self._session_kw,
                )
            return sess

    def _sessions(self):
        return [self.session, *self._tenants.values()]

    # ------------------------------------------------------------- warmup --
    def warmup(self, workloads, *, objectives: tuple[str, ...] = ("edp",),
               kinds: tuple[str, ...] = ("simulate", "explain")) -> dict:
        """Preheat the service's declared working set at startup.

        Builds the exact batched programs :meth:`submit` dispatches — pinned
        to this service's ``request_bucket`` — plus the sequential variants,
        runs each once, and persists their keys when the service was
        constructed with ``cache_dir=...``.  A worker that calls ``warmup``
        before taking traffic serves every declared shape with zero builds
        and the *warm* deadline from its first query; a restarted worker gets
        the same guarantee from the disk records alone.  Returns the
        :meth:`repro_torch.api.Session.preheat` summary dict.
        """
        return self.session.preheat(
            workloads, objectives=objectives, kinds=kinds,
            request_buckets=(self.request_bucket,),
        )

    def _preheated(self, kind: str, spec, bucket, objective: str) -> bool:
        """Preheated warmth: True when every program ``kind`` dispatches for
        this shape is already in the shared cache (built, preheated or
        rehydrated from ``cache_dir``), so the first serve pays dispatch
        only.  optimize/frontier run the engines directly — preheat can't see
        those, so they are never preheated-warm."""
        programs = self.session.programs
        mcfg = self.session.mcfg
        rb = self.request_bucket
        if kind == "simulate":
            return ("report_batched", spec, mcfg, bucket, rb) in programs
        if kind == "explain":
            return (
                ("report_batched", spec, mcfg, bucket, rb) in programs
                and ("explain_batched", spec, mcfg, bucket, objective, rb) in programs
            )
        return False

    # ------------------------------------------------------------- intake --
    def submit(self, q: DesignQuery) -> DesignReply:
        """Answer one query.  Never raises: every failure mode — bad input,
        engine exception, non-finite result, blown deadline, open breaker —
        degrades to a structured ``ok=False`` reply."""
        try:
            reply = self._answer(q)
        except Exception as e:
            reply = self._last_ditch(q, e)
        self._account(reply)
        self.replies.append(reply)
        return reply

    def serve(self, queries: list[DesignQuery]) -> list[DesignReply]:
        """Answer a batch.  Per-query isolation means the batch always
        completes: len(replies) == len(queries), in order, no exceptions."""
        return [self.submit(q) for q in queries]

    # ------------------------------------------------------------- answer --
    def _answer(self, q: DesignQuery) -> DesignReply:
        adm = self._prepare(q)
        if isinstance(adm, DesignReply):
            return adm
        return self._complete(adm)

    def _prepare(self, q: DesignQuery):
        """Intake: validate, resolve, consult the breaker and predict the
        deadline.  Returns a refusal :class:`DesignReply`, or an
        :class:`_Admitted` record ready for :meth:`_complete` — the batching
        layer runs intake for a whole flush before any engine work, so a
        poison query is quarantined before it can join a batch."""
        t0 = self._clock()
        if q.kind not in self._KINDS:
            return self._refuse(q, t0, ClientError(
                f"unknown DesignQuery.kind {q.kind!r} (expected one of {list(self._KINDS)})"
            ))
        # intake quarantine: resolve + validate inputs before any engine work
        # (Workload/Architecture reject non-finite tensors, empty sets and
        # malformed .dhd at construction)
        sess = self._session_for(q.tenant)
        try:
            w = sess._workload(q.workload)
            arch = sess._arch(q.architecture)
        except Exception as e:
            return self._refuse(q, t0, ClientError(
                f"poison query quarantined at intake: {type(e).__name__}: {e}"
            ))
        bkey = (q.kind, w.bucket)
        if not self.breaker.allow(bkey):
            return self._refuse(q, t0, CircuitOpen(
                f"circuit open for kind={q.kind!r} bucket={w.bucket} "
                f"(cooldown {self.breaker.cooldown_s:.1f}s)"
            ))
        shape = (q.kind, arch.spec, w.bucket, q.objective)
        # a shape is warm if it was served before (the warmth ledger) OR if
        # its programs were preheated / rehydrated from the persistent
        # cache — a restarted worker must predict warm deadlines from its
        # first query, not after re-learning every shape the hard way
        cold = shape not in self._warm and not self._preheated(
            q.kind, arch.spec, w.bucket, q.objective
        )
        deadline = q.deadline_s if q.deadline_s is not None else \
            self.deadlines.budget_s(cold, q.kind)
        return _Admitted(q=q, t0=t0, w=w, arch=arch, sess=sess, bkey=bkey,
                         shape=shape, deadline=deadline)

    def _complete(self, adm: "_Admitted", handler: Optional[Callable[[], Any]] = None,
                  *, batched: bool = False, batch_size: int = 1) -> DesignReply:
        """Run one admitted query through the guard stack.  ``handler``
        overrides the sequential engine call — the batching layer passes a
        closure that reads this query's lane of a coalesced dispatch."""
        q = adm.q
        if handler is None:
            handler = self._handler(q, adm.w, adm.arch, adm.sess)
        if self.chaos is not None:
            chaos, qid = self.chaos, q.qid

            def fn(attempt):
                return chaos.call(handler, qid=qid, attempt=attempt)
        else:
            def fn(attempt):
                return handler()
        traces0 = self._traces()
        out = run_guarded(fn, policy=self.retry, deadline_s=adm.deadline, token=q.qid,
                          clock=self._clock, sleep=self._sleep)
        compiled = self._traces() > traces0
        with self._mutex:
            if out.ok or compiled:
                # warm = the program is cached.  A query that failed before
                # anything was built leaves the shape cold — the next query
                # of that shape still faces the build and must get the cold
                # deadline, not the warm one.
                self._warm.add(adm.shape)
            # client errors don't indict the server; everything else votes
            if out.ok or out.fault.code != ClientError.code:
                self.breaker.record(adm.bkey, out.ok)
            straggler = False
            if out.ok:
                if compiled:
                    # a cold build is *expected* to be slow: reset the
                    # latency baseline instead of polluting the EWMA /
                    # flagging it
                    self.monitor.reprime(out.wall_s)
                else:
                    straggler = bool(self.monitor.record(q.qid, out.wall_s))
        return DesignReply(
            qid=q.qid, kind=q.kind, wall_s=self._clock() - adm.t0, compiled=compiled,
            result=out.result, ok=out.ok, error=out.fault,
            attempts=max(out.attempts, 1), deadline_s=adm.deadline,
            straggler=straggler, batched=batched, batch_size=batch_size,
        )

    def _handler(self, q: DesignQuery, w, arch, sess) -> Callable[[], Any]:
        rb = self.request_bucket
        return {
            "simulate": lambda: sess.simulate_batch(
                [w], architectures=[arch], request_bucket=rb
            )[0],
            "explain": lambda: sess.explain_batch(
                [w], objective=q.objective, architectures=[arch], request_bucket=rb
            )[0],
            "optimize": lambda: sess.optimize(
                w, objective=q.objective, architecture=arch, **q.params
            ),
            "frontier": lambda: sess.frontier(w, **q.params),
        }[q.kind]

    def _refuse(self, q: DesignQuery, t0: float, fault) -> DesignReply:
        """A structured no-attempt reply (quarantine / open breaker)."""
        return DesignReply(
            qid=q.qid, kind=q.kind, wall_s=self._clock() - t0, compiled=False,
            result=None, ok=False,
            error=FaultInfo(code=fault.code, message=str(fault), attempts=0,
                            retryable=fault.retryable),
            attempts=0, deadline_s=0.0,
        )

    # ----------------------------------------------------------- plumbing --
    def _account(self, r: DesignReply) -> None:
        with self._mutex:
            self._queries += 1
            self._retries += max(0, r.attempts - 1)
            if r.ok:
                self._ok += 1
                return
            code = r.error.code if r.error else "fault"
            self._errors[code] = self._errors.get(code, 0) + 1
            if code == DeadlineExceeded.code:
                self._deadline_misses += 1
            elif code == CircuitOpen.code:
                self._degraded += 1

    def _last_ditch(self, q, e: Exception) -> DesignReply:
        """Isolation of last resort: a bug in the guard stack itself must
        still cost only this one query."""
        fault = classify_exception(e)
        return DesignReply(
            qid=getattr(q, "qid", -1), kind=getattr(q, "kind", "?"),
            wall_s=0.0, compiled=False, result=None, ok=False,
            error=FaultInfo(code=fault.code, message=str(fault),
                            attempts=1, retryable=fault.retryable),
            attempts=1, deadline_s=0.0,
        )

    def _traces(self) -> int:
        """Builds attributable to this service: every tenant Session's
        program builds plus the kernel libraries loaded into the process
        (``runtime.build``; a query that made the process load one was
        cold).  Scoped (not the global counter) so a concurrent service
        building its own programs doesn't mislabel this one's warm queries
        as cold; only the library tag is shared.  The engines (DOpt, the
        population step) build nothing per configuration, so they have no
        tag of their own (the reference counts their traces here)."""
        from repro_torch.core import instrument

        return sum(s.stats.traces for s in self._sessions()) + instrument.trace_count(
            "runtime.build"
        )

    @property
    def stats(self) -> ServiceStats:
        per = [s.stats for s in self._sessions()]
        return ServiceStats(
            programs=per[0].programs,  # the cache is shared: one count
            hits=sum(s.hits for s in per), misses=sum(s.misses for s in per),
            traces=sum(s.traces for s in per),
            queries=self._queries, ok=self._ok, retries=self._retries,
            deadline_misses=self._deadline_misses, degraded=self._degraded,
            errors=dict(self._errors), stragglers=tuple(self.monitor.flagged),
            breakers=self.breaker.snapshot(),
            batches=self._batches, batched_queries=self._batched_queries,
            tenants=len(self._sessions()),
        )


class BatchingDesignService(DesignService):
    """:class:`DesignService` with cross-request batching.

    Queries enter an intake queue; a :class:`~repro_torch.serving.batching.FlushPolicy`
    flushes on batch size or queue age.  A flush runs intake quarantine for
    *every* query first (a poison query never joins a batch), groups the
    admitted simulate/explain queries by ``(kind, spec, bucket, objective)``,
    and answers each group with ONE dispatch over a request axis — the same
    program, padded to ``policy.max_batch``, that the
    sequential path uses, so coalesced replies are bit-identical to serving
    the same queries one at a time (pinned by test).

    Every query still runs through the full guard stack individually: the
    coalesced dispatch is lazily memoized inside the first lane's guarded
    attempt (see :func:`~repro_torch.serving.batching.make_chunk_handlers`),
    so retries, deadlines, chaos injection, breaker votes and non-finite
    containment all stay per-query — one bad query in a batch costs only
    that query.

    ``optimize``/``frontier`` queries pass through the flush as singleton
    chunks on the sequential path (their useful work is a whole descent;
    there is nothing to coalesce).
    """

    #: smallest batchable chunk routed through :meth:`_dispatch_chunk`;
    #: below it the sequential handler runs (a staged pool subclass may
    #: lower it to 1).
    _coalesce_min = 2

    def __init__(self, architecture="base", *, policy=None, **kw):
        from repro_torch.serving.batching import FlushPolicy, IntakeQueue

        self.policy = policy or FlushPolicy()
        # the flush cap doubles as the pinned request bucket: sequential and
        # coalesced dispatches share one program => bit-identical replies
        kw.setdefault("request_bucket", self.policy.max_batch)
        super().__init__(architecture, **kw)
        self._queue = IntakeQueue(clock=self._clock)

    # ------------------------------------------------------------- intake --
    def enqueue(self, q: DesignQuery) -> list[DesignReply]:
        """Queue one query; flush if the policy says a batch is due.
        Returns the replies flushed *now* (often empty — they arrive with a
        later flush).  Never raises."""
        self._queue.push(q)
        return self.pump()

    def pump(self) -> list[DesignReply]:
        """Flush if due (size or queue-age trigger); else no-op."""
        if self._queue.due(self.policy):
            return self.flush()
        return []

    def submit(self, q: DesignQuery) -> DesignReply:
        """Answer one query immediately (a flush of one — same program,
        same reply bits as arriving in a full batch)."""
        return self.serve([q])[0]

    def serve(self, queries: list[DesignQuery]) -> list[DesignReply]:
        """Answer a batch through the coalescing path.  Per-query isolation
        holds: len(replies) == len(queries), in order, no exceptions."""
        if len(self._queue):  # earlier enqueue()d strays answer separately
            self.flush()
        for q in queries:
            self._queue.push(q)
        return self.flush()

    # -------------------------------------------------------------- flush --
    def flush(self) -> list[DesignReply]:
        """Drain the queue and answer everything, coalescing same-shape
        queries into one dispatch per chunk.  Replies come back in arrival
        order; accounting matches :meth:`DesignService.submit` exactly."""
        from repro_torch.serving.batching import batch_key, make_chunk_handlers, plan_chunks

        items = self._queue.drain()
        if not items:
            return []
        replies: list = [None] * len(items)
        admitted: list = []
        for i, (t_enq, q) in enumerate(items):
            try:
                prep = self._prepare(q)
            except Exception as e:
                prep = self._last_ditch(q, e)
            if isinstance(prep, DesignReply):
                replies[i] = prep
            else:
                prep.t0 = t_enq  # wall time includes the queue wait
                admitted.append((i, prep))
        handler_of: dict = {}
        size_of: dict = {}
        for chunk in plan_chunks(admitted, self.policy.max_batch):
            if len(chunk) < self._coalesce_min or batch_key(chunk[0][1]) is None:
                continue  # nothing to coalesce; sequential handler
            handler_of.update(make_chunk_handlers(chunk, self._dispatch_chunk))
            for idx, _ in chunk:
                size_of[idx] = len(chunk)
            if len(chunk) > 1:  # a size-1 staged dispatch is not a coalesce
                self._batches += 1
                self._batched_queries += len(chunk)
        for i, adm in admitted:
            try:
                replies[i] = self._complete(
                    adm, handler_of.get(i),
                    batched=size_of.get(i, 1) > 1, batch_size=size_of.get(i, 1),
                )
            except Exception as e:
                replies[i] = self._last_ditch(adm.q, e)
        for r in replies:
            self._account(r)
            self.replies.append(r)
        return replies

    def _dispatch_chunk(self, adms: list) -> list:
        """ONE dispatch answering a whole same-key chunk.  Runs on the
        default session (programs are shared across tenants, parameter
        values are call arguments — per-lane results match each tenant's own
        sequential dispatch bit for bit)."""
        kind = adms[0].q.kind
        ws = [a.w for a in adms]
        archs = [a.arch for a in adms]
        if kind == "simulate":
            return self.session.simulate_batch(
                ws, architectures=archs, request_bucket=self.request_bucket
            )
        return self.session.explain_batch(
            ws, objective=adms[0].q.objective, architectures=archs,
            request_bucket=self.request_bucket,
        )
