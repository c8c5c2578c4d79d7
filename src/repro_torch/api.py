"""The DRAGON front door in PyTorch: one typed façade over DGen, DSim and DOpt.

The engines are free functions over trees of tensors — right for composing
PyTorch programs, wrong as a public surface: every caller re-implements the
same specialize → stack → simulate → optimize plumbing.  This module is the
served API instead:

    from repro_torch import Session, Architecture, Workload

    sess = Session(Architecture("edge"))            # .dhd text, library name,
    rep = sess.simulate(Workload("bert_base"))      #   or raw trees
    print(rep)                                      # explainable SimReport
    opt = sess.optimize("bert_base", objective="edp", steps=40)
    front = sess.frontier(["lstm", "bert_base"], population=12)

Everything runs on the session's device: the card unless the caller names
another (``Session(..., device="cpu")``).  Names resolve on that device; an
:class:`Architecture` or :class:`Workload` that lives on another device is
refused with a ``ValueError``, never moved.

Three types:

  * :class:`Workload` — a validated workload set.  Wraps one Graph, a list,
    or workload names; stacks them (``Graph.stack``) with the vertex axis
    padded to a shape *bucket* (next power of two, min 32) so different
    workload sets of similar size land on the same program.  Padding is
    exact — the mapper prices no-op vertices at zero.
  * :class:`Architecture` — a validated design point: ``.dhd`` text, a
    library name, a ``CompiledArch``, or raw ``(tech, arch, spec)`` trees —
    one constructor, ``CompiledArch`` underneath, ``to_dhd()`` back out.
  * :class:`Session` — owns the program cache and routes ``simulate()`` /
    ``optimize()`` / ``frontier()`` / ``explain()`` to the dsim / dopt /
    popsim / pareto engines, returning the frozen result objects from
    :mod:`repro_torch.core.report`.

Cache-key semantics (the serving contract)
------------------------------------------

Programs are keyed by ``(kind, ArchSpec, MapperCfg, shape bucket[,
objective][, request bucket])``.  The port runs eagerly, so a program is a
Python closure bound to its key, not a compiled artifact: building it does
the key's one-time work (the spec's device arrays), and each call runs the
engine functions (``simulate_stacked``, ``simulate_breakdown``,
``stacked_log_objective``) on the call's tensors.  A reply therefore equals
the engine call on the same stack and device bit for bit.  Parameter values,
objective weights and budgets are call arguments, so a changed design point
or mix reuses the program.

Warm calls never build: :attr:`Session.stats` reports programs / hits /
misses / builds (the ``traces`` field), counted by
:mod:`repro_torch.core.instrument`, where a build is counted where it
happens.

``Session(cache_dir=...)`` makes the cache persistent: :meth:`Session.preheat`
writes each program's key to disk (:mod:`repro_torch.serving.aotcache`), and
a new session on that directory rehydrates every program at construction, so
its first query of a preheated shape builds nothing.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
import re
import threading
import time

import numpy as np
import torch

from repro_torch import instrument
from repro_torch.core import dgen as _dgen
from repro_torch.core import dopt as _dopt
from repro_torch.core import popsim as _popsim
from repro_torch.core.dhdl import CompiledArch, load_arch, parse_arch, serialize_arch
from repro_torch.core.dopt import from_log, tech_param_names, to_log
from repro_torch.core.dsim import (
    PARETO_METRICS,
    PerfEstimate,
    simulate_breakdown,
    simulate_stacked,
    stacked_log_objective,
)
from repro_torch.core.graph import DATA_FIELDS, Graph
from repro_torch.core.mapper import MapperCfg
from repro_torch.core.params import COMP_CLS, MEM_CLS, ArchParams, ArchSpec, TechParams, stack_trees
from repro_torch.core.report import (
    Attribution,
    ComputeClassReport,
    FrontierPoint,
    FrontierResult,
    MemoryLevelReport,
    OptResult,
    SimReport,
    VertexReport,
    WorkloadReport,
)
from repro_torch.kernels.runtime import resolve_device
from repro_torch.workloads import get_workload

__all__ = [
    "Workload",
    "Architecture",
    "Session",
    "CacheStats",
    # result objects (re-exported from core.report)
    "SimReport",
    "OptResult",
    "FrontierResult",
    "Attribution",
    # engine types call sites legitimately need alongside the façade
    "Graph",
    "MapperCfg",
    "ArchParams",
    "ArchSpec",
    "TechParams",
    "PerfEstimate",
    "PARETO_METRICS",
    "get_workload",
]

_MIN_BUCKET = 32  # below this the mapper's auto dispatch flips impls; also
# keeps tiny-workload buckets from fragmenting the program cache

_MIN_REQUEST_BUCKET = 2  # batched dispatches pad the request axis to pow2;
# below 2 the sequential program is already the right shape


def _bucket_vertices(v: int) -> int:
    """Vertex-axis bucket: next power of two, at least ``_MIN_BUCKET``."""
    return max(_MIN_BUCKET, 1 << (max(v, 1) - 1).bit_length())


def _bucket_requests(n: int) -> int:
    """Request-axis bucket for batched dispatches: next power of two, at
    least ``_MIN_REQUEST_BUCKET`` — same convention as the vertex axis, so
    warm batches of similar size replay one program."""
    return max(_MIN_REQUEST_BUCKET, 1 << (max(n, 1) - 1).bit_length())


def _dhd_ident(name: str) -> str:
    """Sanitize a display name into a ``.dhd`` identifier, so every
    Architecture serializes to parseable text."""
    ident = re.sub(r"[^A-Za-z0-9_]", "_", name) or "anonymous"
    return ident if ident[0].isalpha() or ident[0] == "_" else f"_{ident}"


def _device(device=None) -> torch.device:
    """``resolve_device`` with a CUDA device's index made explicit, so that
    ``"cuda"`` and ``"cuda:0"`` compare equal."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _check_device(what: str, have: torch.device, want: torch.device) -> None:
    if _device(have) != want:
        raise ValueError(f"{what} lives on {have}, not on {want}; move it there first")


def _check_finite_positive(tree, what: str) -> None:
    a = tree.flatten().detach().cpu().numpy()  # one host copy for the tree
    if not np.all(np.isfinite(a)):
        raise ValueError(f"{what} contains non-finite values")
    if np.any(a <= 0):
        raise ValueError(f"{what} contains non-positive values (parameters are positive)")


# --------------------------------------------------------------------------- #
# Workload
# --------------------------------------------------------------------------- #

_CHECKED_FIELDS = ("n_comp", "n_read", "n_write", "n_alloc")


class Workload:
    """A validated, shape-bucketed workload set on one device.

    ``source`` may be a workload name (resolved via
    ``repro_torch.workloads.get_workload`` on ``device``), a :class:`Graph`,
    another ``Workload``, or a list mixing names and Graphs.  The set stacks
    into one ``[W, V_bucket, ...]`` Graph (:attr:`stacked`) with vertex
    padding to the shape bucket and the per-vertex names stripped, so any
    same-bucket set has the same shapes — that is what lets a
    :class:`Session` serve different workloads from one program.

    ``device`` is the card unless the caller names another; a Graph on
    another device is refused.  Construct once and reuse in hot loops:
    stacking and validation are host work.
    """

    def __init__(self, source, *, labels: tuple[str, ...] | None = None, device=None):
        self.device = _device(device)
        graphs, auto_labels = self._resolve(source, self.device)
        if not graphs:
            raise ValueError("Workload needs at least one graph")
        for lbl, g in zip(auto_labels, graphs):
            if not isinstance(g, Graph):
                raise TypeError(f"workload {lbl!r} is not a Graph (got {type(g).__name__})")
            _check_device(f"workload {lbl!r}", g.device, self.device)
            if g.n_vertices < 1:
                raise ValueError(f"workload {lbl!r} has no vertices")
            if g.n_comp.ndim != 2:
                raise ValueError(
                    f"workload {lbl!r} is already stacked ([W,V,...]); pass its member graphs"
                )
            parts = [getattr(g, f).detach().reshape(-1) for f in _CHECKED_FIELDS]
            host = torch.cat(parts).cpu().numpy()  # one host copy a graph
            for field, a in zip(_CHECKED_FIELDS, np.split(host, np.cumsum([p.numel() for p in parts])[:-1])):
                if not np.all(np.isfinite(a)) or np.any(a < 0):
                    raise ValueError(f"workload {lbl!r}.{field} must be finite and >= 0")
        self.graphs: tuple[Graph, ...] = tuple(graphs)
        self.labels: tuple[str, ...] = tuple(labels) if labels is not None else tuple(auto_labels)
        if len(self.labels) != len(self.graphs):
            raise ValueError(f"{len(self.labels)} labels for {len(self.graphs)} graphs")
        vmax = max(g.n_vertices for g in self.graphs)
        self._bucket = (len(self.graphs), _bucket_vertices(vmax))
        self._stacked: Graph | None = None

    @staticmethod
    def _resolve(source, device) -> tuple[list[Graph], list[str]]:
        if isinstance(source, Workload):
            return list(source.graphs), list(source.labels)
        if isinstance(source, (str, Graph)):
            source = [source]
        graphs, labels = [], []
        for i, item in enumerate(source):
            if isinstance(item, str):
                graphs.append(get_workload(item, device=device))
                labels.append(item)
            elif isinstance(item, Graph):
                graphs.append(item)
                labels.append(f"workload{i}")
            else:
                raise TypeError(f"cannot build a Workload from {type(item).__name__}")
        return graphs, labels

    @property
    def bucket(self) -> tuple[int, int]:
        """``(n_workloads, padded_vertex_count)`` — the cache-key shape."""
        return self._bucket

    @property
    def n_workloads(self) -> int:
        return len(self.graphs)

    @property
    def stacked(self) -> Graph:
        """The bucket-padded ``[W, V_bucket, ...]`` stack, names stripped."""
        if self._stacked is None:
            _, vb = self._bucket
            gs = Graph.stack([g.pad_to(vb) for g in self.graphs])
            self._stacked = dataclasses.replace(gs, names=())
        return self._stacked

    def __repr__(self) -> str:
        w, v = self._bucket
        return f"Workload({list(self.labels)!r}, bucket=[{w}, {v}])"


# --------------------------------------------------------------------------- #
# Architecture
# --------------------------------------------------------------------------- #


class Architecture:
    """A validated design point on one device — one constructor for every
    spelling.

    ``Architecture("edge")`` loads the named ``.dhd`` library design;
    ``Architecture("arch mine inherits edge { ... }")`` parses text (any
    source containing ``{`` is treated as text); ``Architecture(ca)`` wraps
    an existing :class:`CompiledArch`; ``Architecture(tech=..., arch=...,
    spec=...)`` builds one from raw trees (defaults fill the gaps).
    ``to_dhd()`` serializes back to canonical text — the suite's
    interchange format (parse → serialize → parse is the identity).  Names
    are sanitized to ``.dhd`` identifiers (``[A-Za-z_][A-Za-z0-9_]*``) so
    every Architecture's text form is guaranteed parseable.

    Text and names compile on ``device`` (the card unless the caller names
    another); given trees must already live there.
    """

    def __init__(
        self,
        source: "str | CompiledArch | Architecture | None" = None,
        *,
        tech: TechParams | None = None,
        arch: ArchParams | None = None,
        spec: ArchSpec | None = None,
        name: str | None = None,
        device=None,
    ):
        dev = _device(device)
        if isinstance(source, Architecture):
            ca = source._ca
        elif isinstance(source, CompiledArch):
            ca = source
        elif isinstance(source, str):
            ca = parse_arch(source, device=dev) if "{" in source else load_arch(source, device=dev)
        elif source is None:
            ca = CompiledArch(
                name=name or "custom",
                spec=spec if spec is not None else ArchSpec(),
                arch=arch if arch is not None else ArchParams.default(dev),
                tech=tech if tech is not None else TechParams.default(dev),
            )
        else:
            raise TypeError(f"cannot build an Architecture from {type(source).__name__}")
        if source is not None and (tech is not None or arch is not None or spec is not None):
            ca = CompiledArch(
                name=name or ca.name,
                spec=spec if spec is not None else ca.spec,
                arch=arch if arch is not None else ca.arch,
                tech=tech if tech is not None else ca.tech,
            )
        elif name is not None and name != ca.name:
            ca = CompiledArch(name=name, spec=ca.spec, arch=ca.arch, tech=ca.tech)
        ident = _dhd_ident(ca.name)
        if ident != ca.name:
            ca = CompiledArch(name=ident, spec=ca.spec, arch=ca.arch, tech=ca.tech)
        for what, tree in (("tech", ca.tech), ("arch", ca.arch)):
            for leaf in tree.leaves():
                _check_device(f"Architecture {ca.name!r} {what} params", leaf.device, dev)
        _check_finite_positive(ca.tech, f"Architecture {ca.name!r} tech params")
        _check_finite_positive(ca.arch, f"Architecture {ca.name!r} arch params")
        self._ca = ca
        self._device = dev

    @property
    def name(self) -> str:
        return self._ca.name

    @property
    def spec(self) -> ArchSpec:
        return self._ca.spec

    @property
    def arch(self) -> ArchParams:
        return self._ca.arch

    @property
    def tech(self) -> TechParams:
        return self._ca.tech

    @property
    def compiled(self) -> CompiledArch:
        return self._ca

    @property
    def device(self) -> torch.device:
        return self._device

    def to_dhd(self) -> str:
        """Canonical ``.dhd`` text of this design (round-trips bit-exactly)."""
        return serialize_arch(name=self.name, spec=self.spec, arch=self.arch, tech=self.tech)

    def peaks(self) -> dict:
        """Machine peaks of this design point — the roofline axes.

        Evaluates the hardware model (DGen ``specialize``) and returns
        ``peak_flops`` (FLOP/s summed over enabled compute classes at the
        timing-feasible clock), ``mem_bw`` (bytes/s per memory level, keyed
        by :data:`MEM_CLS` name) and ``frequency`` (Hz).  Host floats, from
        one copy to the host — this is reporting surface, not a program.
        """
        with torch.no_grad():
            chw = _dgen.specialize(self.tech, self.arch, self.spec)
            host = torch.cat([chw.frequency.reshape(1), chw.mem_bw.reshape(-1),
                              chw.flops_per_cycle.reshape(-1)]).cpu().numpy()
        freq = float(host[0])
        bw, fpc = host[1:1 + len(MEM_CLS)], host[1 + len(MEM_CLS):]
        return {
            "peak_flops": float(np.sum(fpc)) * freq,
            "mem_bw": {lvl: float(bw[i]) for i, lvl in enumerate(MEM_CLS)},
            "frequency": freq,
        }

    def __repr__(self) -> str:
        return f"Architecture({self.name!r})"


# --------------------------------------------------------------------------- #
# Session
# --------------------------------------------------------------------------- #


@dataclasses.dataclass(frozen=True)
class CacheStats:
    """Program-cache bookkeeping: ``traces`` counts the builds of this
    session's programs (``core.instrument``; the port traces nothing, a
    build is its counterpart); ``hits`` / ``misses`` count cache-key
    lookups."""

    programs: int
    hits: int
    misses: int
    traces: int


_ARCH_PARAM_NAMES: list[str] | None = None


def _arch_param_names() -> list[str]:
    # memoized, and read from host-side defaults: no device work per call
    global _ARCH_PARAM_NAMES
    if _ARCH_PARAM_NAMES is None:
        default = ArchParams.default("cpu")
        names = []
        for f in dataclasses.fields(ArchParams):
            n = getattr(default, f.name).numel()
            if n == 1:
                names.append(f.name)
            else:
                names.extend(f"{cls}.{f.name}" for cls in MEM_CLS[:n])
        _ARCH_PARAM_NAMES = names
    return _ARCH_PARAM_NAMES


def _param_names() -> list[str]:
    return [f"tech.{n}" for n in tech_param_names()] + [f"arch.{n}" for n in _arch_param_names()]


def _request_axis(args: tuple, nb: int) -> tuple:
    """A program's ``(tech, arch, gstack)`` example arguments repeated along
    a leading request axis of ``nb`` — the batched programs' shapes."""
    tech, arch, gstack = args
    return stack_trees([tech] * nb), stack_trees([arch] * nb), Graph.stack([gstack] * nb)


def _flatten(*trees) -> np.ndarray:
    """The trees' leaves, concatenated in order, in one copy to the host."""
    return torch.cat([t.flatten() for t in trees]).detach().cpu().numpy()


def _elasticities(tech, arch, gstack: Graph, objective: str, spec: ArchSpec, mcfg: MapperCfg,
                  batched: bool = False):
    """d log(objective) / d log(parameter) for tech and arch: one backward
    pass of the summed log objective.  ``batched``: leaves with a leading
    request axis [nb, ...] enter with a [nb, 1] lead against ``gstack``
    [nb, W, V]; no operation mixes requests, so each request gets its own
    gradient."""
    tz = to_log(tech).map(lambda x: x.detach().requires_grad_(True))
    az = to_log(arch).map(lambda x: x.detach().requires_grad_(True))
    with torch.enable_grad():
        t, a = from_log(tz), from_log(az)
        if batched:
            t, a = _popsim._against_workloads(t), _popsim._against_workloads(a)
        val, _ = stacked_log_objective(t, a, gstack, objective, spec=spec, mcfg=mcfg)
        wrt = tz.leaves() + az.leaves()
        grads = torch.autograd.grad(val.sum(), wrt, allow_unused=True)
    it = iter(torch.zeros_like(x) if g is None else g for x, g in zip(wrt, grads))
    return tz.map(lambda _: next(it)), az.map(lambda _: next(it))


# the report's fields, copied to the host together (Session._build_report)
_PERF_FIELDS = ("runtime", "energy", "power", "edp", "cycles", "energy_mem", "energy_comp", "energy_leak", "area")
_STATE_FIELDS = ("reads", "writes", "comp_ops", "bw_util")
_EXTRA_FIELDS = ("time_v", "energy_v", "t_level", "e_level_dyn", "e_level_leak", "e_comp_dyn", "e_comp_leak")


def _to_host(perfs: PerfEstimate, extras: dict) -> dict[str, np.ndarray]:
    """Every field a report reads, concatenated on the device and copied to
    the host once, then sliced back into numpy arrays of their shapes."""
    ts = {k: getattr(perfs, k) for k in _PERF_FIELDS}
    ts.update({k: getattr(perfs.state, k) for k in _STATE_FIELDS})
    ts.update({k: extras[k] for k in _EXTRA_FIELDS})
    flat = torch.cat([t.detach().reshape(-1) for t in ts.values()]).cpu().numpy()
    out, i = {}, 0
    for k, t in ts.items():
        out[k] = flat[i:i + t.numel()].reshape(t.shape)
        i += t.numel()
    return out


class Session:
    """The suite front door: simulate / optimize / frontier / explain
    against one architecture, with programs cached across calls.

    ``architecture`` accepts anything :class:`Architecture` accepts (and
    defaults to the library ``base`` design); per-call ``architecture=``
    overrides never invalidate the cache — parameter values are call
    arguments, only a changed :class:`ArchSpec` keys a new program.

    ``programs`` shares a program cache between sessions: pass another
    session's :attr:`programs` (or a plain dict) and every program one
    session builds is warm for the others — the multi-tenant serving
    arrangement.  Hit/miss/build *stats* stay per-session (a shared program
    counts as a hit for the session that finds it and as a build only under
    the session that built it).

    ``device`` is the card unless the caller names another; every tensor the
    session makes lives there.

    ``cache_dir`` makes the cache *persistent*: :meth:`preheat` records each
    program's key on disk (:class:`repro_torch.serving.aotcache.AotCache`,
    under this runtime's fingerprint), and construction rehydrates every
    record that matches this runtime into :attr:`programs` — the program
    rebuilt through the same spec function ``preheat`` uses and run once on
    example arguments of its bucket (on the card that loads the kernel
    libraries and the spec's arrays).  A restarted process serves its first
    query of a preheated shape with zero builds; :attr:`disk_loaded` reports
    how many programs arrived that way.  A rehydrated program counts in
    neither ``misses`` nor ``traces``.
    """

    _ids = itertools.count()

    def __init__(self, architecture="base", *, mcfg: MapperCfg = MapperCfg(),
                 programs: dict | None = None, cache_dir=None, device=None):
        self.device = _device(device)
        self.architecture = self._arch_on_device(architecture)
        self.mcfg = mcfg
        self._tag = f"api.session{next(Session._ids)}"
        # key -> built program; shared across sessions when passed in
        self._programs: dict = programs if programs is not None else {}
        self._engine_keys: set = set()  # engine-routed configs seen (bookkeeping)
        self._hits = 0
        self._misses = 0
        self._workload_memo: dict[str, Workload] = {}
        self._arch_memo: dict[str, Architecture] = {}
        # the pooled serving tier dispatches chunks from worker threads that
        # share one session; cache lookups and build bookkeeping stay atomic
        self._plock = threading.RLock()
        self._aot = None
        self.disk_loaded = 0  # programs rehydrated from cache_dir at construction
        if cache_dir is not None:
            # deferred: the serving package (and its fault taxonomy) only
            # loads for sessions that opt into persistence
            from repro_torch.serving.aotcache import AotCache

            self._aot = AotCache(cache_dir, device=self.device)
            for key in self._aot.load_all():
                if key in self._programs:
                    continue
                try:
                    fn, args = self._rehydrate(key)
                except (TypeError, ValueError):
                    self._aot.reject(key)  # verified, but names no program of this session
                    continue
                fn(*args)
                self._programs[key] = fn
                self.disk_loaded += 1
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)

    @property
    def programs(self) -> dict:
        """The program cache — pass to another ``Session`` to share."""
        return self._programs

    # ------------------------------------------------------------- helpers --
    def _arch_on_device(self, architecture) -> Architecture:
        if isinstance(architecture, Architecture):
            _check_device(f"Architecture {architecture.name!r}", architecture.device, self.device)
            return architecture
        return Architecture(architecture, device=self.device)

    def _arch(self, architecture) -> Architecture:
        if architecture is None:
            return self.architecture
        if isinstance(architecture, str):
            # memoized like workloads: re-parsing a .dhd and materializing
            # its params costs ~ms — far more than a warm dispatch
            with self._plock:
                a = self._arch_memo.get(architecture)
                if a is None:
                    a = self._arch_memo[architecture] = Architecture(architecture, device=self.device)
            return a
        return self._arch_on_device(architecture)

    def _workload(self, workload) -> Workload:
        if isinstance(workload, Workload):
            _check_device(f"{workload!r}", workload.device, self.device)
            return workload
        if isinstance(workload, str):
            with self._plock:
                if workload not in self._workload_memo:
                    self._workload_memo[workload] = Workload(workload, device=self.device)
                return self._workload_memo[workload]
        return Workload(workload, device=self.device)

    def _program(self, key: tuple, build) -> tuple:
        """The program cache: ``key`` -> ``(built program, built now)``.

        Only a miss pays ``build()``, which counts one build.  Thread-safe:
        concurrent pool workers racing the same key get one build and
        consistent hit/miss counts.
        """
        with self._plock:
            fn = self._programs.get(key)
            if fn is None:
                self._misses += 1
                fn = self._programs[key] = build()
                return fn, True
            self._hits += 1
            return fn, False

    def _engine_call(self, key: tuple) -> None:
        """Bookkeeping for calls that run the engines directly
        (optimize/frontier): hit/miss counts key recurrence.  The engines
        build nothing per configuration, so there is nothing to count in
        ``stats.traces``."""
        with self._plock:
            if key in self._engine_keys:
                self._hits += 1
            else:
                self._misses += 1
                self._engine_keys.add(key)

    @property
    def stats(self) -> CacheStats:
        # trailing "." so session1 never sums session10's counters
        return CacheStats(
            programs=len(self._programs),
            hits=self._hits,
            misses=self._misses,
            traces=instrument.trace_count(prefix=f"{self._tag}."),
        )

    # ------------------------------------------------------------ programs --
    # Each served program kind is declared as a *spec* — ``(cache key,
    # build)`` — so the first-call path (``_program``), ``preheat`` and the
    # rehydration from ``cache_dir`` share one definition.  ``build()``
    # counts the build and returns the closure (``build.program``, which
    # rehydration takes without counting); the closure's first call copies
    # the spec's arrays to the device (``dgen.specialize``, counted as
    # ``dgen.spec_arrays``).

    def _make_build(self, kind: str, fn):
        tag = f"{self._tag}.{kind}"

        def build():
            instrument.count_trace(tag)
            return fn

        build.program = fn
        return build

    def _spec_of(self, key: tuple):
        """The ``(key, build)`` spec that makes the program of ``key``.
        Raises ``ValueError`` or ``TypeError`` for a key this session's
        program kinds cannot make."""
        kind, spec, mcfg, bucket, *rest = key
        if not isinstance(spec, ArchSpec) or not isinstance(mcfg, MapperCfg):
            raise TypeError(f"program key {key!r} holds no ArchSpec and MapperCfg")
        bucket = tuple(bucket)
        if kind == "simulate" and not rest:
            made = self._perf_spec(bucket, spec, mcfg)
        elif kind == "report" and not rest:
            made = self._report_spec(bucket, spec, mcfg)
        elif kind == "explain" and len(rest) == 1:
            made = self._explain_spec(bucket, spec, mcfg, rest[0])
        elif kind == "report_batched" and len(rest) == 1:
            made = self._batched_report_spec(int(rest[0]), bucket, spec, mcfg)
        elif kind == "explain_batched" and len(rest) == 2:
            made = self._batched_explain_spec(int(rest[1]), bucket, spec, mcfg, rest[0])
        else:
            raise ValueError(f"no program kind makes the key {key!r}")
        if made[0] != key:
            raise ValueError(f"program key {key!r} is not canonical (made {made[0]!r})")
        return made

    def _rehydrate(self, key: tuple):
        """``(program, example arguments)`` for a key read back from
        ``cache_dir``: the spec's closure, taken without counting a build,
        and a zero-filled stack of the key's bucket under a design of the
        key's spec (the session's architecture where the spec is its own)."""
        _, build = self._spec_of(key)
        kind, spec, _, bucket = key[:4]
        _, gstack = self._bucket_stack(bucket)
        a = self.architecture if self.architecture.spec == spec else Architecture(
            None, spec=spec, device=self.device)
        args = (a.tech, a.arch, gstack)
        if kind in ("report_batched", "explain_batched"):
            args = _request_axis(args, int(key[-1]))
        return build.program, args

    def _perf_spec(self, bucket, spec: ArchSpec, mcfg: MapperCfg):
        """simulate_stacked — bit for bit the engine call it wraps."""

        def fn(tech, arch, gstack):
            return simulate_stacked(tech, arch, gstack, spec, mcfg)

        return ("simulate", spec, mcfg, bucket), self._make_build("simulate", fn)

    def _perf_program(self, bucket, spec: ArchSpec, mcfg: MapperCfg):
        return self._program(*self._perf_spec(bucket, spec, mcfg))[0]

    def _report_spec(self, bucket, spec: ArchSpec, mcfg: MapperCfg):
        """One program for the whole report: the batched PerfEstimate + the
        per-vertex / per-level breakdown extras (simulate_breakdown computes
        both in one pass over the whole [W, V] stack; every extra keeps its
        [W] axis)."""

        def fn(tech, arch, gstack):
            with torch.no_grad():
                return simulate_breakdown(tech, arch, gstack, spec, mcfg)

        return ("report", spec, mcfg, bucket), self._make_build("report", fn)

    def _report_program(self, bucket, spec: ArchSpec, mcfg: MapperCfg):
        return self._program(*self._report_spec(bucket, spec, mcfg))[0]

    def _explain_spec(self, bucket, spec: ArchSpec, mcfg: MapperCfg, objective: str):
        """Elasticities d log(objective) / d log(param) for tech AND arch."""

        def fn(tech, arch, gstack):
            return _elasticities(tech, arch, gstack, objective, spec, mcfg)

        return ("explain", spec, mcfg, bucket, objective), self._make_build("explain", fn)

    def _explain_program(self, bucket, spec: ArchSpec, mcfg: MapperCfg, objective: str):
        return self._program(*self._explain_spec(bucket, spec, mcfg, objective))[0]

    # ----------------------------------------------------- batched programs --
    def _batched_report_spec(self, nb: int, bucket, spec: ArchSpec, mcfg: MapperCfg):
        """The report program with a leading *request* axis: one dispatch
        answers ``nb`` same-bucket queries, each with its own (tech, arch,
        gstack).  The designs enter with a [nb, 1] lead against the
        workloads' [nb, W, V], so the mapper runs once on [nb, W, V] and K1
        takes nb·W rows in one launch.  Keyed by the request bucket too, so
        warm batches of similar size never build."""

        def fn(techs, archs, gstacks):
            with torch.no_grad():
                lead = _popsim._against_workloads
                return simulate_breakdown(lead(techs), lead(archs), gstacks, spec, mcfg)

        return ("report_batched", spec, mcfg, bucket, nb), self._make_build("report_batched", fn)

    def _batched_report_program(self, nb: int, bucket, spec: ArchSpec, mcfg: MapperCfg):
        return self._program(*self._batched_report_spec(nb, bucket, spec, mcfg))[0]

    def _batched_explain_spec(
        self, nb: int, bucket, spec: ArchSpec, mcfg: MapperCfg, objective: str
    ):
        """Elasticities with a leading request axis: one backward pass of the
        summed per-request log objectives."""

        def fn(techs, archs, gstacks):
            return _elasticities(techs, archs, gstacks, objective, spec, mcfg, batched=True)

        return (("explain_batched", spec, mcfg, bucket, objective, nb),
                self._make_build("explain_batched", fn))

    def _batched_explain_program(
        self, nb: int, bucket, spec: ArchSpec, mcfg: MapperCfg, objective: str
    ):
        return self._program(*self._batched_explain_spec(nb, bucket, spec, mcfg, objective))[0]

    # ------------------------------------------------------------- preheat --
    def _bucket_stack(self, item) -> tuple[tuple[int, int], Graph]:
        """Resolve a preheat target into ``(bucket, example stack)``.

        Accepts anything :class:`Workload` accepts *or* a bare
        ``(n_workloads, vertex_count)`` bucket tuple, for which a zero-filled
        stack of that shape is made on the session's device — padding
        vertices are priced at exactly zero, so running a program on it is
        safe and warms the same program real same-bucket workloads use.
        """
        if (
            isinstance(item, tuple)
            and len(item) == 2
            and all(isinstance(x, (int, np.integer)) for x in item)
        ):
            w, vb = int(item[0]), _bucket_vertices(int(item[1]))
            z = lambda *shape, dtype=torch.float32: torch.zeros(shape, dtype=dtype, device=self.device)  # noqa: E731
            stack = Graph(
                n_comp=z(w, vb, len(COMP_CLS)),
                n_read=z(w, vb, len(MEM_CLS)),
                n_write=z(w, vb, len(MEM_CLS)),
                n_alloc=z(w, vb, len(MEM_CLS)),
                dims=z(w, vb, 3),
                op_kind=z(w, vb, dtype=torch.int32),
                edges=z(w, 0, 2, dtype=torch.int32),
                names=(),
            )
            return (w, vb), stack
        wl = self._workload(item)
        return wl.bucket, wl.stacked

    def preheat(
        self,
        workloads,
        *,
        objectives: tuple[str, ...] = ("edp",),
        kinds: tuple[str, ...] = ("simulate", "explain"),
        request_buckets: tuple[int, ...] = (),
        architecture=None,
    ) -> dict:
        """Build the declared working set ahead of time — no first-call
        latency.

        ``workloads`` is one item or a list: anything :meth:`simulate`
        accepts, or bare ``(n_workloads, vertex_count)`` bucket tuples when
        the real graphs don't exist yet (shapes are all a program needs).
        ``kinds`` selects program families — ``"simulate"`` (the report
        program behind :meth:`simulate`), ``"explain"`` (adds the gradient
        program per objective), ``"perf"`` (the raw :meth:`perf` program).
        ``request_buckets`` additionally builds the batched-dispatch
        variants at those pinned request axes.

        Each program is built and run once on example arguments and, when
        the session has a ``cache_dir``, its key is persisted there.  Returns
        a summary dict: ``programs`` touched, ``built`` (built now),
        ``reused`` (already warm, or rehydrated from a record another process
        wrote since construction), ``persisted`` (new records), ``seconds``.
        """
        a = self._arch(architecture)
        spec, mcfg = a.spec, self.mcfg
        if isinstance(workloads, (str, Graph, Workload)) or (
            isinstance(workloads, tuple)
            and len(workloads) == 2
            and all(isinstance(x, (int, np.integer)) for x in workloads)
        ):
            workloads = [workloads]
        kinds = tuple(kinds)
        unknown = set(kinds) - {"perf", "simulate", "explain"}
        if unknown:
            raise ValueError(
                f"preheat kinds {sorted(unknown)} not in ('perf', 'simulate', 'explain')"
            )
        t0 = time.perf_counter()
        built = reused = persisted = 0
        seen: set = set()
        for item in workloads:
            bucket, gstack = self._bucket_stack(item)
            if bucket in seen:
                continue
            seen.add(bucket)
            args = (a.tech, a.arch, gstack)
            jobs = []
            if "perf" in kinds:
                jobs.append((self._perf_spec(bucket, spec, mcfg), args))
            if "simulate" in kinds or "explain" in kinds:
                jobs.append((self._report_spec(bucket, spec, mcfg), args))
            if "explain" in kinds:
                for obj in objectives:
                    jobs.append((self._explain_spec(bucket, spec, mcfg, obj), args))
            for nb in request_buckets:
                nb = int(nb)
                bargs = _request_axis(args, nb)
                if "simulate" in kinds or "explain" in kinds:
                    jobs.append((self._batched_report_spec(nb, bucket, spec, mcfg), bargs))
                if "explain" in kinds:
                    for obj in objectives:
                        jobs.append(
                            (self._batched_explain_spec(nb, bucket, spec, mcfg, obj), bargs)
                        )
            for (key, build), eargs in jobs:
                was_built, was_persisted = self._preheat_one(key, build, eargs)
                built += was_built
                reused += not was_built
                persisted += was_persisted
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return dict(
            programs=built + reused,
            built=built,
            reused=reused,
            persisted=persisted,
            seconds=round(time.perf_counter() - t0, 3),
        )

    def _preheat_one(self, key, build, args) -> tuple[bool, bool]:
        """Ensure one program is built, run once and persisted.

        Returns ``(built, persisted)``.  An in-memory program is reused; a
        record on disk that arrived after construction is rehydrated (a hit,
        no build); otherwise the program is built.  A new program runs once
        on its example arguments: on the card that loads the kernel
        libraries and sets up the library handles and the allocator's pools
        ahead of the first query.
        """
        with self._plock:
            fresh = (key not in self._programs and self._aot is not None
                     and self._aot.get(key) is not None)
            if fresh:
                self._programs[key] = build.program
        fn, built = self._program(key, build)
        if built or fresh:
            fn(*args)
        persisted = self._aot is not None and self._aot.put(key)
        return built, persisted

    def _assemble_batch(self, workloads, architectures, request_bucket=None):
        """Validate + stack a request batch: every item must share the
        session's spec and one shape bucket (that is what gives every request
        the same shapes under one program).  Returns ``(ws, archs, nb,
        stacked)`` with the design leaves stacked to [nb, ...] and the
        workloads to [nb, W, V, ...], the request axis padded to the pow2
        bucket by repeating lane 0 (padding lanes are computed and discarded
        — same convention as vertex padding, minus the zero pricing, because
        discarding is exact).

        ``request_bucket`` pins the padded request axis instead of the auto
        pow2 bucket.  Reductions may be ordered by array shape, so two
        *different* request buckets can differ in the last ulp; serving pins
        one bucket across sequential and coalesced dispatches precisely so
        replies are bit-identical however queries were batched."""
        ws = [self._workload(w) for w in workloads]
        if not ws:
            raise ValueError("batched call needs at least one workload")
        if architectures is None:
            archs = [self.architecture] * len(ws)
        else:
            archs = [self._arch(a) for a in architectures]
        if len(archs) != len(ws):
            raise ValueError(f"{len(archs)} architectures for {len(ws)} workloads")
        bucket, spec = ws[0].bucket, archs[0].spec
        for w in ws[1:]:
            if w.bucket != bucket:
                raise ValueError(
                    f"batched call mixes shape buckets {bucket} and {w.bucket}; "
                    "coalesce same-bucket queries only"
                )
        for a in archs[1:]:
            if a.spec != spec:
                raise ValueError("batched call mixes ArchSpecs; split by spec")
        if request_bucket is None:
            nb = _bucket_requests(len(ws))
        else:
            nb = int(request_bucket)
            if nb < len(ws):
                raise ValueError(
                    f"request_bucket={nb} smaller than the batch ({len(ws)} queries)"
                )
        pad = [0] * (nb - len(ws))
        lanes = list(range(len(ws))) + pad
        techs = stack_trees([archs[i].tech for i in lanes])
        arch_ps = stack_trees([archs[i].arch for i in lanes])
        gstacks = Graph.stack([ws[i].stacked for i in lanes])
        return ws, archs, nb, (techs, arch_ps, gstacks)

    def simulate_batch(
        self, workloads, *, architectures=None, request_bucket=None
    ) -> list[SimReport]:
        """Answer N same-bucket simulate queries in ONE dispatch.

        ``workloads`` is a list of anything :meth:`simulate` accepts;
        ``architectures`` (optional, same length) gives each request its own
        design point.  Every workload must share one shape bucket and every
        architecture the session's ``ArchSpec``.  Reports are bit-identical
        across batch compositions at one ``request_bucket`` — pinned by
        test — the batch only amortizes dispatch overhead across requests.
        """
        ws, archs, nb, stacked = self._assemble_batch(
            workloads, architectures, request_bucket
        )
        return self._simulate_batch_assembled(ws, archs, nb, stacked)

    def _simulate_batch_assembled(self, ws, archs, nb, stacked) -> list[SimReport]:
        techs, arch_ps, gstacks = stacked
        prog = self._batched_report_program(nb, ws[0].bucket, archs[0].spec, self.mcfg)
        perfs, extras = prog(techs, arch_ps, gstacks)
        return self._reports_from_batch(ws, archs, perfs, extras)

    def _reports_from_batch(self, ws, archs, perfs, extras) -> list[SimReport]:
        """Finish a batched report dispatch: slice the ``[nb]``-leading
        program outputs back into per-lane :class:`SimReport`\\ s.  Shared by
        :meth:`simulate_batch` and the serving pool's staging-buffer
        dispatcher, so both paths build reports from identical bits."""
        host = _to_host(perfs, extras)  # one device->host copy for the whole batch
        return [
            self._build_report(archs[i], ws[i], {k: v[i] for k, v in host.items()})
            for i in range(len(ws))
        ]

    def explain_batch(
        self, workloads, *, objective: str = "edp", architectures=None,
        request_bucket=None,
    ) -> list[SimReport]:
        """Batched :meth:`explain`: one report dispatch + one gradient
        dispatch answer N same-bucket explain queries.  Reports (attribution
        included) are bit-identical across batch compositions at one
        ``request_bucket``."""
        ws, archs, nb, stacked = self._assemble_batch(
            workloads, architectures, request_bucket
        )
        techs, arch_ps, gstacks = stacked
        reports = self._simulate_batch_assembled(ws, archs, nb, stacked)
        prog = self._batched_explain_program(
            nb, ws[0].bucket, archs[0].spec, self.mcfg, objective
        )
        g_techs, g_archs = prog(techs, arch_ps, gstacks)
        return self._attribute_batch(reports, g_techs, g_archs, objective)

    def _attribute_batch(self, reports, g_techs, g_archs, objective) -> list[SimReport]:
        """Finish a batched explain dispatch: rank the ``[nb]``-leading
        gradient outputs into per-lane attributions (one copy to the host).
        Shared by :meth:`explain_batch` and the serving pool's
        staging-buffer dispatcher."""
        nb = g_techs.leaves()[0].shape[0]
        leaves = g_techs.leaves() + g_archs.leaves()
        elast = torch.cat([x.reshape(nb, -1) for x in leaves], 1).detach().cpu().numpy()
        return [_attributed(rep, elast[i], objective) for i, rep in enumerate(reports)]

    # ------------------------------------------------------------ simulate --
    def perf(self, workload, *, architecture=None) -> PerfEstimate:
        """Raw batched :class:`PerfEstimate` (device tensors, leading [W]
        axis) from the cached program — the zero-overhead serving path; use
        :meth:`simulate` for the explainable report."""
        w, a = self._workload(workload), self._arch(architecture)
        prog = self._perf_program(w.bucket, a.spec, self.mcfg)
        return prog(a.tech, a.arch, w.stacked)

    def simulate(self, workload, *, architecture=None) -> SimReport:
        """Simulate the workload set; returns a :class:`SimReport` with
        per-workload totals and per-memory-level / per-vertex breakdowns."""
        w, a = self._workload(workload), self._arch(architecture)
        perfs, extras = self._report_program(w.bucket, a.spec, self.mcfg)(
            a.tech, a.arch, w.stacked
        )
        return self._build_report(a, w, _to_host(perfs, extras))

    def explain(self, workload, *, objective: str = "edp", architecture=None) -> SimReport:
        """:meth:`simulate` + gradient-based bottleneck attribution: every
        technology and architecture parameter ranked by its elasticity
        d log(objective) / d log(parameter) — DOpt's Table-3 signal, served
        as an explanation instead of a descent direction."""
        w, a = self._workload(workload), self._arch(architecture)
        rep = self.simulate(w, architecture=a)
        g_tech, g_arch = self._explain_program(w.bucket, a.spec, self.mcfg, objective)(
            a.tech, a.arch, w.stacked
        )
        return _attributed(rep, _flatten(g_tech, g_arch), objective)

    # ------------------------------------------------------------ optimize --
    def optimize(
        self,
        workload,
        *,
        objective: str = "edp",
        steps: int = 200,
        lr: float = 0.05,
        opt_over: str = "both",
        architecture=None,
        report: bool = True,
        **engine_kw,
    ) -> OptResult:
        """Gradient-descend the design for this workload set (DOpt).

        Routes to ``repro_torch.core.dopt.optimize`` with the session's
        bucketed stack on the session's device.  ``engine_kw`` forwards the
        engine's knobs (``fused``, ``chunk``, ``target_factor``,
        ``objective_weights``, ``area_budget``, ``power_budget``,
        ``penalty_weight``, ...).

        ``report=False`` skips the baseline/optimized :class:`SimReport`
        pair (those fields come back ``None``) — the lean serving/benchmark
        mode where only the descent itself should be on the clock.
        """
        w, a = self._workload(workload), self._arch(architecture)
        mcfg = engine_kw.pop("mcfg", self.mcfg)
        # the reference's key: everything static to its fused-chunk program
        self._engine_call(
            ("optimize", a.spec, mcfg, w.bucket, objective, opt_over, steps,
             engine_kw.get("fused", True), engine_kw.get("chunk"),
             engine_kw.get("target_factor"), engine_kw.get("area_constraint"))
        )
        res = _dopt.optimize(
            w.stacked,
            tech=a.tech,
            arch=a.arch,
            spec=a.spec,
            objective=objective,
            opt_over=opt_over,
            steps=steps,
            lr=lr,
            mcfg=mcfg,
            device=self.device,
            **engine_kw,
        )
        opt_arch = Architecture(
            None, name=f"{a.name}_opt", tech=res.tech, arch=res.arch, spec=a.spec, device=self.device
        )
        hist = tuple(float(math.exp(v)) for v in res.history["objective"])
        improvement = hist[0] / max(hist[-1], 1e-300) if hist else 1.0
        return OptResult(
            objective=objective,
            opt_over=opt_over,
            epochs=len(hist),
            improvement=improvement,
            objective_history=hist,
            importance=tuple(
                Attribution(parameter=f"tech.{n}", elasticity=v) for n, v in res.importance
            ),
            baseline=self.simulate(w, architecture=a) if report else None,
            optimized=self.simulate(w, architecture=opt_arch) if report else None,
            dhd=opt_arch.to_dhd(),
        )

    def tech_targets(self, workload, *, goal_factor: float = 100.0, **engine_kw) -> dict:
        """Technology targets for a ``goal_factor``x objective improvement
        (paper §8.3) — thin passthrough to
        ``repro_torch.core.dopt.derive_tech_targets`` on the session's
        bucketed stack and device."""
        w = self._workload(workload)
        return _dopt.derive_tech_targets(w.stacked, goal_factor=goal_factor, device=self.device, **engine_kw)

    # ------------------------------------------------------------ frontier --
    def frontier(
        self,
        workload,
        *,
        seeds: tuple[str, ...] = ("base", "edge", "datacenter"),
        population: int = 24,
        steps: int = 24,
        lr: float = 0.1,
        metrics: tuple[str, ...] = ("time", "energy", "area"),
        area_budget: float | None = None,
        power_budget: float | None = None,
        **engine_kw,
    ) -> FrontierResult:
        """Population-scale constrained multi-objective DSE: the feasible
        latency/energy/area Pareto front for this workload set (popsim).

        Seeds descend from the named ``.dhd`` library designs (the session
        architecture does not constrain the population).  ``engine_kw``
        forwards ``repro_torch.core.popsim.pareto_dse``'s knobs
        (``penalty_weight``, ``sigma``, ``key``, ``hv_box``, the random
        draws ``noise``, ``mix_draws`` and ``hv_samples``, and ``mesh``, a
        ``DeviceMesh`` with a ``pop`` dim over which the members are split,
        every rank returning the same front, ...).
        """
        w = self._workload(workload)
        mcfg = engine_kw.pop("mcfg", self.mcfg)
        self._engine_call(
            ("frontier", mcfg, w.bucket, tuple(metrics), tuple(seeds),
             population, steps, engine_kw.get("chunk"), engine_kw.get("opt_over", "both"))
        )
        res = _popsim.pareto_dse(
            w.stacked,
            seeds=seeds,
            population=population,
            steps=steps,
            lr=lr,
            metrics=metrics,
            area_budget=area_budget,
            power_budget=power_budget,
            mcfg=mcfg,
            device=self.device,
            **engine_kw,
        )
        front = tuple(
            FrontierPoint(
                index=int(win["index"]),
                seed=win["seed"],
                weights=tuple(win["weights"][m] for m in PARETO_METRICS),
                time_s=win["time_s"],
                energy_j=win["energy_j"],
                area_mm2=win["area_mm2"],
                power_w=win["power_w"],
                edp=win["edp"],
                dhd=win["dhd"],
            )
            for win in res.winners
        )
        return FrontierResult(
            metrics=tuple(metrics),
            population=population,
            epochs=steps,
            feasible=int(res.feasible.sum()),
            hypervolume=float(res.hypervolume),
            area_budget=float("inf") if area_budget is None else float(area_budget),
            power_budget=float("inf") if power_budget is None else float(power_budget),
            front=front,
            raw=res,
        )

    # --------------------------------------------------------- introspection --
    def trace_programs(self, workload, *, objective: str = "edp", architecture=None) -> dict:
        """The four served program kinds as FX graphs.

        Returns ``{"simulate": ..., "explain": ..., "optimize": ...,
        "frontier": ...}`` — each a ``torch.fx.GraphModule`` from
        ``make_fx`` over *the same engine functions the session serves*
        (``simulate_stacked``; the explain gradient; one DOpt epoch; the
        population step over a 2-member population), taking the flattened
        leaves of their tree arguments.  Custom kernels appear as their ops
        (``repro_torch.mapper_carries`` and its backward).

        The graphs are traced in ``"real"`` mode on the session's device:
        the programs run once while they are recorded.  Fake tensors would
        be cached by the engines' per-device constant caches, so they are
        not used.  Tracing builds nothing the session keeps.
        """
        from torch.fx.experimental.proxy_tensor import make_fx

        w, a = self._workload(workload), self._arch(architecture)
        spec, mcfg, dev = a.spec, self.mcfg, self.device
        g_leaves = [getattr(w.stacked, f) for f in DATA_FIELDS]
        log_bounds = (tuple(to_log(b) for b in TechParams.bounds(dev)),
                      tuple(to_log(b) for b in ArchParams.bounds(dev)))

        def trace(fn, *args):
            return make_fx(fn, tracing_mode="real")(*args)

        def take(it, like):
            return next(it) if torch.is_tensor(like) else like.map(lambda _: next(it))

        def graph(it) -> Graph:
            return Graph(**{f: next(it) for f in DATA_FIELDS}, names=())

        def sim(*leaves):
            it = iter(leaves)
            tech, arch = take(it, a.tech), take(it, a.arch)
            return simulate_stacked(tech, arch, graph(it), spec, mcfg).leaves()

        def expl(*leaves):
            it = iter(leaves)
            tech, arch = take(it, a.tech), take(it, a.arch)
            g_tech, g_arch = _elasticities(tech, arch, graph(it), objective, spec, mcfg)
            return g_tech.leaves() + g_arch.leaves()

        design = [*a.tech.leaves(), *a.arch.leaves()]
        out = {"simulate": trace(sim, *design, *g_leaves), "explain": trace(expl, *design, *g_leaves)}

        # one DOpt epoch with the state/mix layout optimize() runs
        # (opt_over="both": no type logits, placeholder ystate)
        tech_z, arch_z = to_log(a.tech), to_log(a.arch)
        st0 = _dopt._DoptState(tech_z, arch_z, None, _dopt.adam_init(tech_z), _dopt.adam_init(arch_z),
                               _dopt.adam_init(torch.zeros(1, device=dev)), *_dopt.guard_init(dev))
        f32 = lambda x: torch.full((), x, dtype=torch.float32, device=dev)  # noqa: E731
        mix = (torch.zeros(len(PARETO_METRICS), device=dev), f32(float("inf")), f32(float("inf")), f32(1.0))

        def opt(*leaves):
            it = iter(leaves)
            tz, az = take(it, st0.tech_z), take(it, st0.arch_z)
            adam = lambda s: _dopt.AdamState(m=take(it, s.m), v=take(it, s.v), step=next(it))  # noqa: E731
            st = _dopt._DoptState(tz, az, None, adam(st0.tstate), adam(st0.astate), adam(st0.ystate),
                                  next(it), next(it))
            g = graph(it)
            lr, fault = next(it), next(it)
            mx = tuple(next(it) for _ in mix)
            elast, metrics = _dopt._dopt_step(st, g, lr, mx, fault, spec, objective, None, "both", mcfg,
                                              log_bounds)
            return [elast, metrics, *st.tensors()]

        out["optimize"] = trace(opt, *st0.tensors(), *g_leaves, f32(0.05), f32(0.0), *mix)

        # the population step's member axis, minimally populated (P=2)
        pop = 2
        pstate = _popsim.init_population_state(stack_trees([a.tech] * pop), stack_trees([a.arch] * pop))
        n_state = len(_popsim._state_leaves(pstate))
        budgets = torch.full((pop,), float("inf"), device=dev)

        def front(*leaves):
            st = _popsim._unflatten_state(pstate, list(leaves[:n_state]))
            it = iter(leaves[n_state:])
            mixes = (next(it), next(it), next(it))
            g = graph(it)
            lr, pw = next(it), next(it)
            st, row = _popsim._population_step(st, mixes, g, lr, pw, spec, mcfg, "both", log_bounds)
            return [*_popsim._state_leaves(st), row]

        out["frontier"] = trace(front, *_popsim._state_leaves(pstate), torch.zeros(pop, len(PARETO_METRICS),
                                                                                    device=dev),
                                budgets, budgets, *g_leaves, f32(0.1), f32(1.0))
        return out

    # -------------------------------------------------------------- report --
    def _build_report(self, a: Architecture, w: Workload, host: dict) -> SimReport:
        """A :class:`SimReport` from the report fields already on the host
        (``_to_host``: one copy per report, or per batch)."""
        reads, writes, comp_ops, bw_util = (host[k] for k in _STATE_FIELDS)
        workloads = []
        for i, (lbl, g) in enumerate(zip(w.labels, w.graphs)):
            v = g.n_vertices
            time_v = host["time_v"][i, :v]
            energy_v = host["energy_v"][i, :v]
            rt = float(host["runtime"][i])
            levels = tuple(
                MemoryLevelReport(
                    level=lvl,
                    reads_bytes=float(reads[i, li]),
                    writes_bytes=float(writes[i, li]),
                    transfer_time_s=float(host["t_level"][i, li]),
                    dynamic_energy_j=float(host["e_level_dyn"][i, li]),
                    leakage_energy_j=float(host["e_level_leak"][i, li]),
                    bw_utilization=float(bw_util[i, li]),
                )
                for li, lvl in enumerate(MEM_CLS)
            )
            compute = tuple(
                ComputeClassReport(
                    unit=unit,
                    flops=float(comp_ops[i, ci]),
                    dynamic_energy_j=float(host["e_comp_dyn"][i, ci]),
                    leakage_energy_j=float(host["e_comp_leak"][i, ci]),
                )
                for ci, unit in enumerate(COMP_CLS)
            )
            vertices = tuple(
                VertexReport(
                    name=str(g.names[vi]) if vi < len(g.names) else f"v{vi}",
                    time_s=float(time_v[vi]),
                    energy_j=float(energy_v[vi]),
                    time_share=float(time_v[vi] / max(rt, 1e-300)),
                )
                for vi in range(v)
            )
            workloads.append(
                WorkloadReport(
                    label=lbl,
                    runtime_s=rt,
                    energy_j=float(host["energy"][i]),
                    power_w=float(host["power"][i]),
                    edp=float(host["edp"][i]),
                    cycles=float(host["cycles"][i]),
                    energy_mem_j=float(host["energy_mem"][i]),
                    energy_comp_j=float(host["energy_comp"][i]),
                    energy_leak_j=float(host["energy_leak"][i]),
                    levels=levels,
                    compute=compute,
                    vertices=vertices,
                )
            )
        return SimReport(
            architecture=a.name,
            objective="",
            area_mm2=float(host["area"][0]),
            workloads=tuple(workloads),
        )


def _attributed(rep: SimReport, elast: np.ndarray, objective: str) -> SimReport:
    """``rep`` with every parameter ranked by |elasticity| (``elast`` in
    :func:`_param_names` order)."""
    ranked = sorted(zip(_param_names(), elast.tolist()), key=lambda kv: -abs(kv[1]))
    attribution = tuple(Attribution(parameter=n, elasticity=float(v)) for n, v in ranked)
    return dataclasses.replace(rep, objective=objective, attribution=attribution)
