"""Explainable result objects for the DRAGON façade (`repro_torch.api`).

The engines return raw trees of device tensors (PerfEstimate,
dopt.OptResult, popsim.ParetoResult) — right for composing PyTorch programs,
wrong for humans and services.  This module is the typed, frozen, JSON-able
layer the :class:`repro_torch.api.Session` methods return:

  * :class:`SimReport`     — ``Session.simulate`` / ``Session.explain``:
    per-workload totals, per-memory-level and per-vertex time/energy
    breakdowns, and (from ``explain``) gradient-based bottleneck
    attribution — the elasticities DOpt already computes, ranked;
  * :class:`OptResult`     — ``Session.optimize``: improvement factor,
    convergence history, ranked technology importance, the optimized design
    as canonical ``.dhd`` text;
  * :class:`FrontierResult`— ``Session.frontier``: the constrained Pareto
    front with per-point metrics and serialized designs.

Everything is plain floats/strings/tuples (computed once, host-side), so
reports are hashable-free frozen dataclasses that ``json.dumps`` cleanly via
:meth:`to_json` and round-trip through logs, caches and RPC boundaries.
Designs serialize to ``.dhd`` text (:meth:`OptResult.to_dhd`,
:meth:`FrontierResult.to_dhd`) — the suite's interchange format.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass


def _to_json(obj, exclude: tuple[str, ...] = ()) -> str:
    d = {
        f.name: getattr(obj, f.name)
        for f in dataclasses.fields(obj)
        if f.name not in exclude
    }

    def default(x):
        if dataclasses.is_dataclass(x) and not isinstance(x, type):
            return dataclasses.asdict(x)
        return float(x)

    return json.dumps(d, default=default, indent=1)


# --------------------------------------------------------------------------- #
# simulate / explain
# --------------------------------------------------------------------------- #


@dataclass(frozen=True)
class Attribution:
    """One ranked bottleneck: d log(objective) / d log(parameter).

    Positive elasticity: shrinking the parameter improves the objective
    (it is a cost driver); negative: growing it helps (it is starved).
    """

    parameter: str  # e.g. "tech.mainMem.cell_read_latency", "arch.frequency"
    elasticity: float

    @property
    def action(self) -> str:
        return "reduce" if self.elasticity > 0 else "increase"


@dataclass(frozen=True)
class MemoryLevelReport:
    """Where a memory level's bytes, time and energy went."""

    level: str  # localMem | globalBuf | mainMem
    reads_bytes: float
    writes_bytes: float
    transfer_time_s: float  # demanded (no-overlap) transfer time
    dynamic_energy_j: float
    leakage_energy_j: float
    bw_utilization: float  # average utilization (globalBuf EMA input)


@dataclass(frozen=True)
class ComputeClassReport:
    """Per compute class: issued work and energy."""

    unit: str  # systolicArray | vector | macTree | fpu
    flops: float
    dynamic_energy_j: float
    leakage_energy_j: float


@dataclass(frozen=True)
class VertexReport:
    """One DFG vertex's share of the mapped execution."""

    name: str
    time_s: float
    energy_j: float
    time_share: float  # fraction of total runtime


@dataclass(frozen=True)
class WorkloadReport:
    """One workload's totals + breakdowns on the session's architecture."""

    label: str
    runtime_s: float
    energy_j: float
    power_w: float
    edp: float
    cycles: float
    energy_mem_j: float
    energy_comp_j: float
    energy_leak_j: float
    levels: tuple[MemoryLevelReport, ...]
    compute: tuple[ComputeClassReport, ...]
    vertices: tuple[VertexReport, ...]

    def top_vertices(self, k: int = 5) -> tuple[VertexReport, ...]:
        return tuple(sorted(self.vertices, key=lambda v: -v.time_s)[:k])


@dataclass(frozen=True)
class SimReport:
    """``Session.simulate``'s result: explainable, frozen, JSON-able.

    ``workloads`` carries one :class:`WorkloadReport` per member of the
    simulated :class:`repro_torch.api.Workload`; the scalar conveniences
    (``runtime_s`` ...) read workload 0 for a single workload and the
    geometric mean across the set otherwise (matching the engines'
    mean-log reduction).  ``attribution`` is empty unless the report came
    from ``Session.explain``.
    """

    architecture: str  # architecture name
    objective: str  # the objective `attribution` differentiates ("" = none)
    area_mm2: float
    workloads: tuple[WorkloadReport, ...]
    attribution: tuple[Attribution, ...] = ()

    def _agg(self, field: str) -> float:
        vals = [getattr(w, field) for w in self.workloads]
        if len(vals) == 1:
            return vals[0]
        import math

        return math.exp(sum(math.log(max(v, 1e-300)) for v in vals) / len(vals))

    @property
    def runtime_s(self) -> float:
        return self._agg("runtime_s")

    @property
    def energy_j(self) -> float:
        return self._agg("energy_j")

    @property
    def power_w(self) -> float:
        return self._agg("power_w")

    @property
    def edp(self) -> float:
        return self._agg("edp")

    def bottlenecks(self, k: int = 5) -> tuple[Attribution, ...]:
        """Top-k parameters by |elasticity| (requires ``explain``)."""
        return self.attribution[:k]

    def to_json(self) -> str:
        return _to_json(self)

    def __str__(self) -> str:
        lines = [f"SimReport[{self.architecture}] area {self.area_mm2:.1f} mm^2"]
        for w in self.workloads:
            lines.append(
                f"  {w.label:24s} {w.runtime_s * 1e3:9.3f} ms  "
                f"{w.energy_j * 1e3:9.3f} mJ  edp {w.edp:.3e}"
            )
            for lv in w.levels:
                lines.append(
                    f"      {lv.level:10s} r/w {lv.reads_bytes / 1e6:8.1f}/"
                    f"{lv.writes_bytes / 1e6:8.1f} MB  "
                    f"dyn {lv.dynamic_energy_j * 1e3:8.3f} mJ"
                )
        for a in self.attribution[:5]:
            lines.append(f"  -> {a.action:8s} {a.parameter:44s} |e|={abs(a.elasticity):.3f}")
        return "\n".join(lines)


# --------------------------------------------------------------------------- #
# optimize
# --------------------------------------------------------------------------- #


@dataclass(frozen=True)
class OptResult:
    """``Session.optimize``'s result: what changed, by how much, and why.

    ``improvement`` is the start/end objective factor (geometric-mean
    objective across the workload set, matching the engine's loss);
    ``importance`` ranks technology parameters by accumulated |elasticity|
    — the paper's Table-3 ordering; ``dhd`` is the optimized design as
    canonical text (``to_dhd``), parse-able back into an
    :class:`repro_torch.api.Architecture`.
    """

    objective: str
    opt_over: str
    epochs: int
    improvement: float
    objective_history: tuple[float, ...]  # geomean objective per epoch
    importance: tuple[Attribution, ...]
    baseline: SimReport | None  # None when built with report=False
    optimized: SimReport | None
    dhd: str

    def to_dhd(self) -> str:
        return self.dhd

    def to_json(self) -> str:
        return _to_json(self)

    def __str__(self) -> str:
        top = " > ".join(a.parameter for a in self.importance[:3])
        return (
            f"OptResult[{self.objective}/{self.opt_over}] {self.epochs} epochs, "
            f"{self.improvement:.1f}x better; top levers: {top}"
        )


# --------------------------------------------------------------------------- #
# frontier
# --------------------------------------------------------------------------- #


@dataclass(frozen=True)
class FrontierPoint:
    """One non-dominated design on the constrained frontier."""

    index: int
    seed: str  # .dhd library architecture the member descended from
    weights: tuple[float, ...]  # PARETO_METRICS objective mix
    time_s: float
    energy_j: float
    area_mm2: float
    power_w: float
    edp: float
    dhd: str  # the design, serialized


@dataclass(frozen=True)
class FrontierResult:
    """``Session.frontier``'s result: the feasible Pareto front.

    ``raw`` keeps the engine's :class:`repro_torch.core.popsim.ParetoResult`
    (device tensors and host arrays, full population) for follow-up computation; it is
    excluded from ``to_json``.
    """

    metrics: tuple[str, ...]
    population: int
    epochs: int
    feasible: int
    hypervolume: float
    area_budget: float
    power_budget: float
    front: tuple[FrontierPoint, ...]
    raw: object = None

    def to_dhd(self) -> str:
        """All winning designs as one concatenated ``.dhd`` document."""
        return "\n\n".join(p.dhd for p in self.front)

    def to_json(self) -> str:
        return _to_json(self, exclude=("raw",))

    def __str__(self) -> str:
        lines = [
            f"FrontierResult: {len(self.front)}/{self.population} designs on the "
            f"{'/'.join(self.metrics)} front, hv {self.hypervolume:.2f}"
        ]
        for p in self.front:
            lines.append(
                f"  [{p.seed:10s}] {p.time_s * 1e3:8.2f} ms  {p.energy_j:7.3f} J  "
                f"{p.area_mm2:7.1f} mm^2  {p.power_w:6.1f} W"
            )
        return "\n".join(lines)
