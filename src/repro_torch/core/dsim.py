"""DSim — the hardware simulator (paper §5.3/§6).

simulate(): (TechParams, ArchParams, Graph) -> PerfEstimate
  Runtime = cycles / frequency                         (paper eq. 1)
  Energy  = Σ_mem reads·re + writes·we + leak·Runtime
          + Σ_comp ops·e_op + leak·Runtime             (paper §5.3)
  Area    = Σ areas                                    (paper eq. 2)
  Power   = Energy / Runtime                           (paper eq. 3)

Fully differentiable w.r.t. both parameter sets.  A stacked graph
([W, V, ...]) gives estimates with a leading [W] axis; parameters with a
leading member axis shaped [P, 1] against it give [P, W] estimates, and the
multi-objective layer below reduces over the workload axis (the last) only,
so a population's metrics are [P, 4] and its objective values [P].
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch import instrument
from repro_torch.core.dgen import ConcreteHW, specialize
from repro_torch.core.graph import Graph
from repro_torch.core.mapper import MapperCfg, MapState, map_workload, map_workload_breakdown
from repro_torch.core.params import ArchParams, ArchSpec, TechParams, TensorTree, const, max_const


@dataclass
class PerfEstimate(TensorTree):
    """paper §5: P : Measurements -> R+  (+ useful breakdowns)."""

    runtime: torch.Tensor  # s
    energy: torch.Tensor  # J
    power: torch.Tensor  # W
    area: torch.Tensor  # mm^2
    cycles: torch.Tensor
    edp: torch.Tensor  # J*s
    energy_mem: torch.Tensor
    energy_comp: torch.Tensor
    energy_leak: torch.Tensor
    state: MapState

    def measurements(self) -> dict:
        return dict(runtime=self.runtime, energy=self.energy, power=self.power, area=self.area)


def _energy(chw: ConcreteHW, ms: MapState, runtime: torch.Tensor):
    e_mem_dyn = torch.sum(ms.reads * chw.read_energy_pb + ms.writes * chw.write_energy_pb, -1)
    e_comp_dyn = torch.sum(ms.comp_ops * chw.energy_per_flop, -1)
    e_leak = chw.total_leakage * runtime
    return e_mem_dyn, e_comp_dyn, e_leak


def simulate_chw(chw: ConcreteHW, g: Graph, mcfg: MapperCfg = MapperCfg()) -> PerfEstimate:
    ms = map_workload(chw, g, mcfg)
    runtime = ms.cycles / chw.frequency
    e_mem, e_comp, e_leak = _energy(chw, ms, runtime)
    energy = e_mem + e_comp + e_leak
    area = chw.total_area.expand(runtime.shape)
    return PerfEstimate(
        runtime=runtime,
        energy=energy,
        power=energy / max_const(runtime, 1e-30),
        area=area,
        cycles=ms.cycles,
        edp=energy * runtime,
        energy_mem=e_mem,
        energy_comp=e_comp,
        energy_leak=e_leak,
        state=ms,
    )


def simulate(
    tech: TechParams,
    arch: ArchParams,
    g: Graph,
    spec: ArchSpec = ArchSpec(),
    mcfg: MapperCfg = MapperCfg(),
    type_weights: torch.Tensor | None = None,
) -> PerfEstimate:
    """End-to-end differentiable: params -> CH -> mapping -> estimates.
    Traced, span ``dsim.simulate``, holding ``dgen.specialize`` and
    ``mapper.map``."""
    with instrument.span("dsim.simulate", tech.node.device):
        chw = specialize(tech, arch, spec, type_weights)
        return simulate_chw(chw, g, mcfg)


def _per_vertex(x: torch.Tensor, rate: torch.Tensor) -> torch.Tensor:
    """``x`` [..., V, N] against a per-class ``rate``: [N], or with leading
    axes ([nb, 1, N] for a batch of designs) as one product per design."""
    if rate.ndim == 1:
        return x @ rate
    return (x @ rate.unsqueeze(-1)).squeeze(-1)


def simulate_breakdown(
    tech: TechParams,
    arch: ArchParams,
    g: Graph,
    spec: ArchSpec = ArchSpec(),
    mcfg: MapperCfg = MapperCfg(),
    type_weights: torch.Tensor | None = None,
) -> tuple[PerfEstimate, dict]:
    """Simulate + the per-level / per-vertex attribution arrays.

      * ``time_v`` / ``energy_v`` [V] — per-vertex wall time and energy
        (dynamic traffic + compute + leakage prorated by the vertex's time);
      * ``e_level_dyn`` / ``e_level_leak`` [N_MEM] — per-memory-level energy;
      * ``e_comp_dyn`` / ``e_comp_leak`` [N_COMP] — per-compute-class energy;
      * ``t_level`` [N_MEM] — demanded transfer time per level.

    Each array also carries the graph's leading axes ([W] for a stack), and
    designs with a leading axis shaped [nb, 1] against a [nb, W, V] graph (one
    design a request) give [nb, W, ...] arrays, no request mixing with another.
    """
    chw = specialize(tech, arch, spec, type_weights)
    perf = simulate_chw(chw, g, mcfg)
    bd = map_workload_breakdown(chw, g, mcfg)
    ms = perf.state
    leak_w = chw.total_leakage[..., None]  # against [..., V], a design lead included
    e_v_dyn = (
        _per_vertex(g.n_read, chw.read_energy_pb)
        + _per_vertex(g.n_write, chw.write_energy_pb)
        + _per_vertex(g.n_comp, chw.energy_per_flop)
    ) * bd["active"]
    extras = dict(
        time_v=bd["time_v"],
        energy_v=e_v_dyn + leak_w * bd["time_v"],
        tiles_v=bd["tiles_v"],
        t_comp_v=bd["t_comp_v"],
        t_main_exposed_v=bd["t_main_exposed_v"],
        t_level=bd["t_level"],
        e_level_dyn=ms.reads * chw.read_energy_pb + ms.writes * chw.write_energy_pb,
        e_level_leak=chw.mem_leakage * perf.runtime[..., None],
        e_comp_dyn=ms.comp_ops * chw.energy_per_flop,
        e_comp_leak=chw.comp_leakage * perf.runtime[..., None],
    )
    return perf, extras


def simulate_stacked(
    tech: TechParams,
    arch: ArchParams,
    gs: Graph,
    spec: ArchSpec = ArchSpec(),
    mcfg: MapperCfg = MapperCfg(),
    type_weights: torch.Tensor | None = None,
) -> PerfEstimate:
    """Batched simulate over a ``Graph.stack()``-ed workload axis: one
    hardware point, W workloads, one mapper pass over [W, V] arrays.
    Returns a PerfEstimate whose fields carry a leading [W] axis."""
    return simulate(tech, arch, gs, spec, mcfg, type_weights)


def stacked_log_objective(
    tech: TechParams,
    arch: ArchParams,
    gs: Graph,
    objective: str = "edp",
    area_constraint: float | None = None,
    spec: ArchSpec = ArchSpec(),
    mcfg: MapperCfg = MapperCfg(),
    type_weights: torch.Tensor | None = None,
) -> tuple[torch.Tensor, PerfEstimate]:
    """Mean log objective across a stacked workload set (the last axis; [P]
    values for a population) + the batched estimates.  Log-objective keeps
    gradients scale-free across heterogeneous workloads."""
    perfs = simulate_stacked(tech, arch, gs, spec, mcfg, type_weights)
    return torch.mean(torch.log(objective_value(perfs, objective, area_constraint)), -1), perfs


# --------------------------------------------------------------------------- #
# multi-objective layer: per-design metric vectors + constrained scalarization
# --------------------------------------------------------------------------- #

# the metric space multi-objective DSE optimizes over; order is the metric-
# vector layout shared by stacked_log_metrics / popsim / pareto
PARETO_METRICS = ("time", "energy", "area", "edp")


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + e^x) as logaddexp(x, 0): exactly 0 with a zero gradient at -inf."""
    return torch.logaddexp(x, torch.zeros_like(x))


def stacked_log_metrics(perfs: PerfEstimate) -> torch.Tensor:
    """[..., 4] log-metric vectors of a batched estimate, in PARETO_METRICS
    order: each entry is the mean log metric across the stacked workload axis
    (the last; a [W] estimate gives [4], a population's [P, W] gives [P, 4])."""
    return torch.stack(
        [
            torch.mean(torch.log(perfs.runtime), -1),
            torch.mean(torch.log(perfs.energy), -1),
            torch.mean(torch.log(perfs.area), -1),
            torch.mean(torch.log(perfs.edp), -1),
        ],
        -1,
    )


def budget_penalty(
    perfs: PerfEstimate,
    area_budget: torch.Tensor,
    power_budget: torch.Tensor,
    sharpness: float = 8.0,
) -> torch.Tensor:
    """Differentiable log-space budget penalty (smooth hinge on violation).

    For each budget B and worst-case metric m over the workload stack (the
    last axis), the violation is ``v = log m - log B`` and the penalty is
    ``softplus(sharpness * v) / sharpness``.  An ``inf`` budget disables a
    budget exactly: the violation is ``-inf``, the penalty and its gradient
    are exactly zero.  Budgets must be positive; a population's are [P].
    """
    area_budget = torch.as_tensor(area_budget, dtype=torch.float32).to(perfs.area.device)
    power_budget = torch.as_tensor(power_budget, dtype=torch.float32).to(perfs.power.device)
    viol_area = torch.log(torch.amax(perfs.area, -1)) - torch.log(area_budget)
    viol_power = torch.log(torch.amax(perfs.power, -1)) - torch.log(power_budget)
    sp = lambda v: _softplus(sharpness * v) / sharpness  # noqa: E731
    return sp(viol_area) + sp(viol_power)


def mixed_log_objective(
    tech: TechParams,
    arch: ArchParams,
    gs: Graph,
    weights: torch.Tensor,
    area_budget: torch.Tensor | float | None = None,
    power_budget: torch.Tensor | float | None = None,
    penalty_weight: torch.Tensor | float = 1.0,
    spec: ArchSpec = ArchSpec(),
    mcfg: MapperCfg = MapperCfg(),
    type_weights: torch.Tensor | None = None,
) -> tuple[torch.Tensor, PerfEstimate]:
    """Constrained scalarization of the PARETO_METRICS vector.

    ``weights`` [4] mixes the log metrics (a one-hot weight reproduces the
    corresponding single-objective ``stacked_log_objective``).  Budgets are
    worst-case-over-workloads area/power ceilings applied as
    :func:`budget_penalty`, scaled by ``penalty_weight``; ``None``/``inf``
    disables one.  For a population (params with a [P, 1] lead), ``weights``
    are [P, 4], the budgets [P] or scalars, and the value is [P].
    """
    perfs = simulate_stacked(tech, arch, gs, spec, mcfg, type_weights)
    dev = perfs.runtime.device
    w = torch.as_tensor(weights, dtype=torch.float32).to(dev)
    val = torch.sum(w * stacked_log_metrics(perfs), -1)
    ab = float("inf") if area_budget is None else area_budget
    pb = float("inf") if power_budget is None else power_budget
    return val + penalty_weight * budget_penalty(perfs, ab, pb), perfs


def objective_value(perf: PerfEstimate, objective: str, area_constraint: float | None = None) -> torch.Tensor:
    """Scalar optimization objective (paper §7 / Appendix C).

    area-constrained form: F = T * e^(a - A)  (paper §11.3), smooth-rectified
    so the penalty only binds above the constraint.
    """
    base = {
        "time": perf.runtime,
        "energy": perf.energy,
        "edp": perf.edp,
        "power": perf.power,
        "area": perf.area,
    }[objective]
    if area_constraint is not None:
        a = const(perf.area, area_constraint)
        base = base * torch.exp(_softplus((perf.area - a) / a))
    return base
