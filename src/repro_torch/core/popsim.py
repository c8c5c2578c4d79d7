"""Population-scale multi-objective DSE on the device.

DSE here is a *population* of independent gradient-descent trajectories
(multi-start over the non-convex design/technology space, paper Fig. 3),
each descending its own constrained objective mix against a *set* of
workloads; the question it answers is what the latency/energy/area frontier
looks like and which design wins under a budget.

  * :func:`seed_population` — [P] starting points from the ``.dhd``
    architecture library plus log-space jitter (pristine library seeds are
    kept unjittered);
  * :func:`sample_objective_mixes` — per-member PARETO_METRICS weight
    vectors (Dirichlet over a metric subset, deterministic one-hot corners
    first so the front's extremes are always probed);
  * :func:`population_chunk` — ``n`` epochs of ``P`` independent Adam
    trajectories back to back on the device, with one host copy of the
    history per chunk: the per-member DOpt step (dsim.mixed_log_objective
    value and gradient + log-space Adam + Alg.-6 bounds clamping) over an
    explicit member axis, with the per-epoch penalty weight supplied as a
    tensor so constraint schedules don't force chunk boundaries.  With a
    ``DeviceMesh``, the members are split over one of its dims
    (:func:`population_chunk_sharded`): trajectories are independent, so the
    only collective is the gather of the history;
  * :func:`pareto_dse` — the driver: seed, descend, extract the
    non-dominated front (core.pareto), and serialize every winner back to
    diffable ``.dhd`` text via dhdl.serialize_arch.

The member axis.  The [P]-stacked parameters enter ``specialize`` with a
[P, 1] lead, which broadcasts against the stacked workload set's [W, V]: the
mapper runs once on [P, W, V], and its carries kernel (K1) takes P·W rows in
one launch forward and one backward.  No operation mixes members (every
reduction is over the workload or vertex axis), so one backward pass of the
summed member losses gives each member its own gradient.

Random draws.  The jitter noise, the Dirichlet mixes and the hypervolume's
unit samples are explicit arguments; absent, they are drawn on the host by
``numpy.random`` from ``key`` (one child generator per use), so one key gives
one population on the CPU and on the card.

Legacy single-objective helpers (init_population / population_objective /
make_dse_step / shard_population / dse_in_shardings) are kept beside it: they
are the DSE step the production-mesh dry run runs (``launch.dryrun --popsim``),
members over ("pod", "data") and workloads over "model".
"""
from __future__ import annotations

import dataclasses
import math
from collections.abc import Mapping
from dataclasses import dataclass

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from repro_torch import instrument
from repro_torch.core.dhdl import load_arch, serialize_arch
from repro_torch.core.dopt import AdamState, adam_update, from_log, to_log
from repro_torch.core.dsim import (
    PARETO_METRICS,
    mixed_log_objective,
    objective_value,
    simulate_stacked,
    stacked_log_metrics,
    stacked_log_objective,
)
from repro_torch.core.graph import DATA_FIELDS, Graph
from repro_torch.core.mapper import MapperCfg
from repro_torch.core.params import ArchParams, ArchSpec, TechParams, clamp_params, per_member, stack_trees
from repro_torch.core.pareto import hv_ref_point, hypervolume, non_dominated_mask, unit_samples
from repro_torch.kernels.runtime import resolve_device

_TREES = (TechParams, ArchParams)


def _fields(cls) -> list[str]:
    return [f.name for f in dataclasses.fields(cls)]


def _members(tree) -> int:
    return tree.leaves()[0].shape[0]


def _against_workloads(tree):
    """[P, ...] member leaves as [P, 1, ...]: the member lead broadcasts
    against a stacked workload set's [W, ...]."""
    return tree.map(lambda x: x.unsqueeze(1))


def _tensor(x, dev) -> torch.Tensor:
    """``x`` (a tensor, an array or a number) as a float32 tensor on ``dev``."""
    if torch.is_tensor(x):
        return x.to(dev, torch.float32)
    return torch.tensor(np.asarray(x, np.float32), device=dev)


def _draw(draws, field: str):
    """One field's draws from a dict, or from an object holding them as attributes."""
    return draws[field] if isinstance(draws, Mapping) else getattr(draws, field)


def _stack_graphs(graphs, dev) -> Graph:
    if isinstance(graphs, Graph):
        gstack = graphs if graphs.n_comp.ndim == 3 else Graph.stack([graphs])
    else:
        gstack = Graph.stack(list(graphs))
    return gstack.to(dev)


# --------------------------------------------------------------------------- #
# population seeding: .dhd library starts + log-space jitter
# --------------------------------------------------------------------------- #


def jitter_noise(n: int, key: int = 0) -> tuple[dict, dict]:
    """Standard-normal draws for :func:`seed_population`: one float32 array
    [n, ...] per TechParams and ArchParams field, in field order, from
    ``numpy.random.default_rng(key)``."""
    rng = np.random.default_rng(key)
    shapes = [{f: tuple(getattr(t, f).shape) for f in _fields(cls)}
              for cls, t in zip(_TREES, (TechParams.default("cpu"), ArchParams.default("cpu")))]
    return tuple({f: rng.standard_normal((n,) + s, dtype=np.float32) for f, s in sh.items()} for sh in shapes)


def seed_population(
    n: int,
    seeds: tuple[str, ...] = ("base", "edge", "datacenter"),
    key: int | None = None,
    sigma: float = 0.25,
    noise: tuple | None = None,
    device=None,
) -> tuple[tuple[TechParams, ArchParams], ArchSpec, tuple[str, ...]]:
    """[P]-stacked (tech, arch) start points from named ``.dhd`` library
    architectures, round-robin over ``seeds`` with log-normal jitter.

    The first ``len(seeds)`` members are the pristine library designs
    (jitter only applies from the second pass over the seed list), so every
    described architecture is always present in the population exactly as
    written.  Jittered points are clamped into the Alg.-6 bounds.  All
    seeds must share one ArchSpec: members share one static spec.

    ``noise`` is ``(tech_noise, arch_noise)``, each holding one
    standard-normal array [n, ...] per field (a dict or an object with the
    fields as attributes); member i's leaf moves by ``sigma * noise[i]`` in
    log space.  Without it, :func:`jitter_noise` draws it from ``key``
    (default 0).
    """
    if n < len(seeds):
        raise ValueError(f"population {n} smaller than seed list {seeds}")
    dev = resolve_device(device)
    cas = [load_arch(nm, dev) for nm in seeds]
    spec = cas[0].spec
    for nm, ca in zip(seeds, cas):
        if ca.spec != spec:
            raise ValueError(
                f"seed {nm!r} has ArchSpec {ca.spec}, expected {spec} "
                f"(population members share one static spec)"
            )
    member_names = tuple(seeds[i % len(seeds)] for i in range(n))
    jittered = torch.tensor([i >= len(seeds) for i in range(n)], device=dev)
    if noise is None:
        noise = jitter_noise(n, 0 if key is None else key)

    def jitter(cls, tree, bounds, draws):
        lo, hi = (to_log(b) for b in bounds)
        out = {}
        for f in _fields(cls):
            leaf = getattr(tree, f)
            z = sigma * _tensor(_draw(draws, f), dev)
            if z.shape != leaf.shape:
                raise ValueError(f"seed_population: noise for {f} is {tuple(z.shape)}, want {tuple(leaf.shape)}")
            moved = torch.exp(torch.minimum(torch.maximum(torch.log(leaf) + z, getattr(lo, f)), getattr(hi, f)))
            # pristine seeds bypass the log round-trip entirely: the first
            # pass over the seed list is the library design, bit for bit
            out[f] = torch.where(per_member(jittered, leaf), moved, leaf)
        return cls(**out)

    tech = stack_trees([cas[i % len(cas)].tech for i in range(n)])
    arch = stack_trees([cas[i % len(cas)].arch for i in range(n)])
    return ((jitter(TechParams, tech, TechParams.bounds(dev), noise[0]),
             jitter(ArchParams, arch, ArchParams.bounds(dev), noise[1])), spec, member_names)


def sample_objective_mixes(
    n: int,
    metrics: tuple[str, ...] = ("time", "energy", "area"),
    key: int | None = None,
    concentration: float = 0.7,
    draws=None,
    device=None,
) -> torch.Tensor:
    """[P, 4] PARETO_METRICS weight vectors, one objective mix per member.

    The first ``len(metrics)`` members get deterministic one-hot corners
    (pure latency, pure energy, ...), so the frontier's extreme points are
    always descended; the rest take Dirichlet(``concentration``) mixes over
    the chosen metric subset (concentration < 1 biases toward edges of the
    simplex — spread, not consensus).  ``draws`` [n, len(metrics)] are those
    Dirichlet draws; without them they are drawn from
    ``numpy.random.default_rng(key)`` (default 1).
    """
    idx = [PARETO_METRICS.index(m) for m in metrics]
    if draws is None:
        rng = np.random.default_rng(1 if key is None else key)
        draws = rng.dirichlet(np.full(len(idx), concentration), size=n)
    draws = np.array(draws, np.float32)
    if draws.shape != (n, len(idx)):
        raise ValueError(f"sample_objective_mixes: draws {draws.shape}, want {(n, len(idx))}")
    k = min(n, len(idx))
    draws[:k] = np.eye(len(idx), dtype=np.float32)[:k]
    w = np.zeros((n, len(PARETO_METRICS)), np.float32)
    w[:, idx] = draws
    return torch.as_tensor(w, device=resolve_device(device))


# --------------------------------------------------------------------------- #
# the population chunk: P trajectories x n epochs, one host copy
# --------------------------------------------------------------------------- #


def init_population_state(tech: TechParams, arch: ArchParams):
    """Optimizer state for [P]-stacked params: per-member log-space params +
    per-member Adam moments (each AdamState.step is [P])."""
    tech_z, arch_z = to_log(tech), to_log(arch)

    def adam(z):
        step = torch.zeros((_members(z),), dtype=torch.int32, device=z.leaves()[0].device)
        return AdamState(m=z.map(torch.zeros_like), v=z.map(torch.zeros_like), step=step)

    return (tech_z, arch_z, adam(tech_z), adam(arch_z))


def _state_leaves(state) -> list[torch.Tensor]:
    tech_z, arch_z, ts, as_ = state
    return [*tech_z.leaves(), *arch_z.leaves(), *ts.m.leaves(), *ts.v.leaves(), ts.step,
            *as_.m.leaves(), *as_.v.leaves(), as_.step]


def _population_step(state, mixes, gstack: Graph, lr, penalty_w, spec, mcfg, opt_over, log_bounds):
    """One epoch of every member — member for member, dopt's step (same loss
    for a one-hot mix, same Adam, same log-space Alg.-6 clamp), which is what
    the population-vs-sequential equivalence tests pin.

    Non-finite containment per member: if a member's loss or gradients go
    non-finite, its parameter/Adam update (step included) is rolled back, so
    the member freezes at its last finite state while the rest keep
    descending — one diverging trajectory cannot poison its neighbours or the
    final front.  Returns (state', rows [P, 5])."""
    tech_z, arch_z, tstate, astate = state
    weights, area_budget, power_budget = mixes
    dev = tech_z.leaves()[0].device
    tz = tech_z.map(lambda x: x.detach().requires_grad_(True))
    az = arch_z.map(lambda x: x.detach().requires_grad_(True))
    with torch.enable_grad():
        with instrument.span("popsim.forward", dev):
            val, perfs = mixed_log_objective(
                _against_workloads(from_log(tz)), _against_workloads(from_log(az)), gstack, weights, area_budget,
                power_budget, penalty_w, spec, mcfg,
            )
            loss = val.sum()
        wrt = tz.leaves() + az.leaves()
        with instrument.span("popsim.backward", dev):
            grads = torch.autograd.grad(loss, wrt, allow_unused=True)
    with instrument.span("popsim.update", dev):
        grads = [torch.zeros_like(x) if g is None else g for x, g in zip(wrt, grads)]
        val = val.detach()
        ok = torch.isfinite(val)
        for g in grads:
            ok = ok & torch.isfinite(g).reshape(g.shape[0], -1).all(1)
        it = iter(grads)
        g_t, g_a = tech_z.map(lambda _: next(it)), arch_z.map(lambda _: next(it))

        if opt_over in ("tech", "both"):
            upd, tstate = adam_update(g_t, tstate, lr)
            tech_z = tech_z.map(lambda p, u: p + u, upd)
        if opt_over in ("arch", "both"):
            upd, astate = adam_update(g_a, astate, lr)
            arch_z = arch_z.map(lambda p, u: p + u, upd)
        tech_z = clamp_params(tech_z, *log_bounds[0])
        arch_z = clamp_params(arch_z, *log_bounds[1])
        cand = (tech_z, arch_z, tstate, astate)
        kept = [torch.where(per_member(ok, new), new, old)
                for new, old in zip(_state_leaves(cand), _state_leaves(state))]
        # per-epoch row: [scalarized value, log time, log energy, log area, log edp]
        row = torch.cat([val[:, None], stacked_log_metrics(perfs).detach()], -1)
    return _unflatten_state(state, kept), row


def _unflatten_state(like, leaves: list[torch.Tensor]):
    it = iter(leaves)
    tech_z, arch_z, ts, as_ = like
    t = tech_z.map(lambda _: next(it))
    a = arch_z.map(lambda _: next(it))
    ts = AdamState(m=ts.m.map(lambda _: next(it)), v=ts.v.map(lambda _: next(it)), step=next(it))
    as_ = AdamState(m=as_.m.map(lambda _: next(it)), v=as_.v.map(lambda _: next(it)), step=next(it))
    return (t, a, ts, as_)


def _epochs(state, mixes, gstack: Graph, lr, pw_schedule, spec, mcfg, opt_over):
    """Every epoch of ``pw_schedule`` on the state's device, member for member:
    (state', history [n, P, 5] on the device)."""
    dev = state[0].leaves()[0].device
    f32 = lambda x: _tensor(x, dev)  # noqa: E731
    mixes = tuple(f32(x) for x in mixes)
    lr, pw_schedule = f32(lr), f32(pw_schedule).reshape(-1)
    gstack = gstack.to(dev)
    log_bounds = (tuple(to_log(b) for b in TechParams.bounds(dev)),
                  tuple(to_log(b) for b in ArchParams.bounds(dev)))
    rows = []
    for i in range(pw_schedule.shape[0]):
        with instrument.span("popsim.epoch", dev):
            state, row = _population_step(state, mixes, gstack, lr, pw_schedule[i], spec, mcfg, opt_over,
                                          log_bounds)
        rows.append(row)
    return state, (torch.stack(rows) if rows else torch.zeros((0, _members(state[0]), 5), device=dev))


def population_chunk(
    state,
    mixes,
    gstack: Graph,
    lr,
    pw_schedule,
    *,
    spec: ArchSpec = ArchSpec(),
    mcfg: MapperCfg = MapperCfg(),
    opt_over: str = "both",
    mesh=None,
    axis: str = "pop",
):
    """Advance ``P`` independent Adam trajectories ``len(pw_schedule)``
    epochs back to back on the state's device.

    * ``state``: ``init_population_state`` output (not changed; the advanced
      state is returned);
    * ``mixes``: ``(weights [P,4], area_budget [P], power_budget [P])``;
    * ``pw_schedule`` [n]: per-epoch budget-penalty weight (the constraint
      schedule), read on the device;
    * ``mesh``/``axis``: split the members over dim ``axis`` of a
      ``DeviceMesh`` (:func:`population_chunk_sharded`, whose docstring gives
      the layout it takes and returns); the dim's size must divide P.
      ``mesh=None``, or a mesh of one rank, runs the plain path.

    Returns ``(state', metrics)``: ``metrics`` is the [n, P, 5] float32
    numpy history, per-epoch rows ``[scalarized value, log time, log energy,
    log area, log edp]``, copied to the host once.

    Traced, the call is span ``popsim.chunk``: a ``popsim.epoch`` each epoch,
    then ``popsim.readback`` (:mod:`repro_torch.instrument`).
    """
    with instrument.span("popsim.chunk", state[0].leaves()[0].device):
        if opt_over not in ("tech", "arch", "both"):
            # the population engine has no DOpt2 type-logits state; an unknown
            # opt_over would otherwise run a full descent that never moves
            raise ValueError(
                f"opt_over={opt_over!r} not supported by the population engine "
                "(use 'tech', 'arch' or 'both'; DOpt2 'both+types' is optimize()-only)"
            )
        if mesh is not None and mesh.size() > 1:
            names = tuple(mesh.mesh_dim_names)
            if axis not in names:
                raise ValueError(f"mesh has axes {names}, no {axis!r} axis")
            p, shards = _members(state[0]), mesh.size(names.index(axis))
            if p % shards != 0:
                raise ValueError(
                    f"mesh axis {axis!r}={shards} must divide the population (got P={p}) — "
                    f"pad the population to a multiple of {shards}"
                )
            return population_chunk_sharded(state, mixes, gstack, lr, pw_schedule, spec=spec, mcfg=mcfg,
                                            opt_over=opt_over, mesh=mesh, axis=axis)
        state, rows = _epochs(state, mixes, gstack, lr, pw_schedule, spec, mcfg, opt_over)
        with instrument.span("popsim.readback", rows.device):
            return state, rows.cpu().numpy()


def population_chunk_sharded(
    state,
    mixes,
    gstack: Graph,
    lr,
    pw_schedule,
    *,
    spec: ArchSpec = ArchSpec(),
    mcfg: MapperCfg = MapperCfg(),
    opt_over: str = "both",
    mesh,
    axis: str = "pop",
):
    """:func:`population_chunk` with the members split over dim ``axis`` of
    ``mesh`` (any ``DeviceMesh`` that has it, one rank included): under a
    ``local_map``, each rank advances its contiguous block of members
    through the same epochs, with ``gstack``, ``lr`` and the schedule whole.
    Members are independent, so the one collective is the gather of the
    [n, P, 5] history, which every rank returns whole.

    Layout.  A leaf of ``state`` or ``mixes`` is either a plain tensor (or
    array), whole on every rank, of which each rank keeps its block, or a
    DTensor split so.  The returned state's leaves are DTensors,
    ``Shard(0)`` on ``axis`` and ``Replicate`` on every other mesh dim (and
    on ``axis`` when it has one rank), which the next call takes as they are.
    """
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.models.sharding import Spec, distribute, to_placements

    leaves = [distribute(x, mesh, Spec(axis)) for x in _state_leaves(state)]
    dev = leaves[0].device
    mixes = [distribute(_tensor(x, dev), mesh, Spec(axis)) for x in mixes]
    members, history = to_placements(Spec(axis), mesh), to_placements(Spec(None, axis), mesh)
    n = len(leaves)

    def body(*flat):
        st, rows = _epochs(_unflatten_state(state, list(flat[:n])), flat[n:], gstack, lr, pw_schedule, spec, mcfg,
                           opt_over)
        return (*_state_leaves(st), rows)

    out = local_map(body, out_placements=(members,) * n + (history,), in_placements=(members,) * (n + 3),
                    device_mesh=mesh)(*leaves, *mixes)
    with instrument.span("popsim.readback", dev):
        return _unflatten_state(state, list(out[:n])), out[n].full_tensor().cpu().numpy()


def population_log_metrics(
    tech: TechParams,
    arch: ArchParams,
    gstack: Graph,
    spec: ArchSpec = ArchSpec(),
    mcfg: MapperCfg = MapperCfg(),
):
    """Final-population evaluation: per-member ``[P, 4]`` log-metric vectors
    plus the worst-case-over-workloads raw area [P] and power [P] the budget
    feasibility check is defined on (matching dsim.budget_penalty).  Traced,
    the call is span ``popsim.log_metrics``, holding ``dsim.simulate``."""
    with torch.no_grad(), instrument.span("popsim.log_metrics", tech.node.device):
        perfs = simulate_stacked(_against_workloads(tech), _against_workloads(arch), gstack, spec, mcfg)
        return stacked_log_metrics(perfs), torch.amax(perfs.area, -1), torch.amax(perfs.power, -1)


# --------------------------------------------------------------------------- #
# the driver: seed -> descend -> Pareto front -> .dhd winners
# --------------------------------------------------------------------------- #


@dataclass
class ParetoResult:
    tech: TechParams  # [P] final technology params
    arch: ArchParams  # [P] final architecture params
    spec: ArchSpec
    seeds: tuple[str, ...]  # per-member seed architecture names
    weights: np.ndarray  # [P, 4] objective mixes
    area_budget: np.ndarray  # [P]
    power_budget: np.ndarray  # [P]
    history: np.ndarray  # [steps, P, 5]: value + log metrics per epoch
    log_metrics: np.ndarray  # [P, 4] final log-metric vectors
    area: np.ndarray  # [P] final worst-case area (mm^2)
    power: np.ndarray  # [P] final worst-case power (W)
    feasible: np.ndarray  # [P] bool: meets budgets within tolerance
    front: np.ndarray  # indices of the non-dominated feasible subset
    front_log_metrics: np.ndarray  # [F, len(metrics)] points the front lives on
    hypervolume: float  # MC hypervolume of the front (log-metric space)
    hv_lo: np.ndarray  # sample-box lower corner the hypervolume used
    hv_ref: np.ndarray  # reference point (box upper corner) the hypervolume used
    winners: list  # one dict per front member, incl. serialized .dhd text


def pareto_dse(
    graphs: list[Graph] | Graph,
    seeds: tuple[str, ...] = ("base", "edge", "datacenter"),
    population: int = 24,
    steps: int = 24,
    lr: float = 0.1,
    metrics: tuple[str, ...] = ("time", "energy", "area"),
    area_budget: float | None = None,
    power_budget: float | None = None,
    penalty_weight: tuple[float, float] = (0.25, 4.0),
    budget_tol: float = 0.05,
    opt_over: str = "both",
    sigma: float = 0.25,
    concentration: float = 0.7,
    chunk: int | None = None,
    spec_override: ArchSpec | None = None,
    mcfg: MapperCfg = MapperCfg(),
    mesh=None,
    key: int = 0,
    hv_box: tuple | None = None,
    noise: tuple | None = None,
    mix_draws=None,
    hv_samples=None,
    device=None,
) -> ParetoResult:
    """Population-scale constrained multi-objective DSE.

    Seeds ``population`` members from the ``.dhd`` library (+ log-space
    jitter), gives each its own objective mix over ``metrics`` (and the
    shared area/power budgets), advances all trajectories on the device
    with the budget-penalty weight ramped geometrically across
    ``penalty_weight = (start, end)``, then extracts the feasible
    non-dominated front, its hypervolume, and serializes every winner back
    to canonical ``.dhd`` text.

    ``chunk`` bounds epochs per host copy of the history (default: all
    ``steps`` in one — the penalty schedule is a per-epoch tensor, so
    chunking is only a host-visibility knob, not a semantic one).

    ``hv_box`` optionally fixes the hypervolume sample box as ``(lo, ref)``
    arrays in the selected log-metric space.  The default box is derived
    from this run's feasible points, which is fine for a single frontier
    but NOT comparable across runs — pass a common box (e.g. derived from
    the seed designs) when tracking hypervolume as a trend metric; the box
    used is always recorded in ``hv_lo``/``hv_ref``.

    The random draws: ``noise`` (see :func:`seed_population`), ``mix_draws``
    (the Dirichlet draws of :func:`sample_objective_mixes`) and
    ``hv_samples`` (the hypervolume's [n, len(metrics)] unit samples).  Each
    one not given is drawn from its own child of ``numpy.random.SeedSequence(key)``.

    ``mesh`` (a ``DeviceMesh`` with a ``pop`` dim) splits the members of
    every chunk over that dim (:func:`population_chunk`).  The draws are made
    whole on every rank, each rank descends its own members, and the final
    members are gathered before the front, the hypervolume and the winners'
    ``.dhd`` text, so every rank returns the same result.

    ``graphs`` may also be an already ``Graph.stack()``-ed workload set
    (leading [W] axis).  Everything runs on ``device`` (the card unless the
    caller names another).
    """
    dev = resolve_device(device)
    gstack = _stack_graphs(graphs, dev)
    k_seed, k_mix, k_hv = np.random.SeedSequence(key).spawn(3)

    (tech0, arch0), spec, member_seeds = seed_population(
        population, seeds, sigma=sigma,
        noise=jitter_noise(population, k_seed) if noise is None else noise, device=dev)
    if spec_override is not None:
        spec = spec_override
    weights = sample_objective_mixes(population, metrics, k_mix, concentration, draws=mix_draws, device=dev)
    inf = float("inf")
    ab = torch.full((population,), inf if area_budget is None else area_budget, dtype=torch.float32, device=dev)
    pb = torch.full((population,), inf if power_budget is None else power_budget, dtype=torch.float32, device=dev)
    mixes = (weights, ab, pb)

    w0, w1 = penalty_weight
    pw_schedule = torch.as_tensor(np.geomspace(max(w0, 1e-6), max(w1, 1e-6), steps).astype(np.float32), device=dev)

    state = init_population_state(tech0, arch0)
    rows = []
    done = 0
    step_per_chunk = steps if chunk is None else max(1, chunk)
    while done < steps:
        n = min(step_per_chunk, steps - done)
        state, m = population_chunk(state, mixes, gstack, lr, pw_schedule[done:done + n],
                                    spec=spec, mcfg=mcfg, opt_over=opt_over, mesh=mesh)
        rows.append(m)
        done += n
    history = np.concatenate(rows, axis=0) if rows else np.zeros((0, population, 5), np.float32)

    tech, arch = (from_log(z.map(lambda x: x.full_tensor() if isinstance(x, DTensor) else x)) for z in state[:2])
    logm, area, power = (x.cpu().numpy() for x in population_log_metrics(tech, arch, gstack, spec, mcfg))

    tol = 1.0 + budget_tol
    # a member whose final metrics are non-finite (a divergence the in-step
    # freeze could not mask, or corrupted evaluation) is infeasible by
    # definition — it must never reach the front or the hypervolume box
    finite = np.isfinite(logm).all(axis=1) & np.isfinite(area) & np.isfinite(power)
    feasible = finite & (area <= ab.cpu().numpy() * tol) & (power <= pb.cpu().numpy() * tol)
    midx = [PARETO_METRICS.index(m) for m in metrics]
    pts = torch.as_tensor(logm[:, midx], device=dev)
    front = np.nonzero(non_dominated_mask(pts, torch.as_tensor(feasible, device=dev)).cpu().numpy())[0]

    if front.size:
        fpts = pts[torch.as_tensor(front, device=dev)]
        if hv_box is not None:
            lo, ref = (torch.as_tensor(np.asarray(b, np.float32), device=dev) for b in hv_box)
        else:
            feas_pts = pts[torch.as_tensor(np.nonzero(feasible)[0], device=dev)] if feasible.any() else pts
            ref = hv_ref_point(feas_pts)
            lo = torch.minimum(torch.amin(feas_pts, 0), ref)
        u = unit_samples(16384, len(metrics), k_hv) if hv_samples is None else hv_samples
        hv = float(hypervolume(fpts, ref, lo=lo, samples=u))
        hv_lo, hv_ref = lo.cpu().numpy(), ref.cpu().numpy()
        front_pts = fpts.cpu().numpy()
    else:
        hv = 0.0
        hv_lo = hv_ref = np.full(len(metrics), np.nan)
        front_pts = np.zeros((0, len(metrics)), np.float32)

    weights_np = weights.cpu().numpy()
    winners = []
    for i in front.tolist():
        text = serialize_arch(name=f"pareto_{member_seeds[i]}_{i}", spec=spec,
                              arch=arch.map(lambda x: x[i]), tech=tech.map(lambda x: x[i]))
        winners.append(
            dict(
                index=i,
                seed=member_seeds[i],
                weights={m: float(weights_np[i, j]) for j, m in enumerate(PARETO_METRICS)},
                time_s=float(np.exp(logm[i, 0])),
                energy_j=float(np.exp(logm[i, 1])),
                area_mm2=float(area[i]),
                power_w=float(power[i]),
                edp=float(np.exp(logm[i, 3])),
                dhd=text,
            )
        )

    return ParetoResult(
        tech=tech,
        arch=arch,
        spec=spec,
        seeds=member_seeds,
        weights=weights_np,
        area_budget=ab.cpu().numpy(),
        power_budget=pb.cpu().numpy(),
        history=history,
        log_metrics=logm,
        area=area,
        power=power,
        feasible=feasible,
        front=front,
        front_log_metrics=front_pts,
        hypervolume=hv,
        hv_lo=hv_lo,
        hv_ref=hv_ref,
        winners=winners,
    )


# --------------------------------------------------------------------------- #
# legacy single-objective population helpers
# --------------------------------------------------------------------------- #


def init_population(key: int, n: int, sigma: float = 0.3, noise: tuple | None = None, device=None):
    """n jittered copies of the default design point (log-normal): member i's
    leaf is ``exp(log(default) + sigma * noise[i])``, ``noise`` as in
    :func:`seed_population` (drawn from ``key`` when not given)."""
    dev = resolve_device(device)
    noise = jitter_noise(n, key) if noise is None else noise
    out = []
    for cls, tree, draws in zip(_TREES, (TechParams.default(dev), ArchParams.default(dev)), noise):
        out.append(cls(**{f: torch.exp(torch.log(getattr(tree, f))[None] + sigma * _tensor(_draw(draws, f), dev))
                          for f in _fields(cls)}))
    return tuple(out)


def population_objective(pop, graphs: Graph, objective: str = "edp", spec: ArchSpec = ArchSpec(),
                         mcfg: MapperCfg = MapperCfg()):
    """[P] objectives for a population ``(tech, arch)`` against stacked
    workloads.

    ``graphs``: a Graph whose arrays carry a leading workload axis W (padded
    to equal vertex count; see Graph.pad_to).  Result is the mean log
    objective across workloads, per candidate.
    """
    tech, arch = pop
    val, _ = stacked_log_objective(_against_workloads(tech), _against_workloads(arch), graphs, objective,
                                   spec=spec, mcfg=mcfg)
    return val


def _mesh_population_objective(pop, graphs: Graph, mesh, objective: str = "edp", spec: ArchSpec = ArchSpec(),
                               mcfg: MapperCfg = MapperCfg()):
    """:func:`population_objective` of DTensor members against DTensor
    workloads (as :func:`lay_out_dse_inputs` places them) on ``mesh``: a
    ``local_map`` body simulates each rank's members against its workloads
    and takes their mean; where the workloads are split over mesh dims, the
    members' objective is the mean of those local means, one all-reduce over
    those dims, and each member's gradient leaves the body as a partial sum
    over them (reduced once, where the caller redistributes it).  Returns
    the [P] objectives laid out as the members are."""
    from torch.distributed.tensor import Partial
    from torch.distributed.tensor.experimental import local_map

    tech, arch = pop
    members = tuple(tech.leaves()[0].placements)
    gleaves = [getattr(graphs, f) for f in DATA_FIELDS]
    split = [d for d, p in enumerate(gleaves[0].placements) if p.is_shard()]
    out = tuple(Partial() if d in split else p for d, p in enumerate(members))
    nt, na = len(tech.leaves()), len(arch.leaves())
    n = math.prod(mesh.size(d) for d in split)

    def body(*flat):
        it = iter(flat)
        t, a = tech.map(lambda _: next(it)), arch.map(lambda _: next(it))
        g = Graph(**{f: next(it) for f in DATA_FIELDS})
        perfs = simulate_stacked(_against_workloads(t), _against_workloads(a), g, spec, mcfg)
        mean = torch.mean(torch.log(objective_value(perfs, objective)), -1)
        return mean if n == 1 else mean / n  # this rank's share of the mean of the n local means

    workloads = tuple(tuple(x.placements) for x in gleaves)
    fn = local_map(body, out_placements=(out,), in_placements=(members,) * (nt + na) + workloads,
                   in_grad_placements=(out,) * (nt + na) + workloads, device_mesh=mesh)
    val = fn(*tech.leaves(), *arch.leaves(), *gleaves)
    return val if n == 1 else val.redistribute(mesh, members)


def make_dse_step(objective: str = "edp", lr: float = 0.05, spec: ArchSpec = ArchSpec(), mesh=None):
    """One population gradient-descent epoch: grads in log-space, SGD update.

    With ``mesh`` the step takes its inputs laid out by
    :func:`dse_in_shardings` (plain tensors are laid out first) and computes
    the objective with :func:`_mesh_population_objective`: the workload mean
    is a collective over "model", forward and backward."""

    def objective_of(p, graphs):
        if mesh is None:
            return population_objective(p, graphs, objective, spec)
        return _mesh_population_objective(p, graphs, mesh, objective, spec)

    def dse_step(pop, graphs: Graph):
        if mesh is not None:
            pop, graphs = lay_out_dse_inputs(mesh, pop, graphs)
        pop_z = tuple(to_log(t).map(lambda x: x.detach().requires_grad_(True)) for t in pop)
        with torch.enable_grad():
            loss = torch.sum(objective_of(tuple(from_log(z) for z in pop_z), graphs))
            wrt = [x for z in pop_z for x in z.leaves()]
            grads = iter(torch.autograd.grad(loss, wrt, allow_unused=True))
        new_z = tuple(z.map(lambda p: p.detach() - lr * _grad_of(next(grads), p)) for z in pop_z)
        new_pop = tuple(from_log(z) for z in new_z)
        with torch.no_grad():
            return new_pop, objective_of(new_pop, graphs)

    return dse_step


def _grad_of(g, p: torch.Tensor) -> torch.Tensor:
    """``p``'s gradient laid out as ``p`` is (a partial sum reduced; zeros where unused)."""
    if g is None:
        return torch.zeros_like(p)
    return g.redistribute(p.device_mesh, p.placements) if isinstance(g, DTensor) else g


def _member_spec(mesh, pop_axes=("pod", "data")):
    from repro_torch.models.sharding import Spec, axis_names

    return Spec(tuple(a for a in pop_axes if a in axis_names(mesh)) or None)


def shard_population(mesh, pop, pop_axes=("pod", "data")):
    """The population ``(tech, arch)`` as DTensors on ``mesh``, the members
    split over the dims of ``pop_axes`` it has (their product)."""
    from repro_torch.models.sharding import distribute

    s = _member_spec(mesh, pop_axes)
    return tuple(t.map(lambda x: distribute(x, mesh, s)) for t in pop)


def dse_in_shardings(mesh, pop, graphs: Graph):
    """The ``models.sharding.Spec`` trees the DSE step's inputs are laid out
    by: every member leaf over ("pod", "data") where the mesh has them; a
    workload leaf over "model" where the mesh has it and its size divides
    the leaf's leading dim, else replicated (so a mesh without "model"
    replicates the workloads).  Any mesh with ``.shape`` and
    ``.axis_names``, or a ``DeviceMesh``."""
    from repro_torch.models.sharding import Spec, mesh_axes

    pop_s = tuple(t.map(lambda _: _member_spec(mesh)) for t in pop)
    w = mesh_axes(mesh).get("model", 0)

    def spec(x):
        return Spec("model") if w and x.ndim >= 1 and x.shape[0] % w == 0 else Spec()

    return pop_s, Graph(**{f: spec(getattr(graphs, f)) for f in DATA_FIELDS}, names=graphs.names)


def lay_out_dse_inputs(mesh, pop, graphs: Graph):
    """``(pop, graphs)`` as DTensors on ``mesh``, laid out by
    :func:`dse_in_shardings` (a DTensor already so laid out is kept)."""
    from repro_torch.models.sharding import distribute

    g_s = dse_in_shardings(mesh, pop, graphs)[1]
    return shard_population(mesh, pop), Graph(
        **{f: distribute(getattr(graphs, f), mesh, getattr(g_s, f)) for f in DATA_FIELDS}, names=graphs.names)
