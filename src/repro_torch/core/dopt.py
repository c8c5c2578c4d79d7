"""DOpt — the hardware optimizer (paper §7, Appendix A/B).

Gradient descent on the *joint* space of technology and architectural
parameters, through the differentiable mapper.  One forward (simulate) +
backward (grad) = one epoch (paper §7).  Features:

  * objectives: time / energy / edp / power, optional area constraint
    F = obj * e^(a-A) (paper §11.3 / Appendix C), or the "mixed"
    constrained scalarization of the (time, energy, area, edp) metrics;
  * optimization over tech params, arch params, or both;
  * log-space Adam (positive parameters, multiplicative updates) with
    realistic bounds clamping (paper Alg. 6 step 5);
  * DOpt2: differentiable memory-technology selection via a softmax over
    {sram, rram, dram} per memory unit, with the logits' learning rate x4;
  * non-finite containment: an epoch whose loss or gradients are not
    finite is rolled back and halves the learning rate.

The whole epoch stays on the device: the containment test, the rollback and
the history row are tensor selects, so the fused driver copies to the host
once per chunk of epochs.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.dsim import PARETO_METRICS, mixed_log_objective, stacked_log_objective
from repro_torch.core.graph import Graph
from repro_torch.core.mapper import MapperCfg
from repro_torch.core.params import (
    COMP_CLS,
    MEM_CLS,
    MEM_TYPES,
    ArchParams,
    ArchSpec,
    TechParams,
    clamp_params,
    per_member,
)
from repro_torch.kernels.runtime import resolve_device

# --------------------------------------------------------------------------- #
# log-space Adam over tensor trees
# --------------------------------------------------------------------------- #


@dataclass
class AdamState:
    m: object
    v: object
    step: torch.Tensor  # int32 on the device: a scalar, or [P] for a population (one step a member)


def _tmap(fn, tree, *rest):
    """``map`` over a TensorTree, or over a bare tensor."""
    if torch.is_tensor(tree):
        return fn(tree, *rest)
    return tree.map(fn, *rest)


def _leaves(tree) -> list[torch.Tensor]:
    return [tree] if torch.is_tensor(tree) else tree.leaves()


def adam_init(params) -> AdamState:
    dev = _leaves(params)[0].device
    return AdamState(m=_tmap(torch.zeros_like, params), v=_tmap(torch.zeros_like, params),
                     step=torch.zeros((), dtype=torch.int32, device=dev))


def adam_update(grads, state: AdamState, lr, b1=0.9, b2=0.999, eps=1e-8):
    """One Adam step.  A [P] step (a population's) corrects each leaf's bias
    by the leaf's leading axis, member by member."""
    step = state.step + 1
    stepf = step.to(torch.float32)
    c1 = 1 - torch.pow(torch.full_like(stepf, b1), stepf)
    c2 = 1 - torch.pow(torch.full_like(stepf, b2), stepf)
    m = _tmap(lambda m, g: b1 * m + (1 - b1) * g, state.m, grads)
    v = _tmap(lambda v, g: b2 * v + (1 - b2) * g * g, state.v, grads)
    mh = _tmap(lambda m: m / per_member(c1, m), m)
    vh = _tmap(lambda v: v / per_member(c2, v), v)
    upd = _tmap(lambda m, v: -lr * m / (torch.sqrt(v) + eps), mh, vh)
    return upd, AdamState(m=m, v=v, step=step)


def to_log(p):
    return _tmap(lambda x: torch.log(torch.maximum(x, torch.full_like(x, 1e-30))), p)


def from_log(z):
    return _tmap(torch.exp, z)


# --------------------------------------------------------------------------- #
# parameter naming (for importance ranking / Table 3)
# --------------------------------------------------------------------------- #

_TECH_FIELD_CLASSES = {
    "mem_wire_cap": MEM_CLS,
    "mem_wire_resist": MEM_CLS,
    "cell_read_latency": MEM_CLS,
    "cell_access_device": MEM_CLS,
    "cell_read_power": MEM_CLS,
    "cell_leakage_power": MEM_CLS,
    "cell_area": MEM_CLS,
    "peripheral_node": MEM_CLS,
    "comp_wire_cap": COMP_CLS,
    "comp_wire_resist": COMP_CLS,
    "node": COMP_CLS,
}


def tech_param_names() -> list[str]:
    names = []
    for f in dataclasses.fields(TechParams):
        for cls in _TECH_FIELD_CLASSES[f.name]:
            names.append(f"{cls}.{f.name}")
    return names


# --------------------------------------------------------------------------- #
# DOpt driver
# --------------------------------------------------------------------------- #


@dataclass
class OptResult:
    tech: TechParams
    arch: ArchParams
    type_weights: torch.Tensor | None
    history: dict  # lists per metric
    importance: list[tuple[str, float]]  # ranked tech-parameter elasticities


def _default_chunk(steps: int, target_factor) -> int:
    """Epochs per host copy of the history.

    Equal-size chunks (ceil-divided against a cap), e.g. 200 steps -> 4x50,
    60 steps -> 2x30; with ``target_factor`` a smaller cap bounds how far
    past the target a chunk can run before the boundary check."""
    if steps <= 0:  # steps=0 is a valid no-op run (baseline read)
        return 1
    cap = 25 if target_factor is not None else 50
    n_chunks = -(-steps // cap)
    return -(-steps // n_chunks)


@dataclass
class _DoptState:
    """Everything one epoch reads and updates, on the device.  The step
    updates the tensors in place (``copy_``), so the state object a chunk
    starts from is the one it ends with."""

    tech_z: TechParams
    arch_z: ArchParams
    type_logits: torch.Tensor | None
    tstate: AdamState
    astate: AdamState
    ystate: AdamState
    lr_scale: torch.Tensor  # multiplies lr: 1.0 until a fault halves it
    last_metrics: torch.Tensor  # [5] last accepted history row (NaN at first)

    def tensors(self) -> list[torch.Tensor]:
        out = _leaves(self.tech_z) + _leaves(self.arch_z)
        if self.type_logits is not None:
            out.append(self.type_logits)
        for s in (self.tstate, self.astate, self.ystate):
            out += _leaves(s.m) + _leaves(s.v) + [s.step]
        return out + [self.lr_scale, self.last_metrics]


def guard_init(device) -> tuple[torch.Tensor, torch.Tensor]:
    """Initial non-finite-containment guard: ``(lr_scale, last_metrics)``."""
    return (torch.ones((), device=device),
            torch.full((5,), float("nan"), dtype=torch.float32, device=device))


def _dopt_step(st: _DoptState, gstack: Graph, lr, mix, fault, spec, objective, area_constraint,
               opt_over, mcfg, log_bounds) -> tuple[torch.Tensor, torch.Tensor]:
    """One DOpt epoch (forward + backward + Adam + log-space clamp) with
    non-finite containment; updates ``st`` in place and returns
    ``(elasticity, metrics)``.

    ``fault`` is the chaos seam: a positive scalar poisons this epoch's loss
    and gradients with NaN *before* the containment check.  Containment:
    when the loss or any gradient is non-finite, the epoch's parameter/Adam/
    type updates are dropped (the previous state is kept bit-for-bit), the
    ``lr_scale`` halves (recovering 2x per clean epoch, capped at 1.0), the
    elasticity contribution is zeroed, and the history row re-emits the last
    accepted metrics with the trailing fault flag set.
    """
    dopt2 = opt_over == "both+types"
    tz = st.tech_z.map(lambda x: x.detach().requires_grad_(True))
    az = st.arch_z.map(lambda x: x.detach().requires_grad_(True))
    tl = st.type_logits.detach().requires_grad_(True) if dopt2 else None

    with torch.enable_grad():
        tw = None if tl is None else torch.softmax(tl, -1)
        if objective == "mixed":
            w, ab, pb, pw = mix
            val, perfs = mixed_log_objective(from_log(tz), from_log(az), gstack, w, ab, pb, pw, spec, mcfg, tw)
        else:
            val, perfs = stacked_log_objective(
                from_log(tz), from_log(az), gstack, objective, area_constraint, spec, mcfg, tw
            )
        wrt = tz.leaves() + az.leaves() + ([tl] if dopt2 else [])
        flat = torch.autograd.grad(val, wrt, allow_unused=True)
    flat = [torch.zeros_like(x) if g is None else g for x, g in zip(wrt, flat)]
    val = val.detach()

    # chaos seam: an injected fault corrupts loss+grads exactly like a real
    # numeric escape would, upstream of the containment logic
    poison = fault > 0
    nan = torch.full((), float("nan"), device=val.device)
    val = torch.where(poison, nan, val)
    flat = [torch.where(poison, nan, g) for g in flat]
    ok = torch.isfinite(val)
    for g in flat:
        ok = ok & torch.all(torch.isfinite(g))
    nt = len(tz.leaves())
    na = len(az.leaves())
    g_tech = _unflatten(st.tech_z, flat[:nt])
    g_arch = _unflatten(st.arch_z, flat[nt:nt + na])

    tech_z, arch_z, type_logits = st.tech_z, st.arch_z, st.type_logits
    tstate, astate, ystate = st.tstate, st.astate, st.ystate
    lr_eff = lr * st.lr_scale
    if opt_over in ("tech", "both", "both+types"):
        upd, tstate = adam_update(g_tech, tstate, lr_eff)
        tech_z = tech_z.map(lambda p, u: p + u, upd)
    if opt_over in ("arch", "both", "both+types"):
        upd, astate = adam_update(g_arch, astate, lr_eff)
        arch_z = arch_z.map(lambda p, u: p + u, upd)
    if dopt2:
        upd, ystate = adam_update(flat[-1], ystate, lr_eff * 4.0)
        type_logits = type_logits + upd
    # clamp to realistic bounds (paper Alg. 6) — log is monotone, so
    # clamping z against log(bounds) is clamping the parameters
    tech_z = clamp_params(tech_z, *log_bounds[0])
    arch_z = clamp_params(arch_z, *log_bounds[1])

    # history row: [objective, runtime, energy, area, edp] of workload 0,
    # re-emitting the last accepted row on a faulted epoch, + fault flag
    rt, en, ar = perfs.runtime[0].detach(), perfs.energy[0].detach(), perfs.area[0].detach()
    row = torch.where(ok, torch.stack([val, rt, en, ar, rt * en]), st.last_metrics)
    metrics = torch.cat([row, (~ok).to(torch.float32)[None]])
    # elasticity d log obj / d log param = gradient in log space (zeroed on a
    # faulted epoch so the importance accumulator never sees NaN)
    elast = torch.where(ok, g_tech.flatten(), torch.zeros_like(g_tech.flatten()))

    # containment: keep the previous state where anything escaped
    cand = _DoptState(tech_z, arch_z, type_logits, tstate, astate, ystate,
                      torch.where(ok, torch.minimum(st.lr_scale * 2.0, torch.ones_like(st.lr_scale)),
                                  st.lr_scale * 0.5),
                      row)
    with torch.no_grad():
        for old, new in zip(st.tensors(), cand.tensors()):
            if new is old:
                continue
            if old is st.lr_scale or old is st.last_metrics:
                old.copy_(new)  # already selected on ok above
            else:
                old.copy_(torch.where(ok, new, old))
    return elast, metrics


def _unflatten(like, leaves: list[torch.Tensor]):
    it = iter(leaves)
    return like.map(lambda _: next(it))


def optimize(
    graphs: list[Graph] | Graph,
    tech: TechParams | None = None,
    arch: ArchParams | None = None,
    spec: ArchSpec = ArchSpec(),
    objective: str = "edp",
    area_constraint: float | None = None,
    opt_over: str = "both",  # tech | arch | both | both+types (DOpt2)
    steps: int = 200,
    lr: float = 0.05,
    mcfg: MapperCfg = MapperCfg(),
    target_factor: float | None = None,  # stop when obj improves by this factor
    log_every: int = 0,
    fused: bool = True,  # history copied to the host once per chunk (False: per step)
    chunk: int | None = None,  # epochs per host copy when fused
    objective_weights=None,  # [4] PARETO_METRICS mix, for objective="mixed"
    area_budget: float | None = None,  # worst-case area ceiling (mm^2), mixed only
    power_budget: float | None = None,  # worst-case power ceiling (W), mixed only
    penalty_weight: float = 1.0,  # budget-penalty scale, mixed only
    nan_epochs: tuple = (),  # chaos seam: epochs whose loss/grads are NaN-poisoned
    device=None,
) -> OptResult:
    """DOpt driver.

    ``graphs`` may be a single Graph, a list of Graphs, or an already
    ``Graph.stack()``-ed workload set (leading [W] axis).  Everything runs on
    ``device`` (the card unless the caller names another).

    ``fused=True`` (default) runs chunks of epochs back to back on the device
    and copies the stacked [chunk, 6] history to the host once per chunk;
    the ``target_factor`` early exit is evaluated at chunk boundaries, so
    the fused loop may run up to one chunk past the meeting epoch.
    ``fused=False`` copies each epoch's row to the host after the epoch —
    the per-step loop kept for equivalence tests.
    """
    dev = resolve_device(device)
    if isinstance(graphs, Graph):
        gstack = graphs if graphs.n_comp.ndim == 3 else Graph.stack([graphs])
    else:
        gstack = Graph.stack(list(graphs))
    gstack = gstack.to(dev)
    tech = (tech or TechParams.default(dev)).to(dev)
    arch = (arch or ArchParams.default(dev)).to(dev)

    dopt2 = opt_over == "both+types"
    if objective == "mixed" and objective_weights is None:
        raise ValueError('objective="mixed" needs objective_weights (len-4 PARETO_METRICS mix)')
    if objective == "mixed" and area_constraint is not None:
        raise ValueError('objective="mixed" takes area_budget (log-space penalty), not area_constraint')
    if objective != "mixed" and not (
        objective_weights is None and area_budget is None and power_budget is None and penalty_weight == 1.0
    ):
        raise ValueError(
            "objective_weights/area_budget/power_budget/penalty_weight only apply to "
            f'objective="mixed" (got objective={objective!r}) — they would be silently ignored'
        )
    w = (torch.zeros(len(PARETO_METRICS), device=dev) if objective_weights is None
         else torch.as_tensor(np.asarray(objective_weights, np.float32), device=dev))
    if tuple(w.shape) != (len(PARETO_METRICS),):
        raise ValueError(f"objective_weights must be shape {(len(PARETO_METRICS),)}, got {tuple(w.shape)}")
    f32 = lambda x: torch.full((), x, dtype=torch.float32, device=dev)  # noqa: E731
    mix = (
        w,
        f32(float("inf") if area_budget is None else area_budget),
        f32(float("inf") if power_budget is None else power_budget),
        f32(penalty_weight),
    )
    lr_t = f32(lr)
    log_bounds = (tuple(to_log(b) for b in TechParams.bounds(dev)),
                  tuple(to_log(b) for b in ArchParams.bounds(dev)))
    static = dict(spec=spec, objective=objective, area_constraint=area_constraint,
                  opt_over=opt_over, mcfg=mcfg, log_bounds=log_bounds)

    # chaos schedule: which epochs get their loss/grads NaN-poisoned
    fault_np = np.zeros(steps, np.float32)
    for i in nan_epochs:
        if 0 <= int(i) < steps:
            fault_np[int(i)] = 1.0
    faults = torch.as_tensor(fault_np, device=dev)

    tech_z, arch_z = to_log(tech), to_log(arch)
    type_logits = torch.zeros((len(MEM_CLS), len(MEM_TYPES)), device=dev) if dopt2 else None
    st = _DoptState(
        tech_z, arch_z, type_logits, adam_init(tech_z), adam_init(arch_z),
        adam_init(type_logits if dopt2 else torch.zeros(1, device=dev)), *guard_init(dev),
    )
    elast_acc = torch.zeros(len(tech_param_names()), dtype=torch.float32, device=dev)

    hist = dict(objective=[], runtime=[], energy=[], area=[], edp=[], fault=[])

    def _append(m: np.ndarray):
        for j, k in enumerate(hist):
            hist[k] += m[:, j].tolist()

    def _target_met() -> bool:
        """True once the objective has improved by target_factor."""
        if target_factor is None or len(hist["edp"]) < 2:
            return False
        cur = np.asarray(hist["edp"] if objective == "edp" else np.exp(np.asarray(hist["objective"])))
        return bool(np.any(cur[0] / np.maximum(cur[1:], 1e-300) >= target_factor))

    def _log(lo: int, hi: int, every: int):
        for i in range(lo, hi):
            if every and i % every == 0:
                print(
                    f"  dopt step {i:4d}  obj={hist['objective'][i]:.4f} "
                    f"runtime={hist['runtime'][i]:.3e}s energy={hist['energy'][i]:.3e}J"
                )

    executed = 0
    n_chunk = (_default_chunk(steps, target_factor) if chunk is None else max(1, chunk)) if fused else 1
    while executed < steps:
        n = min(n_chunk, steps - executed)
        rows = []
        for i in range(executed, executed + n):
            elast, metrics = _dopt_step(st, gstack, lr_t, mix, faults[i], **static)
            elast_acc += torch.abs(elast)
            rows.append(metrics)
        _append(torch.stack(rows).cpu().numpy())  # the one host copy per chunk
        _log(executed, executed + n, log_every)
        executed += n
        if _target_met():
            break

    elast_mean = elast_acc.double().cpu().numpy() / max(executed, 1)
    ranked = sorted(zip(tech_param_names(), elast_mean), key=lambda kv: -kv[1])
    return OptResult(
        tech=from_log(st.tech_z),
        arch=from_log(st.arch_z),
        type_weights=None if not dopt2 else torch.softmax(st.type_logits, -1),
        history=hist,
        importance=[(n, float(v)) for n, v in ranked],
    )


def derive_tech_targets(
    graphs,
    goal_factor: float = 100.0,
    objective: str = "edp",
    spec: ArchSpec = ArchSpec(),
    steps: int = 400,
    lr: float = 0.05,
    device=None,
) -> dict:
    """paper §8.3: derive technology targets for a goal_factor x improvement.

    Returns the targets (start -> end values per tech parameter), the ranked
    importance order, and the achieved factor — a single gradient-descent
    pass instead of a >1e5-point technology sweep.  Runs on ``device`` (the
    card unless the caller names another).
    """
    dev = resolve_device(device)
    # baseline objective at the default design point: a direct simulate, not
    # a throwaway optimize(steps=1, lr=0) that runs a full gradient step
    if isinstance(graphs, Graph) and graphs.n_comp.ndim == 3:
        gstack = graphs
    else:
        gstack = Graph.stack([graphs] if isinstance(graphs, Graph) else list(graphs))
    with torch.no_grad():
        base_val, _ = stacked_log_objective(
            TechParams.default(dev), ArchParams.default(dev), gstack.to(dev), objective, spec=spec
        )
    start = TechParams.default(dev)
    res = optimize(
        gstack, tech=start, opt_over="tech", objective=objective, steps=steps, lr=lr, spec=spec,
        target_factor=goal_factor, device=dev,
    )
    start_f = start.flatten().cpu().numpy()
    end_f = res.tech.flatten().cpu().numpy()
    names = tech_param_names()
    targets = {
        n: dict(start=float(s), target=float(e), factor=float(s / max(e, 1e-300)))
        for n, s, e in zip(names, start_f, end_f)
    }
    edp0 = res.history["edp"][0]
    edp1 = res.history["edp"][-1]
    return dict(
        targets=targets,
        importance=res.importance,
        achieved_factor=edp0 / max(edp1, 1e-300),
        epochs=len(res.history["edp"]),
        history=res.history,
        baseline_objective=float(base_val),
    )
