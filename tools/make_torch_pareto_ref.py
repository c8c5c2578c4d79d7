"""Make ``tests/data/torch_pareto_ref.npz``: the reference package's Pareto
DSE at the configuration of ``benchmarks/bench_pareto.py``'s full run, with
the random draws it made, so that the PyTorch port can replay the run.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/make_torch_pareto_ref.py [--check-port]

The run: workloads lstm, bert_base and merge_sort stacked at their natural
V_max; seeds base, edge, mobile, datacenter and hbm_class; 32 members, 24
steps, lr 0.1, the penalty weight ramped from 0.25 to 4.0; area and power
budgets and the hypervolume box from the seeds, as the benchmark's
``_seed_budgets`` computes them; key 0.

Stored: the draws (the jitter noise of every TechParams and ArchParams field,
the Dirichlet mixes and the 16,384 x 3 hypervolume unit samples, each
reproduced from the key as the reference draws them), the budgets, the box,
and the result: history [24, 32, 5], final log metrics, area and power,
feasible, front and hypervolume.  ``chip_smoke.py`` holds the port on the
card against this file.

Also stored, per member, the reference's own spread: the largest relative
change of its history (and of its final log metrics) when the same descent
runs through exact reformulations of the same arithmetic — the mapper's
sequential oracle (``scan_impl="ref"``), the workload stack reversed, and the
stack padded with 8 no-op vertices.  A member whose trajectory turns on a
gradient coordinate that float32 cannot resolve (a cancellation whose true
value lies below its rounding noise; Adam's first step turns its sign into a
full ``lr`` step) moves under these; a member that moves by more than the
agreement tolerance under them is not determined by the reference to that
tolerance, and ``chip_smoke.py`` holds it only where it is (the first epoch,
before any step).

``--check-port`` then runs the port on the CPU against the file just written
and prints how far it is from it.  A few minutes on the CPU.

``--gradient-noise MEMBER`` (with the file already written) prints that
member's gradient at the start, coordinate by coordinate, in four
evaluations of the same function: the reference in float32 with its default
mapper and with its sequential one, the port in float32, and the port in
float64 (sequential mapper) as the value float32 rounds; and names the
coordinates whose float32 signs disagree with float64's.
"""
from __future__ import annotations

import argparse
import dataclasses
import pathlib
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from benchmarks.bench_pareto import WORKLOADS, _seed_budgets  # noqa: E402
from repro.api import Session, Workload  # noqa: E402
from repro.core.dopt import from_log  # noqa: E402  # engine-oracle
from repro.core.graph import Graph  # noqa: E402
from repro.core.mapper import MapperCfg  # noqa: E402  # engine-oracle
from repro.core.params import ArchParams, TechParams  # noqa: E402
from repro.core.popsim import (  # noqa: E402  # engine-oracle
    init_population_state,
    pareto_dse,
    population_chunk,
    population_log_metrics,
    sample_objective_mixes,
    seed_population,
)
from repro.workloads import get_workload  # noqa: E402

OUT = ROOT / "tests" / "data" / "torch_pareto_ref.npz"
SEEDS = ("base", "edge", "mobile", "datacenter", "hbm_class")
POPULATION = 32
STEPS = 24
LR = 0.1
PENALTY = (0.25, 4.0)
METRICS = ("time", "energy", "area")
CONCENTRATION = 0.7
SIGMA = 0.25
HV_SAMPLES = 16384
KEY = 0
TREES = (("tech", TechParams), ("arch", ArchParams))


def reference_draws(key: int, population: int, seeds=SEEDS, n_metrics: int = len(METRICS)) -> dict:
    """The draws ``repro.core.popsim.pareto_dse(..., key=key)`` makes, made
    here from the same keys in the same order: the standard-normal jitter
    noise per field (before the ``sigma`` scale), the Dirichlet mixes (before
    the one-hot corners), and the hypervolume's unit samples (PRNGKey(0))."""
    k_seed, k_mix = jax.random.split(jax.random.PRNGKey(key))
    (tech, arch), _, _ = seed_population(population, seeds, k_seed, SIGMA)
    out = {}
    for (tree_name, cls), k, tree in zip(TREES, jax.random.split(k_seed), (tech, arch)):
        keys = jax.random.split(k, len(dataclasses.fields(cls)))
        for f, kk in zip(dataclasses.fields(cls), keys):
            out[f"noise/{tree_name}/{f.name}"] = np.asarray(jax.random.normal(kk, getattr(tree, f.name).shape))
    alpha = jnp.full((n_metrics,), jnp.float32(CONCENTRATION))
    out["mix_draws"] = np.asarray(jax.random.dirichlet(k_mix, alpha, (population,)))
    out["hv_samples"] = np.asarray(jax.random.uniform(jax.random.PRNGKey(0), (HV_SAMPLES, n_metrics)))
    return out


def noise_of(d) -> tuple[dict, dict]:
    """(tech_noise, arch_noise) of a dict of draws, as ``pareto_dse`` takes them."""
    return tuple({f.name: np.asarray(d[f"noise/{t}/{f.name}"]) for f in dataclasses.fields(cls)}
                 for t, cls in TREES)


def reference_spread(graphs, area_b: float, power_b: float, history: np.ndarray,
                     log_metrics: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Per member, the largest relative change of the reference's history and
    final log metrics under exact reformulations of its arithmetic (see the
    module docstring), with the draws, budgets and schedule of ``pareto_dse``."""
    k_seed, k_mix = jax.random.split(jax.random.PRNGKey(KEY))
    (tech, arch), spec, _ = seed_population(POPULATION, SEEDS, k_seed, SIGMA)
    mixes = (sample_objective_mixes(POPULATION, METRICS, k_mix, CONCENTRATION),
             jnp.full((POPULATION,), jnp.float32(area_b)), jnp.full((POPULATION,), jnp.float32(power_b)))
    sched = jnp.asarray(np.geomspace(*PENALTY, STEPS), jnp.float32)
    v_max = max(g.n_vertices for g in graphs)
    variants = {
        "sequential mapper": (Graph.stack(graphs), MapperCfg(scan_impl="ref")),
        "stack reversed": (Graph.stack(graphs[::-1]), MapperCfg()),
        "stack padded by 8": (Graph.stack([g.pad_to(v_max + 8) for g in graphs]), MapperCfg()),
    }
    rel = lambda got, want: np.abs(got - want) / np.maximum(np.abs(want), 1e-30)  # noqa: E731
    s_hist, s_lm = np.zeros(POPULATION), np.zeros(POPULATION)
    for name, (gs, mcfg) in variants.items():
        state, m = population_chunk(init_population_state(tech, arch), mixes, gs, LR, sched, spec=spec, mcfg=mcfg)
        lm = population_log_metrics(from_log(state[0]), from_log(state[1]), gs, spec, mcfg)[0]
        h = rel(np.asarray(m, np.float64), history.astype(np.float64)).max(axis=(0, 2))
        g = rel(np.asarray(lm, np.float64), log_metrics.astype(np.float64)).max(axis=1)
        print(f"  spread, {name}: history {h.max():.3g} (member {h.argmax()}), log metrics {g.max():.3g}")
        s_hist, s_lm = np.maximum(s_hist, h), np.maximum(s_lm, g)
    return s_hist, s_lm


def make() -> dict:
    area_b, power_b, hv_box = _seed_budgets(Session("base"), SEEDS, Workload(WORKLOADS))
    graphs = [get_workload(n) for n in WORKLOADS]
    t0 = time.perf_counter()
    res = pareto_dse(graphs, seeds=SEEDS, population=POPULATION, steps=STEPS, lr=LR, metrics=METRICS,
                     area_budget=area_b, power_budget=power_b, penalty_weight=PENALTY, key=KEY,
                     hv_box=hv_box)
    print(f"reference pareto_dse: {time.perf_counter() - t0:.1f} s; front {res.front.tolist()}, "
          f"hypervolume {res.hypervolume:.6g}")
    out = reference_draws(KEY, POPULATION)
    out["spread_history"], out["spread_log_metrics"] = reference_spread(graphs, area_b, power_b, res.history,
                                                                        res.log_metrics)
    out.update(
        workloads=np.asarray(WORKLOADS), seeds=np.asarray(SEEDS), population=POPULATION, steps=STEPS, lr=LR,
        penalty=np.asarray(PENALTY), metrics=np.asarray(METRICS), key=KEY,
        area_budget=np.float32(area_b), power_budget=np.float32(power_b),
        hv_lo=np.asarray(hv_box[0], np.float32), hv_ref=np.asarray(hv_box[1], np.float32),
        history=res.history, log_metrics=res.log_metrics, area=res.area, power=res.power,
        weights=res.weights, feasible=res.feasible, front=res.front, hypervolume=np.float64(res.hypervolume),
        v_max=np.int32(Graph.stack(graphs).n_vertices),
    )
    return out


def check_port(ref: dict) -> None:
    """The port's pareto_dse on the CPU with the fixture's draws, held as
    ``chip_smoke.py`` holds it on the card."""
    import chip_smoke

    t0 = time.perf_counter()
    res = chip_smoke.fixture_pareto_dse(ref, "cpu")
    print(f"port pareto_dse (CPU): {time.perf_counter() - t0:.1f} s")
    print(f"  held against the fixture: {chip_smoke.hold_pareto(res, ref)}")


def gradient_noise(ref: dict, i: int) -> None:
    """Member ``i``'s start gradient (log-space parameters, epoch 0's penalty
    weight) in the reference (float32: default and sequential mapper) and the
    port (float32; float64 with the sequential mapper)."""
    import torch

    from repro.core.dsim import mixed_log_objective  # engine-oracle
    from repro_torch.core import dopt as tdopt
    from repro_torch.core import dsim as tdsim
    from repro_torch.core.graph import DATA_FIELDS
    from repro_torch.core.graph import Graph as PortGraph
    from repro_torch.core.mapper import MapperCfg as PortMapperCfg
    from repro_torch.core.params import from_reference
    from repro_torch.workloads import get_workload as port_workload

    k_seed, _ = jax.random.split(jax.random.PRNGKey(KEY))
    (tech, arch), spec, _ = seed_population(POPULATION, SEEDS, k_seed, SIGMA)
    tech, arch = (jax.tree.map(lambda x: x[i], t) for t in (tech, arch))
    w, ab, pb, pw = ref["weights"][i], float(ref["area_budget"]), float(ref["power_budget"]), PENALTY[0]
    graphs = [get_workload(n) for n in WORKLOADS]
    evals = {}
    for name, mcfg in (("reference f32", MapperCfg()),
                       ("reference f32, sequential mapper", MapperCfg(scan_impl="ref"))):
        def loss(tz, az, mcfg=mcfg):
            return mixed_log_objective(from_log(tz), from_log(az), Graph.stack(graphs), jnp.asarray(w), ab, pb, pw,
                                       spec, mcfg)[0]

        g = jax.grad(loss, argnums=(0, 1))(*(jax.tree.map(lambda x: jnp.log(jnp.maximum(x, 1e-30)), t)
                                            for t in (tech, arch)))
        evals[name] = np.concatenate([np.atleast_1d(np.asarray(x, np.float64)) for x in jax.tree.leaves(g)])
    pspec = from_reference(spec)
    for name, dtype, mcfg in (("port f32", torch.float32, PortMapperCfg()),
                              ("port f64, sequential mapper", torch.float64, PortMapperCfg(scan_impl="ref"))):
        gs = PortGraph.stack([port_workload(n, device="cpu") for n in WORKLOADS])
        gs = PortGraph(**{f: getattr(gs, f).to(dtype) if getattr(gs, f).is_floating_point() else getattr(gs, f)
                          for f in DATA_FIELDS}, names=gs.names)
        tz, az = (tdopt.to_log(from_reference(t, "cpu")).map(lambda x: x.to(dtype).requires_grad_(True))
                  for t in (tech, arch))
        val, _ = tdsim.mixed_log_objective(tdopt.from_log(tz), tdopt.from_log(az), gs,
                                           torch.tensor(w, dtype=dtype), ab, pb, pw, pspec, mcfg)
        evals[name] = torch.cat([g.reshape(-1) for g in torch.autograd.grad(val, tz.leaves() + az.leaves())]
                                ).double().numpy()
    names = [f"{t}.{f.name}[{k}]" for t, cls in TREES for f in dataclasses.fields(cls)
             for k in range(np.size(getattr(cls.default(), f.name)))]
    truth = evals["port f64, sequential mapper"]
    print(f"member {i}: start gradient, {len(names)} log-space coordinates; " + "; ".join(evals))
    for c, n in enumerate(names):
        row = [evals[e][c] for e in evals]
        apart = any(np.sign(x) != np.sign(truth[c]) for x in row[:3])
        print(f"  {n:34s} " + " ".join(f"{x:+.6e}" for x in row)
              + ("  <- float32 signs disagree with float64" if apart else ""))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--check-port", action="store_true", help="run the port on the CPU against the file")
    ap.add_argument("--gradient-noise", type=int, metavar="MEMBER",
                    help="print MEMBER's start gradient in four evaluations (needs the file) and stop")
    args = ap.parse_args()
    if args.gradient_noise is not None:
        gradient_noise(dict(np.load(OUT)), args.gradient_noise)
        return
    out = make()
    OUT.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(OUT, **out)
    print(f"wrote {OUT.relative_to(ROOT)} ({OUT.stat().st_size / 1024:.1f} KiB)")
    if args.check_port:
        check_port(dict(np.load(OUT)))


if __name__ == "__main__":
    main()
