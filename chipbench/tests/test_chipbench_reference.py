"""The plain reference agrees with the program's CPU path at small sizes,
and loads nothing of the program."""
from __future__ import annotations

import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from chipbench.harness import checks
from chipbench.inputs import draws
from chipbench.reference import sim
from chipbench.tests.conftest import ROOT

SEEDS = ["base", "edge", "mobile", "datacenter", "hbm_class"]


def program_inputs(names, bucket, P, seed):
    from repro_torch.core.graph import Graph
    from repro_torch.core.params import ArchParams, ArchSpec, TechParams

    g = draws.graph_stack({"workloads": names, "bucket": bucket})
    spec, seeds = draws.seed_designs(SEEDS)
    tech, arch = draws.population(seeds, P, 0.25, seed, 0, "cpu")
    gs = Graph.from_numpy(g, tuple(names), "cpu")
    return g, spec, seeds, tech, arch, gs, ArchSpec(**{k: tuple(v) for k, v in spec.items()}), TechParams, ArchParams


@pytest.mark.parametrize("seed", [1, 2**31 + 7])
def test_sweep_answers_equal_the_programs(seed):
    from repro_torch.core import popsim

    g, spec, _, tech, arch, gs, pspec, T, A = program_inputs(["lstm", "gcn", "bert_base", "bfs_graph"], 128, 24, seed)
    got = popsim.population_log_metrics(T(**tech), A(**arch), gs, pspec)
    want = sim.evaluate(tech, arch, draws.to_device(g, "cpu"), spec)
    gaps = checks.sweep_gaps(tuple(x.numpy() for x in got), tuple(x.numpy() for x in want))
    assert gaps.max() <= 1e-6


@pytest.mark.parametrize("seed", [3, 2**31 + 9])
def test_population_epochs_agree_with_the_programs(seed):
    from repro_torch.core import popsim

    g, spec, seeds, tech, arch, gs, pspec, T, A = program_inputs(["lstm", "bert_base", "dlrm"], 128, 16, seed)
    w = torch.as_tensor(draws.mixes(16, 0.7, seed, 1))
    area_b, power_b = draws.seed_budgets(seeds, spec, g, "cpu")
    mixes = (w, torch.full((16,), area_b), torch.full((16,), power_b))
    lr, pw = torch.tensor(0.1), torch.full((3,), 2.0)
    state = popsim.init_population_state(T(**tech), A(**arch))
    s1, r1 = popsim.population_chunk(state, mixes, gs, lr, pw[:1], spec=pspec)
    s3, r2 = popsim.population_chunk(s1, mixes, gs, lr, pw[:2], spec=pspec)
    ref = sim.init_state(tech, arch)
    rows = []
    for e in range(3):
        ref, row, _ = sim.population_step(ref, mixes, draws.to_device(g, "cpu"), spec, lr, pw[e],
                                          sim.log_bounds("cpu"))
        rows.append(row.numpy())
        if e == 0:
            grad = {k: x / (1 - checks.B1) for m in ref["m"] for k, x in m.items()}
    z0 = {k: x for t in sim.init_state(tech, arch)["z"] for k, x in t.items()}
    leaves = lambda t: {k: getattr(t, k) for k in t.__dataclass_fields__}  # noqa: E731
    prog = dict(rows=np.concatenate([r1, r2]),
                grad={k: x / (1 - checks.B1) for t in (s1[2].m, s1[3].m) for k, x in leaves(t).items()},
                change={k: x - z0[k] for t in s3[:2] for k, x in leaves(t).items()})
    want = dict(rows=np.stack(rows), grad=grad,
                change={k: x - z0[k] for t in ref["z"] for k, x in t.items()})
    got = checks.descent_numbers(prog, want)
    assert got["loss_gap"] <= 1e-6 and got["grad_gap"] <= 1e-5 and got["change_gap"] <= 1e-4, got


def test_reference_loads_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, sys.argv[1]); import chipbench.reference.sim, chipbench.inputs.draws; "
            "import json; print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code, str(ROOT)], capture_output=True, text=True, check=True)
    loaded = set(json.loads(out.stdout))
    assert not loaded & {"repro_torch", "repro", "jax", "jaxlib", "flax"}
