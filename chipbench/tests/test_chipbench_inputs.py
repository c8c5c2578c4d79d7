"""The benchmark's frozen inputs equal what the program's own builders and
library give."""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from chipbench.inputs import draws, graphs
from chipbench.reference import sim

LM = ["qwen2.5-32b:prefill_32k", "granite-3-8b:train_4k", "kimi-k2-1t-a32b:decode_32k", "falcon-mamba-7b:long_500k",
      "zamba2-1.2b:train_4k"]
SEEDS = ["base", "edge", "mobile", "datacenter", "hbm_class"]


@pytest.mark.parametrize("name", LM + list(graphs.CLASSIC))
def test_frozen_builder_equals_the_programs(name):
    from repro_torch.workloads import get_workload, lm_cell

    want = lm_cell(*name.split(":"), device="cpu") if ":" in name else get_workload(name, device="cpu")
    got = graphs.workload_graph(name)
    for f in graphs.DATA_FIELDS:
        np.testing.assert_array_equal(got[f], getattr(want, f).numpy(), err_msg=f)
    assert got["names"] == want.names


def test_stack_equals_graph_stack():
    from repro_torch.core.graph import Graph
    from repro_torch.workloads import get_workload

    names = ["lstm", "bert_base", "gcn"]
    got = graphs.stack([graphs.workload_graph(n) for n in names], 128)
    want = Graph.stack([get_workload(n, device="cpu").pad_to(128) for n in names])
    for f in graphs.DATA_FIELDS:
        np.testing.assert_array_equal(got[f], getattr(want, f).numpy(), err_msg=f)


def test_seed_designs_equal_the_library():
    from repro_torch.core.dhdl import load_arch

    spec, trees = draws.seed_designs(SEEDS)
    for name, (tech, arch) in zip(SEEDS, trees):
        ca = load_arch(name, "cpu")
        assert spec == {f.name: list(getattr(ca.spec, f.name)) for f in dataclasses.fields(ca.spec)}
        for mine, theirs in ((tech, ca.tech), (arch, ca.arch)):
            for f in dataclasses.fields(theirs):
                np.testing.assert_array_equal(mine[f.name], getattr(theirs, f.name).numpy(), err_msg=f.name)


def test_bounds_equal_the_programs():
    from repro_torch.core.params import ArchParams, TechParams

    for (lo, hi), cls in zip(sim.bounds("cpu"), (TechParams, ArchParams)):
        plo, phi = cls.bounds("cpu")
        for f in dataclasses.fields(cls):
            torch.testing.assert_close(lo[f.name], getattr(plo, f.name), rtol=0, atol=0)
            torch.testing.assert_close(hi[f.name], getattr(phi, f.name), rtol=0, atol=0)


def test_draws_repeat_from_the_seed_and_stay_in_bounds():
    _, seeds = draws.seed_designs(SEEDS)
    seed = 2**31 + 12345
    a = draws.population(seeds, 40, 0.25, seed, 0, "cpu")
    b = draws.population(seeds, 40, 0.25, seed, 0, "cpu")
    c = draws.population(seeds, 40, 0.25, seed + 1, 0, "cpu")
    for t, (lo, hi) in enumerate(sim.bounds("cpu")):
        for f in a[t]:
            assert torch.equal(a[t][f], b[t][f])
            assert a[t][f].is_contiguous()
            assert bool((a[t][f] >= lo[f] * (1 - 1e-6)).all() and (a[t][f] <= hi[f] * (1 + 1e-6)).all())
            assert torch.equal(a[t][f][:5], torch.as_tensor(np.stack([s[t][f] for s in seeds])))
    assert not torch.equal(a[1]["frequency"], c[1]["frequency"])
    w = draws.mixes(40, 0.7, seed, 1)
    np.testing.assert_array_equal(w, draws.mixes(40, 0.7, seed, 1))
    np.testing.assert_allclose(w.sum(1), 1.0, rtol=1e-6)
    np.testing.assert_array_equal(w[:3, :3], np.eye(3))
