"""popsim's member sharding in the port against its unsharded runs and the
reference, on the CPU.

* One spawn of two gloo ranks: ``population_chunk(mesh=)`` over a ("pop",)
  mesh of 2 at P = 8 (lstm, 2 epochs, the reference's seeded population and
  mixes), then a second chunk from the state it returned; ``pareto_dse(mesh=)``
  at a small configuration in chunks of 2; the ``ValueError``s of a mesh
  without the axis and of a dim that does not divide P; the dry run's DSE
  step (``make_dse_step(mesh=)``) at (1, 2) and (2, 1) ("data", "model")
  meshes; ``shard_population``'s shards.
* In this process: the reference's and the port's unsharded
  ``population_chunk`` on the same inputs; ``dse_in_shardings``' specs
  against the reference's ``NamedSharding`` specs entry by entry; and a
  one-rank gloo group, where ``population_chunk(mesh=)`` takes the plain
  path and the sharded body (``population_chunk_sharded``) and the DSE step
  equal the unsharded runs bit for bit.

Tolerances: rtol 1e-5, atol 1e-6 (``tests/test_popsim.py``'s sharded test)
for the population; the DSE step's objectives and updated members at rel
1e-6 (a mean over two workloads taken as the mean of two local means).
"""
import os
import pathlib
import subprocess
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import Mesh

import repro.core.graph as jgraph
import repro.core.popsim as jpop
import repro.workloads as jwl
import repro_torch.core.popsim as tpop
from repro_torch.core.graph import DATA_FIELDS, Graph
from repro_torch.core.params import ArchParams, TechParams
from repro_torch.models.sharding import Spec
from repro_torch.workloads import get_workload

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
P, EPOCHS, SEEDS = 8, 2, ("base", "edge")
RTOL, ATOL = 1e-5, 1e-6
PARETO = dict(seeds=SEEDS, population=6, steps=4, chunk=2, lr=0.1, area_budget=400.0, key=3)
DSE_TOL = 1e-6


def reference_inputs() -> dict:
    """The reference's seeded population and mixes (tests/test_popsim.py's
    sharded case) as numpy arrays, and the schedule."""
    (tech, arch), _, _ = jpop.seed_population(P, SEEDS, jax.random.PRNGKey(0))
    out = {f"tech/{k}": np.asarray(getattr(tech, k)) for k in TechParams.__dataclass_fields__}
    out.update({f"arch/{k}": np.asarray(getattr(arch, k)) for k in ArchParams.__dataclass_fields__})
    out["weights"] = np.asarray(jpop.sample_objective_mixes(P))
    out["area"], out["power"] = np.full(P, 300.0, np.float32), np.full(P, np.inf, np.float32)
    out["sched"] = np.linspace(0.5, 2.0, EPOCHS).astype(np.float32)
    return out


def port_inputs(inp: dict):
    """(state, mixes, gstack, spec) of the port from ``reference_inputs``."""
    tech = TechParams.from_numpy({k[5:]: v for k, v in inp.items() if k.startswith("tech/")}, "cpu")
    arch = ArchParams.from_numpy({k[5:]: v for k, v in inp.items() if k.startswith("arch/")}, "cpu")
    spec = tpop.seed_population(P, SEEDS, device="cpu")[1]
    return (tpop.init_population_state(tech, arch), (inp["weights"], inp["area"], inp["power"]),
            Graph.stack([get_workload("lstm", device="cpu")]), spec)


def dse_inputs():
    pop = tpop.init_population(0, 4, device="cpu")
    return pop, Graph.stack([get_workload("lstm", device="cpu"), get_workload("merge_sort", device="cpu")])


def _close(got, want, what: str) -> None:
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL, atol=ATOL, err_msg=what)


def _state_arrays(state) -> list:
    return [x.detach().numpy() for x in tpop._state_leaves(state)]


# --------------------------------------------------------------------------- #
# two gloo ranks, one spawn
# --------------------------------------------------------------------------- #

_WORKER = r'''
import os, sys
import numpy as np, torch, torch.distributed as dist, torch.multiprocessing as mp


def full(x):
    return (x.full_tensor() if hasattr(x, "full_tensor") else x).detach().numpy()


def worker(rank, port, root):
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank, world_size=2)
    sys.path.insert(0, os.environ["REPRO_SRC"])
    sys.path.insert(0, os.environ["TESTS_DIR"])
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch.core import popsim
    from repro_torch.workloads import get_workload
    from test_torch_popsim_mesh import PARETO, dse_inputs, port_inputs
    inp = dict(np.load(os.path.join(root, "inputs.npz")))
    out = {}
    pop_mesh = DeviceMesh("cpu", torch.arange(2), mesh_dim_names=("pop",))
    state, mixes, gs, spec = port_inputs(inp)
    s1, m1 = popsim.population_chunk(state, mixes, gs, 0.1, inp["sched"], spec=spec, mesh=pop_mesh)
    s2, m2 = popsim.population_chunk(s1, mixes, gs, 0.1, inp["sched"], spec=spec, mesh=pop_mesh)
    out["chunk/m1"], out["chunk/m2"] = m1, m2
    for i, x in enumerate(popsim._state_leaves(s1)):
        out[f"chunk/s1/{i}"] = full(x)
        out[f"chunk/local_rows/{i}"] = np.asarray(x.to_local().shape[0])
    for i, x in enumerate(popsim._state_leaves(s2)):
        out[f"chunk/s2/{i}"] = full(x)
    lstm = [get_workload("lstm", device="cpu")]
    res = popsim.pareto_dse(lstm, mesh=pop_mesh, device="cpu", **PARETO)
    out["pareto/history"], out["pareto/log_metrics"] = res.history, res.log_metrics
    out["pareto/hv"], out["pareto/front"] = np.asarray(res.hypervolume), res.front
    out["pareto/dhd"] = np.asarray([w["dhd"] for w in res.winners])
    try:
        popsim.population_chunk(state, mixes, gs, 0.1, inp["sched"], spec=spec,
                                mesh=DeviceMesh("cpu", torch.arange(2), mesh_dim_names=("data",)))
    except ValueError as e:
        out["err/axis"] = np.asarray(str(e))
    (t3, a3), spec3, _ = popsim.seed_population(3, ("base", "edge"), device="cpu")
    try:
        popsim.population_chunk(popsim.init_population_state(t3, a3), (np.ones((3, 4), np.float32), np.ones(3),
                                np.ones(3)), gs, 0.1, inp["sched"], spec=spec3, mesh=pop_mesh)
    except ValueError as e:
        out["err/divide"] = np.asarray(str(e))
    pop, graphs = dse_inputs()
    for shape in ((1, 2), (2, 1)):
        mesh = DeviceMesh("cpu", torch.arange(2).reshape(shape), mesh_dim_names=("data", "model"))
        new, obj = popsim.make_dse_step(mesh=mesh)(pop, graphs)
        tag = "x".join(map(str, shape))
        out[f"dse/{tag}/obj"] = full(obj)
        for i, x in enumerate(new[0].leaves() + new[1].leaves()):
            out[f"dse/{tag}/pop/{i}"] = full(x)
        sp = popsim.shard_population(mesh, pop)
        out[f"shard/{tag}/rows"] = np.asarray([x.to_local().shape[0] for t in sp for x in t.leaves()])
    np.savez(os.path.join(root, f"rank{rank}.npz"), **out)
    dist.destroy_process_group()


if __name__ == "__main__":
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    mp.spawn(worker, args=(port, sys.argv[1]), nprocs=2)
'''


@pytest.fixture(scope="module")
def inputs():
    return reference_inputs()


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory, inputs):
    root = tmp_path_factory.mktemp("popsim2")
    np.savez(root / "inputs.npz", **inputs)
    (root / "worker.py").write_text(_WORKER)
    env = dict(os.environ, PYTHONPATH=str(SRC), REPRO_SRC=str(SRC), TESTS_DIR=str(pathlib.Path(__file__).parent),
               OMP_NUM_THREADS="2")
    out = subprocess.run([sys.executable, str(root / "worker.py"), str(root)], capture_output=True, text=True,
                         env=env, timeout=240)
    assert out.returncode == 0, out.stderr[-4000:]
    return [dict(np.load(root / f"rank{r}.npz")) for r in range(2)]


@pytest.fixture(scope="module")
def unsharded(inputs):
    """Two chunks of the port's and one of the reference's unsharded
    population_chunk on the same inputs."""
    state, mixes, gs, spec = port_inputs(inputs)
    s1, m1 = tpop.population_chunk(state, mixes, gs, 0.1, inputs["sched"], spec=spec)
    s2, m2 = tpop.population_chunk(s1, mixes, gs, 0.1, inputs["sched"], spec=spec)
    (tech, arch), jspec, _ = jpop.seed_population(P, SEEDS, jax.random.PRNGKey(0))
    jmix = (jnp.asarray(inputs["weights"]), jnp.asarray(inputs["area"]), jnp.asarray(inputs["power"]))
    js, jm = jpop.population_chunk(jpop.init_population_state(tech, arch), jmix,
                                   jgraph.Graph.stack([jwl.get_workload("lstm")]), 0.1,
                                   jnp.asarray(inputs["sched"]), spec=jspec)
    return {"s1": _state_arrays(s1), "m1": m1, "s2": _state_arrays(s2), "m2": m2, "params": s1[:2],
            "ref_m": np.asarray(jm), "ref_params": js[:2]}


def test_sharded_chunk_matches_the_unsharded_port_and_the_reference(two_ranks, unsharded):
    for r in two_ranks:
        assert r["chunk/m1"].shape == (EPOCHS, P, 5)
        _close(r["chunk/m1"], unsharded["m1"], "history against the port")
        _close(r["chunk/m1"], unsharded["ref_m"], "history against the reference")
        for i, want in enumerate(unsharded["s1"]):
            _close(r[f"chunk/s1/{i}"], want, f"state leaf {i}")
    # the unsharded port's log-space parameters against the reference's, field by field
    for port, ref in zip(unsharded["params"], unsharded["ref_params"]):
        for f in type(port).__dataclass_fields__:
            _close(getattr(port, f).numpy(), np.asarray(getattr(ref, f)), f)


def test_sharded_state_goes_round_a_second_chunk(two_ranks, unsharded):
    """The returned state (DTensors, each rank its 4 members) is taken again
    by the next call: the second chunk equals the unsharded second chunk."""
    for r in two_ranks:
        assert all(int(r[f"chunk/local_rows/{i}"]) == P // 2 for i in range(len(unsharded["s1"])))
        _close(r["chunk/m2"], unsharded["m2"], "second chunk's history")
        for i, want in enumerate(unsharded["s2"]):
            _close(r[f"chunk/s2/{i}"], want, f"second chunk's state leaf {i}")


def test_sharded_pareto_dse_is_the_same_on_both_ranks_and_without_a_mesh(two_ranks):
    want = tpop.pareto_dse([get_workload("lstm", device="cpu")], device="cpu", **PARETO)
    a, b = two_ranks
    for k in ("pareto/history", "pareto/log_metrics", "pareto/hv", "pareto/front", "pareto/dhd"):
        assert np.array_equal(a[k], b[k]), k
    _close(a["pareto/history"], want.history, "pareto history")
    _close(a["pareto/log_metrics"], want.log_metrics, "pareto log metrics")
    assert np.array_equal(a["pareto/front"], want.front)
    assert float(a["pareto/hv"]) == pytest.approx(want.hypervolume, rel=RTOL)
    assert a["pareto/dhd"].tolist() == [w["dhd"] for w in want.winners]


def test_sharded_chunk_errors(two_ranks):
    for r in two_ranks:
        assert "no 'pop' axis" in str(r["err/axis"])
        assert "must divide the population (got P=3)" in str(r["err/divide"])


@pytest.mark.parametrize("shape", ["1x2", "2x1"])
def test_sharded_dse_step_matches_the_unsharded_step(two_ranks, shape):
    """At (1, 2) the two workloads are split over "model": the objective's
    mean and its gradient are reduced once over the two ranks (neither
    dropped nor doubled); at (2, 1) the members are split over "data"."""
    pop, graphs = dse_inputs()
    new, obj = tpop.make_dse_step()(pop, graphs)
    want = [x.numpy() for x in new[0].leaves() + new[1].leaves()]
    for r in two_ranks:
        np.testing.assert_allclose(r[f"dse/{shape}/obj"], obj.numpy(), rtol=DSE_TOL)
        for i, w in enumerate(want):
            np.testing.assert_allclose(r[f"dse/{shape}/pop/{i}"], w, rtol=DSE_TOL, err_msg=f"member leaf {i}")


def test_shard_population_splits_members_over_data(two_ranks):
    for r in two_ranks:
        assert set(r["shard/2x1/rows"].tolist()) == {2}  # 4 members over data = 2
        assert set(r["shard/1x2/rows"].tolist()) == {4}  # no data split: whole on each rank


# --------------------------------------------------------------------------- #
# dse_in_shardings: the reference's specs, entry by entry
# --------------------------------------------------------------------------- #


def _ref_mesh(names):
    return Mesh(np.array(jax.devices()[:1]).reshape((1,) * len(names)), names)


def _entries(spec) -> tuple:
    return tuple(tuple(e) if isinstance(e, (tuple, list)) else e for e in spec)


@pytest.mark.parametrize("names", [("pod", "data"), ("data", "model"), ("pod", "data", "model"), ("model",)])
def test_dse_in_shardings_match_the_references(names):
    jgs = jgraph.Graph.stack([jwl.get_workload("lstm"), jwl.get_workload("merge_sort")])
    jpop_ = jax.tree.map(lambda x: x[None], (jpop.TechParams.default(), jpop.ArchParams.default()))
    ref_pop, ref_g = jpop.dse_in_shardings(_ref_mesh(names), jpop_, jgs)
    pop = tuple(t.map(lambda x: x[None]) for t in (TechParams.default("cpu"), ArchParams.default("cpu")))
    gs = Graph.stack([get_workload("lstm", device="cpu"), get_workload("merge_sort", device="cpu")])
    mesh = SimpleNamespace(shape={n: 1 for n in names}, axis_names=names)
    pop_s, g_s = tpop.dse_in_shardings(mesh, pop, gs)
    got = [s for t in pop_s for s in t.leaves()]
    want = jax.tree.leaves(ref_pop)
    assert len(got) == len(want)
    for s, w in zip(got, want):
        assert isinstance(s, Spec) and _entries(s) == _entries(w.spec)
    for f in DATA_FIELDS:
        assert _entries(getattr(g_s, f)) == _entries(getattr(ref_g, f).spec), f


def test_dse_in_shardings_guard_on_a_wide_model_axis():
    """16 ranks on "model": two workloads do not divide, so they replicate;
    sixteen do."""
    mesh = SimpleNamespace(shape={"data": 16, "model": 16}, axis_names=("data", "model"))
    pop = tuple(t.map(lambda x: x[None]) for t in (TechParams.default("cpu"), ArchParams.default("cpu")))
    two = Graph.stack([get_workload("lstm", device="cpu")] * 2)
    sixteen = Graph.stack([get_workload("lstm", device="cpu")] * 16)
    assert all(getattr(tpop.dse_in_shardings(mesh, pop, two)[1], f) == Spec() for f in DATA_FIELDS)
    assert all(getattr(tpop.dse_in_shardings(mesh, pop, sixteen)[1], f) == Spec("model") for f in DATA_FIELDS)
    assert all(s == Spec("data") for t in tpop.dse_in_shardings(mesh, pop, two)[0] for s in t.leaves())


# --------------------------------------------------------------------------- #
# one rank, in this process: bit for bit
# --------------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def one_rank():
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield dist
    finally:
        dist.destroy_process_group()


def _mesh(names):
    from torch.distributed.device_mesh import DeviceMesh

    return DeviceMesh("cpu", torch.arange(1).reshape((1,) * len(names)), mesh_dim_names=names)


def test_one_rank_chunk_takes_the_plain_path_and_the_sharded_body_equals_it(one_rank, inputs, unsharded):
    state, mixes, gs, spec = port_inputs(inputs)
    mesh = _mesh(("pop",))
    s, m = tpop.population_chunk(state, mixes, gs, 0.1, inputs["sched"], spec=spec, mesh=mesh)
    assert np.array_equal(m, unsharded["m1"])
    assert all(np.array_equal(a, b) for a, b in zip(_state_arrays(s), unsharded["s1"]))
    s, m = tpop.population_chunk_sharded(state, mixes, gs, 0.1, inputs["sched"], spec=spec, mesh=mesh)
    assert np.array_equal(m, unsharded["m1"])
    assert all(np.array_equal(a.full_tensor().numpy(), b) for a, b in zip(tpop._state_leaves(s), unsharded["s1"]))


def test_one_rank_dse_step_is_the_unsharded_step_bit_for_bit(one_rank):
    pop, graphs = dse_inputs()
    new, obj = tpop.make_dse_step()(pop, graphs)
    mnew, mobj = tpop.make_dse_step(mesh=_mesh(("data", "model")))(pop, graphs)
    assert torch.equal(mobj.full_tensor(), obj)
    for a, b in zip(mnew[0].leaves() + mnew[1].leaves(), new[0].leaves() + new[1].leaves()):
        assert torch.equal(a.full_tensor(), b)
