"""The port's sharding rules and spec trees (``repro_torch.models.sharding``,
``repro_torch.launch.specs``, ``.policy``) held entry by entry against the
reference's, for every arch on the 16x16 and 2x16x16 production meshes in
tp and dp; and ``to_placements``' shard shapes on a fake 512-rank process
group (in a subprocess: the fake group is process-global)."""
import itertools
import json
import os
import pathlib
import random
import subprocess
import sys
from types import SimpleNamespace

import jax
import pytest
from _hypothesis_compat import given, settings, st  # degrades to skip without hypothesis
from jax.sharding import PartitionSpec as P

import repro.launch.policy as ref_policy
import repro.launch.specs as ref_specs
import repro.models.sharding as ref_sh
from repro.configs import SHAPES as REF_SHAPES
from repro.configs import get_config as ref_get_config
from repro.models import build_model as ref_build_model
from repro.optim.adamw import AdamWConfig as RefAdamW
from repro.train.train_step import TrainConfig as RefTrainConfig
from repro_torch import tree as tu
from repro_torch.configs import SHAPES, all_archs, get_config
from repro_torch.launch import policy, specs
from repro_torch.models import build_model
from repro_torch.models import sharding as sh
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.train_step import TrainConfig

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
MESHES = {"16x16": None, "2x16x16": 2}


def fake_mesh(data=16, model=16, pod=None):
    shape = {}
    if pod:
        shape["pod"] = pod
    shape.update({"data": data, "model": model})
    return SimpleNamespace(shape=shape, axis_names=tuple(shape))


def ref_flat(tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: isinstance(x, P))
    return {jax.tree_util.keystr(kp): tuple(s) for kp, s in flat}


def port_flat(tree) -> dict:
    return {path: tuple(s) for path, s in tu.leaves_with_path(tree, sh.is_spec)}


# --------------------------------------------------------------------------- #
# the rules
# --------------------------------------------------------------------------- #


LOGICAL = [("vocab", "embed"), ("layers", "embed", "ff"), ("batch", None), ("batch", None, "vocab"),
           ("layers", "experts", "embed", None), ("embed", "heads", None), (None, "kv_heads", "d_inner"),
           ("batch", "embed"), ("layers", "d_inner", "embed")]


@pytest.mark.parametrize("mode", ["tp", "dp"])
@pytest.mark.parametrize("axes", [("data", "model"), ("pod", "data", "model"), ("x", "y")])
def test_logical_to_spec_matches(axes, mode):
    for names, fsdp in itertools.product(LOGICAL, [(), ("data",), ("data", "pod")]):
        with ref_sh.parallelism(mode), sh.parallelism(mode):
            assert tuple(sh.logical_to_spec(names, axes, fsdp)) == tuple(ref_sh.logical_to_spec(names, axes, fsdp))


def _repair_cases(n: int, seed: int):
    """The reference test's strategy, drawn deterministically: 1-4 dims of
    1-4096, data in {2, 4, 16}, model in {2, 8, 16}, model and data on two
    neighbouring dims."""
    rng = random.Random(seed)
    for _ in range(n):
        dims = tuple(rng.randint(1, 4096) for _ in range(rng.randint(1, 4)))
        # divisible dims are rare from uniform draws: mix in powers of two
        dims = tuple(d if rng.random() < 0.5 else 2 ** rng.randint(0, 12) for d in dims)
        yield dims, rng.choice([2, 4, 16]), rng.choice([2, 8, 16]), rng.randint(0, 3)


def _check_repair(dims, data, model, which):
    m = fake_mesh(data=data, model=model)
    entries = [None] * len(dims)
    entries[which % len(dims)] = "model"
    if len(dims) > 1:
        entries[(which + 1) % len(dims)] = "data"
    for relocate in (True, False):
        for names in ((), tuple("heads" if e == "model" else None for e in entries)):
            ours = sh.repair_spec(sh.Spec(*entries), dims, m, names, relocate)
            assert tuple(ours) == tuple(ref_sh.repair_spec(P(*entries), dims, m, names, relocate)), (dims, entries)
            used = []
            for e, dim in zip(tuple(ours) + (None,) * len(dims), dims):
                assert dim % sh.nshards(m, e) == 0
                used += list(sh._astuple(e))
            assert len(used) == len(set(used))


@pytest.mark.parametrize("seed", range(4))
def test_repair_spec_matches_on_drawn_cases(seed):
    for case in _repair_cases(150, seed):
        _check_repair(*case)


@settings(max_examples=60, deadline=None)
@given(
    dims=st.lists(st.integers(1, 4096), min_size=1, max_size=4),
    data=st.sampled_from([2, 4, 16]),
    model=st.sampled_from([2, 8, 16]),
    which=st.integers(0, 3),
)
def test_repair_spec_matches_property(dims, data, model, which):
    _check_repair(tuple(dims), data, model, which)


def test_repair_relocation_examples():
    m = fake_mesh()
    assert tuple(sh.repair_spec(sh.Spec(None, "model", None), (1, 49155, 4096), m)) == (None, None, "model")
    assert tuple(sh.repair_spec(sh.Spec(None, "model", None), (4096, 40, 128), m, ("embed", "heads", None))) == \
        (None, None, None)
    assert sh.Spec(("data",), None) == ("data", None)  # one-name entries stored as the name


def test_parallelism_for_every_cell():
    for arch, shape in itertools.product(all_archs(), SHAPES):
        for chips in (256, 512):
            assert policy.parallelism_for(get_config(arch), SHAPES[shape], chips) == \
                ref_policy.parallelism_for(ref_get_config(arch), REF_SHAPES[shape], chips), (arch, shape, chips)


# --------------------------------------------------------------------------- #
# the spec trees of every arch
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("mode", ["tp", "dp"])
@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", all_archs())
def test_spec_trees_match(arch, mesh_name, mode):
    mesh = fake_mesh(pod=MESHES[mesh_name])
    model, ref_model = build_model(get_config(arch)), ref_build_model(ref_get_config(arch))
    assert model.fsdp_axes() == ref_model.fsdp_axes()
    with ref_sh.parallelism(mode), sh.parallelism(mode):
        assert port_flat(model.specs(mesh)) == ref_flat(ref_model.specs(mesh))
        for int8 in (False, True):
            for compress in (False, True):
                ours = specs.train_state_specs(model, mesh, AdamWConfig(int8_states=int8), TrainConfig(
                    compress_grads=compress))
                ref = ref_specs.train_state_specs(ref_model, mesh, RefAdamW(int8_states=int8), RefTrainConfig(
                    compress_grads=compress))
                assert port_flat(ours) == ref_flat(ref), (int8, compress)
        for shape in ("train_4k", "prefill_32k"):
            ours = specs.batch_specs(model.cfg, mesh, specs.abstract_batch(model.cfg, SHAPES[shape]))
            ref = ref_specs.batch_specs(ref_model.cfg, mesh, ref_specs.abstract_batch(ref_model.cfg, REF_SHAPES[shape]))
            assert port_flat(ours) == ref_flat(ref)
        assert port_flat(specs.batch_specs(model.cfg, mesh)) == ref_flat(ref_specs.batch_specs(ref_model.cfg, mesh))
        for (B, M), seq_shard in itertools.product([(128, 32_768), (1, 524_288), (4, 4096)], (False, True)):
            assert port_flat(model.cache_specs(mesh, B, M, seq_shard)) == \
                ref_flat(ref_model.cache_specs(mesh, B, M, seq_shard)), (B, M, seq_shard)


def test_abstract_batch_shapes():
    for arch in all_archs():
        cfg = get_config(arch)
        ours = specs.abstract_batch(cfg, SHAPES["train_4k"])
        ref = ref_specs.abstract_batch(ref_get_config(arch), REF_SHAPES["train_4k"])
        assert {k: tuple(v.shape) for k, v in ours.items()} == {k: tuple(v.shape) for k, v in ref.items()}
        assert all(v.device.type == "meta" for v in ours.values())


def test_to_placements_of_a_spec():
    from torch.distributed.tensor import Replicate, Shard

    m = fake_mesh(pod=2)
    assert sh.to_placements(sh.Spec(("pod", "data"), None, "model"), m) == (Shard(0), Shard(0), Shard(2))
    # an entry in another order than the mesh's is split in mesh-dim order
    assert sh.to_placements(sh.Spec(None, ("data", "pod")), m) == (Shard(1), Shard(1), Replicate())
    assert sh.to_placements(sh.Spec(None, "model"), fake_mesh(data=1, model=1)) == (Replicate(), Replicate())


# --------------------------------------------------------------------------- #
# placements on a fake 512-rank group: shard shapes equal the spec arithmetic
# --------------------------------------------------------------------------- #

_CHILD = r"""
import json, sys, torch, torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
rank = int(sys.argv[1])
dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=512)
from repro_torch import tree as tu
from repro_torch.configs import all_archs, get_config
from repro_torch.launch.mesh import make_production_mesh, mesh_chips
from repro_torch.launch.specs import distribute_tree, train_state_specs
from repro_torch.models import build_model
from repro_torch.models import sharding as sh
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.train_step import TrainConfig, abstract_train_state
mesh = make_production_mesh(multi_pod=True)
assert mesh_chips(mesh) == 512 and mesh.mesh_dim_names == ("pod", "data", "model")
bad, n = [], 0
for arch in all_archs():
    model = build_model(get_config(arch))
    ocfg, tcfg = AdamWConfig(int8_states=True), TrainConfig()
    spec_tree = train_state_specs(model, mesh, ocfg, tcfg)
    state = distribute_tree(abstract_train_state(model, ocfg, tcfg), mesh, spec_tree)
    for (path, x), s in zip(tu.leaves_with_path(state), tu.leaves(spec_tree, sh.is_spec)):
        n += 1
        want = sh.local_shape(s, tuple(x.shape), mesh)
        got = tuple(x.to_local().shape)
        if got != want or x.to_local().device.type != "meta":
            bad.append((arch, path, got, want))
        # this rank's index ranges cover its shard
        r = sh.shard_ranges(x)
        if tuple(b - a for a, b in r) != want:
            bad.append((arch, path, "ranges", r))
print(json.dumps({"n": n, "bad": bad[:5], "coord": mesh.get_coordinate()}))
"""


@pytest.mark.parametrize("rank", [0, 301])
def test_to_placements_local_shapes_on_a_fake_512_rank_group(rank):
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", _CHILD, str(rank)], capture_output=True, text=True, env=env,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["bad"] == [] and res["n"] > 100
    assert res["coord"] == [rank // 256, rank // 16 % 16, rank % 16]
