"""The port's cost counter (``launch.hlo_costs``), collective accounting
(``launch.hlo_stats``) and dry run (``launch.dryrun``) on the CPU.

* Synthetic programs with exact counts: a product in a loop of n counts
  n x 2MNK; all-reduce, all-gather and reduce-scatter on a fake group of 16
  give the ring factors' link bytes; float32 and bf16 traffic split.
* The ``dot`` FLOPs of a reduced dense forward on one rank against the
  reference's ``hlo_costs`` of the same forward lowered on the CPU.  They
  differ by construction by the attention products: the reference's
  attention is jnp products (its chunked path, each 64-token sequence one
  block pair, so the whole S x S square: 4·B·H·S²·D a layer), the port's is
  the attention kernel's op, a class of its own.  With that term the two
  are held equal exactly.
* Dry-run records of reduced dense, ssm, hybrid and moe configs at train,
  prefill and decode on the 16x16 mesh (a fake group of 256 ranks, in a
  subprocess; ``test_torch_dryrun_multipod.py`` has the 2x16x16 mesh):
  every reference field but ``xla_*``, the argument bytes against the spec
  arithmetic, and dp's collective bytes below tp's for granite-3-8b's train
  cell at full size.
* The ``--popsim`` record on 16x16: the population-DSE step's FLOPs a rank
  against the unsharded step on the same local problem.
"""
import dataclasses
import json
import math
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

from repro.configs import get_config as ref_get_config
from repro.launch.hlo_costs import hlo_costs
from repro.launch.hlo_stats import _link_bytes as ref_link_bytes
from repro.models import build_model as ref_build_model
from repro_torch import tree as tu
from repro_torch.configs import SHAPES, get_config
from repro_torch.launch import dryrun, hlo_stats
from repro_torch.launch.hlo_costs import program_costs, trace
from repro_torch.launch.specs import abstract_batch, batch_specs, train_state_specs
from repro_torch.models import build_model
from repro_torch.models import sharding as sh
from repro_torch.models.model import params_from_numpy
from repro_torch.train.train_step import TrainConfig, abstract_train_state

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
ENV = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="2")
ARCHS = {"dense": "granite-3-8b", "ssm": "falcon-mamba-7b", "hybrid": "zamba2-1.2b", "moe": "llama4-scout-17b-a16e"}
CELL_SHAPES = ("train_4k", "prefill_32k", "decode_32k")
FIELDS = {"arch", "shape", "mesh", "chips", "kind", "parallelism", "ok", "lower_s", "compile_s", "memory",
          "collectives", "scan_trip_counts", "flops_per_device", "bytes_per_device", "flops_by_op", "bytes_by_op",
          "hbm_per_device_gb", "roofline"}
MEMORY = {"argument_size_in_bytes", "output_size_in_bytes", "temp_size_in_bytes", "alias_size_in_bytes",
          "generated_code_size_in_bytes"}


# --------------------------------------------------------------------------- #
# synthetic programs
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("n", [1, 3, 7])
def test_product_in_a_loop_counts_n_times_2mnk(n):
    M, K, N = 24, 40, 56
    a, b = torch.randn(M, K), torch.randn(K, N)

    def prog():
        y = a
        for _ in range(n):
            y = (a @ b)[:, :K]
        return y

    c = program_costs(prog)
    assert c["flops_by_op"]["dot"] == n * 2 * M * N * K
    assert c["bytes_by_op"]["dot"] == n * 4 * (M * K + K * N + M * N)


def test_elementwise_reduce_and_layout_classes():
    x = torch.randn(8, 16)
    c = program_costs(lambda: (x * 2.0).sum(-1).to(torch.bfloat16))
    assert c["flops_by_op"] == {"elementwise": 128.0, "reduce": 128.0}
    assert c["bytes_by_op"]["layout"] == 8 * 4 + 8 * 2 and c["bytes_by_op"]["reduce"] == 128 * 4 + 8 * 4


def test_kernel_ops_are_classes_of_their_own():
    from repro_torch.kernels.flash_attention import flash_attention, operations

    q = torch.randn(1, 4, 32, 16)
    k = v = torch.randn(1, 2, 32, 16)
    c = program_costs(lambda: flash_attention(q, k, v, causal=True))
    assert c["flops_by_op"] == {"flash_attention": float(operations(1, 4, 32, 32, 16, True))}
    assert c["bytes_by_op"]["flash_attention"] == 4 * (2 * q.numel() + k.numel() + v.numel())


def test_peak_live_bytes_and_loops():
    from repro_torch import instrument

    def prog():
        instrument.note_loop("layers", 3)
        a = torch.ones(1024)  # 4 KB live
        b = a * 2  # 8 KB live: the peak
        del a  # 4 KB
        return b.sum()  # b freed on return: the 4-byte result alone stays

    tr = trace(prog)
    assert tr.peak_bytes == 8192 and tr.tracer.live == 4 and tr.loops == [("layers", 3)]
    assert hlo_stats.layer_loops(tr) == [{"loop": "layers", "trips": 3}]


_COLLECTIVES = r"""
import json, torch, torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=16)
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from repro_torch.launch.hlo_costs import trace
from repro_torch.launch.hlo_stats import collective_stats
mesh = DeviceMesh("cpu", torch.arange(16), mesh_dim_names=("model",))
out = {}
for dt in (torch.float32, torch.bfloat16):
    local = torch.empty(64, 32, dtype=dt, device="meta")
    sharded = DTensor.from_local(local, mesh, [Shard(0)], run_check=False)
    partial = DTensor.from_local(local, mesh, [Partial()], run_check=False)
    progs = {"all-gather": lambda: sharded.redistribute(mesh, [Replicate()]),
             "all-reduce": lambda: partial.redistribute(mesh, [Replicate()]),
             "reduce-scatter": lambda: partial.redistribute(mesh, [Shard(0)])}
    for kind, fn in progs.items():
        tr = trace(fn)
        out[f"{kind}/{dt}"] = {"records": [{k: (str(v) if k == "dtype" else v) for k, v in r.items()}
                                           for r in tr.collectives], "stats": collective_stats(tr)}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def collectives():
    out = subprocess.run([sys.executable, "-c", _COLLECTIVES], capture_output=True, text=True, env=ENV, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("dtype", ["torch.float32", "torch.bfloat16"])
@pytest.mark.parametrize("kind", ["all-gather", "all-reduce", "reduce-scatter"])
def test_collective_link_bytes_on_a_fake_group_of_16(collectives, kind, dtype):
    r = collectives[f"{kind}/{dtype}"]
    (rec,) = r["records"]
    item = 4 if dtype == "torch.float32" else 2
    out_elems = {"all-gather": 16 * 64 * 32, "all-reduce": 64 * 32, "reduce-scatter": 4 * 32}[kind]
    assert rec["kind"] == kind and rec["group_size"] == 16 and rec["bytes"] == out_elems * item
    assert rec["ranks"] == list(range(16))
    want = ref_link_bytes(kind, out_elems * item, 16)
    s = r["stats"]
    assert s["bytes_by_kind"] == {kind: int(want)} and s["total_bytes"] == int(want)
    assert s["counts"] == {kind: 1}
    # the float32 / low-precision split
    assert (s["f32_bytes"], s["lp_bytes"]) == ((int(want), 0) if item == 4 else (0, int(want)))
    assert s["tpu_adjusted_bytes"] == int(s["f32_bytes"] / 2 + s["lp_bytes"])


def test_link_bytes_are_the_references():
    for kind in ("all-reduce", "all-gather", "reduce-scatter", "all-to-all", "collective-permute"):
        for g in (1, 2, 16):
            assert hlo_stats._link_bytes(kind, 4096, g) == ref_link_bytes(kind, 4096, g)


def test_collective_seconds_by_group_span():
    recs = [{"kind": "all-reduce", "bytes": 1000, "group_size": 8, "ranks": tuple(range(8)), "dtype": None},
            {"kind": "all-reduce", "bytes": 1000, "group_size": 2, "ranks": (0, 16), "dtype": None}]
    lb = hlo_stats._link_bytes("all-reduce", 1000, 8), hlo_stats._link_bytes("all-reduce", 1000, 2)
    assert hlo_stats.collective_seconds(recs, 100.0, 10.0) == pytest.approx(lb[0] / 100.0 + lb[1] / 10.0)


# --------------------------------------------------------------------------- #
# the dot FLOPs of a forward against the reference's HLO counter
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("arch", ["granite-3-8b", "qwen2.5-32b"])
def test_dot_flops_of_a_forward_match_the_reference(arch):
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    rcfg = dataclasses.replace(ref_get_config(arch).reduced(), dtype="float32")
    model, ref_model = build_model(cfg), ref_build_model(rcfg)
    w = model.init_numpy(0)
    B, S = 2, 64
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (B, S))
    lowered = jax.jit(lambda p, t: ref_model.forward(p, t)[0]).lower(jax.tree.map(jnp.asarray, w),
                                                                      jnp.asarray(toks, jnp.int32))
    ref = hlo_costs(lowered.compile().as_text())["flops_by_op"]["dot"]
    params = params_from_numpy(cfg, w, "cpu")
    with torch.no_grad():
        ours = program_costs(lambda: model.forward(params, torch.as_tensor(toks))[0])["flops_by_op"]
    attention_dots = 4 * B * cfg.n_heads * S * S * cfg.hd * cfg.n_layers
    assert ours["dot"] + attention_dots == ref  # exact
    assert ours["flash_attention"] > 0


# --------------------------------------------------------------------------- #
# dry-run records
# --------------------------------------------------------------------------- #

_CELLS = r"""
import json, sys
from repro_torch.launch import dryrun
multi_pod = sys.argv[1] == "on"
dryrun.start_fake_group(512 if multi_pod else 256)
out = {}
for arch, shape, par, reduced in json.loads(sys.argv[2]):
    out[f"{arch}/{shape}/{par}/{reduced}"] = dryrun.run_cell(arch, shape, multi_pod, parallelism=par, reduced=reduced)
print(json.dumps(out))
"""


def run_cells(mesh_name: str, cells: list) -> dict:
    """Dry-run records of ``cells`` ((arch, shape, parallelism, reduced)) on a
    fake group of the mesh's size, in a subprocess (the group is process-global)."""
    mp = "on" if mesh_name == "2x16x16" else "off"
    out = subprocess.run([sys.executable, "-c", _CELLS, mp, json.dumps(cells)], capture_output=True, text=True,
                         env=ENV, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def family_cells() -> list:
    return [(a, s, "tp", True) for a in ARCHS.values() for s in CELL_SHAPES]


@pytest.fixture(scope="module")
def records():
    # the families' reduced cells, and granite-3-8b's train cell at full size in tp and dp
    cells = family_cells() + [(ARCHS["dense"], "train_4k", par, False) for par in ("tp", "dp")]
    return {"16x16": run_cells("16x16", cells)}


def _fake_mesh(mesh_name):
    shape = {"pod": 2} if mesh_name == "2x16x16" else {}
    shape.update({"data": 16, "model": 16})
    return SimpleNamespace(shape=shape, axis_names=tuple(shape))


def _spec_bytes(tree, spec_tree, mesh) -> int:
    total = 0
    for x, s in zip(tu.leaves(tree), tu.leaves(spec_tree, sh.is_spec)):
        total += math.prod(sh.local_shape(s, tuple(x.shape), mesh)) * x.element_size()
    return total


def _argument_bytes(arch, shape_name, mesh_name, par) -> int:
    """The rank's shard bytes of a cell's inputs from the specs alone."""
    cfg = dryrun._config(arch, True)
    model, shape, mesh = build_model(cfg), SHAPES[shape_name], _fake_mesh(mesh_name)
    with sh.parallelism(par):
        if shape.kind == "train":
            ocfg, tcfg = dryrun.opt_cfg_for(cfg), TrainConfig()
            state = abstract_train_state(model, ocfg, tcfg)
            batch = abstract_batch(cfg, shape)
            return (_spec_bytes(state, train_state_specs(model, mesh, ocfg, tcfg), mesh)
                    + _spec_bytes(batch, batch_specs(cfg, mesh, batch), mesh))
        params = _spec_bytes(model.abstract_params(), model.specs(mesh), mesh)
        if shape.kind == "prefill":
            batch = abstract_batch(cfg, shape)
            return params + _spec_bytes({"tokens": batch["tokens"]}, batch_specs(cfg, mesh, {"tokens": batch["tokens"]}),
                                        mesh)
        B, M = shape.global_batch, shape.seq_len
        toks = torch.empty((B, 1), dtype=torch.int64, device="meta")
        tspec = sh.repair_spec(sh.Spec(("pod", "data") if "pod" in mesh.shape else "data", None), (B, 1), mesh)
        return (params + _spec_bytes(model.abstract_cache(B, M), model.cache_specs(mesh, B, M), mesh)
                + _spec_bytes([toks], [tspec], mesh))


def check_record(rec: dict, family: str, shape: str, mesh_name: str) -> None:
    arch = ARCHS[family]
    assert set(rec) == FIELDS and not any(k.startswith("xla_") for k in rec)
    assert rec["ok"] and rec["mesh"] == mesh_name and rec["chips"] == (512 if mesh_name == "2x16x16" else 256)
    assert rec["kind"] == SHAPES[shape].kind and rec["arch"] == arch + "-smoke"
    assert set(rec["memory"]) == MEMORY
    assert rec["memory"]["argument_size_in_bytes"] == _argument_bytes(arch, shape, mesh_name, "tp")
    assert rec["flops_per_device"] == pytest.approx(sum(rec["flops_by_op"].values()))
    assert rec["bytes_per_device"] == pytest.approx(sum(rec["bytes_by_op"].values()))
    assert rec["flops_per_device"] > 0 and rec["bytes_per_device"] > 0
    assert rec["scan_trip_counts"] and all(t["trips"] > 0 for t in rec["scan_trip_counts"])
    kernel = {"dense": "flash_attention", "moe": "flash_attention", "ssm": "selective_scan",
              "hybrid": "ssd_chunk_scan"}[family]
    if SHAPES[shape].kind != "decode":
        assert rec["flops_by_op"][kernel] > 0
    roof = rec["roofline"]
    assert roof["t_compute"] == rec["flops_per_device"] / dryrun.PEAK_FLOPS
    assert roof["t_memory"] == rec["bytes_per_device"] / dryrun.HBM_BW
    assert roof["bottleneck"] == max(("t_compute", "t_memory", "t_collective"), key=lambda k: roof[k])
    if SHAPES[shape].kind == "train":
        assert rec["memory"]["alias_size_in_bytes"] > 0 and rec["collectives"]["total_bytes"] > 0


@pytest.mark.parametrize("shape", CELL_SHAPES)
@pytest.mark.parametrize("family", list(ARCHS))
def test_dry_run_record(records, family, shape):
    check_record(records["16x16"][f"{ARCHS[family]}/{shape}/tp/True"], family, shape, "16x16")


def test_dp_moves_fewer_collective_bytes_than_tp_for_dense_training(records):
    """At full size (granite-3-8b, train_4k, 16x16): ZeRO-3's parameter
    gathers against tensor parallelism's activation gathers.  (The smoke
    config has no FSDP and 64-wide activations, so it shows nothing.)"""
    tp = records["16x16"][f"{ARCHS['dense']}/train_4k/tp/False"]["collectives"]["total_bytes"]
    dp = records["16x16"][f"{ARCHS['dense']}/train_4k/dp/False"]["collectives"]["total_bytes"]
    assert 0 < dp < tp


def test_h100_roofline_constants():
    assert (dryrun.PEAK_FLOPS, dryrun.HBM_BW, dryrun.NVLINK_BW, dryrun.NET_BW) == (989e12, 3.35e12, 450e9, 50e9)


POPSIM_FIELDS = {"arch", "shape", "mesh", "chips", "kind", "ok", "compile_s", "flops_per_device", "bytes_per_device",
                 "collectives"}


def test_cli_writes_a_record_and_popsim_names_the_next_slice(tmp_path):
    """The CLI writes a cell's record, and ``--popsim`` writes the
    population-DSE step's record on 16x16: the reference's fields, 256 chips, and per rank the FLOPs of the unsharded
    step on the same local problem (4,096 / 16 members, one of the 16
    workloads) plus the three divisions of a member's local mean by the 16
    ranks of "model" (the loss's, its gradient's, the new objective's), and
    the all-reduces over "model" that make the workload mean."""
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "granite-3-8b", "--shape",
                          "decode_32k", "--reduced", "--out", str(tmp_path)], capture_output=True, text=True,
                         env=ENV, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    rec = json.loads((tmp_path / "granite-3-8b-smoke__decode_32k__16x16.json").read_text())
    assert rec["ok"] and "[dryrun] granite-3-8b-smoke x decode_32k [16x16]: OK" in out.stdout

    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--popsim", "--out", str(tmp_path)],
                         capture_output=True, text=True, env=ENV, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    rec = json.loads((tmp_path / "popsim__16x16.json").read_text())
    assert set(rec) == POPSIM_FIELDS and "[dryrun] popsim 16x16: OK" in out.stdout
    assert (rec["arch"], rec["shape"], rec["mesh"], rec["chips"], rec["kind"], rec["ok"]) == \
        ("dragon-popsim-dse", "pop4096", "16x16", 256, "dse", True)
    from repro_torch.core.graph import Graph
    from repro_torch.core.popsim import init_population, make_dse_step
    from repro_torch.workloads import get_workload

    local = dryrun.POPSIM_MEMBERS // 16
    pop = tuple(t.map(lambda x: x.to("meta")) for t in init_population(0, local, device="cpu"))
    graphs = Graph.stack([get_workload("bert_base", device="cpu")]).to("meta")
    assert rec["flops_per_device"] == program_costs(make_dse_step(), pop, graphs)["flops"] + 3 * local
    coll = rec["collectives"]
    assert coll["total_bytes"] > 0 and set(coll["bytes_by_kind"]) == {"all-reduce"}
