"""Dry run: every (architecture x input shape) cell run once against the
production mesh — 16x16 = 256 ranks single-pod, 2x16x16 = 512 multi-pod —
without allocating, and what one rank does recorded for the roofline.

The mesh comes from a fake process group (``FakeStore``, backend "fake") of
256 or 512 ranks, whose collectives complete at once; every parameter,
optimizer state, batch and cache is a DTensor of ``meta`` tensors laid out
by ``launch.specs``; one train step, prefill or decode step runs under
``hlo_costs.trace``.  The record holds the reference's fields but its two
``xla_*`` ones:

  * ``flops_per_device`` / ``bytes_per_device`` / ``*_by_op``: the rank's
    own ops (``hlo_costs``);
  * ``collectives``: its collectives' link bytes (``hlo_stats``), and
    ``scan_trip_counts``: the layer loops the model ran;
  * ``memory``: ``argument`` / ``output`` — the rank's shards of the inputs
    and outputs; ``alias`` — the state (train) or cache (decode) updated in
    place; ``temp`` — the peak of live bytes the traced ops allocated;
    ``generated_code`` — 0 (nothing is compiled);
  * ``lower_s``: seconds to build the sharded inputs; ``compile_s``: seconds
    of the traced run;
  * ``roofline``: the three terms over an NVIDIA H100 SXM's rates below.

``--popsim`` runs DRAGON's own population-DSE step instead
(:func:`run_popsim`): 4,096 members over ("pod", "data"), bert_base stacked
once for each rank of "model" over it, one ``popsim.make_dse_step(mesh=)``
step whose workload mean is an all-reduce over "model"; its record has the
reference's fields (``compile_s``: the traced run's seconds) and goes to
``popsim__{mesh}.json``.

The fake group is process-global: each process runs one mesh size, and
``--multipod both`` runs the two in subprocesses of their own.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen2.5-32b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multipod both] [--out results/dryrun_torch]
  python -m repro_torch.launch.dryrun --arch granite-3-8b --shape train_4k --reduced   # smoke size
  python -m repro_torch.launch.dryrun --popsim [--multipod both]

``--reduced`` runs each arch's smoke-size config (a MoE's with 16 experts at
least, so that each rank of the model axis holds one) at the full shapes.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
import traceback

import torch
import torch.distributed as dist

from repro_torch import tree as tu
from repro_torch.configs import SHAPES, all_archs, cell_status, get_config
from repro_torch.launch.hlo_costs import trace
from repro_torch.launch.hlo_stats import collective_seconds, collective_stats, layer_loops
from repro_torch.launch.mesh import make_production_mesh, mesh_chips
from repro_torch.launch.specs import abstract_batch, batch_specs, distribute_tree
from repro_torch.models.model import build_model
from repro_torch.models.sharding import Spec, axis_names, distribute, is_dtensor, parallelism as parallelism_ctx, \
    repair_spec
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.train_step import TrainConfig, abstract_train_state, distribute_train_state, make_train_step

# NVIDIA H100 SXM5 80GB HBM3 at 700 W, per GPU (NVIDIA's H100 data sheet)
PEAK_FLOPS = 989e12  # dense bf16 tensor-core FLOP/s
HBM_BW = 3.35e12  # HBM3 bytes/s
NVLINK_BW = 450e9  # NVLink 4 bytes/s per direction: a collective group inside one 8-GPU node
NET_BW = 50e9  # one 400 Gb/s NDR InfiniBand port a GPU: a group that spans nodes

POPSIM_MEMBERS = 4096


def opt_cfg_for(cfg) -> AdamWConfig:
    # trillion-param MoE: int8 moments or optimizer state cannot fit device memory
    int8 = cfg.family == "moe" and cfg.moe.n_experts >= 64
    return AdamWConfig(int8_states=int8)


def start_fake_group(world: int) -> None:
    """A fake process group of ``world`` ranks (this process is rank 0)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() != world:
            raise RuntimeError(f"a process group of {dist.get_world_size()} ranks is already started")
        return
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)


def _present(mesh, axes):
    got = tuple(a for a in axes if a in axis_names(mesh))
    return got if len(got) > 1 else (got[0] if got else None)


def _local_bytes(tree) -> int:
    """Bytes of this rank's shards of a tree's tensors."""
    total = 0
    for x in tu.leaves(tree):
        if isinstance(x, torch.Tensor):
            t = x.to_local() if is_dtensor(x) else x
            total += t.numel() * t.element_size()
    return total


def _config(arch: str, reduced: bool):
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
        if cfg.moe is not None:  # one expert a rank of the 16-wide model axis at least
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, n_experts=max(cfg.moe.n_experts, 16)))
    return cfg


def _build_cell(cfg, shape, mesh):
    """(fn, args, alias tree) of the cell's program on meta DTensors."""
    model = build_model(cfg)
    if shape.kind == "train":
        ocfg, tcfg = opt_cfg_for(cfg), TrainConfig()
        step = make_train_step(model, ocfg, tcfg, mesh=mesh)
        state = distribute_train_state(abstract_train_state(model, ocfg, tcfg), model, ocfg, tcfg, mesh)
        batch = abstract_batch(cfg, shape)
        return step, (state, distribute_tree(batch, mesh, batch_specs(cfg, mesh, batch))), state
    params = distribute_tree(model.abstract_params(), mesh, model.specs(mesh))
    if shape.kind == "prefill":
        batch = abstract_batch(cfg, shape)
        bspec = batch_specs(cfg, mesh, batch)
        toks = distribute(batch["tokens"], mesh, bspec["tokens"])
        vision = distribute(batch["vision"], mesh, bspec["vision"]) if cfg.vision else None

        def prefill(p, t):
            with torch.no_grad():
                return model.prefill(p, t, max_len=shape.seq_len, vision=vision, mesh=mesh)

        return prefill, (params, toks), None
    # decode at 500k with batch 1: shard the KV-cache sequence dim instead of the unshardable batch
    B, M = shape.global_batch, shape.seq_len
    sizes = dict(zip(axis_names(mesh), mesh.shape))
    seq_shard = B < sizes.get("data", 1) * sizes.get("pod", 1)
    cache = distribute_tree(model.abstract_cache(B, M), mesh, model.cache_specs(mesh, B, M, seq_shard=seq_shard))
    tok_shape = (B, 1, cfg.audio.n_codebooks) if cfg.audio else (B, 1)
    tspec = repair_spec(Spec(_present(mesh, ("pod", "data")), *([None] * (len(tok_shape) - 1))), tok_shape, mesh)
    toks = distribute(torch.empty(tok_shape, dtype=torch.int64, device="meta"), mesh, tspec)

    def decode(p, t, c):
        with torch.no_grad():
            return model.decode_step(p, t, c, mesh=mesh, seq_shard=seq_shard)

    return decode, (params, toks, cache), cache


def run_cell(arch: str, shape_name: str, multi_pod: bool, parallelism: str = "tp", reduced: bool = False) -> dict:
    """One cell on the production mesh (the fake group must be started with
    its rank count).  Returns the record."""
    cfg = _config(arch, reduced)
    shape = SHAPES[shape_name]
    mesh = make_production_mesh(multi_pod=multi_pod)
    t0 = time.time()
    with parallelism_ctx(parallelism):
        fn, args, alias = _build_cell(cfg, shape, mesh)
        t_lower = time.time() - t0
        tr = trace(fn, *args)
    t_compile = time.time() - t0 - t_lower
    costs = tr.costs()
    memory = {
        "argument_size_in_bytes": _local_bytes(args),
        "output_size_in_bytes": _local_bytes(tr.result),
        "temp_size_in_bytes": int(tr.peak_bytes),
        "alias_size_in_bytes": _local_bytes(alias) if alias is not None else 0,
        "generated_code_size_in_bytes": 0,
    }
    rec = {
        "arch": arch + ("-smoke" if reduced else ""),
        "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "chips": mesh_chips(mesh),
        "kind": shape.kind,
        "parallelism": parallelism,
        "ok": True,
        "lower_s": round(t_lower, 2),
        "compile_s": round(t_compile, 2),
        "memory": memory,
        "collectives": collective_stats(tr),
        "scan_trip_counts": layer_loops(tr)[:32],
        "flops_per_device": costs["flops"],
        "bytes_per_device": costs["bytes"],
        "flops_by_op": costs["flops_by_op"],
        "bytes_by_op": costs["bytes_by_op"],
    }
    live = memory["argument_size_in_bytes"] + memory["output_size_in_bytes"] - memory["alias_size_in_bytes"] \
        + memory["temp_size_in_bytes"]
    rec["hbm_per_device_gb"] = round(live / 1e9, 3)
    rec["roofline"] = {
        "t_compute": rec["flops_per_device"] / PEAK_FLOPS,
        "t_memory": rec["bytes_per_device"] / HBM_BW,
        "t_collective": collective_seconds(tr, NVLINK_BW, NET_BW),
    }
    rec["roofline"]["bottleneck"] = max(rec["roofline"], key=lambda k: rec["roofline"][k])
    return rec


def run_popsim(multi_pod: bool) -> dict:
    """DRAGON's population-DSE step on the production mesh (the fake group
    must be started with its rank count), on meta tensors laid out by
    ``popsim.dse_in_shardings``.  Returns the record."""
    from repro_torch.core.graph import Graph
    from repro_torch.core.popsim import init_population, lay_out_dse_inputs, make_dse_step
    from repro_torch.workloads import get_workload

    mesh = make_production_mesh(multi_pod=multi_pod)
    pop = tuple(t.map(lambda x: x.to("meta")) for t in init_population(0, POPSIM_MEMBERS, device="cpu"))
    graphs = Graph.stack([get_workload("bert_base", device="cpu")] * dict(zip(axis_names(mesh), mesh.shape))["model"])
    pop, graphs = lay_out_dse_inputs(mesh, pop, graphs.to("meta"))
    t0 = time.time()
    tr = trace(make_dse_step(mesh=mesh), pop, graphs)
    t_run = time.time() - t0
    costs = tr.costs()
    return {
        "arch": "dragon-popsim-dse",
        "shape": f"pop{POPSIM_MEMBERS}",
        "mesh": "2x16x16" if multi_pod else "16x16",
        "chips": mesh_chips(mesh),
        "kind": "dse",
        "ok": True,
        "compile_s": round(t_run, 2),
        "flops_per_device": costs["flops"],
        "bytes_per_device": costs["bytes"],
        "collectives": collective_stats(tr),
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--popsim", action="store_true")
    ap.add_argument("--multipod", choices=("on", "off", "both"), default="off")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--resume", action="store_true", help="skip cells with existing JSON")
    ap.add_argument("--parallelism", choices=("tp", "dp", "auto"), default="tp",
                    help="model-axis policy; auto = launch.policy per cell")
    ap.add_argument("--reduced", action="store_true", help="the smoke-size config of each arch (tests)")
    args = ap.parse_args(argv)

    if args.multipod == "both":  # one fake group a process: one subprocess a mesh size
        base = [a for a in (argv if argv is not None else sys.argv[1:])]
        i = base.index("--multipod")
        for mp in ("off", "on"):
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", *base[:i], "--multipod", mp, *base[i + 2:]]
            subprocess.run(cmd, check=True)
        return
    multi_pod = args.multipod == "on"
    os.makedirs(args.out, exist_ok=True)
    start_fake_group(512 if multi_pod else 256)
    if args.popsim:
        rec = run_popsim(multi_pod)
        with open(os.path.join(args.out, f"popsim__{rec['mesh']}.json"), "w") as f:
            json.dump(rec, f, indent=1)
        print(f"[dryrun] popsim {rec['mesh']}: OK run={rec['compile_s']}s flops/dev={rec['flops_per_device']:.4g} "
              f"bytes/dev={rec['bytes_per_device']:.4g} collectives={rec['collectives']['total_bytes']} link bytes",
              flush=True)
        dist.destroy_process_group()
        return

    cells = [(a, s) for a in all_archs() for s in SHAPES] if args.all else [(args.arch, args.shape)]
    failed = 0
    for arch, shape_name in cells:
        status = cell_status(get_config(arch), SHAPES[shape_name])
        mesh_tag = "2x16x16" if multi_pod else "16x16"
        name = arch + ("-smoke" if args.reduced else "")
        fn = os.path.join(args.out, f"{name}__{shape_name}__{mesh_tag}.json")
        if args.resume and os.path.exists(fn):
            print(f"[dryrun] skip existing {fn}")
            continue
        if status != "run":
            rec = {"arch": name, "shape": shape_name, "mesh": mesh_tag, "ok": True, "skipped": status}
            print(f"[dryrun] {name} x {shape_name} [{mesh_tag}]: SKIP ({status})")
        else:
            try:
                par = args.parallelism
                if par == "auto":
                    from repro_torch.launch.policy import parallelism_for

                    par = parallelism_for(get_config(arch), SHAPES[shape_name])
                rec = run_cell(arch, shape_name, multi_pod, parallelism=par, reduced=args.reduced)
                r = rec["roofline"]
                print(f"[dryrun] {name} x {shape_name} [{mesh_tag}]: OK "
                      f"run={rec['compile_s']:.1f}s hbm/dev={rec['hbm_per_device_gb']}GB "
                      f"t_comp={r['t_compute']:.3e} t_mem={r['t_memory']:.3e} "
                      f"t_coll={r['t_collective']:.3e} -> {r['bottleneck']}", flush=True)
            except Exception as e:  # noqa: BLE001  (recorded, the run goes on to the next cell)
                failed += 1
                rec = {"arch": name, "shape": shape_name, "mesh": mesh_tag, "ok": False,
                       "error": f"{type(e).__name__}: {e}", "traceback": traceback.format_exc()[-4000:]}
                print(f"[dryrun] {name} x {shape_name} [{mesh_tag}]: FAIL {type(e).__name__}: {e}", flush=True)
        with open(fn, "w") as f:
            json.dump(rec, f, indent=1)
    dist.destroy_process_group()
    if failed:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
