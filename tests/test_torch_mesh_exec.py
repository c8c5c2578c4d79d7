"""The model zoo on a device mesh (``mesh=``) against the same programs
without one, on the CPU.

* A one-rank gloo mesh in this process gives exactly the unsharded results
  (train step, prefill, two decode steps) for a reduced dense config.
* One spawn of two gloo ranks covers tp (1, 2) and dp (2, 1) for a reduced
  dense config and a reduced zamba2 (loss, gradients, prefill and decode
  logits), the dense config with one KV head in tp (query heads split over
  ranks that the KV heads are not), the expert-parallel MoE at (1, 2) against ``moe_ffn`` on one
  device, and a Trainer on the (1, 2) mesh that restarts from its
  checkpoint against an uninterrupted run.

Tolerances (float32).  Splitting a product's contraction or a reduction
over two ranks reorders float32 sums: each sum of n terms moves by at most
~n·eps relative to its magnitude (eps = 2^-23 ≈ 1.2e-7).  The widest sums
here run over d = 64, the 2 x 32 tokens of a batch and, in the gradients,
back through two layers, so a leaf's gradient is held at 1e-4 of its
largest entry (n·eps ≈ 64 x 64 x 1.2e-7 ≈ 5e-4 bounds it; the runs stay
under 3e-5), logits at 1e-5 of their largest, the loss at rtol 1e-6."""
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch import tree as tu
from repro_torch.configs import SHAPES, get_config
from repro_torch.data import make_batch
from repro_torch.launch.mesh import make_local_mesh, mesh_chips
from repro_torch.launch.specs import batch_specs, distribute_tree
from repro_torch.models import build_model
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.train_step import TrainConfig, distribute_train_state, init_train_state, make_train_step

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
GRAD_TOL, LOGIT_TOL, LOSS_RTOL = 1e-4, 1e-5, 1e-6


# --------------------------------------------------------------------------- #
# one rank, in this process: bit for bit
# --------------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def one_rank_mesh():
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield make_local_mesh()
    finally:
        dist.destroy_process_group()


def test_one_rank_mesh_is_a_1x1_mesh(one_rank_mesh):
    assert one_rank_mesh.mesh_dim_names == ("data", "model") and mesh_chips(one_rank_mesh) == 1


@pytest.mark.parametrize("int8", [False, True])
def test_one_rank_train_step_is_bit_equal(one_rank_mesh, int8):
    cfg = get_config("granite-3-8b").reduced()
    model = build_model(cfg)
    ocfg, tcfg = AdamWConfig(int8_states=int8), TrainConfig(microbatches=2)
    s1 = init_train_state(model, 0, ocfg, tcfg, "cpu")
    s2 = distribute_train_state(init_train_state(model, 0, ocfg, tcfg, "cpu"), model, ocfg, tcfg, one_rank_mesh)
    f1, f2 = make_train_step(model, ocfg, tcfg), make_train_step(model, ocfg, tcfg, mesh=one_rank_mesh)
    for step in range(2):
        batch = make_batch(cfg, SHAPES["train_4k"], step, batch_override=4, seq_override=32)
        s1, m1 = f1(s1, batch)
        s2, m2 = f2(s2, batch)
        for k in m1:
            assert torch.equal(m1[k], m2[k]), k
    for (path, a), b in zip(tu.leaves_with_path(s1), tu.leaves(s2)):
        assert torch.equal(a, b.full_tensor()), path


def test_one_rank_prefill_and_decode_are_bit_equal(one_rank_mesh):
    model = build_model(get_config("granite-3-8b").reduced())
    params = model.init(0, "cpu")
    dparams = distribute_tree(params, one_rank_mesh, model.specs(one_rank_mesh))
    toks = torch.randint(0, model.cfg.vocab_size, (2, 24), generator=torch.Generator().manual_seed(1))
    dtoks = distribute_tree({"tokens": toks}, one_rank_mesh, batch_specs(model.cfg, one_rank_mesh,
                                                                         {"tokens": toks}))["tokens"]
    with torch.no_grad():
        la, ca = model.prefill(params, toks, max_len=40)
        lb, cb = model.prefill(dparams, dtoks, max_len=40, mesh=one_rank_mesh)
        assert torch.equal(la, lb.full_tensor())
        nxt = la.argmax(-1, keepdim=True)
        for _ in range(2):
            la, ca = model.decode_step(params, nxt, ca)
            lb, cb = model.decode_step(dparams, nxt, cb, mesh=one_rank_mesh)
            assert torch.equal(la, lb.full_tensor())
            nxt = la.argmax(-1, keepdim=True)
    for k in ca:
        assert torch.equal(ca[k], cb[k].full_tensor() if hasattr(cb[k], "full_tensor") else cb[k]), k


# --------------------------------------------------------------------------- #
# two gloo ranks, one spawn
# --------------------------------------------------------------------------- #

_WORKER = r'''
import dataclasses, json, os, sys
import torch, torch.distributed as dist, torch.multiprocessing as mp


def cfg_of(arch):
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(arch).reduced(), dtype="float32")


def rel(a, b):
    b = b.full_tensor() if hasattr(b, "full_tensor") else b
    return float((a - b).abs().max() / a.abs().max().clamp(min=1e-30))


def family(model, mesh):
    from repro_torch import tree as tu
    from repro_torch.launch.specs import batch_specs, distribute_tree
    from repro_torch.models.model import on_mesh
    params = model.init(0, "cpu")
    g = torch.Generator().manual_seed(0)
    toks = torch.randint(0, model.cfg.vocab_size, (4, 32), generator=g)
    batch = {"tokens": toks, "labels": toks.roll(1, 1)}
    dparams = distribute_tree(params, mesh, model.specs(mesh))
    dbatch = distribute_tree(batch, mesh, batch_specs(model.cfg, mesh, batch))
    live = tu.tree_map(lambda p: p.detach().requires_grad_(True), params)
    dlive = tu.tree_map(lambda p: p.detach().requires_grad_(True), dparams)
    l1, _ = model.loss(live, batch)
    g1 = torch.autograd.grad(l1, tu.leaves(live))
    with on_mesh(mesh):
        l2, _ = model.loss(dlive, dbatch, mesh=mesh)
        g2 = torch.autograd.grad(l2, tu.leaves(dlive))
    out = {"loss": [float(l1), float(l2.full_tensor())], "grad": max(rel(a, b) for a, b in zip(g1, g2))}
    with torch.no_grad():
        la, ca = model.prefill(params, toks, max_len=40)
        lb, cb = model.prefill(dparams, dbatch["tokens"], max_len=40, mesh=mesh)
        out["prefill"] = rel(la, lb)
        nxt = la.argmax(-1, keepdim=True)
        errs = []
        for _ in range(2):
            la, ca = model.decode_step(params, nxt, ca)
            lb, cb = model.decode_step(dparams, nxt, cb, mesh=mesh)
            errs.append(rel(la, lb))
            nxt = la.argmax(-1, keepdim=True)
        out["decode"] = max(errs)
    return out


def moe(mesh):
    from repro_torch.models.model import on_mesh
    from repro_torch.models.moe import moe_ffn, moe_ffn_expert_parallel
    from repro_torch.models.sharding import Spec, distribute
    g = torch.Generator().manual_seed(0)
    T, d, E, f, k = 64, 32, 4, 16, 2
    x = torch.randn(T, d, generator=g)
    ws = [torch.randn(d, E, generator=g) * 0.1, torch.randn(E, d, f, generator=g) / d ** .5,
          torch.randn(E, d, f, generator=g) / d ** .5, torch.randn(E, f, d, generator=g) / f ** .5]
    ins = [t.clone().requires_grad_() for t in [x] + ws]
    # capacity 4.0: every assignment fits in both (no drops), so both compute the same function
    o1 = moe_ffn(*ins, top_k=k, capacity_factor=4.0)
    (o1.y.square().sum() + o1.aux_loss + o1.z_loss).backward()
    sp = [Spec("data", "model"), Spec(None, None), Spec("model", None, None), Spec("model", None, None),
          Spec("model", None, None)]
    dins = [distribute(t, mesh, s).detach().requires_grad_() for t, s in zip([x] + ws, sp)]
    with on_mesh(mesh):
        o2 = moe_ffn_expert_parallel(*dins, top_k=k, capacity_factor=4.0, mesh=mesh, compute_dtype=torch.float32)
        (o2.y.square().sum() + o2.aux_loss + o2.z_loss).backward()
    return {"y": rel(o1.y, o2.y), "aux": [float(o1.aux_loss), float(o2.aux_loss.full_tensor())],
            "z": [float(o1.z_loss), float(o2.z_loss.full_tensor())],
            "dropped": float(o2.dropped_frac.full_tensor()),
            "grad": [rel(a.grad, b.grad) for a, b in zip(ins, dins)]}


def trainer(mesh, root):
    from repro_torch import tree as tu
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models import build_model
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train import TrainConfig, Trainer, TrainerConfig
    model = build_model(cfg_of("granite-3-8b"))
    shape = ShapeConfig("t", 32, 4, "train")
    quiet = lambda s: None

    def run(d, steps):
        rcfg = TrainerConfig(steps=steps, ckpt_every=2, ckpt_dir=d, log_every=0)
        return Trainer(model, shape, AdamWConfig(), TrainConfig(), rcfg, log_fn=quiet, device="cpu", mesh=mesh).run()

    full = run(os.path.join(root, "a"), 4)
    run(os.path.join(root, "b"), 2)   # stops after its step-2 checkpoint
    resumed = run(os.path.join(root, "b"), 4)  # restores step 2 onto the mesh, runs 2 more
    eq = all(torch.equal(a.full_tensor(), b.full_tensor())
             for a, b in zip(tu.leaves(full["state"]), tu.leaves(resumed["state"])))
    placed = all(hasattr(x, "placements") for x in tu.leaves(resumed["state"]))
    return {"equal": eq, "placed": placed, "losses": [full["losses"][2:], resumed["losses"]]}


def worker(rank, port, root):
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank, world_size=2)
    sys.path.insert(0, os.environ["REPRO_SRC"])
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import build_model
    res = {}
    for name, ma in (("tp", 2), ("dp", 1)):
        mesh = make_local_mesh(ma)
        for arch in ("granite-3-8b", "zamba2-1.2b"):
            res[f"{arch}/{name}"] = family(build_model(cfg_of(arch)), mesh)
    # one KV head against query heads split 2 ways: each rank reads a copy of it
    mqa = dataclasses.replace(cfg_of("granite-3-8b"), n_kv_heads=1)
    res["granite-3-8b-mqa/tp"] = family(build_model(mqa), make_local_mesh(2))
    res["moe"] = moe(make_local_mesh(2))
    res["trainer"] = trainer(make_local_mesh(2), root)
    if rank == 0:
        with open(os.path.join(root, "result.json"), "w") as f:
            json.dump(res, f)
    dist.destroy_process_group()


if __name__ == "__main__":
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    mp.spawn(worker, args=(port, sys.argv[1]), nprocs=2)
'''


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    root = tmp_path_factory.mktemp("mesh2")
    script = root / "worker.py"
    script.write_text(_WORKER)
    env = dict(os.environ, PYTHONPATH=str(SRC), REPRO_SRC=str(SRC), OMP_NUM_THREADS="2")
    out = subprocess.run([sys.executable, str(script), str(root)], capture_output=True, text=True, env=env,
                         timeout=240)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads((root / "result.json").read_text())


@pytest.mark.parametrize("case", ["granite-3-8b/tp", "granite-3-8b/dp", "zamba2-1.2b/tp", "zamba2-1.2b/dp",
                                  "granite-3-8b-mqa/tp"])
def test_two_rank_loss_grads_and_logits(two_ranks, case):
    r = two_ranks[case]
    assert r["loss"][1] == pytest.approx(r["loss"][0], rel=LOSS_RTOL)
    assert r["grad"] < GRAD_TOL
    assert r["prefill"] < LOGIT_TOL and r["decode"] < LOGIT_TOL


def test_two_rank_expert_parallel_moe_matches_moe_ffn(two_ranks):
    r = two_ranks["moe"]
    assert r["dropped"] == 0.0
    assert r["y"] < LOGIT_TOL
    assert r["aux"][1] == pytest.approx(r["aux"][0], rel=LOSS_RTOL)
    assert r["z"][1] == pytest.approx(r["z"][0], rel=LOSS_RTOL)
    assert max(r["grad"]) < GRAD_TOL  # x, router, w_gate, w_up, w_down


def test_two_rank_trainer_restart_equals_uninterrupted_run(two_ranks):
    r = two_ranks["trainer"]
    assert r["placed"] and r["equal"]
    assert r["losses"][0] == r["losses"][1]
    assert np.all(np.isfinite(r["losses"][0]))
