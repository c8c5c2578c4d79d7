"""The port's GPipe (``train/pipeline.py``) and ``compressed_psum`` against
the reference on the CPU.

* The reference's own ``gpipe`` body runs in this process under
  ``jax.vmap(apply, in_axes=(0, None), axis_name="stage")`` (its
  ``ppermute``, ``all_gather`` and ``axis_index`` run under vmap on one CPU
  device), the stacked params reshaped to [S, L/S, ...].
* One spawn of two gloo ranks runs the port's ``pipeline_apply`` at S = 2 on
  the same numpy-seeded W and x at M = 4 and 8 (y, and the gradients of W
  and x through ``y.sum()``), and ``compressed_psum`` over the two ranks; the
  reference's ``compressed_psum`` runs under ``jax.vmap(..., axis_name="i")``
  over the two ranks' stacked gradient trees.
* One stage on a one-rank gloo group in this process: equal bit for bit to
  the same layers applied microbatch by microbatch in a plain loop.

Tolerances are ``tests/test_pipeline.py``'s: y within 1e-6, the gradients
within 1e-5 (float32; the pipeline reorders no sum but the gradient's over
microbatches).  ``compressed_psum``'s mean and residual within 1e-6.
"""
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.optim.grad_compress import compressed_psum as ref_compressed_psum
from repro.train.pipeline import gpipe as ref_gpipe
from repro_torch.optim import compressed_psum, ef_compress_tree
from repro_torch.train import gpipe, pipeline_apply

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
L, D, B = 8, 16, 8
Y_TOL, GRAD_TOL, PSUM_TOL = 1e-6, 1e-5, 1e-6
GRAD_SHAPES = {"a": (4, 512), "b": (3, 300), "c": (700,)}  # "b": a last dim that is no whole number of blocks


def weights():
    rng = np.random.default_rng(0)
    return (rng.standard_normal((L, D, D)) * 0.2).astype(np.float32), rng.standard_normal((B, D)).astype(np.float32)


def grad_trees():
    """Each rank's gradient tree and carried residual, [2, ...] stacked."""
    rng = np.random.default_rng(1)
    g = {k: rng.standard_normal((2,) + s).astype(np.float32) for k, s in GRAD_SHAPES.items()}
    e = {k: (1e-3 * rng.standard_normal((2,) + s)).astype(np.float32) for k, s in GRAD_SHAPES.items()}
    return g, e


# --------------------------------------------------------------------------- #
# the reference, in this process
# --------------------------------------------------------------------------- #


def ref_layer(w, h):
    return jnp.tanh(h @ w)


def ref_sequential(W, x):
    h, _ = jax.lax.scan(lambda h, w: (ref_layer(w, h), None), x, W)
    return h


def ref_pipeline(W, x, S: int, M: int):
    """The reference's gpipe body under vmap over S stages: y [B, D]."""
    apply = ref_gpipe(ref_layer, S, M)
    outs = jax.vmap(apply, in_axes=(0, None), axis_name="stage")(W.reshape((S, L // S) + W.shape[1:]),
                                                                 x.reshape((M, B // M) + x.shape[1:]))
    return outs[0].reshape(x.shape)


@pytest.fixture(scope="module")
def reference():
    W, x = (jnp.asarray(a) for a in weights())
    out = {"seq": (np.asarray(ref_sequential(W, x)),
                   *(np.asarray(g) for g in jax.grad(lambda W, x: ref_sequential(W, x).sum(), (0, 1))(W, x)))}
    for S, M in ((2, 4), (2, 8), (4, 4)):
        f = lambda W, x: ref_pipeline(W, x, S, M)  # noqa: E731
        out[(S, M)] = (np.asarray(f(W, x)),
                       *(np.asarray(g) for g in jax.grad(lambda W, x: f(W, x).sum(), (0, 1))(W, x)))
    g, e = grad_trees()
    mean, err = jax.vmap(lambda g, e: ref_compressed_psum(g, "i", e), axis_name="i")(
        {k: jnp.asarray(v) for k, v in g.items()}, {k: jnp.asarray(v) for k, v in e.items()})
    out["psum"] = ({k: np.asarray(v) for k, v in mean.items()}, {k: np.asarray(v) for k, v in err.items()})
    return out


def test_reference_gpipe_under_vmap_matches_its_sequential_stack(reference):
    """The harness itself: at S = 4, M = 4 the reference's pipeline under
    vmap gives its sequential stack's y and gradients."""
    y, gW, gx = reference[(4, 4)]
    sy, sW, sx = reference["seq"]
    assert np.abs(y - sy).max() < Y_TOL
    assert np.abs(gW - sW).max() < GRAD_TOL and np.abs(gx - sx).max() < GRAD_TOL


# --------------------------------------------------------------------------- #
# two gloo ranks, one spawn
# --------------------------------------------------------------------------- #

_WORKER = r'''
import os, sys
import numpy as np, torch, torch.distributed as dist, torch.multiprocessing as mp


def worker(rank, port, root):
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank, world_size=2)
    sys.path.insert(0, os.environ["REPRO_SRC"])
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch.optim import compressed_psum
    from repro_torch.train import pipeline_apply
    inp = np.load(os.path.join(root, "inputs.npz"))
    layer = lambda w, h: torch.tanh(h @ w)
    mesh = DeviceMesh("cpu", torch.arange(2), mesh_dim_names=("stage",))
    out = {}
    for M in (4, 8):
        W = torch.tensor(inp["W"], requires_grad=True)
        x = torch.tensor(inp["x"], requires_grad=True)
        y = pipeline_apply(mesh, layer, W, x, n_microbatches=M)
        y.sum().backward()
        out[f"y{M}"], out[f"gW{M}"], out[f"gx{M}"] = y.detach().numpy(), W.grad.numpy(), x.grad.numpy()
    with torch.no_grad():
        out["y_nograd"] = pipeline_apply(mesh, layer, torch.tensor(inp["W"]), torch.tensor(inp["x"]),
                                         n_microbatches=4).numpy()
    keys = [k[2:] for k in inp.files if k.startswith("g/")]
    grads = {k: torch.tensor(inp["g/" + k][rank]) for k in keys}
    errs = {k: torch.tensor(inp["e/" + k][rank]) for k in keys}
    mean, err = compressed_psum(grads, "stage", errs, mesh=mesh)
    for k in keys:
        out["mean/" + k], out["err/" + k] = mean[k].numpy(), err[k].numpy()
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
def two_ranks(tmp_path_factory):
    root = tmp_path_factory.mktemp("pipe2")
    W, x = weights()
    g, e = grad_trees()
    np.savez(root / "inputs.npz", W=W, x=x, **{"g/" + k: v for k, v in g.items()},
             **{"e/" + k: v for k, v in e.items()})
    (root / "worker.py").write_text(_WORKER)
    env = dict(os.environ, PYTHONPATH=str(SRC), REPRO_SRC=str(SRC), OMP_NUM_THREADS="2")
    out = subprocess.run([sys.executable, str(root / "worker.py"), str(root)], capture_output=True, text=True,
                         env=env, timeout=180)
    assert out.returncode == 0, out.stderr[-4000:]
    return [dict(np.load(root / f"rank{r}.npz")) for r in range(2)]


@pytest.mark.parametrize("M", [4, 8])
def test_two_stage_gpipe_matches_the_reference_and_the_sequential_stack(two_ranks, reference, M):
    ry, rW, rx = reference[(2, M)]
    sy, sW, sx = reference["seq"]
    for r in two_ranks:
        y, gW, gx = r[f"y{M}"], r[f"gW{M}"], r[f"gx{M}"]
        assert np.abs(y - ry).max() < Y_TOL and np.abs(y - sy).max() < Y_TOL
        assert np.abs(gW - rW).max() < GRAD_TOL and np.abs(gW - sW).max() < GRAD_TOL
        assert np.abs(gx - rx).max() < GRAD_TOL and np.abs(gx - sx).max() < GRAD_TOL


def test_two_stage_gpipe_gives_every_rank_the_same_results(two_ranks):
    """y is equal on both stages, and so are the plain leaves' gradients
    (each stage's rows reach every rank; x's from stage 0 alone)."""
    a, b = two_ranks
    for k in ("y4", "gW4", "gx4", "y8", "gW8", "gx8", "y_nograd"):
        assert np.array_equal(a[k], b[k]), k
    assert np.array_equal(a["y_nograd"], a["y4"])


def test_two_rank_compressed_psum_matches_the_reference(two_ranks, reference):
    mean, err = reference["psum"]
    for rank, r in enumerate(two_ranks):
        for k in GRAD_SHAPES:
            assert np.abs(r["mean/" + k] - mean[k][rank]).max() < PSUM_TOL, k
            assert np.abs(r["err/" + k] - err[k][rank]).max() < PSUM_TOL, k


# --------------------------------------------------------------------------- #
# one rank, in this process
# --------------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def one_rank():
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        from torch.distributed.device_mesh import DeviceMesh

        yield DeviceMesh("cpu", torch.arange(1), mesh_dim_names=("stage",))
    finally:
        dist.destroy_process_group()


def _layer(w, h):
    return torch.tanh(h @ w)


@pytest.mark.parametrize("M", [1, 4])
def test_one_stage_is_the_plain_loop_bit_for_bit(one_rank, M):
    W0, x0 = weights()
    W, x = torch.tensor(W0, requires_grad=True), torch.tensor(x0, requires_grad=True)
    y = pipeline_apply(one_rank, _layer, W, x, n_microbatches=M)
    y.sum().backward()
    Wp, xp = torch.tensor(W0, requires_grad=True), torch.tensor(x0, requires_grad=True)
    outs = []
    for h in xp.reshape(M, B // M, D):
        for i in range(L):
            h = _layer(Wp[i], h)
        outs.append(h)
    yp = torch.stack(outs).reshape(B, D)
    yp.sum().backward()
    assert torch.equal(y, yp) and torch.equal(W.grad, Wp.grad) and torch.equal(x.grad, xp.grad)


def test_gpipe_alone_on_one_stage(one_rank):
    """``gpipe``'s apply on this rank's tensors: [M, mb, ...] in, out."""
    W0, x0 = weights()
    apply = gpipe(_layer, 1, 2)
    got = apply(torch.tensor(W0), torch.tensor(x0).reshape(2, B // 2, D), one_rank)
    assert got.shape == (2, B // 2, D)
    assert torch.equal(got.reshape(B, D), pipeline_apply(one_rank, _layer, torch.tensor(W0), torch.tensor(x0),
                                                         n_microbatches=2))


def test_batch_not_a_multiple_of_the_microbatches_raises(one_rank):
    W0, x0 = weights()
    with pytest.raises(ValueError, match="microbatches"):
        pipeline_apply(one_rank, _layer, torch.tensor(W0), torch.tensor(x0), n_microbatches=3)


def test_one_rank_compressed_psum_is_ef_compress_tree_bit_for_bit(one_rank):
    g, e = grad_trees()
    grads = {k: torch.tensor(v[0]) for k, v in g.items()}
    errs = {k: torch.tensor(v[0]) for k, v in e.items()}
    mean, err = compressed_psum(grads, "stage", errs, mesh=one_rank)
    want, want_err = ef_compress_tree(grads, errs)
    for k in GRAD_SHAPES:
        assert torch.equal(mean[k], want[k]) and torch.equal(err[k], want_err[k]), k
    # the default group when no mesh is given
    mean2, _ = compressed_psum(grads, "stage", errs)
    assert all(torch.equal(mean2[k], want[k]) for k in GRAD_SHAPES)
