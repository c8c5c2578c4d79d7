"""Make ``tests/data/torch_train_ref.npz``: the reference package's training
numbers for granite-3-8b at full width, on numpy weights that the PyTorch
port regenerates from a seed.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/make_torch_train_ref.py [--check-port]

The configuration: granite-3-8b with 2 of its 40 layers, ``dtype="float32"``
(full width: d_model 4096, vocab 49,155; 0.80 B parameters), weights
``repro_torch``'s ``Model.init_numpy(0)``, batches ``make_batch`` of 2 x 128
tokens at steps 0, 1 and 2 (``DataConfig()``).  Stored:

  * ``tokens``, ``labels`` [3, 2, 128]: the batches, as this machine's numpy
    made them (a numpy of another version may draw another Zipf stream;
    ``chip_smoke.py`` trains on these and reports whether its own
    ``make_batch`` reproduces them);
  * ``loss``, ``grad_norm``: the loss and the global grad norm at step 0's
    batch (``Model.loss``, ``jax.value_and_grad``);
  * ``leaves`` (key paths), ``leaf_norm``: each leaf's grad norm;
  * ``idx`` [leaves, 64], ``sample``: each leaf's grad at 64 seeded flat
    indices;
  * ``history``: the losses of 3 AdamW steps (lr 3e-4, fp32 states, no
    schedule), each step's loss before its update, as ``make_train_step``
    reports ``total_loss``;
  * ``spread`` (and ``spread_by``, each nudge's): how far the reference itself
    moves when one weight of both layers (``wq``, ``wk``, ``wv``, ``wo``,
    ``w_gate``, ``w_down``, one run each) moves up by one float32 ulp,
    measured as :func:`distances` measures the port: rel loss, rel grad norm,
    the largest rel leaf norm, the largest sampled-grad error over its leaf's
    scale, the largest rel history loss.

The AdamW steps use the reference's ``adamw_update`` a leaf at a time, with
the grads scaled by the reference's global-norm clip factor beforehand and
the per-call clip off (``grad_clip=inf``, so the call multiplies by 1.0):
the same arithmetic as one call over the tree, with float32 temporaries of
one leaf at a time instead of the whole tree's (the host holds params, grads
and both moments, ~13 GB, at once).

``--check-port`` then runs the port on the CPU against the file just written
and prints its distances beside the spread.  ``chip_smoke.py`` holds the port
on the card against this file (bound: 4x the spread, at least 3e-5).
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import pathlib
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
OUT = ROOT / "tests" / "data" / "torch_train_ref.npz"
NAME, N_LAYERS = "granite-3-8b", 2
SEED = 0
BATCH, SEQ = 2, 128
STEPS = 3
LR = 3e-4
SAMPLES = 64
SAMPLE_SEED = 5
NUDGED = ("wq", "wk", "wv", "wo", "w_gate", "w_down")
MEASURES = ("loss", "grad_norm", "leaf_norm", "sample", "history")


def port_cfg():
    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(NAME), dtype="float32", n_layers=N_LAYERS)


def batches(cfg) -> list[dict]:
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import make_batch

    shape = ShapeConfig("fixture", SEQ, BATCH, "train")
    return [make_batch(cfg, shape, s) for s in range(STEPS)]


def sample_indices(sizes: list[int]) -> np.ndarray:
    rng = np.random.default_rng(SAMPLE_SEED)
    return np.stack([rng.integers(0, n, SAMPLES) for n in sizes]).astype(np.int64)


def distances(got: dict, ref) -> dict:
    """How far ``got`` (loss, grad_norm, leaf_norm [L], sample [L, 64],
    history [3]) is from the fixture's reference values, one number a measure."""
    ref_norm = np.asarray(ref["leaf_norm"], np.float64)
    ref_sample = np.asarray(ref["sample"], np.float64)
    n = np.asarray(ref["leaf_size"], np.float64)
    scale = np.maximum(np.abs(ref_sample).max(1), ref_norm / np.sqrt(n))  # a leaf's scale
    return {
        "loss": abs(float(got["loss"]) - float(ref["loss"])) / abs(float(ref["loss"])),
        "grad_norm": abs(float(got["grad_norm"]) - float(ref["grad_norm"])) / float(ref["grad_norm"]),
        "leaf_norm": float(np.max(np.abs(np.asarray(got["leaf_norm"], np.float64) - ref_norm) / ref_norm)),
        "sample": float(np.max(np.abs(np.asarray(got["sample"], np.float64) - ref_sample).max(1) / scale)),
        "history": float(np.max(np.abs(np.asarray(got["history"], np.float64) - ref["history"]) / np.abs(ref["history"]))),
    }


# --------------------------------------------------------------------------- #
# the reference
# --------------------------------------------------------------------------- #


def reference_run(nudge: str | None = None, idx: np.ndarray | None = None) -> dict:
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jax_config
    from repro.models.model import build_model
    from repro.optim import adamw as A
    from repro_torch.models.model import build_model as port_model

    pcfg = port_cfg()
    cfg = dataclasses.replace(jax_config(NAME), dtype="float32", n_layers=N_LAYERS)
    model = build_model(cfg)
    w = port_model(pcfg).init_numpy(SEED)
    params = jax.tree.map(jnp.asarray, w)
    del w
    gc.collect()
    if nudge is not None:
        params["layers"][nudge] = jnp.nextafter(params["layers"][nudge], jnp.float32(np.inf))
    vg = jax.jit(jax.value_and_grad(lambda p, b: model.loss(p, b)[0]))
    opt = A.AdamWConfig(lr=LR, grad_clip=float("inf"))
    clip_at = A.AdamWConfig().grad_clip
    m = jax.tree.map(lambda p: jnp.zeros(p.shape, jnp.float32), params)
    v = jax.tree.map(lambda p: jnp.zeros(p.shape, jnp.float32), params)
    step = jnp.zeros((), jnp.int32)
    out = {"history": []}
    for s, batch in enumerate(batches(pcfg)):
        loss, grads = vg(params, jax.tree.map(jnp.asarray, batch))
        gnorm = A.global_norm(grads)
        out["history"].append(float(loss))
        if s == 0:
            flat, _ = jax.tree_util.tree_flatten_with_path(grads)
            out["loss"], out["grad_norm"] = float(loss), float(gnorm)
            out["leaves"] = [jax.tree_util.keystr(kp) for kp, _ in flat]
            out["leaf_size"] = [int(np.prod(g.shape)) for _, g in flat]
            out["leaf_norm"] = [float(jnp.sqrt(jnp.sum(jnp.square(g)))) for _, g in flat]
            if idx is None:
                idx = sample_indices(out["leaf_size"])
            out["idx"] = idx
            out["sample"] = np.stack([np.asarray(g).reshape(-1)[i] for (_, g), i in zip(flat, idx)])
        clip = jnp.minimum(1.0, clip_at / jnp.maximum(gnorm, 1e-12))
        # a leaf at a time: the same arithmetic as one adamw_update over the tree
        for path in _paths(params):
            sub = lambda t: _get(t, path)  # noqa: E731
            p1, st, _ = A.adamw_update({"x": sub(params)}, {"x": sub(grads).astype(jnp.float32) * clip},
                                       {"m": {"x": sub(m)}, "v": {"x": sub(v)}, "step": step}, opt)
            _set(params, path, p1["x"])
            _set(m, path, st["m"]["x"])
            _set(v, path, st["v"]["x"])
        step = step + 1
        del grads
        gc.collect()
    out["history"] = np.asarray(out["history"], np.float64)
    del params, m, v
    gc.collect()
    return out


def _paths(tree, prefix=()):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _paths(tree[k], prefix + (k,))
        else:
            yield prefix + (k,)


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _set(tree, path, value):
    _get(tree, path[:-1])[path[-1]] = value


# --------------------------------------------------------------------------- #
# the port on the CPU
# --------------------------------------------------------------------------- #


def port_run(ref, device="cpu") -> dict:
    """The port's numbers for the fixture's configuration on ``device``."""
    import torch

    from repro_torch import tree as tu
    from repro_torch.data import batch_to
    from repro_torch.models.model import build_model, params_from_numpy
    from repro_torch.optim import AdamWConfig, global_norm, init_opt_state
    from repro_torch.train import make_train_step

    cfg = port_cfg()
    model = build_model(cfg)
    params = params_from_numpy(cfg, model.init_numpy(SEED), device)
    data = batches(cfg)
    live = tu.tree_map(lambda p: p.detach().requires_grad_(True), params)
    loss, _ = model.loss(live, batch_to(data[0], params["embed"].device))
    grads = torch.autograd.grad(loss, tu.leaves(live))
    paths = [p for p, _ in tu.leaves_with_path(params)]
    if paths != [str(x) for x in ref["leaves"]]:
        raise ValueError(f"leaf paths {paths} differ from the fixture's")
    got = {"loss": float(loss.detach()), "grad_norm": float(global_norm(list(grads))),
           # a tree sum: torch.linalg.vector_norm of a float32 leaf of 1e8 entries is off by ~1% on the CPU
           "leaf_norm": [float(torch.sqrt(torch.sum(torch.square(g)))) for g in grads],
           "sample": np.stack([g.reshape(-1)[torch.as_tensor(i, device=g.device)].cpu().numpy()
                               for g, i in zip(grads, ref["idx"])])}
    del live, grads, loss
    opt = AdamWConfig(lr=LR)
    state = {"params": params, "opt": init_opt_state(params, opt),
             "step": torch.zeros((), dtype=torch.int32, device=params["embed"].device)}
    step = make_train_step(model, opt)
    got["history"] = [float(step(state, b)[1]["total_loss"]) for b in data]
    return got


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--check-port", action="store_true", help="then hold the port on the CPU against the file")
    args = ap.parse_args()
    t0 = time.perf_counter()
    ref = reference_run()
    print(f"reference: loss {ref['loss']:.8g}, grad norm {ref['grad_norm']:.8g}, history {ref['history']} "
          f"({time.perf_counter() - t0:.1f} s)")
    out = {"name": np.asarray(NAME), "n_layers": np.int64(N_LAYERS), "seed": np.int64(SEED),
           "batch": np.int64(BATCH), "seq": np.int64(SEQ), "lr": np.float64(LR),
           "loss": np.float64(ref["loss"]), "grad_norm": np.float64(ref["grad_norm"]),
           "leaves": np.asarray(ref["leaves"]), "leaf_size": np.asarray(ref["leaf_size"], np.int64),
           "leaf_norm": np.asarray(ref["leaf_norm"], np.float64), "idx": ref["idx"],
           "sample": ref["sample"].astype(np.float32), "history": ref["history"],
           "measures": np.asarray(MEASURES), "numpy": np.asarray(np.__version__),
           "tokens": np.stack([b["tokens"] for b in batches(port_cfg())]),
           "labels": np.stack([b["labels"] for b in batches(port_cfg())])}
    spread = []
    for leaf in NUDGED:
        t0 = time.perf_counter()
        moved = reference_run(leaf, ref["idx"])
        d = distances(moved, out)
        spread.append([d[k] for k in MEASURES])
        print(f"nudge {leaf}: " + ", ".join(f"{k} {d[k]:.3g}" for k in MEASURES)
              + f" ({time.perf_counter() - t0:.1f} s)")
    out["spread_by"] = np.asarray(spread, np.float64)
    out["spread"] = out["spread_by"].max(0)
    OUT.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(OUT, **out)
    print(f"wrote {OUT} ({OUT.stat().st_size} bytes); spread " + ", ".join(
        f"{k} {s:.3g}" for k, s in zip(MEASURES, out["spread"])))
    if args.check_port:
        ref_file = dict(np.load(OUT))
        t0 = time.perf_counter()
        d = distances(port_run(ref_file), ref_file)
        print(f"port on the CPU ({time.perf_counter() - t0:.1f} s): " + ", ".join(
            f"{k} {d[k]:.3g} (spread {s:.3g}, {d[k] / max(s, 1e-300):.2f}x)" for k, s in zip(MEASURES, out["spread"])))


if __name__ == "__main__":
    main()
