"""Make ``tests/data/torch_train_ref.npz``: the reference package's training
numbers for granite-3-8b at full width, on numpy weights that the PyTorch
port regenerates from a seed; with ``--ssm``, ``tests/data/torch_ssm_train_ref.npz``:
the same numbers for the SSM families (falcon-mamba-7b with 2 of its 64
layers, 0.743 B parameters; zamba2-1.2b with 6 of its 38, the first depth that
reaches its shared attention block, 0.364 B), one entry each, every field
stored under ``"<entry>/<field>"`` and the entries listed in ``entries``.

zamba2's reference runs its Mamba2 layers through the reference's own
per-step oracle, ``repro.kernels.ref.ssd_reference`` (the recurrence that the
chunked ``repro.models.mamba.ssd_scan`` reformulates, equal to it in value),
in place of ``ssd_scan``: ``jax.grad`` of ``ssd_scan`` is NaN wherever a
chunk's log-decay passes ~88, because ``jnp.where(mask, exp(li), 0)`` takes
exp of the masked entries above the diagonal too and their zero cotangent
meets inf (0 x inf), and at zamba2's A (-1 to -64) and dt every gradient of
the layers is NaN.  The swap lives in this process only; the reference
package is not changed.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/make_torch_train_ref.py [--ssm [--only ENTRY]] [--check-port]

``--only`` remakes one entry of an existing SSM file and keeps the other.

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
    moves when one weight leaf (granite: ``wq``, ``wk``, ``wv``, ``wo``,
    ``w_gate``, ``w_down`` of both layers; the SSM entries: ``NUDGED`` below;
    one run each) moves up by one float32 ulp,
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
SSM_OUT = ROOT / "tests" / "data" / "torch_ssm_train_ref.npz"
NAME, N_LAYERS = "granite-3-8b", 2
SSM_ENTRIES = (("falcon-mamba-7b", 2), ("zamba2-1.2b", 6))
SEED = 0
BATCH, SEQ = 2, 128
STEPS = 3
LR = 3e-4
SAMPLES = 64
SAMPLE_SEED = 5
# the leaves nudged by one ulp, as key paths into the parameter tree
NUDGED = {
    "granite-3-8b": tuple(("layers", k) for k in ("wq", "wk", "wv", "wo", "w_gate", "w_down")),
    "falcon-mamba-7b": tuple(("layers", k) for k in ("in_proj", "conv_w", "x_proj", "dt_proj", "A_log", "out_proj")),
    "zamba2-1.2b": (("layers", "in_proj"), ("layers", "conv_w"), ("layers", "A_log"), ("layers", "out_proj"),
                    ("shared", "wq"), ("shared", "w_down")),
}
MEASURES = ("loss", "grad_norm", "leaf_norm", "sample", "history")


def port_cfg(name: str = NAME, n_layers: int = N_LAYERS):
    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(name), dtype="float32", n_layers=n_layers)


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


def reference_run(nudge: tuple | None = None, idx: np.ndarray | None = None, name: str = NAME,
                  n_layers: int = N_LAYERS) -> dict:
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jax_config
    from repro.models.model import build_model
    from repro.optim import adamw as A
    from repro_torch.models.model import build_model as port_model

    pcfg = port_cfg(name, n_layers)
    cfg = dataclasses.replace(jax_config(name), dtype="float32", n_layers=n_layers)
    if cfg.family == "hybrid":
        use_ssd_oracle()
    model = build_model(cfg)
    w = port_model(pcfg).init_numpy(SEED)
    params = jax.tree.map(jnp.asarray, w)
    del w
    gc.collect()
    if nudge is not None:
        _set(params, nudge, jnp.nextafter(_get(params, nudge), jnp.float32(np.inf)))
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


def use_ssd_oracle() -> None:
    """Run the reference's Mamba2 layers through its per-step SSD oracle
    (the module docstring says why), in this process."""
    from repro.kernels import ref as jax_ref  # engine-oracle: the per-step SSD recurrence
    from repro.models import ssm_models

    ssm_models.ssd_scan = lambda x, dt, A, Bm, Cm, chunk=64, state0=None: jax_ref.ssd_reference(x, dt, A, Bm, Cm)


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


def port_run(ref, device="cpu", name: str = NAME, n_layers: int = N_LAYERS) -> dict:
    """The port's numbers for the fixture's configuration on ``device``."""
    import torch

    from repro_torch import tree as tu
    from repro_torch.data import batch_to
    from repro_torch.models.model import build_model, params_from_numpy
    from repro_torch.optim import AdamWConfig, global_norm, init_opt_state
    from repro_torch.train import make_train_step

    cfg = port_cfg(name, n_layers)
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


def entry(name: str, n_layers: int) -> dict:
    """One configuration's fixture fields, its spread over ``NUDGED[name]``."""
    t0 = time.perf_counter()
    ref = reference_run(name=name, n_layers=n_layers)
    print(f"reference {name}@{n_layers}: loss {ref['loss']:.8g}, grad norm {ref['grad_norm']:.8g}, history "
          f"{ref['history']} ({time.perf_counter() - t0:.1f} s)")
    cfg = port_cfg(name, n_layers)
    out = {"name": np.asarray(name), "n_layers": np.int64(n_layers), "seed": np.int64(SEED),
           "batch": np.int64(BATCH), "seq": np.int64(SEQ), "lr": np.float64(LR),
           "loss": np.float64(ref["loss"]), "grad_norm": np.float64(ref["grad_norm"]),
           "leaves": np.asarray(ref["leaves"]), "leaf_size": np.asarray(ref["leaf_size"], np.int64),
           "leaf_norm": np.asarray(ref["leaf_norm"], np.float64), "idx": ref["idx"],
           "sample": ref["sample"].astype(np.float32), "history": ref["history"],
           "measures": np.asarray(MEASURES), "numpy": np.asarray(np.__version__),
           "tokens": np.stack([b["tokens"] for b in batches(cfg)]),
           "labels": np.stack([b["labels"] for b in batches(cfg)])}
    spread = []
    for leaf in NUDGED[name]:
        t0 = time.perf_counter()
        moved = reference_run(leaf, ref["idx"], name, n_layers)
        d = distances(moved, out)
        spread.append([d[k] for k in MEASURES])
        print(f"nudge {'/'.join(leaf)}: " + ", ".join(f"{k} {d[k]:.3g}" for k in MEASURES)
              + f" ({time.perf_counter() - t0:.1f} s)")
    out["spread_by"] = np.asarray(spread, np.float64)
    out["spread"] = out["spread_by"].max(0)
    print(f"{name}@{n_layers}: spread " + ", ".join(f"{k} {s:.3g}" for k, s in zip(MEASURES, out["spread"])))
    return out


def check_port(ref: dict, name: str, n_layers: int) -> None:
    t0 = time.perf_counter()
    d = distances(port_run(ref, "cpu", name, n_layers), ref)
    print(f"port {name}@{n_layers} on the CPU ({time.perf_counter() - t0:.1f} s): " + ", ".join(
        f"{k} {d[k]:.3g} (spread {s:.3g}, {d[k] / max(s, 1e-300):.2f}x)" for k, s in zip(MEASURES, ref["spread"])))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ssm", action="store_true", help="write the SSM families' file instead")
    ap.add_argument("--only", default=None, help="with --ssm: remake this entry of the existing file alone")
    ap.add_argument("--check-port", action="store_true", help="then hold the port on the CPU against the file")
    args = ap.parse_args()
    if args.ssm:
        out = {"entries": np.asarray([f"{n}@{L}" for n, L in SSM_ENTRIES])}
        if args.only is not None:
            out.update({k: v for k, v in np.load(SSM_OUT).items() if not k.startswith(f"{args.only}/")})
        for name, n_layers in SSM_ENTRIES:
            if args.only not in (None, f"{name}@{n_layers}"):
                continue
            out.update({f"{name}@{n_layers}/{k}": v for k, v in entry(name, n_layers).items()})
            gc.collect()
        SSM_OUT.parent.mkdir(parents=True, exist_ok=True)
        np.savez_compressed(SSM_OUT, **out)
        print(f"wrote {SSM_OUT} ({SSM_OUT.stat().st_size} bytes)")
        if args.check_port:
            saved = dict(np.load(SSM_OUT))
            for name, n_layers in SSM_ENTRIES:
                key = f"{name}@{n_layers}/"
                check_port({k[len(key):]: v for k, v in saved.items() if k.startswith(key)}, name, n_layers)
        return
    out = entry(NAME, N_LAYERS)
    OUT.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(OUT, **out)
    print(f"wrote {OUT} ({OUT.stat().st_size} bytes)")
    if args.check_port:
        check_port(dict(np.load(OUT)), NAME, N_LAYERS)


if __name__ == "__main__":
    main()
