"""Make ``tests/data/torch_ssm_ref.npz``: the reference package's logits for
the two SSM families at full width, on numpy weights that the PyTorch port
regenerates from a seed.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/make_torch_ssm_ref.py [--check-port]

Entries, all at full width with ``dtype="float32"``: zamba2-1.2b at full depth
(38 layers) and with its first 6 layers (one shared attention block);
falcon-mamba-7b with 2 of its 64 layers (64 float32 layers would need ~29 GB
of host memory twice over).  For each:

  * weights: ``repro_torch``'s ``Model.init_numpy(SEED)``, handed to the JAX
    model as they are;
  * one prompt of 67 tokens (odd, so the reference scans it in chunks of 1
    while the port's kernels run a ragged last chunk);
  * the JAX model's prefill, then 8 greedy decode steps;
  * the same run with every ``in_proj`` weight moved up by one float32 ulp,
    teacher-forced with the first run's tokens: how far the reference itself
    moves under a rounding-sized change (its "spread").  With random weights
    the full-depth zamba2 amplifies such changes to percent-level logit
    differences, so an agreement bound has to be read against this spread.

Stored per entry: name, layer count, seed, the prompt, the 9 greedy tokens
(one from the prefill, one from each decode step), per step the top-64 logits
and their indices, and per step the spread (max |logit change| at those
indices over the step's largest |logit|).  ``chip_smoke.py`` holds the port on
the card against this file.

``--check-port`` then runs the port on the CPU against the file just written
and prints how far its logits are from it, beside the spread.  Runs on the
CPU, one entry at a time, in several minutes; an entry's weights are held
twice (numpy and JAX), 4.7 GB each for zamba2-1.2b at full depth.
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import gc
import pathlib
import time

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_config as jax_config
from repro.models.model import build_model as jax_model
from repro_torch.configs import get_config as port_config
from repro_torch.models.model import build_model as port_model

ROOT = pathlib.Path(__file__).resolve().parents[1]
OUT = ROOT / "tests" / "data" / "torch_ssm_ref.npz"
ENTRIES = (("zamba2-1.2b", 38), ("zamba2-1.2b", 6), ("falcon-mamba-7b", 2))  # (name, layers kept)
SEED = 0
PROMPT_SEED = 1
PROMPT_LEN = 67
DECODE_STEPS = 8
TOP = 64


def _top(logits: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    idx = np.argsort(-logits, kind="stable")[:TOP]
    return idx.astype(np.int32), logits[idx].astype(np.float32)


def rel_dev(logits: np.ndarray, idx: np.ndarray, val: np.ndarray) -> float:
    """max |logits[idx] - val| over max |val| (the agreement measure)."""
    return float(np.max(np.abs(logits[idx].astype(np.float64) - val)) / np.max(np.abs(val)))


def _steps(model, params, prompt: np.ndarray, forced=None) -> list[np.ndarray]:
    """Logits of the prefill and DECODE_STEPS decode steps; each step is fed the
    previous greedy token, or the ``forced`` tokens when given."""
    prefill = jax.jit(functools.partial(model.prefill, max_len=PROMPT_LEN + DECODE_STEPS + 1))
    decode = jax.jit(model.decode_step)
    logits, cache = prefill(params, jnp.asarray(prompt)[None])
    steps = [np.asarray(logits[0], np.float32)]
    for i in range(DECODE_STEPS):
        tok = int(steps[-1].argmax()) if forced is None else int(forced[i])
        logits, cache = decode(params, jnp.asarray([[tok]], jnp.int32), cache)
        steps.append(np.asarray(logits[0], np.float32))
    return steps


def reference_run(name: str, n_layers: int) -> dict:
    port_cfg = dataclasses.replace(port_config(name), dtype="float32", n_layers=n_layers)
    cfg = dataclasses.replace(jax_config(name), dtype="float32", n_layers=n_layers)
    model = jax_model(cfg)
    weights = port_model(port_cfg).init_numpy(SEED)
    prompt = np.random.default_rng(PROMPT_SEED).integers(0, cfg.vocab_size, PROMPT_LEN).astype(np.int32)
    steps = _steps(model, jax.tree.map(jnp.asarray, weights), prompt)
    gc.collect()
    tokens = np.asarray([s.argmax() for s in steps], np.int32)
    tops = [_top(s) for s in steps]
    weights["layers"]["in_proj"] = np.nextafter(weights["layers"]["in_proj"], np.float32(np.inf))
    moved = _steps(model, jax.tree.map(jnp.asarray, weights), prompt, forced=tokens)
    del weights
    gc.collect()
    key = f"{name}@{n_layers}"
    return {f"{key}/name": np.asarray(name), f"{key}/n_layers": np.int64(n_layers), f"{key}/seed": np.int64(SEED),
            f"{key}/prompt": prompt, f"{key}/tokens": tokens,
            f"{key}/top_idx": np.stack([t[0] for t in tops]), f"{key}/top_val": np.stack([t[1] for t in tops]),
            f"{key}/spread": np.asarray([rel_dev(m, *t) for m, t in zip(moved, tops)], np.float64)}


def check_port(ref) -> None:
    """The port on the CPU, float32, against the fixture."""
    import torch

    from repro_torch.models.model import params_from_numpy

    for key in [str(k) for k in ref["entries"]]:
        name, n_layers = str(ref[f"{key}/name"]), int(ref[f"{key}/n_layers"])
        cfg = dataclasses.replace(port_config(name), dtype="float32", n_layers=n_layers)
        model = port_model(cfg)
        params = params_from_numpy(cfg, model.init_numpy(int(ref[f"{key}/seed"])), "cpu")
        tokens, idx, val = ref[f"{key}/tokens"], ref[f"{key}/top_idx"], ref[f"{key}/top_val"]
        prompt = torch.as_tensor(ref[f"{key}/prompt"], dtype=torch.int64)[None]
        with torch.no_grad():
            logits, cache = model.prefill(params, prompt, max_len=prompt.shape[1] + len(tokens))
            steps = [logits[0].numpy()]
            for t in tokens[:-1]:
                logits, cache = model.decode_step(params, torch.tensor([[int(t)]]), cache)
                steps.append(logits[0].numpy())
        rel = [rel_dev(s, idx[i], val[i]) for i, s in enumerate(steps)]
        same = sum(int(s.argmax()) == int(tokens[i]) for i, s in enumerate(steps))
        print(f"port on the CPU, {key}: max rel logit error {max(rel):.3g} (per step "
              f"{[f'{r:.3g}' for r in rel]}); the reference's own spread {float(np.max(ref[f'{key}/spread'])):.3g} "
              f"(per step {[f'{s:.3g}' for s in ref[f'{key}/spread']]}); greedy tokens equal at {same} of "
              f"{len(steps)} steps; top-2 margins {[f'{float((v[0] - v[1]) / np.max(np.abs(v))):.3g}' for v in val]}")
        del params, cache
        gc.collect()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--check-port", action="store_true", help="then hold the port on the CPU against the file")
    args = ap.parse_args()
    out = {"entries": np.asarray([f"{n}@{layers}" for n, layers in ENTRIES])}
    for name, n_layers in ENTRIES:
        t0 = time.perf_counter()
        out.update(reference_run(name, n_layers))
        gc.collect()
        print(f"{name}@{n_layers}: reference runs took {time.perf_counter() - t0:.1f} s")
    OUT.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(OUT, **out)
    print(f"wrote {OUT} ({OUT.stat().st_size} bytes)")
    if args.check_port:
        check_port(np.load(OUT))


if __name__ == "__main__":
    main()
