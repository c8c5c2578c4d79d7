"""Make ``tests/data/torch_lm_ref.npz``: the reference package's logits for the
transformer families (dense, vision, audio, MoE) at full width, on numpy
weights that the PyTorch port regenerates from a seed.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/make_torch_lm_ref.py [--check-port]
        [--only kimi-k2-1t-a32b@1 ...]

Entries, all at full width with ``dtype="float32"``, cut in depth so that the
weights fit the host twice over: granite-3-8b with 2 of its 40 layers,
llama-3.2-vision-11b with 5 of 40 (one group: 4 self layers and a cross
layer), musicgen-large with 2 of 48 (4 codebooks), llama4-scout-17b-a16e with
1 of 48 (16 experts, top-1), kimi-k2-1t-a32b with 1 of 61 and its experts cut
from 384 to 16 (top-8 kept; ``EXPERTS``, stored as ``n_experts``): 3.17 B
parameters, 12.7 GB in float32 (all 384 at one layer would be 19.4 B).  With
``--only`` the named entries are remade and written into the existing file,
whose other entries stay as they are.  For each:

  * weights: ``repro_torch``'s ``Model.init_numpy(SEED)``, each leaf rounded to
    the dtype the port stores it in (kimi-k2's ``param_dtype`` is bf16: the
    port's ``params_from_numpy`` rounds its matrices, while the reference keeps
    the float32 arrays it is handed, so it is handed the rounded ones), and
    the vision cross layers' ``attn_gate`` and ``mlp_gate``, which start at 0
    (``tanh(0)`` would zero the cross path), set to seeded values in
    [0.3, 0.9] (stored);
  * one prompt of 67 tokens ([67, 4] for the audio model), and for the vision
    model a seeded normal vision input [1, 1601, 1280] (its seed stored): the
    serving engine's zero stub would make the vision K/V zero;
  * the JAX model's prefill, then 8 greedy decode steps;
  * the same run six more times, each with one weight of every layer moved up
    by one ulp of the dtype the port stores it in (``wq``, ``wk``, ``wv``,
    ``wo``, ``w_gate``, ``w_down``; float32, or bf16 for kimi-k2, where a
    float32 ulp would vanish in the port's rounding), teacher-forced with the
    first run's tokens: how far the
    reference itself moves under rounding-sized changes (its "spread", the
    largest over the six).  With the reference's initializer (std over the
    second-last dim: k has std ~23 at d_model 4096) attention is close to a
    hard argmax over keys, so a near-tie between two keys' scores decides
    where a rounding-sized change lands; one weight's nudge finds some such
    ties and another finds others, hence six.

Stored per entry: name, layer count, seed, the prompt, the 9 greedy tokens
([9] or [9, ncb]), per step the top-64 logits over all codebooks' logits
flattened and their indices, the top-2 margin of each codebook over the
step's largest |logit| ([9, ncb]), and the spread (max |logit change| at
those indices over the step's largest |logit|; ``spread_by``, each nudge's).
The MoE entry also stores the smallest top-k router margin of the prefill
(the gap between a token's k-th and (k+1)-th router probability): an expert
choice closer than float32 noise can flip between two correct runs.  ``chip_smoke.py`` holds the port on the
card against this file.

``--check-port`` then runs the port on the CPU against the file just written
and prints how far its logits are from it, beside the spread.  Runs on the
CPU, one entry at a time; an entry's weights are converted to the JAX model
leaf by leaf, so the largest (llama4-scout at one layer, 16.6 GB of float32)
is held about once.
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
import torch

from repro.configs import get_config as jax_config
from repro.models import transformer as jax_T
from repro.models.layers import rms_norm
from repro.models.model import _precast
from repro.models.model import build_model as jax_model
from repro_torch.configs import get_config as port_config
from repro_torch.models import defs as D
from repro_torch.models.model import build_model as port_model

ROOT = pathlib.Path(__file__).resolve().parents[1]
OUT = ROOT / "tests" / "data" / "torch_lm_ref.npz"
ENTRIES = (("granite-3-8b", 2), ("llama-3.2-vision-11b", 5), ("musicgen-large", 2),
           ("llama4-scout-17b-a16e", 1), ("kimi-k2-1t-a32b", 1))  # (name, layers kept)
EXPERTS = {"kimi-k2-1t-a32b": 16}  # experts kept where an entry cuts them (top-k kept)
SEED = 0
PROMPT_SEED = 1
VISION_SEED = 2
GATE_SEED = 3
PROMPT_LEN = 67
DECODE_STEPS = 8
TOP = 64
NUDGED = ("wq", "wk", "wv", "wo", "w_gate", "w_down")  # layer weights moved by one ulp, one run each


def entry_config(get_config, name: str, n_layers: int, n_experts: int | None = None):
    """An entry's config from ``get_config`` (either package's): float32,
    ``n_layers`` deep, ``n_experts`` experts where given."""
    cfg = get_config(name)
    kw = dict(dtype="float32", n_layers=n_layers)
    if n_experts:
        kw["moe"] = dataclasses.replace(cfg.moe, n_experts=n_experts)
    return dataclasses.replace(cfg, **kw)


def as_stored(model, w: dict) -> dict:
    """``w`` with every leaf that the port stores in a reduced dtype rounded to
    it in place, as it rounds them (still float32 arrays)."""
    for path, d in D.leaves(model.param_defs()):
        if d.dtype != torch.float32:
            t = torch.from_numpy(functools.reduce(lambda sub, k: sub[k], path, w))
            t.copy_(t.to(d.dtype))
    return w


def ulp_up(x, dtype: torch.dtype):
    """``x`` moved up by one ulp of ``dtype`` (float32, or bf16 for a float32
    array of bf16 values: the next bf16 toward +inf)."""
    if dtype == torch.float32:
        return jnp.nextafter(x, jnp.float32(np.inf))
    assert dtype == torch.bfloat16, dtype
    bits = jax.lax.bitcast_convert_type(x, jnp.uint32)
    step = jnp.uint32(1 << 16)  # one bf16 ulp in a float32's bits
    bits = jnp.where(x > 0, bits + step, jnp.where(x < 0, bits - step, step))
    return jax.lax.bitcast_convert_type(bits, jnp.float32)


def gates(n_cross: int) -> tuple[np.ndarray, np.ndarray]:
    """The cross layers' attn_gate and mlp_gate, seeded, in [0.3, 0.9]."""
    rng = np.random.default_rng(GATE_SEED)
    return tuple(rng.uniform(0.3, 0.9, n_cross).astype(np.float32) for _ in range(2))


def vision_input(cfg, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((1, cfg.vision.n_patches, cfg.vision.d_vision),
                                                       dtype=np.float32)


def prompt_for(cfg) -> np.ndarray:
    shape = (PROMPT_LEN,) + ((cfg.audio.n_codebooks,) if cfg.audio else ())
    return np.random.default_rng(PROMPT_SEED).integers(0, cfg.vocab_size, shape).astype(np.int32)


def _top(logits: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    flat = logits.reshape(-1)
    idx = np.argsort(-flat, kind="stable")[:TOP]
    return idx.astype(np.int32), flat[idx].astype(np.float32)


def rel_dev(logits: np.ndarray, idx: np.ndarray, val: np.ndarray) -> float:
    """max |logits[idx] - val| over max |val| (the agreement measure; logits
    flattened over the codebooks)."""
    flat = np.asarray(logits).reshape(-1)
    return float(np.max(np.abs(flat[idx].astype(np.float64) - val)) / np.max(np.abs(val)))


def margins(logits: np.ndarray, scale: float) -> np.ndarray:
    """Each codebook's top-2 logit gap over ``scale``: [ncb]."""
    top2 = np.sort(logits.reshape(-1, logits.shape[-1]), -1)[:, -2:]
    return ((top2[:, 1] - top2[:, 0]) / scale).astype(np.float64)


def _steps(model, params, prompt: np.ndarray, vision, forced=None) -> list[np.ndarray]:
    """Logits ([V] or [ncb, V]) of the prefill and DECODE_STEPS decode steps;
    each step is fed the previous greedy token(s), or the ``forced`` ones."""
    prefill = jax.jit(functools.partial(model.prefill, max_len=PROMPT_LEN + DECODE_STEPS + 1))
    decode = jax.jit(model.decode_step)
    logits, cache = prefill(params, jnp.asarray(prompt)[None], vision=vision)
    steps = [np.asarray(logits[0], np.float32)]
    for i in range(DECODE_STEPS):
        tok = steps[-1].argmax(-1) if forced is None else forced[i]
        logits, cache = decode(params, jnp.asarray(tok, jnp.int32).reshape((1, 1) + np.shape(tok)), cache)
        steps.append(np.asarray(logits[0], np.float32))
    return steps


def router_margin(cfg, params, prompt: np.ndarray) -> float:
    """The smallest gap between a token's k-th and (k+1)-th router
    probability in the first MoE layer of the prefill (the reference's own
    blocks, float32)."""
    p = _precast(cfg, params)
    lp = jax.tree.map(lambda x: x[0], p["layers"])
    h = jax_T.embed_tokens(cfg, p, jnp.asarray(prompt)[None], jnp.float32)
    a, _ = jax_T.self_attn_block(cfg, lp, h, jnp.arange(prompt.shape[0])[None])
    x = rms_norm(h + a, lp["ln2"], cfg.norm_eps)
    probs = np.asarray(jax.nn.softmax(jnp.einsum("bsd,de->bse", x, lp["router"].astype(jnp.float32)), -1))
    top = np.sort(probs, -1)[..., ::-1]
    k = cfg.moe.top_k
    return float(np.min(top[..., k - 1] - top[..., k]))


def entry_weights(model, cfg, seed: int) -> dict:
    """``init_numpy(seed)`` as the port stores it, with the cross gates set (vision)."""
    w = as_stored(model, model.init_numpy(seed))
    if cfg.vision:
        n_cross = cfg.n_layers // cfg.vision.cross_attn_every
        w["cross_layers"]["attn_gate"], w["cross_layers"]["mlp_gate"] = gates(n_cross)
    return w


def _to_jax(tree: dict) -> dict:
    """The numpy tree as JAX arrays, each numpy leaf dropped once converted."""
    return {k: _to_jax(tree.pop(k)) if isinstance(tree[k], dict) else jnp.asarray(tree.pop(k))
            for k in sorted(tree)}


def reference_run(name: str, n_layers: int) -> dict:
    n_experts = EXPERTS.get(name)
    port_cfg = entry_config(port_config, name, n_layers, n_experts)
    cfg = entry_config(jax_config, name, n_layers, n_experts)
    model = jax_model(cfg)
    stored = {path[-1]: d.dtype for path, d in D.leaves(port_model(port_cfg).param_defs()["layers"])}
    params = _to_jax(entry_weights(port_model(port_cfg), port_cfg, SEED))
    gc.collect()
    prompt = prompt_for(cfg)
    vision = jnp.asarray(vision_input(cfg, VISION_SEED)) if cfg.vision else None
    steps = _steps(model, params, prompt, vision)
    tokens = np.stack([s.argmax(-1) for s in steps]).astype(np.int32)
    tops = [_top(s) for s in steps]
    key = f"{name}@{n_layers}"
    out = {f"{key}/name": np.asarray(name), f"{key}/n_layers": np.int64(n_layers), f"{key}/seed": np.int64(SEED),
           f"{key}/prompt": prompt, f"{key}/tokens": tokens,
           f"{key}/top_idx": np.stack([t[0] for t in tops]), f"{key}/top_val": np.stack([t[1] for t in tops]),
           f"{key}/margin": np.stack([margins(s, float(np.max(np.abs(t[1])))) for s, t in zip(steps, tops)])}
    if cfg.vision:
        out[f"{key}/vision_seed"] = np.int64(VISION_SEED)
        out[f"{key}/attn_gate"] = np.asarray(params["cross_layers"]["attn_gate"])
        out[f"{key}/mlp_gate"] = np.asarray(params["cross_layers"]["mlp_gate"])
    if cfg.moe:
        out[f"{key}/router_margin"] = np.float64(router_margin(cfg, params, prompt))
    if n_experts:
        out[f"{key}/n_experts"] = np.int64(n_experts)
    spread = []
    for leaf in NUDGED:
        kept = params["layers"][leaf]
        params["layers"][leaf] = ulp_up(kept, stored[leaf])
        moved = _steps(model, params, prompt, vision, forced=tokens)
        params["layers"][leaf] = kept
        spread.append([rel_dev(m, *t) for m, t in zip(moved, tops)])
    out[f"{key}/spread_by"] = np.asarray(spread, np.float64)
    out[f"{key}/spread"] = out[f"{key}/spread_by"].max(0)
    del params
    gc.collect()
    return out


def check_port(ref, keys: list[str]) -> None:
    """The port on the CPU, float32, against the fixture's entries ``keys``."""
    from repro_torch.models.model import params_from_numpy

    for key in keys:
        name, n_layers = str(ref[f"{key}/name"]), int(ref[f"{key}/n_layers"])
        n_experts = int(ref[f"{key}/n_experts"]) if f"{key}/n_experts" in ref else None
        cfg = entry_config(port_config, name, n_layers, n_experts)
        model = port_model(cfg)
        w = model.init_numpy(int(ref[f"{key}/seed"]))
        vision = None
        if cfg.vision:
            w["cross_layers"]["attn_gate"] = ref[f"{key}/attn_gate"]
            w["cross_layers"]["mlp_gate"] = ref[f"{key}/mlp_gate"]
            vision = torch.from_numpy(vision_input(cfg, int(ref[f"{key}/vision_seed"])))
        params = params_from_numpy(cfg, w, "cpu")
        del w
        tokens, idx, val = ref[f"{key}/tokens"], ref[f"{key}/top_idx"], ref[f"{key}/top_val"]
        prompt = torch.as_tensor(ref[f"{key}/prompt"], dtype=torch.int64)[None]
        with torch.no_grad():
            logits, cache = model.prefill(params, prompt, max_len=prompt.shape[1] + len(tokens), vision=vision)
            steps = [logits[0].numpy()]
            for t in tokens[:-1]:
                logits, cache = model.decode_step(params, torch.as_tensor(t, dtype=torch.int64).reshape(
                    (1, 1) + t.shape), cache)
                steps.append(logits[0].numpy())
        rel = [rel_dev(s, idx[i], val[i]) for i, s in enumerate(steps)]
        same = sum(bool(np.all(s.argmax(-1) == tokens[i])) for i, s in enumerate(steps))
        extra = (f"; smallest router margin {float(ref[f'{key}/router_margin']):.3g}"
                 if f"{key}/router_margin" in ref else "")
        print(f"port on the CPU, {key}: max rel logit error {max(rel):.3g} (per step "
              f"{[f'{r:.3g}' for r in rel]}); the reference's own spread {float(np.max(ref[f'{key}/spread'])):.3g}; "
              f"greedy tokens equal at {same} of {len(steps)} steps; smallest top-2 margin "
              f"{float(np.min(ref[f'{key}/margin'])):.3g}{extra}")
        del params, cache
        gc.collect()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--check-port", action="store_true", help="then hold the port on the CPU against the file")
    ap.add_argument("--only", nargs="+", metavar="NAME@LAYERS", choices=[f"{n}@{k}" for n, k in ENTRIES],
                    help="remake these entries alone, keeping the file's others")
    args = ap.parse_args()
    keys = [f"{n}@{layers}" for n, layers in ENTRIES]
    out = {"entries": np.asarray(keys)}
    if args.only:
        with np.load(OUT) as old:
            kept = [str(k) for k in old["entries"] if str(k) not in args.only]
            out.update({k: old[k] for k in old.files if k != "entries" and k.split("/")[0] in kept})
        out["entries"] = np.asarray([k for k in keys if k in kept or k in args.only])
    for name, n_layers in ENTRIES:
        if args.only and f"{name}@{n_layers}" not in args.only:
            continue
        t0 = time.perf_counter()
        out.update(reference_run(name, n_layers))
        gc.collect()
        print(f"{name}@{n_layers}: reference runs took {time.perf_counter() - t0:.1f} s")
    OUT.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(OUT, **out)
    print(f"wrote {OUT} ({OUT.stat().st_size} bytes)")
    if args.check_port:
        check_port(np.load(OUT), args.only or keys)


if __name__ == "__main__":
    main()
