"""The Model API for the SSM families: ``build_model(cfg) -> Model`` with
``forward`` / ``prefill`` / ``decode_step`` over a dict of stacked ``[L, ...]``
parameter tensors.

Only the ``ssm`` (falcon-mamba, Mamba1) and ``hybrid`` (zamba2, Mamba2 with a
shared attention block) families are ported; any other family raises.

Against the reference's structure:
  * the scan over layers is a Python loop over views of the stacked tensors;
  * the zamba2 shared block runs after every ``attn_every``-th Mamba2 layer,
    and layers past the last multiple (zamba2's 2 of 38) form a tail with no
    block after them;
  * the scan kernels return their final state, so :meth:`Model.prefill`
    collects the conv windows and states in the forward itself, with no second
    pass over the prompt;
  * weights are cast to the compute dtype by :meth:`Model.precast`, once at
    load (the serving engine calls it); the functions below cast only leaves
    still in float32, which a precast tree no longer has;
  * :meth:`Model.decode_step` updates the cache it is given in place, which
    keeps one copy of the multi-GB cache.

Cache layouts are the reference's: ``conv [L, B, K-1, C]``, ``state [L, B, ...]``
fp32, ``k``/``v [n_kv_layers, B, max_len, KV, hd]``, ``len [B]``.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import runtime
from repro_torch.models import defs as D
from repro_torch.models import ssm_models as S
from repro_torch.models import transformer as T
from repro_torch.models.layers import apply_rope, attention, decode_attention, mlp_act, mm, rms_norm

PORTED_FAMILIES = ("ssm", "hybrid")

# numerics-sensitive leaves stay fp32; everything else is cast to the compute dtype
_KEEP_F32 = {"norm", "ln1", "ln2", "norm_g", "final_norm", "A_log", "dt_bias",
             "D", "conv_b", "conv_w", "attn_gate", "mlp_gate", "router"}


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def cast_layer_params(cfg: ModelConfig, tree: dict) -> dict:
    dt = _dtype(cfg)
    return {k: v if k in _KEEP_F32 or v.dtype != torch.float32 else v.to(dt) for k, v in tree.items()}


def _precast(cfg: ModelConfig, params: dict) -> dict:
    out = dict(params)
    for key in ("layers", "shared"):
        if key in params:
            out[key] = cast_layer_params(cfg, params[key])
    if params["lm_head"].dtype == torch.float32:
        out["lm_head"] = params["lm_head"].to(_dtype(cfg))
    return out


def _layer(layers: dict, i: int) -> dict:
    return {k: v[i] for k, v in layers.items()}


def _write_at(cache: torch.Tensor, lens: torch.Tensor, x: torch.Tensor) -> None:
    """``cache[b, lens[b]] = x[b]`` in place, for every b with lens[b] inside
    the cache; a write past its end is dropped (no index leaves the cache)."""
    bidx = torch.arange(cache.shape[0], device=cache.device)
    idx = lens.clamp(max=cache.shape[1] - 1)
    keep = (lens < cache.shape[1]).reshape((-1,) + (1,) * (x.ndim - 1))
    cache[bidx, idx] = torch.where(keep, x.to(cache.dtype), cache[bidx, idx])


# --------------------------------------------------------------------------- #
# zamba2 shared attention block (full sequence + decode)
# --------------------------------------------------------------------------- #


def _shared_mlp(cfg: ModelConfig, sp: dict, h: torch.Tensor) -> torch.Tensor:
    x2 = rms_norm(h, sp["ln2"], cfg.norm_eps)
    g = mm("bsd,df->bsf", x2, sp["w_gate"])
    u = mm("bsd,df->bsf", x2, sp["w_up"])
    return h + mm("bsf,fd->bsd", mlp_act(g, u, "swiglu"), sp["w_down"])


def _shared_qkv(cfg: ModelConfig, sp: dict, h, h0, positions):
    x = rms_norm(torch.cat([h, h0], -1), sp["ln1"], cfg.norm_eps)
    q = apply_rope(mm("bsd,dhk->bshk", x, sp["wq"]), positions, cfg.rope_theta)
    k = apply_rope(mm("bsd,dhk->bshk", x, sp["wk"]), positions, cfg.rope_theta)
    return q, k, mm("bsd,dhk->bshk", x, sp["wv"])


def _shared_block(cfg: ModelConfig, sp: dict, h, h0, positions):
    """Full-sequence shared block on concat(h, h0).  Returns (h_new, (k, v))."""
    q, k, v = _shared_qkv(cfg, sp, h, h0, positions)
    o = attention(q, k, v, causal=True)
    h = h + mm("bshk,hkd->bsd", o, sp["wo"].reshape(cfg.n_heads, cfg.hd, -1))
    return _shared_mlp(cfg, sp, h), (k, v)


def _shared_block_decode(cfg: ModelConfig, sp: dict, h, h0, k_cache, v_cache, lens):
    """One token at position ``lens``; writes its k, v into the caches
    ([B, max_len, KV, hd] views) in place."""
    B = h.shape[0]
    q, k, v = _shared_qkv(cfg, sp, h, h0, lens.reshape(B, 1))
    _write_at(k_cache, lens, k[:, 0])
    _write_at(v_cache, lens, v[:, 0])
    o = decode_attention(q.transpose(1, 2), k_cache.transpose(1, 2).to(q.dtype),
                         v_cache.transpose(1, 2).to(q.dtype), lens + 1)
    h = h + mm("bshk,hkd->bsd", o.transpose(1, 2), sp["wo"].reshape(cfg.n_heads, cfg.hd, -1))
    return _shared_mlp(cfg, sp, h)


# --------------------------------------------------------------------------- #
# Model
# --------------------------------------------------------------------------- #


@dataclass
class Model:
    cfg: ModelConfig

    def __post_init__(self):
        if self.cfg.family not in PORTED_FAMILIES:
            raise ValueError(f"family {self.cfg.family!r} ({self.cfg.name}) is not ported yet: only "
                             f"{PORTED_FAMILIES} are (see ROADMAP.md, queue 1)")

    # ------------------------------------------------------------- params --
    def param_defs(self) -> dict:
        cfg = self.cfg
        defs = {
            "embed": D.ParamDef((1, cfg.vocab_size, cfg.d_model), (None, "vocab", "embed"), "embed", 0.02),
            "final_norm": D.ParamDef((cfg.d_model,), (None,), "ones"),
            "lm_head": D.ParamDef((1, cfg.d_model, cfg.vocab_size), (None, "embed", "vocab")),
        }
        if cfg.family == "ssm":
            defs["layers"] = S.mamba1_defs(cfg)
        else:
            defs["layers"] = S.mamba2_defs(cfg, cfg.n_layers)
            defs["shared"] = S.shared_block_defs(cfg)
        if cfg.param_dtype != "float32":
            # weight matrices stored reduced-precision; norms, biases and SSM
            # constants stay fp32
            pd = getattr(torch, cfg.param_dtype)
            defs = D.map_defs(lambda d: D.ParamDef(d.shape, d.axes, d.init, d.scale, pd)
                              if d.init in ("normal", "embed") else d, defs)
        return defs

    def init(self, seed: int = 0, device=None) -> dict:
        """Random weights drawn on ``device`` (None: the card) from
        ``torch.Generator(device).manual_seed(seed)``."""
        dev = runtime.resolve_device(device)
        return D.init_params(self.param_defs(), torch.Generator(device=dev).manual_seed(seed), dev)

    def init_numpy(self, seed: int = 0) -> dict:
        """Random weights as numpy arrays from ``np.random.default_rng(seed)``
        (the same arrays can be fed to the reference package)."""
        return D.init_numpy(self.param_defs(), seed)

    def param_count(self) -> int:
        return D.param_count(self.param_defs())

    def precast(self, params: dict) -> dict:
        """The tree with every leaf outside ``_KEEP_F32``, and the LM head, in
        the compute dtype.  Call once at load; the other methods then cast
        nothing."""
        return _precast(self.cfg, params)

    # ------------------------------------------------------------ forward --
    def forward(self, params: dict, tokens: torch.Tensor, *, collect_cache: bool = False, head: bool = True):
        """Full-sequence forward.  tokens [B, S].  Returns (logits [B, S, V], caches)
        or, with ``head=False``, (hidden [B, S, d], caches).  With
        ``collect_cache`` the caches hold each layer's conv window and final
        state (``conv``, ``state``) and, for the hybrid, each shared block's k
        and v [G, B, S, KV, hd]."""
        cfg = self.cfg
        B, Sq = tokens.shape
        params = _precast(cfg, params)
        h = T.embed_tokens(cfg, params, tokens, _dtype(cfg))
        convs, states, ks, vs = [], [], [], []
        if cfg.family == "ssm":
            for i in range(cfg.n_layers):
                h, (cb, st) = S.mamba1_layer(cfg, _layer(params["layers"], i), h)
                convs.append(cb)
                states.append(st)
        else:
            every = cfg.hybrid.attn_every
            h0 = h
            positions = torch.arange(Sq, device=h.device).expand(B, Sq)
            for i in range(cfg.n_layers):
                h, (cb, st) = S.mamba2_layer(cfg, _layer(params["layers"], i), h)
                convs.append(cb)
                states.append(st)
                if (i + 1) % every == 0:  # none after the tail past the last multiple
                    h, (k, v) = _shared_block(cfg, params["shared"], h, h0, positions)
                    ks.append(k)
                    vs.append(v)
        caches = {}
        if collect_cache:
            caches = {"conv": torch.stack(convs), "state": torch.stack(states)}
            if ks:
                caches["k"], caches["v"] = torch.stack(ks), torch.stack(vs)
        if not head:
            return h, caches
        return T.lm_logits(cfg, params, h), caches

    # ------------------------------------------------------------ caching --
    def cache_dims(self) -> dict:
        cfg = self.cfg
        if cfg.family == "ssm":
            return {"kind": "ssm", "n_ssm_layers": cfg.n_layers}
        return {"kind": "hybrid", "n_ssm_layers": cfg.n_layers,
                "n_kv_layers": cfg.n_layers // cfg.hybrid.attn_every}

    def cache_struct(self, B: int, max_len: int) -> dict:
        """name -> (shape, dtype) of the decode cache."""
        cfg = self.cfg
        dt = _dtype(cfg)
        dims = self.cache_dims()
        L, s, di = dims["n_ssm_layers"], cfg.ssm, cfg.d_inner
        out = {"len": ((B,), torch.int64)}
        if "n_kv_layers" in dims:
            kv = (dims["n_kv_layers"], B, max_len, cfg.n_kv_heads, cfg.hd)
            out["k"], out["v"] = (kv, dt), (kv, dt)
        if cfg.family == "ssm":
            out["conv"] = ((L, B, s.d_conv - 1, di), dt)
            out["state"] = ((L, B, di, s.d_state), torch.float32)
        else:
            out["conv"] = ((L, B, s.d_conv - 1, di + 2 * s.d_state), dt)
            out["state"] = ((L, B, di // s.head_dim, s.d_state, s.head_dim), torch.float32)
        return out

    def init_cache(self, B: int, max_len: int, device=None) -> dict:
        dev = runtime.resolve_device(device)
        return {k: torch.zeros(shape, dtype=dt, device=dev) for k, (shape, dt) in self.cache_struct(B, max_len).items()}

    # ------------------------------------------------------------ prefill --
    def prefill(self, params: dict, tokens: torch.Tensor, *, max_len: int):
        """Process the prompt (exact length: a recurrent state would absorb
        any padding).  Returns (last-position logits [B, V], cache)."""
        cfg = self.cfg
        B, Sq = tokens.shape
        if Sq > max_len:
            raise ValueError(f"prompt of {Sq} tokens exceeds max_len={max_len}")
        params = _precast(cfg, params)
        h, caches = self.forward(params, tokens, collect_cache=True, head=False)
        logits = T.lm_logits(cfg, params, h[:, -1:])
        cache = {"len": torch.full((B,), Sq, dtype=torch.int64, device=h.device),
                 "conv": caches["conv"], "state": caches["state"]}
        if "k" in caches:
            pad = (0, 0, 0, 0, 0, max_len - Sq)
            cache["k"], cache["v"] = F.pad(caches["k"], pad), F.pad(caches["v"], pad)
        return logits[:, -1], cache

    # -------------------------------------------------------------- decode --
    def decode_step(self, params: dict, tokens: torch.Tensor, cache: dict):
        """tokens [B, 1].  Returns (logits [B, V], cache), the cache updated in place."""
        cfg = self.cfg
        params = _precast(cfg, params)
        lens = cache["len"]
        h = T.embed_tokens(cfg, params, tokens, _dtype(cfg))
        h0 = h
        step = S.mamba1_decode if cfg.family == "ssm" else S.mamba2_decode
        for i in range(cfg.n_layers):
            h, cb, st = step(cfg, _layer(params["layers"], i), h, cache["conv"][i], cache["state"][i])
            cache["conv"][i] = cb
            cache["state"][i] = st
            if cfg.family == "hybrid" and (i + 1) % cfg.hybrid.attn_every == 0:
                g = (i + 1) // cfg.hybrid.attn_every - 1
                h = _shared_block_decode(cfg, params["shared"], h, h0, cache["k"][g], cache["v"][g], lens)
        logits = T.lm_logits(cfg, params, h)
        cache["len"] = lens + 1
        return logits[:, -1], cache


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg)


def params_from_numpy(cfg: ModelConfig, tree: dict, device=None) -> dict:
    """The reference's parameter tree as numpy arrays
    (``jax.tree.map(np.asarray, params)``) -> this package's tree on ``device``
    (None: the card), each leaf checked against its ParamDef."""
    dev = runtime.resolve_device(device)

    def walk(defs, sub, path):
        if D.is_def(defs):
            arr = np.asarray(sub)
            if tuple(arr.shape) != defs.shape:
                raise ValueError(f"{'/'.join(path)}: shape {tuple(arr.shape)}, expected {defs.shape}")
            if arr.dtype != np.float32:
                arr = arr.astype(np.float32)
            elif not arr.flags.writeable:  # torch.from_numpy wants a writable buffer
                arr = arr.copy()
            return torch.from_numpy(arr).to(device=dev, dtype=defs.dtype)
        if set(sub) != set(defs):
            raise ValueError(f"{'/'.join(path) or 'params'}: keys {sorted(sub)}, expected {sorted(defs)}")
        return {k: walk(defs[k], sub[k], path + (k,)) for k in sorted(defs)}

    return walk(Model(cfg).param_defs(), tree, ())
