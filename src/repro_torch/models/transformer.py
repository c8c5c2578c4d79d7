"""Transformer spine: the dense, MoE, VLM (cross-attention) and audio
(multi-codebook) families, and the token embedding and LM head that every
family uses.  Parameters are declared as ParamDef trees (defs.py) with the
per-layer tensors stacked on a leading "layers" dim; the block functions take
one layer's weights, without that dim.

Layer patterns (run by models/model.py as Python loops over the stacks):
  * dense, audio, moe: one homogeneous stack of L layers;
  * vlm: groups of ``cross_attn_every - 1`` self-attention layers followed by
    one cross-attention layer that attends to projected vision patches.

The loss: :func:`xent_loss` on full logits, and :func:`chunked_xent`, which
never holds more than one sequence chunk's logits.

Every block takes ``mesh`` (None: one device).  On a mesh the tensors are
DTensors and the blocks put the reference's ``constrain`` points in as
redistributions (``models/sharding.py``); the MoE block takes the
expert-parallel path (``moe.moe_ffn_expert_parallel``) whenever the mesh has
a ``model`` axis.  The KV cache of :func:`self_attn_decode` is written in
place.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import defs as D
from repro_torch.models.layers import apply_rope, attention, decode_attention, mlp_act, mm, rms_norm, write_at
from repro_torch.models.moe import moe_ffn, moe_ffn_expert_parallel
from repro_torch.models.sharding import axis_names, constrain, constrain_logical, fsdp_axes_for, reduce_partial, \
    reshape

P_ = D.ParamDef


# --------------------------------------------------------------------------- #
# param definitions
# --------------------------------------------------------------------------- #


def attn_defs(cfg: ModelConfig, L: int, d_in: Optional[int] = None) -> dict:
    d = d_in or cfg.d_model
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    defs = {
        "ln1": P_((L, cfg.d_model) if d_in is None else (L, d), ("layers", None), "ones"),
        "wq": P_((L, d, H, hd), ("layers", "embed", "heads", None)),
        "wk": P_((L, d, KV, hd), ("layers", "embed", "kv_heads", None)),
        "wv": P_((L, d, KV, hd), ("layers", "embed", "kv_heads", None)),
        "wo": P_((L, H * hd, cfg.d_model), ("layers", "heads", "embed")),
    }
    if cfg.qkv_bias:
        defs["bq"] = P_((L, H, hd), ("layers", "heads", None), "zeros")
        defs["bk"] = P_((L, KV, hd), ("layers", "kv_heads", None), "zeros")
        defs["bv"] = P_((L, KV, hd), ("layers", "kv_heads", None), "zeros")
    return defs


def mlp_defs(cfg: ModelConfig, L: int) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    defs = {
        "ln2": P_((L, d), ("layers", None), "ones"),
        "w_gate": P_((L, d, f), ("layers", "embed", "ff")),
        "w_down": P_((L, f, d), ("layers", "ff", "embed")),
    }
    if cfg.mlp_type == "swiglu":
        defs["w_up"] = P_((L, d, f), ("layers", "embed", "ff"))
    return defs


def moe_defs(cfg: ModelConfig, L: int) -> dict:
    d, e = cfg.d_model, cfg.moe
    f = e.d_ff_expert
    return {
        "ln2": P_((L, d), ("layers", None), "ones"),
        "router": P_((L, d, e.n_experts), ("layers", "embed", None), "normal", 0.1),
        "w_gate": P_((L, e.n_experts, d, f), ("layers", "experts", "embed", None)),
        "w_up": P_((L, e.n_experts, d, f), ("layers", "experts", "embed", None)),
        "w_down": P_((L, e.n_experts, f, d), ("layers", "experts", None, "embed")),
    }


def transformer_defs(cfg: ModelConfig) -> dict:
    V, d = cfg.vocab_size, cfg.d_model
    ncb = cfg.audio.n_codebooks if cfg.audio else 1
    defs: dict = {
        "embed": P_((ncb, V, d), (None, "vocab", "embed"), "embed", 0.02),
        "final_norm": P_((d,), (None,), "ones"),
        "lm_head": P_((ncb, d, V), (None, "embed", "vocab")),
    }
    if cfg.family == "moe":
        L = cfg.n_layers
        defs["layers"] = {**attn_defs(cfg, L), **moe_defs(cfg, L)}
    elif cfg.vision:
        k = cfg.vision.cross_attn_every
        n_cross = cfg.n_layers // k
        n_self = cfg.n_layers - n_cross
        assert n_self % n_cross == 0
        defs["layers"] = {**attn_defs(cfg, n_self), **mlp_defs(cfg, n_self)}
        cross = {**attn_defs(cfg, n_cross), **mlp_defs(cfg, n_cross)}
        cross["attn_gate"] = P_((n_cross,), ("layers",), "zeros")
        cross["mlp_gate"] = P_((n_cross,), ("layers",), "zeros")
        defs["cross_layers"] = cross
        defs["patch_proj"] = P_((cfg.vision.d_vision, d), (None, "embed"))
    else:  # dense / audio
        L = cfg.n_layers
        defs["layers"] = {**attn_defs(cfg, L), **mlp_defs(cfg, L)}
    return defs


# --------------------------------------------------------------------------- #
# blocks (one layer, weights without the leading L dim)
# --------------------------------------------------------------------------- #


def _proj_qkv(cfg: ModelConfig, p: dict, x: torch.Tensor):
    q = mm("bsd,dhk->bshk", x, p["wq"])
    k = mm("bsd,dhk->bshk", x, p["wk"])
    v = mm("bsd,dhk->bshk", x, p["wv"])
    if cfg.qkv_bias:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    return q, k, v


def self_attn_block(cfg: ModelConfig, p: dict, h: torch.Tensor, positions: torch.Tensor, mesh=None):
    """Full-sequence causal self-attention sublayer.  Returns (out, (k, v))."""
    x = rms_norm(h, p["ln1"], cfg.norm_eps)
    q, k, v = _proj_qkv(cfg, p, x)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    q = constrain(q, mesh, ("pod", "data"), None, "model", None)
    k = constrain(k, mesh, ("pod", "data"), None, "model", None)
    o = attention(q, k, v, causal=True)
    out = mm("bshk,hkd->bsd", o, reshape(p["wo"], cfg.n_heads, cfg.hd, -1))
    return out, (k, v)


def self_attn_decode(cfg: ModelConfig, p: dict, h: torch.Tensor, k_cache, v_cache, lens, mesh=None):
    """One-token self-attention against a KV cache.  h [B, 1, d]; lens [B],
    each slot's valid length (its new token lands at position lens[b]).  The
    token's k and v are written into the caches ([B, max_len, KV, hd]) in
    place.  Returns (out, k_cache, v_cache)."""
    B = h.shape[0]
    x = rms_norm(h, p["ln1"], cfg.norm_eps)
    q, k, v = _proj_qkv(cfg, p, x)
    pos = lens.reshape(B, 1)
    q = apply_rope(q, pos, cfg.rope_theta)
    k = apply_rope(k, pos, cfg.rope_theta)
    write_at(k_cache, lens, k[:, 0])
    write_at(v_cache, lens, v[:, 0])
    o = decode_attention(q.transpose(1, 2), k_cache.transpose(1, 2).to(q.dtype),
                         v_cache.transpose(1, 2).to(q.dtype), lens + 1)
    out = mm("bshk,hkd->bsd", o.transpose(1, 2), reshape(p["wo"], cfg.n_heads, cfg.hd, -1))
    return out, k_cache, v_cache


def cross_attn_block(cfg: ModelConfig, p: dict, h: torch.Tensor, kv_k, kv_v, mesh=None):
    """Cross-attention (not causal) against precomputed vision K/V [B, P, KV, hd]."""
    x = rms_norm(h, p["ln1"], cfg.norm_eps)
    q = mm("bsd,dhk->bshk", x, p["wq"])
    if cfg.qkv_bias:
        q = q + p["bq"].to(x.dtype)
    o = attention(q, kv_k.to(q.dtype), kv_v.to(q.dtype), causal=False)
    return mm("bshk,hkd->bsd", o, reshape(p["wo"], cfg.n_heads, cfg.hd, -1))


def vision_kv(cfg: ModelConfig, p: dict, vis: torch.Tensor):
    """K/V of one cross layer from the projected vision embeddings [B, P, d]."""
    k = mm("bpd,dhk->bphk", vis, p["wk"])
    v = mm("bpd,dhk->bphk", vis, p["wv"])
    if cfg.qkv_bias:
        k = k + p["bk"].to(vis.dtype)
        v = v + p["bv"].to(vis.dtype)
    return k, v


def mlp_block(cfg: ModelConfig, p: dict, h: torch.Tensor, mesh=None) -> torch.Tensor:
    x = rms_norm(h, p["ln2"], cfg.norm_eps)
    g = mm("bsd,df->bsf", x, p["w_gate"])
    g = constrain(g, mesh, ("pod", "data"), None, "model")
    up = mm("bsd,df->bsf", x, p["w_up"]) if cfg.mlp_type == "swiglu" else None
    return mm("bsf,fd->bsd", mlp_act(g, up, cfg.mlp_type), p["w_down"])


def moe_block(cfg: ModelConfig, p: dict, h: torch.Tensor, mesh=None):
    """The MoE sublayer: expert-parallel on a mesh with a ``model`` axis, else
    on one device.  Returns (out, aux_loss, z_loss)."""
    B, S, d = h.shape
    x = rms_norm(h, p["ln2"], cfg.norm_eps)
    kw = dict(top_k=cfg.moe.top_k, capacity_factor=cfg.moe.capacity_factor, mlp_kind=cfg.mlp_type)
    if mesh is not None and "model" in axis_names(mesh):
        out = moe_ffn_expert_parallel(reshape(x, B * S, d), p["router"], p["w_gate"], p["w_up"], p["w_down"],
                                      mesh=mesh, fsdp_axes=fsdp_axes_for(cfg), compute_dtype=getattr(torch, cfg.dtype),
                                      **kw)
    else:
        out = moe_ffn(reshape(x, B * S, d), p["router"], p["w_gate"], p["w_up"], p["w_down"], **kw)
    return reshape(out.y, B, S, d).to(h.dtype), out.aux_loss, out.z_loss


# --------------------------------------------------------------------------- #
# embedding / head / loss
# --------------------------------------------------------------------------- #


def embed_tokens(cfg: ModelConfig, params: dict, tokens: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """tokens [B, S], or [B, S, ncb] for audio (the codebooks' embeddings
    summed in the embedding's dtype, c = 0..ncb-1) -> [B, S, d] in ``dtype``."""
    emb = params["embed"]
    if cfg.audio:  # on a mesh each codebook's vocab-parallel lookup reduced before the sum
        out = reduce_partial(F.embedding(tokens[..., 0], emb[0]))
        for c in range(1, cfg.audio.n_codebooks):
            out = out + reduce_partial(F.embedding(tokens[..., c], emb[c]))
        return out.to(dtype)
    return F.embedding(tokens, emb[0]).to(dtype)


def lm_logits(cfg: ModelConfig, params: dict, h: torch.Tensor, mesh=None) -> torch.Tensor:
    """[B, S, d] -> [B, S, V] fp32 logits, or [B, S, ncb, V] for audio."""
    hn = rms_norm(h, params["final_norm"], cfg.norm_eps)
    logits = mm("bsd,cdv->bscv", hn, params["lm_head"])
    logits = constrain_logical(logits, mesh, "batch", None, None, "vocab")
    if not cfg.audio:
        logits = logits[:, :, 0, :]
    return logits.float()


def _xent_terms(logits: torch.Tensor, labels: torch.Tensor, ignore: int):
    """(sum of the kept tokens' cross-entropy, kept-token count), float32;
    labels [...] against logits [..., V]."""
    labels = labels.long()
    lse = torch.logsumexp(logits, -1)
    # on a mesh, a vocab-parallel gather's masked partial sum, reduced before any view of it
    gold = reduce_partial(torch.gather(logits, -1, labels.clamp(min=0)[..., None]))[..., 0]
    mask = (labels != ignore).float()
    return torch.sum((lse - gold) * mask), torch.sum(mask)


def xent_loss(logits: torch.Tensor, labels: torch.Tensor, ignore: int = -1) -> torch.Tensor:
    """Mean token cross-entropy; labels broadcast against [..., V] logits,
    tokens labelled ``ignore`` left out."""
    tot, cnt = _xent_terms(logits, labels, ignore)
    return tot / torch.clamp(cnt, min=1.0)


def _xent_chunk(cfg: ModelConfig, params: dict, h: torch.Tensor, labels: torch.Tensor, ignore: int, mesh=None):
    return _xent_terms(lm_logits(cfg, params, h, mesh), labels, ignore)


def chunked_xent(cfg: ModelConfig, params: dict, h: torch.Tensor, labels: torch.Tensor, chunk: int = 256,
                 ignore: int = -1, mesh=None) -> torch.Tensor:
    """Cross-entropy without materializing [B, S, (ncb,) V] logits: the head
    and the softmax run a sequence chunk at a time, each chunk checkpointed
    (its logits recomputed in the backward), so peak logits are
    [B, chunk, (ncb,) V].  The same value and grads as
    ``xent_loss(lm_logits(h))``.  labels [B, S], or [B, S, ncb] for audio."""
    S = h.shape[1]
    c = min(chunk, S)
    while S % c:
        c -= 1
    tot = cnt = torch.zeros((), device=h.device)
    for i in range(0, S, c):
        t, n = checkpoint(_xent_chunk, cfg, params, h[:, i:i + c], labels[:, i:i + c], ignore, mesh,
                          use_reentrant=False)
        tot, cnt = tot + t, cnt + n
    return tot / torch.clamp(cnt, min=1.0)
