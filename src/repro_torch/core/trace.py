"""Workload tracer: ModelConfig x ShapeConfig -> dataflow Graph.

Emits an operator-level DFG with exact FLOP / byte counts for every assigned
architecture family (dense GQA transformer, MoE, Mamba1 SSM, Mamba2 hybrid,
VLM cross-attention, audio-token decoder).  These graphs feed DSim/DOpt (the
paper's 'modern AI workloads').

Conventions:
  * bf16 operands: 2 bytes/element.
  * train mode: fwd FLOPs x3 (fwd + 2x bwd), weight gradients written back.
  * decode mode: S_q = 1 against a KV cache of length S (read from mainMem).
  * weights stream from mainMem each use (the mapper's prefetch/tiling decides
    what is actually resident — see mapper.py).
"""
from __future__ import annotations

import numpy as np

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.graph import (
    CONV,
    ELEMWISE,
    GATHER,
    Graph,
    GraphBuilder,
    MATMUL,
    MISC,
    REDUCTION,
    SCAN,
    SOFTMAX,
)

BYTES = 2.0  # bf16


def _mm(b: GraphBuilder, name: str, M: float, K: float, N: float, *, mode: str, w_resident: bool = False):
    """A weight matmul [M,K]x[K,N]: activations in globalBuf, weights from mainMem."""
    mult = 3.0 if mode == "train" else 1.0
    flops = 2.0 * M * K * N * mult
    w_bytes = K * N * BYTES
    act_in = M * K * BYTES
    act_out = M * N * BYTES
    b.add(
        name,
        MATMUL,
        flops,
        gbuf_read=(act_in + w_bytes) * mult,
        gbuf_write=act_out * mult,
        main_read=0.0 if w_resident else w_bytes * (2.0 if mode == "train" else 1.0),
        main_write=w_bytes if mode == "train" else 0.0,  # weight grads
        alloc=act_in + act_out + w_bytes,
        dims=(M, N, K),
    )


def _ew(b: GraphBuilder, name: str, elems: float, flops_per: float, *, mode: str, kind: int = ELEMWISE):
    mult = 3.0 if mode == "train" else 1.0
    b.add(
        name,
        kind,
        elems * flops_per * mult,
        gbuf_read=elems * BYTES * mult,
        gbuf_write=elems * BYTES * mult,
        alloc=2 * elems * BYTES,
        dims=(elems, 1.0, 1.0),
    )


def _attention(b: GraphBuilder, name: str, Bq: float, Sq: float, Skv: float, nh: int, kv: int, hd: int, *, mode: str, causal: bool, kv_from_main: float = 0.0):
    """Scores + softmax + AV.  ``kv_from_main``: bytes of KV cache streamed
    from main memory (decode)."""
    mult = 3.0 if mode == "train" else 1.0
    frac = 0.5 if (causal and Sq == Skv) else 1.0
    score_flops = 2.0 * Bq * nh * Sq * Skv * hd * frac * mult
    kv_bytes = Bq * kv * Skv * hd * 2 * BYTES  # K and V
    q_bytes = Bq * nh * Sq * hd * BYTES
    s_bytes = Bq * nh * Sq * Skv * frac * BYTES
    b.add(
        name + ".scores",
        MATMUL,
        score_flops,
        gbuf_read=(q_bytes + kv_bytes / 2) * mult,
        gbuf_write=s_bytes * mult,
        main_read=kv_from_main / 2,
        alloc=q_bytes + kv_bytes / 2 + s_bytes,
        dims=(Bq * nh * Sq, Skv * frac, hd),
    )
    _ew(b, name + ".softmax", Bq * nh * Sq * Skv * frac, 5.0, mode=mode, kind=SOFTMAX)
    b.add(
        name + ".av",
        MATMUL,
        score_flops,
        gbuf_read=(s_bytes + kv_bytes / 2) * mult,
        gbuf_write=q_bytes * mult,
        main_read=kv_from_main / 2,
        alloc=s_bytes + kv_bytes / 2 + q_bytes,
        dims=(Bq * nh * Sq, hd, Skv * frac),
    )


def trace_lm(cfg: ModelConfig, shape: ShapeConfig, device=None) -> Graph:
    """Build the operator DFG for one (architecture x shape) cell."""
    mode = shape.kind  # train | prefill | decode
    B = float(shape.global_batch)
    S = 1.0 if mode == "decode" else float(shape.seq_len)
    Skv = float(shape.seq_len)
    d, V = float(cfg.d_model), float(cfg.vocab_size)
    T = B * S  # tokens processed this step
    b = GraphBuilder()

    # ---- embedding (gather) -------------------------------------------------
    n_emb = cfg.audio.n_codebooks if cfg.audio else 1
    b.add(
        "embed",
        GATHER,
        T * d * n_emb,
        main_read=T * d * n_emb * BYTES,
        gbuf_write=T * d * BYTES,
        alloc=T * d * BYTES,
        dims=(T, d, 1.0),
    )
    if cfg.vision:
        P = float(cfg.vision.n_patches)
        _mm(b, "patch_proj", B * P, float(cfg.vision.d_vision), d, mode=mode)

    # ---- layers -------------------------------------------------------------
    nh, kv, hd, ff = cfg.n_heads, cfg.n_kv_heads, cfg.hd, float(cfg.d_ff)

    def dense_attn_layer(i: int, prefix: str, kv_len: float, d_in: float = None):
        di = d_in or d
        _ew(b, f"{prefix}{i}.norm1", T * d, 8.0, mode=mode, kind=REDUCTION)
        _mm(b, f"{prefix}{i}.qkv", T, di, (nh + 2 * kv) * hd, mode=mode)
        _ew(b, f"{prefix}{i}.rope", T * nh * hd, 6.0, mode=mode)
        kv_main = B * kv * kv_len * hd * 2 * BYTES if mode == "decode" else 0.0
        _attention(b, f"{prefix}{i}.attn", B, S, kv_len, nh, kv, hd, mode=mode, causal=True, kv_from_main=kv_main)
        _mm(b, f"{prefix}{i}.o", T, nh * hd, d, mode=mode)

    def mlp(i: int, prefix: str, width: float):
        _ew(b, f"{prefix}{i}.norm2", T * d, 8.0, mode=mode, kind=REDUCTION)
        nmat = 3 if cfg.mlp_type == "swiglu" else 2
        _mm(b, f"{prefix}{i}.mlp_up", T, d, width * (nmat - 1), mode=mode)
        _ew(b, f"{prefix}{i}.act", T * width, 4.0, mode=mode)
        _mm(b, f"{prefix}{i}.mlp_down", T, width, d, mode=mode)

    if cfg.family in ("dense", "audio", "vlm"):
        for i in range(cfg.n_layers):
            is_cross = cfg.vision and (i + 1) % cfg.vision.cross_attn_every == 0
            if is_cross:
                P = float(cfg.vision.n_patches)
                _ew(b, f"L{i}.norm1", T * d, 8.0, mode=mode, kind=REDUCTION)
                _mm(b, f"L{i}.q", T, d, nh * hd, mode=mode)
                _mm(b, f"L{i}.kv_img", B * P, d, 2 * kv * hd, mode=mode)
                _attention(b, f"L{i}.xattn", B, S, P, nh, kv, hd, mode=mode, causal=False)
                _mm(b, f"L{i}.o", T, nh * hd, d, mode=mode)
            else:
                dense_attn_layer(i, "L", Skv)
            mlp(i, "L", ff)

    elif cfg.family == "moe":
        e = cfg.moe
        for i in range(cfg.n_layers):
            dense_attn_layer(i, "L", Skv)
            _ew(b, f"L{i}.norm2", T * d, 8.0, mode=mode, kind=REDUCTION)
            _mm(b, f"L{i}.router", T, d, e.n_experts, mode=mode)
            _ew(b, f"L{i}.topk", T * e.n_experts, 3.0, mode=mode, kind=REDUCTION)
            # dispatch + expert FFN (top_k experts active per token) + combine
            mult = 3.0 if mode == "train" else 1.0
            tok = T * e.top_k
            w_bytes = e.n_experts * 3 * d * e.d_ff_expert * BYTES
            # weights of ALL routed-to experts stream from main memory — the
            # hallmark mainMem pressure of MoE (capped by total expert bytes)
            act_expert_w = min(w_bytes, tok * 3 * d * e.d_ff_expert * BYTES)
            b.add(
                f"L{i}.dispatch",
                GATHER,
                tok * d,
                gbuf_read=T * d * BYTES * mult,
                gbuf_write=tok * d * BYTES * mult,
                alloc=(T + tok) * d * BYTES,
                dims=(tok, d, 1.0),
            )
            b.add(
                f"L{i}.experts",
                MATMUL,
                2.0 * tok * 3 * d * e.d_ff_expert * mult,
                gbuf_read=(tok * d * BYTES + act_expert_w) * mult,
                gbuf_write=tok * d * BYTES * mult,
                main_read=act_expert_w * (2.0 if mode == "train" else 1.0),
                main_write=w_bytes if mode == "train" else 0.0,
                alloc=tok * d * BYTES * 2 + act_expert_w,
                dims=(tok, e.d_ff_expert, d),
            )
            b.add(
                f"L{i}.combine",
                GATHER,
                tok * d * 2,
                gbuf_read=tok * d * BYTES * mult,
                gbuf_write=T * d * BYTES * mult,
                alloc=(T + tok) * d * BYTES,
                dims=(T, d, 1.0),
            )

    elif cfg.family == "ssm":
        s, di, dtr = cfg.ssm, float(cfg.d_inner), float(cfg.dt_rank)
        for i in range(cfg.n_layers):
            _ew(b, f"L{i}.norm", T * d, 8.0, mode=mode, kind=REDUCTION)
            _mm(b, f"L{i}.in_proj", T, d, 2 * di, mode=mode)
            b.add(
                f"L{i}.conv1d",
                CONV,
                2.0 * T * di * s.d_conv * (3.0 if mode == "train" else 1.0),
                gbuf_read=T * di * BYTES,
                gbuf_write=T * di * BYTES,
                alloc=2 * T * di * BYTES,
                dims=(T * di, 1.0, s.d_conv),
            )
            _mm(b, f"L{i}.x_proj", T, di, dtr + 2 * s.d_state, mode=mode)
            _mm(b, f"L{i}.dt_proj", T, dtr, di, mode=mode)
            # selective scan: per (token, channel): state update 3*d_state
            # FLOPs + output reduction 2*d_state
            _ew(b, f"L{i}.sel_scan", T * di, 5.0 * s.d_state, mode=mode, kind=SCAN)
            _ew(b, f"L{i}.gate", T * di, 4.0, mode=mode)
            _mm(b, f"L{i}.out_proj", T, di, d, mode=mode)

    elif cfg.family == "hybrid":
        s, di = cfg.ssm, float(cfg.d_inner)
        nssm = di // s.head_dim
        h = cfg.hybrid
        for i in range(cfg.n_layers):
            _ew(b, f"L{i}.norm", T * d, 8.0, mode=mode, kind=REDUCTION)
            _mm(b, f"L{i}.in_proj", T, d, 2 * di + 2 * nssm * s.d_state + nssm, mode=mode)
            b.add(
                f"L{i}.conv1d",
                CONV,
                2.0 * T * (di + 2 * nssm * s.d_state) * s.d_conv,
                gbuf_read=T * di * BYTES,
                gbuf_write=T * di * BYTES,
                alloc=2 * T * di * BYTES,
                dims=(T * di, 1.0, s.d_conv),
            )
            # SSD: intra-chunk matmuls dominate; ~4 * T * di * d_state FLOPs
            _ew(b, f"L{i}.ssd", T * di, 6.0 * s.d_state, mode=mode, kind=SCAN)
            _mm(b, f"L{i}.out_proj", T, di, d, mode=mode)
            if (i + 1) % h.attn_every == 0:
                # shared attention block on concat(hidden, embed): 2d -> heads
                _ew(b, f"L{i}.snorm", T * 2 * d, 8.0, mode=mode, kind=REDUCTION)
                _mm(b, f"L{i}.sqkv", T, 2 * d, (nh + 2 * kv) * hd, mode=mode, w_resident=True)
                kv_main = B * kv * Skv * hd * 2 * BYTES if mode == "decode" else 0.0
                _attention(b, f"L{i}.sattn", B, S, Skv, nh, kv, hd, mode=mode, causal=True, kv_from_main=kv_main)
                _mm(b, f"L{i}.so", T, nh * hd, d, mode=mode, w_resident=True)
                _mm(b, f"L{i}.smlp_up", T, d, 3 * h.shared_attn_mlp_ff - h.shared_attn_mlp_ff, mode=mode, w_resident=True)
                _mm(b, f"L{i}.smlp_down", T, h.shared_attn_mlp_ff, d, mode=mode, w_resident=True)
    else:
        raise ValueError(cfg.family)

    # ---- head ---------------------------------------------------------------
    _ew(b, "final_norm", T * d, 8.0, mode=mode, kind=REDUCTION)
    _mm(b, "logits", T, d, V * n_emb, mode=mode)
    if mode == "train":
        _ew(b, "xent", T * V, 6.0, mode=mode, kind=SOFTMAX)

    return b.build(device)


# --------------------------------------------------------------------------- #
# Model-FLOPs formulas for validation (6ND and friends)
# --------------------------------------------------------------------------- #


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """6 * N_active * D for train; 2 * N_active * D for inference."""
    tokens = shape.global_batch * (1 if shape.kind == "decode" else shape.seq_len)
    n = cfg.active_param_count()
    per_tok = 6.0 * n if shape.kind == "train" else 2.0 * n
    return per_tok * tokens
