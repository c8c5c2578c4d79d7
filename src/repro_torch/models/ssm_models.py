"""SSM-family model pieces: Mamba1 (falcon-mamba) and the Mamba2 +
shared-attention hybrid (zamba2).  Param defs and per-layer functions (full
sequence and one decode step); the loop over layers is in model.py.

The full-sequence layers return the new hidden state together with what
decode starts from, the layer's conv window and final SSM state: the scan
kernels return the state anyway, so the prefill needs no second pass.  With
``cache=False`` (training) they return the hidden state alone and build no
conv window; they are differentiable end to end (the scans' autograd formulas
are in ``kernels/sscan.py`` and ``kernels/ssd.py``).  Each takes ``mesh``
(None: one device); on a mesh the input projection's output is constrained as
the reference's is.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import defs as D
from repro_torch.models.layers import mm, rms_norm
from repro_torch.models.sharding import constrain, einsum, reshape
from repro_torch.models.mamba import (
    causal_conv1d,
    conv_step,
    conv_window,
    selective_scan,
    selective_scan_step,
    ssd_scan,
    ssd_step,
)

P_ = D.ParamDef


# --------------------------------------------------------------------------- #
# Mamba1 (falcon-mamba)
# --------------------------------------------------------------------------- #


def mamba1_defs(cfg: ModelConfig) -> dict:
    L, d, di = cfg.n_layers, cfg.d_model, cfg.d_inner
    s, dtr = cfg.ssm, cfg.dt_rank
    return {
        "norm": P_((L, d), ("layers", None), "ones"),
        "in_proj": P_((L, d, 2 * di), ("layers", "embed", "d_inner")),
        "conv_w": P_((L, s.d_conv, di), ("layers", None, "d_inner")),
        "conv_b": P_((L, di), ("layers", "d_inner"), "zeros"),
        "x_proj": P_((L, di, dtr + 2 * s.d_state), ("layers", "d_inner", None)),
        "dt_proj": P_((L, dtr, di), ("layers", None, "d_inner")),
        "dt_bias": P_((L, di), ("layers", "d_inner"), "dt_bias"),
        "A_log": P_((L, di, s.d_state), ("layers", "d_inner", None), "ssm_a"),
        "D": P_((L, di), ("layers", "d_inner"), "ones"),
        "out_proj": P_((L, di, d), ("layers", "d_inner", "embed")),
    }


def _mamba1_inner(cfg: ModelConfig, lp: dict, x: torch.Tensor, mesh=None):
    """x: [B, S, d] normed input -> (xi, z) halves of the input projection."""
    xz = constrain(mm("bsd,de->bse", x, lp["in_proj"]), mesh, ("pod", "data"), None, "model")
    return xz.chunk(2, -1)


def _mamba1_bcdt(cfg: ModelConfig, lp: dict, xi: torch.Tensor):
    N, dtr = cfg.ssm.d_state, cfg.dt_rank
    bcdt = mm("bse,ek->bsk", xi, lp["x_proj"])
    Bc = bcdt[..., dtr:dtr + N].float()
    Cc = bcdt[..., dtr + N:].float()
    dt = mm("bsk,ke->bse", bcdt[..., :dtr], lp["dt_proj"])
    dt = F.softplus(dt.float() + lp["dt_bias"].float())
    return dt, Bc, Cc


def mamba1_layer(cfg: ModelConfig, lp: dict, h: torch.Tensor, cache: bool = True, mesh=None):
    """Full-sequence Mamba1 block.  h: [B, S, d].
    Returns (h_new, (conv window [B, K-1, di], state [B, di, N])), or h_new
    alone without ``cache``."""
    x = rms_norm(h, lp["norm"], cfg.norm_eps)
    xi, zg = _mamba1_inner(cfg, lp, x, mesh)
    conv_buf = conv_window(xi, cfg.ssm.d_conv) if cache else None
    xi = causal_conv1d(xi, lp["conv_w"], lp["conv_b"])
    xi = F.silu(xi.float()).to(h.dtype)
    dt, Bc, Cc = _mamba1_bcdt(cfg, lp, xi)
    A = -torch.exp(lp["A_log"].float())
    y, state = selective_scan(xi, dt, A, Bc, Cc, lp["D"].float())
    y = y * F.silu(zg.float()).to(h.dtype)
    h = h + mm("bse,ed->bsd", y, lp["out_proj"])
    return (h, (conv_buf, state)) if cache else h


def mamba1_decode(cfg: ModelConfig, lp: dict, h: torch.Tensor, conv_buf, state, mesh=None):
    """One-token step.  h: [B, 1, d]; conv_buf [B, K-1, di]; state [B, di, N]."""
    x = rms_norm(h, lp["norm"], cfg.norm_eps)
    xi, zg = _mamba1_inner(cfg, lp, x, mesh)
    xi_t, conv_buf = conv_step(xi[:, 0], conv_buf, lp["conv_w"], lp["conv_b"])
    xi_t = F.silu(xi_t.float()).to(h.dtype)
    dt, Bc, Cc = _mamba1_bcdt(cfg, lp, xi_t[:, None])
    A = -torch.exp(lp["A_log"].float())
    y, state = selective_scan_step(xi_t, dt[:, 0], A, Bc[:, 0], Cc[:, 0], lp["D"].float(), state)
    y = y[:, None] * F.silu(zg.float()).to(h.dtype)
    return h + mm("bse,ed->bsd", y, lp["out_proj"]), conv_buf, state


# --------------------------------------------------------------------------- #
# Mamba2 layer (zamba2 hybrid)
# --------------------------------------------------------------------------- #


def mamba2_defs(cfg: ModelConfig, L: int) -> dict:
    d, di, s = cfg.d_model, cfg.d_inner, cfg.ssm
    nh = di // s.head_dim
    N = s.d_state
    return {
        "norm": P_((L, d), ("layers", None), "ones"),
        "in_proj": P_((L, d, 2 * di + 2 * N + nh), ("layers", "embed", "d_inner")),
        "conv_w": P_((L, s.d_conv, di + 2 * N), ("layers", None, "d_inner")),
        "conv_b": P_((L, di + 2 * N), ("layers", "d_inner"), "zeros"),
        "dt_bias": P_((L, nh), ("layers", None), "dt_bias"),
        "A_log": P_((L, nh), ("layers", None), "ssm_a"),
        "D": P_((L, nh), ("layers", None), "ones"),
        "norm_g": P_((L, di), ("layers", "d_inner"), "ones"),
        "out_proj": P_((L, di, d), ("layers", "d_inner", "embed")),
    }


def _mamba2_split(cfg: ModelConfig, proj: torch.Tensor):
    di, N = cfg.d_inner, cfg.ssm.d_state
    return (proj[..., :di], proj[..., di:2 * di], proj[..., 2 * di:2 * di + N],
            proj[..., 2 * di + N:2 * di + 2 * N], proj[..., 2 * di + 2 * N:])


def _mamba2_out(cfg: ModelConfig, lp: dict, h, y, xi, zg):
    """The skip through D (each head's D on its head_dim channels), the gated
    norm and the output projection.  The skip is a product over [..., nh, P]
    heads (``sharding.einsum``): on a mesh, D's gradient is then never a
    split vector viewed as heads."""
    heads = reshape(xi, *xi.shape[:-1], -1, cfg.ssm.head_dim).float()
    y = y + reshape(einsum("bshp,h->bshp", heads, lp["D"].float()), *xi.shape)
    y = rms_norm(y * F.silu(zg.float()).to(h.dtype), lp["norm_g"], cfg.norm_eps)
    return h + mm("bse,ed->bsd", y.to(h.dtype), lp["out_proj"]).to(h.dtype)


def mamba2_layer(cfg: ModelConfig, lp: dict, h: torch.Tensor, cache: bool = True, mesh=None):
    """Full-sequence Mamba2 block.  h: [B, S, d].
    Returns (h_new, (conv window [B, K-1, di+2N], state [B, nh, N, P])), or
    h_new alone without ``cache``."""
    B, S, _ = h.shape
    di, s = cfg.d_inner, cfg.ssm
    nh, N = di // s.head_dim, s.d_state
    x = rms_norm(h, lp["norm"], cfg.norm_eps)
    proj = constrain(mm("bsd,de->bse", x, lp["in_proj"]), mesh, ("pod", "data"), None, "model")
    xi, zg, Bc, Cc, dt = _mamba2_split(cfg, proj)
    xbc = torch.cat([xi, Bc, Cc], -1)
    conv_buf = conv_window(xbc, s.d_conv) if cache else None
    xbc = F.silu(causal_conv1d(xbc, lp["conv_w"], lp["conv_b"]).float()).to(h.dtype)
    xi, Bc, Cc = xbc[..., :di], xbc[..., di:di + N], xbc[..., di + N:]
    dt = F.softplus(dt.float() + lp["dt_bias"].float())
    A = -torch.exp(lp["A_log"].float())
    y, state = ssd_scan(reshape(xi, B, S, nh, s.head_dim), dt, A, Bc.float(), Cc.float())
    h = _mamba2_out(cfg, lp, h, reshape(y, B, S, di), xi, zg)
    return (h, (conv_buf, state)) if cache else h


def mamba2_decode(cfg: ModelConfig, lp: dict, h: torch.Tensor, conv_buf, state, mesh=None):
    """h: [B, 1, d]; conv_buf [B, K-1, di+2N]; state [B, nh, N, P] fp32."""
    B = h.shape[0]
    di, s = cfg.d_inner, cfg.ssm
    nh, N = di // s.head_dim, s.d_state
    x = rms_norm(h, lp["norm"], cfg.norm_eps)
    xi, zg, Bc, Cc, dt = _mamba2_split(cfg, mm("bsd,de->bse", x, lp["in_proj"]))
    xbc_t, conv_buf = conv_step(torch.cat([xi, Bc, Cc], -1)[:, 0], conv_buf, lp["conv_w"], lp["conv_b"])
    xbc_t = F.silu(xbc_t.float()).to(h.dtype)
    xi_t, B_t, C_t = xbc_t[..., :di], xbc_t[..., di:di + N], xbc_t[..., di + N:]
    dt_t = F.softplus(dt[:, 0].float() + lp["dt_bias"].float())
    A = -torch.exp(lp["A_log"].float())
    y, state = ssd_step(reshape(xi_t, B, nh, s.head_dim), dt_t, A, B_t.float(), C_t.float(), state)
    h = _mamba2_out(cfg, lp, h, reshape(y, B, 1, di), xi_t[:, None], zg)
    return h, conv_buf, state


# --------------------------------------------------------------------------- #
# zamba2 shared attention block (weights shared across invocations)
# --------------------------------------------------------------------------- #


def shared_block_defs(cfg: ModelConfig) -> dict:
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    ff = cfg.hybrid.shared_attn_mlp_ff
    return {
        "ln1": P_((2 * d,), (None,), "ones"),
        "wq": P_((2 * d, H, hd), (None, "heads", None)),
        "wk": P_((2 * d, KV, hd), (None, "kv_heads", None)),
        "wv": P_((2 * d, KV, hd), (None, "kv_heads", None)),
        "wo": P_((H * hd, d), ("heads", "embed")),
        "ln2": P_((d,), (None,), "ones"),
        "w_gate": P_((d, ff), ("embed", "ff")),
        "w_up": P_((d, ff), ("embed", "ff")),
        "w_down": P_((ff, d), ("ff", "embed")),
    }
