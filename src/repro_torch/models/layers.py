"""Layers shared by the model zoo (functional, over plain tensors).

Attention has two paths:

  * :func:`attention` — full-sequence attention on [B, S, H, D] tensors, always
    through the hand-written attention kernel (``kernels.flash_attention``);
  * :func:`decode_attention` — one query against a KV cache, plain PyTorch.

Layout: activations are [B, S, d_model]; per-head tensors are [B, S, H, D]
(transposed to [B, H, S, D] only inside attention).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention import flash_attention


def mm(subscripts: str, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """A product with the weight cast to the activation dtype: bf16 operands,
    fp32 accumulation (the card's and the CPU's bf16 products accumulate in
    fp32), output in the activation dtype."""
    return torch.einsum(subscripts, x, w.to(x.dtype))


# --------------------------------------------------------------------------- #
# norms / rope / mlp
# --------------------------------------------------------------------------- #


def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, -1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * gamma.float()).to(x.dtype)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [B, S, H, D]; positions: [B, S] (int)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    ang = positions[..., None].float() * freqs  # [B, S, D/2]
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = x.float().chunk(2, -1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1).to(x.dtype)


def mlp_act(gate: torch.Tensor, up: Optional[torch.Tensor], kind: str) -> torch.Tensor:
    """swiglu (silu in float32), gelu (the tanh approximation, in the gate's
    dtype, as ``jax.nn.gelu``) or relu2 (``relu(gate) ** 2``)."""
    if kind == "swiglu":
        return F.silu(gate.float()).to(gate.dtype) * up
    if kind == "gelu":
        return F.gelu(gate, approximate="tanh")
    if kind == "relu2":
        r = F.relu(gate)
        return r * r
    raise ValueError(kind)


# --------------------------------------------------------------------------- #
# attention
# --------------------------------------------------------------------------- #


def write_at(cache: torch.Tensor, lens: torch.Tensor, x: torch.Tensor) -> None:
    """``cache[b, lens[b]] = x[b]`` in place, for every b with lens[b] inside
    the cache; a write past its end is dropped (no index leaves the cache)."""
    bidx = torch.arange(cache.shape[0], device=cache.device)
    idx = lens.clamp(max=cache.shape[1] - 1)
    keep = (lens < cache.shape[1]).reshape((-1,) + (1,) * (x.ndim - 1))
    cache[bidx, idx] = torch.where(keep, x.to(cache.dtype), cache[bidx, idx])


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, cache_len: torch.Tensor, *,
                     scale: Optional[float] = None) -> torch.Tensor:
    """q [B, Hq, 1, D] against a padded cache k, v [B, Hkv, Skv, D]; positions
    at or past ``cache_len`` ([B] or a scalar) are masked out."""
    B, Hq, _, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    group = Hq // Hkv
    scale = D ** -0.5 if scale is None else scale
    qg = q.reshape(B, Hkv, group, D)
    s = torch.einsum("bhgd,bhkd->bhgk", qg.float(), k.float()) * scale
    valid = torch.arange(Skv, device=q.device)[None, None, None, :] < cache_len.reshape(-1, 1, 1, 1)
    p = torch.softmax(s.masked_fill(~valid, float("-inf")), -1)
    out = torch.einsum("bhgk,bhkd->bhgd", p, v.float())
    return out.reshape(B, Hq, 1, D).to(q.dtype)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
              use_flash: bool = False) -> torch.Tensor:
    """[B, S, H, D] tensors through the attention kernel.  ``use_flash`` is
    kept for the reference's signature: in this package both values run the
    kernel (the reference's other path, a flash-shaped jnp program, exists for
    its XLA dry-run, which has no counterpart here)."""
    del use_flash
    o = flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), causal=causal)
    return o.transpose(1, 2)
