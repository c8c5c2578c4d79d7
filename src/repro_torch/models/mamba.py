"""Mamba1 (selective scan) and Mamba2 (SSD) pieces: the full-sequence scans
and the single-step decode recurrences.

The full-sequence scans run the hand-written kernels: :func:`selective_scan`
(``kernels.sscan.selective_scan``) and :func:`ssd_scan`
(``kernels.ssd.ssd_chunk_scan``).  Both return the output and the final state,
which the prefill hands to decode.  Each kernel picks its own chunking and
masks a ragged tail, so any prompt length works.  Both are differentiable:
with gradients on, the kernel keeps the state entering each of its chunks
and a plain-PyTorch backward starts from them.  The conv and the two decode
steps are plain PyTorch.

Numerics: state math in fp32; parameters fp32; activations in the model dtype
at block boundaries.
"""
from __future__ import annotations

from typing import Optional

import torch

# the full-sequence scans are the kernels' wrappers themselves:
#   selective_scan(u, dt, A, B, C, D) -> (y [B,S,C], state [B,C,N])       (K5)
#   ssd_scan(x, dt, A, B, C)          -> (y [B,S,H,P], state [B,H,N,P])   (K4)
from repro_torch.kernels.ssd import ssd_chunk_scan as ssd_scan  # noqa: F401
from repro_torch.kernels.sscan import selective_scan  # noqa: F401
from repro_torch.models.sharding import einsum, pad


def causal_conv1d(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor]) -> torch.Tensor:
    """x: [B, S, C]; w: [K, C] depthwise kernel; causal (left) padding."""
    K, S = w.shape[0], x.shape[1]
    xp = pad(x, (0, 0, K - 1, 0))
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(K):
        out = out + xp[:, i:i + S].float() * w[i].float()
    if b is not None:
        out = out + b.float()
    return out.to(x.dtype)


def conv_window(x: torch.Tensor, K: int) -> torch.Tensor:
    """The last K-1 inputs of x [B, S, C], zero-padded on the left: the conv
    buffer decode starts from (prompts shorter than K-1 included)."""
    return pad(x, (0, 0, K - 1, 0))[:, -(K - 1):]


def conv_step(x_t: torch.Tensor, conv_buf: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor]):
    """One decode step.  x_t: [B, C]; conv_buf: [B, K-1, C] (past inputs).
    Returns (y_t [B, C], new_buf)."""
    window = torch.cat([conv_buf, x_t[:, None, :]], 1)  # [B, K, C]
    y = einsum("bkc,kc->bc", window.float(), w.float())
    if b is not None:
        y = y + b.float()
    return y.to(x_t.dtype), window[:, 1:]


def selective_scan_step(u_t, dt_t, A, B_t, C_t, D, state):
    """u_t, dt_t [B, C]; B_t, C_t [B, N]; state [B, C, N] fp32."""
    uf, dtf = u_t.float(), dt_t.float()
    a = torch.exp(dtf[..., None] * A[None])
    b = (dtf * uf)[..., None] * B_t[:, None, :]
    state = a * state + b
    y = einsum("bcn,bn->bc", state, C_t.float()) + uf * D
    return y.to(u_t.dtype), state


def ssd_step(x_t, dt_t, A, B_t, C_t, state):
    """x_t [B, H, P]; dt_t [B, H]; B_t, C_t [B, N]; state [B, H, N, P] fp32."""
    decay = torch.exp(dt_t.float() * A[None])  # [B, H]
    upd = dt_t[..., None, None] * B_t[:, None, :, None] * x_t[:, :, None, :]
    state = decay[..., None, None] * state + upd.float()
    y = einsum("bn,bhnp->bhp", C_t.float(), state)
    return y.to(x_t.dtype), state
