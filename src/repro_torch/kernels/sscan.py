"""Two scans as hand-written CUDA kernels:

* the first-order affine prefix ``s_i = decay * s_{i-1} + b_i`` (s0 = 0) —
  the DSim mapper's bandwidth-EMA carry — (``csrc/affine_scan.cu``) with a
  differentiable wrapper;
* the Mamba1 selective scan (``csrc/selective_scan.cu``), forward only, as
  :func:`selective_scan`; its plain version is ``ref.selective_scan``.

``s_i = sum_{j<=i} decay^(i-j) b_j``; the gradient is the reversed scan
``db_k = sum_{i>=k} decay^(i-k) g_i``, so the backward launches the same
kernel with ``reverse=1`` on the cotangent and needs no residuals.

The scan is the torch op ``torch.ops.repro_torch.affine_scan``: its CUDA
implementation launches the kernel, its CPU implementation is the plain
version, ``ref.affine_scan_reference`` (a log-step doubling scan).  The
dispatcher picks by the tensor's device; there is no other fallback.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import runtime
from repro_torch.kernels.ref import affine_scan_reference
from repro_torch.kernels.ref import selective_scan as selective_scan_plain


@torch.library.custom_op("repro_torch::affine_scan", mutates_args=(), device_types="cpu")
def affine_scan_op(add: torch.Tensor, decay: float, reverse: bool) -> torch.Tensor:
    """Inclusive affine prefix along the last axis (plain version, CPU)."""
    return affine_scan_reference(decay, add, reverse=reverse)


@affine_scan_op.register_kernel("cuda")
def _affine_scan_cuda(add: torch.Tensor, decay: float, reverse: bool) -> torch.Tensor:
    if add.dtype != torch.float32:
        raise TypeError(f"affine_scan takes float32, got {add.dtype}")
    if add.numel() == 0:  # nothing to scan, no launch
        return torch.empty_like(add)
    v = add.shape[-1]
    b = add.contiguous().view(-1, v)
    s = torch.empty_like(b)
    lib = runtime.library("affine_scan")
    runtime.count_launch("affine_scan")
    err = lib.affine_scan_launch(b.data_ptr(), s.data_ptr(), b.shape[0], v, float(decay),
                                 int(reverse), runtime.stream_handle(b))
    runtime.check_launch("affine_scan", err)
    return s.view(add.shape)


@affine_scan_op.register_fake
def _affine_scan_fake(add: torch.Tensor, decay: float, reverse: bool) -> torch.Tensor:
    return torch.empty_like(add)


class _AffineScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, add: torch.Tensor, decay: float) -> torch.Tensor:
        ctx.decay = decay
        return affine_scan_op(add, decay, False)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return affine_scan_op(g, ctx.decay, True), None


def affine_scan(decay: float, add: torch.Tensor) -> torch.Tensor:
    """Differentiable inclusive prefix of ``s' = decay*s + b`` along the last
    axis of ``add`` (any leading batch axes)."""
    return _AffineScan.apply(add, float(decay))


# --------------------------------------------------------------------------- #
# Mamba1 selective scan
# --------------------------------------------------------------------------- #

MAX_STATE = 16  # csrc/selective_scan.cu holds at most 16 states a channel (2 a thread, in 8 warps)


def _check_selective(u, dt, A, Bm, Cm, D) -> None:
    if u.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"selective_scan takes float32 or bfloat16 u, got {u.dtype}")
    if any(t.dtype != torch.float32 for t in (dt, A, Bm, Cm, D)):
        raise TypeError("selective_scan takes float32 dt, A, B, C and D")
    if u.ndim != 3:
        raise ValueError(f"selective_scan takes u [B,S,C], got {tuple(u.shape)}")
    Bt, S, C = u.shape
    if (dt.shape != u.shape or A.ndim != 2 or A.shape[0] != C or tuple(D.shape) != (C,)
            or tuple(Bm.shape) != (Bt, S, A.shape[1]) or Cm.shape != Bm.shape):
        raise ValueError(f"selective_scan: dt {tuple(dt.shape)}, A {tuple(A.shape)}, B {tuple(Bm.shape)}, "
                         f"C {tuple(Cm.shape)}, D {tuple(D.shape)} do not fit u {tuple(u.shape)}")
    if len({t.device for t in (u, dt, A, Bm, Cm, D)}) != 1:
        raise ValueError("selective_scan: all inputs must be on one device")


@torch.library.custom_op("repro_torch::selective_scan", mutates_args=(), device_types="cpu")
def selective_scan_op(u: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
                      D: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version (CPU implementation of the op)."""
    _check_selective(u, dt, A, Bm, Cm, D)
    return selective_scan_plain(u, dt, A, Bm, Cm, D)


@selective_scan_op.register_kernel("cuda")
def _selective_scan_cuda(u: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
                         Cm: torch.Tensor, D: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    _check_selective(u, dt, A, Bm, Cm, D)
    if not all(t.is_contiguous() for t in (u, dt, A, Bm, Cm, D)):
        raise ValueError("selective_scan: inputs must be contiguous")
    Bt, S, C = u.shape
    N = A.shape[1]
    if not 0 < N <= MAX_STATE:
        raise ValueError(f"selective_scan: state width {N} must lie in 1..{MAX_STATE}")
    y = torch.empty_like(u)
    state = torch.empty((Bt, C, N), dtype=torch.float32, device=u.device)
    if Bt * C == 0:  # no channel to scan, no launch
        return y, state
    lib = runtime.library("selective_scan")
    runtime.count_launch("selective_scan")
    err = lib.selective_scan_launch(u.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
                                    D.data_ptr(), y.data_ptr(), state.data_ptr(), Bt, S, C, N,
                                    int(u.dtype == torch.bfloat16), runtime.stream_handle(u))
    runtime.check_launch("selective_scan", err)
    return y, state


@selective_scan_op.register_fake
def _selective_scan_fake(u, dt, A, Bm, Cm, D):
    return torch.empty_like(u), u.new_empty((u.shape[0], u.shape[2], A.shape[1]), dtype=torch.float32)


def selective_scan(u: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
                   D: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """u [B, S, C], dt [B, S, C] (after softplus), A [C, N] (negative), B and C
    [B, S, N], D [C] -> (y [B, S, C] in u's type, final state [B, C, N] float32)."""
    return selective_scan_op(*(t.contiguous() for t in (u, dt, A, Bm, Cm, D)))


def selective_scan_operations(Bt: int, S: int, C: int, N: int) -> int:
    """Operations of the recurrence: per (step, channel, state) dt A (1),
    decay*s + (dt u) B (3) and the C . s sum (2); per (step, channel) dt*u and
    u*D + the sum (3).  The exponential of each (step, channel, state) is not
    among them: it is counted apart, against the special-function unit."""
    return Bt * S * C * (6 * N + 3)
