"""The first-order affine prefix ``s_i = decay * s_{i-1} + b_i`` (s0 = 0) —
the DSim mapper's bandwidth-EMA carry — as a hand-written CUDA kernel
(``csrc/affine_scan.cu``) with a differentiable wrapper.

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
