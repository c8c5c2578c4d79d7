"""Three scans as hand-written CUDA kernels:

* the DSim mapper's two Alg.-7 carries, buffer occupancy
  ``s' = min(occ_decay*s + alloc, cap)`` and the bandwidth EMA
  ``t' = bw_decay*t + bw_gain*x``, as exclusive prefixes in one launch, and
  their closed-form gradient in one more (``csrc/affine_scan.cu``), as
  :func:`mapper_carries`; plain versions ``ref.mapper_carries_reference`` and
  ``ref.mapper_carries_backward_reference``;
* the bare first-order affine prefix ``s_i = decay * s_{i-1} + b_i`` (s0 = 0)
  (the same source, the occupancy carry compiled out) with a differentiable
  wrapper, :func:`affine_scan`;
* the Mamba1 selective scan (``csrc/selective_scan.cu``) as
  :func:`selective_scan`; its plain version is ``ref.selective_scan``.  With
  gradients on, the kernel also writes the state entering each of its
  48-step chunks, and the backward (``ref.selective_scan_bwd``, plain
  PyTorch on the inputs' device) starts from them.

``s_i = sum_{j<=i} decay^(i-j) b_j``; the gradient is the reversed scan
``db_k = sum_{i>=k} decay^(i-k) g_i``, so the backward launches the same
kernel with ``reverse=1`` on the cotangent and needs no residuals.

Each scan is a torch op (``torch.ops.repro_torch.*``): its CUDA
implementation launches the kernel, its CPU implementation is the plain
version (log-step doubling scans).  The dispatcher picks by the tensor's
device; there is no other fallback.

On DTensors the selective scan's ops (forward, states, backward
``repro_torch::selective_scan_backward``) have sharding rules: everything
split over batch, or over channels (A and D with them, B and C replicated;
their gradients partial sums), or replicated.  The sequence and the state
width they need whole: a placement there is redistributed, and each rank
runs the kernel on its shard.
"""
from __future__ import annotations

import torch

from repro_torch import instrument
from repro_torch.kernels import runtime
from repro_torch.kernels.ref import (affine_scan_reference, mapper_carries_backward_reference,
                                     mapper_carries_reference, selective_scan_bwd, selective_scan_states)
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
# the mapper's two carries, forward and backward
# --------------------------------------------------------------------------- #
#
# The ops take rows [Ra, V] of alloc, [Rb, V] of bw_x and [Rc] of cap, each
# count 1 or R (one row broadcast over all), and return [R, V]; the kernel
# reads the inputs through their strides, so a broadcast row or a strided
# view (alloc is a column of the graph's [..., V, 3] allocations) is no copy.


def _rows(*ts: torch.Tensor) -> int:
    """R, after checking that every count of rows is 1 or R."""
    counts = [t.shape[0] for t in ts]
    R = 0 if 0 in counts else max(counts)
    if any(c not in (1, R) for c in counts):
        raise ValueError(f"mapper_carries: row counts {counts} do not broadcast")
    return R


def _check_carries(alloc, bw_x, cap) -> tuple[int, int]:
    if any(t.dtype != torch.float32 for t in (alloc, bw_x, cap)):
        raise TypeError(f"mapper_carries takes float32, got {alloc.dtype}, {bw_x.dtype}, {cap.dtype}")
    if alloc.ndim != 2 or bw_x.ndim != 2 or cap.ndim != 1 or alloc.shape[1] != bw_x.shape[1]:
        raise ValueError(f"mapper_carries: alloc {tuple(alloc.shape)}, bw_x {tuple(bw_x.shape)}, "
                         f"cap {tuple(cap.shape)} are not [R,V], [R,V], [R]")
    if len({t.device for t in (alloc, bw_x, cap)}) != 1:
        raise ValueError("mapper_carries: all inputs must be on one device")
    return _rows(alloc, bw_x, cap), bw_x.shape[1]


def _strides(t: torch.Tensor, R: int) -> tuple[int, int]:
    """(row, element) strides of [n, V] rows, the row stride 0 where one row serves R."""
    return (t.stride(0) if t.shape[0] == R else 0), t.stride(1)


@torch.library.custom_op("repro_torch::mapper_carries", mutates_args=(), device_types="cpu")
def mapper_carries_op(alloc: torch.Tensor, bw_x: torch.Tensor, cap: torch.Tensor, occ_decay: float,
                      bw_decay: float, bw_gain: float) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(occ_prev, bw_prev, code) [R, V] (plain version, CPU)."""
    R, V = _check_carries(alloc, bw_x, cap)
    return mapper_carries_reference(alloc.expand(R, V), bw_x.expand(R, V), cap.expand(R), occ_decay, bw_decay,
                                    bw_gain)


@mapper_carries_op.register_kernel("cuda")
def _mapper_carries_cuda(alloc: torch.Tensor, bw_x: torch.Tensor, cap: torch.Tensor, occ_decay: float,
                         bw_decay: float, bw_gain: float) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    R, V = _check_carries(alloc, bw_x, cap)
    if not occ_decay >= 0.0:
        raise ValueError(f"mapper_carries: occ_decay {occ_decay} < 0 (min-affine maps compose only for >= 0)")
    occ = torch.empty((R, V), dtype=torch.float32, device=bw_x.device)
    bw = torch.empty_like(occ)
    code = torch.empty((R, V), dtype=torch.uint8, device=bw_x.device)
    if R * V == 0:  # nothing to scan, no launch
        return occ, bw, code
    lib = runtime.library("affine_scan")
    runtime.count_launch("mapper_carries")
    err = lib.mapper_carries_launch(alloc.data_ptr(), *_strides(alloc, R), bw_x.data_ptr(), *_strides(bw_x, R),
                                    cap.data_ptr(), cap.stride(0) if cap.shape[0] == R else 0, occ.data_ptr(),
                                    bw.data_ptr(), code.data_ptr(), R, V, float(occ_decay), float(bw_decay),
                                    float(bw_gain), runtime.stream_handle(bw_x))
    runtime.check_launch("mapper_carries", err)
    return occ, bw, code


@mapper_carries_op.register_fake
def _mapper_carries_fake(alloc, bw_x, cap, occ_decay, bw_decay, bw_gain):
    R, V = _check_carries(alloc, bw_x, cap)
    occ = bw_x.new_empty((R, V))
    return occ, torch.empty_like(occ), occ.new_empty((R, V), dtype=torch.uint8)


def _check_carries_backward(g_occ, g_bw, code) -> tuple[int, int]:
    if g_occ.dtype != torch.float32 or g_bw.dtype != torch.float32 or code.dtype != torch.uint8:
        raise TypeError(f"mapper_carries_backward takes float32 cotangents and a uint8 code, got "
                        f"{g_occ.dtype}, {g_bw.dtype}, {code.dtype}")
    if not (g_occ.ndim == 2 and g_occ.shape == g_bw.shape == code.shape):
        raise ValueError(f"mapper_carries_backward: g_occ {tuple(g_occ.shape)}, g_bw {tuple(g_bw.shape)}, "
                         f"code {tuple(code.shape)} are not all one [R,V]")
    if len({t.device for t in (g_occ, g_bw, code)}) != 1:
        raise ValueError("mapper_carries_backward: all inputs must be on one device")
    return code.shape


@torch.library.custom_op("repro_torch::mapper_carries_backward", mutates_args=(), device_types="cpu")
def mapper_carries_backward_op(g_occ: torch.Tensor, g_bw: torch.Tensor, code: torch.Tensor, occ_decay: float,
                               bw_decay: float, bw_gain: float,
                               need_alloc: bool) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(grad_alloc [R, V] or [0] without ``need_alloc``, grad_bw_x [R, V],
    grad_cap [R]) (plain version, CPU)."""
    _check_carries_backward(g_occ, g_bw, code)
    ga, gb, gc = mapper_carries_backward_reference(g_occ, g_bw, code, occ_decay, bw_decay, bw_gain)
    return (ga if need_alloc else ga.new_empty(0)), gb, gc


@mapper_carries_backward_op.register_kernel("cuda")
def _mapper_carries_backward_cuda(g_occ: torch.Tensor, g_bw: torch.Tensor, code: torch.Tensor, occ_decay: float,
                                  bw_decay: float, bw_gain: float,
                                  need_alloc: bool) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    R, V = _check_carries_backward(g_occ, g_bw, code)
    code = code.contiguous()
    ga = torch.empty((R, V) if need_alloc else (0,), dtype=torch.float32, device=code.device)
    gb = torch.empty((R, V), dtype=torch.float32, device=code.device)
    gc = torch.empty((R,), dtype=torch.float32, device=code.device)
    if R * V == 0:  # nothing to scan, no launch
        return ga, gb, gc.zero_()
    lib = runtime.library("affine_scan")
    runtime.count_launch("mapper_carries_backward")
    err = lib.mapper_carries_backward_launch(g_occ.data_ptr(), *_strides(g_occ, R), g_bw.data_ptr(),
                                             *_strides(g_bw, R), code.data_ptr(),
                                             ga.data_ptr() if need_alloc else None, gb.data_ptr(), gc.data_ptr(),
                                             R, V, float(occ_decay), float(bw_decay), float(bw_gain),
                                             runtime.stream_handle(code))
    runtime.check_launch("mapper_carries_backward", err)
    return ga, gb, gc


@mapper_carries_backward_op.register_fake
def _mapper_carries_backward_fake(g_occ, g_bw, code, occ_decay, bw_decay, bw_gain, need_alloc):
    R, V = _check_carries_backward(g_occ, g_bw, code)
    return g_bw.new_empty((R, V) if need_alloc else (0,)), torch.empty_like(g_bw), g_bw.new_empty((R,))


class _MapperCarries(torch.autograd.Function):
    @staticmethod
    def forward(ctx, alloc: torch.Tensor, bw_x: torch.Tensor, cap: torch.Tensor, decays: tuple):
        lead = torch.broadcast_shapes(alloc.shape[:-1], bw_x.shape[:-1], cap.shape)
        V = bw_x.shape[-1]
        if alloc.shape[-1] != V:
            raise ValueError(f"mapper_carries: alloc {tuple(alloc.shape)} and bw_x {tuple(bw_x.shape)} differ in V")

        def rows(t: torch.Tensor, *v: int) -> torch.Tensor:  # one row, or one a broadcast row
            if t.shape[:t.ndim - len(v)].numel() == 1:
                return t.reshape(1, *v)
            return t.expand(*lead, *v).reshape(lead.numel(), *v)

        occ, bw, code = mapper_carries_op(rows(alloc, V), rows(bw_x, V), rows(cap), *decays)
        ctx.save_for_backward(code)
        ctx.decays, ctx.shapes, ctx.lead = decays, (alloc.shape, bw_x.shape, cap.shape), lead
        return occ.view(*lead, V), bw.view(*lead, V)

    @staticmethod
    def backward(ctx, g_occ: torch.Tensor, g_bw: torch.Tensor):
        (code,) = ctx.saved_tensors
        R, V = code.shape
        need = ctx.needs_input_grad
        ga, gb, gc = mapper_carries_backward_op(g_occ.reshape(R, V), g_bw.reshape(R, V), code, *ctx.decays,
                                                need[0])
        full = (*ctx.lead, V)
        return (ga.view(full).sum_to_size(ctx.shapes[0]) if need[0] else None,
                gb.view(full).sum_to_size(ctx.shapes[1]) if need[1] else None,
                gc.view(ctx.lead).sum_to_size(ctx.shapes[2]) if need[2] else None, None)


def mapper_carries(alloc: torch.Tensor, bw_x: torch.Tensor, cap: torch.Tensor, occ_decay: float,
                   bw_decay: float, bw_gain: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Differentiable (occ_prev, bw_prev): the states before each vertex of
    ``s' = min(occ_decay*s + alloc, cap)`` and ``t' = bw_decay*t + bw_gain*bw_x``
    along the last axis, one launch forward and one backward.  ``alloc`` and
    ``bw_x`` [..., V] and ``cap`` [...] broadcast; both outputs have the
    broadcast shape, and each gradient is summed back to its input's shape."""
    return _MapperCarries.apply(alloc, bw_x, cap, (float(occ_decay), float(bw_decay), float(bw_gain)))


# --------------------------------------------------------------------------- #
# Mamba1 selective scan
# --------------------------------------------------------------------------- #

MAX_STATE = 16  # csrc/selective_scan.cu holds at most 16 states a channel (2 a thread, in 8 warps)
CHUNK = 48  # csrc/selective_scan.cu's kChunk: the entering states are those of its chunks
BACKWARD_SPAN = "selective_scan_backward"  # the backward's instrument.span
BACKWARD_RANGE = instrument.RANGE_PREFIX + BACKWARD_SPAN  # ... and its torch.profiler range


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
    # contiguous, as the kernel's outputs and the fake's are (DTensor views them)
    return tuple(t.contiguous() for t in selective_scan_plain(u, dt, A, Bm, Cm, D))


@selective_scan_op.register_kernel("cuda")
def _selective_scan_cuda(u: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
                         D: torch.Tensor, entering: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel; ``entering`` (the states op's) is None or the
    [Bt, chunks, C, N] float32 buffer of the state entering each chunk."""
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
                                    D.data_ptr(), y.data_ptr(), state.data_ptr(),
                                    None if entering is None else entering.data_ptr(), Bt, S, C, N,
                                    int(u.dtype == torch.bfloat16), runtime.stream_handle(u))
    runtime.check_launch("selective_scan", err)
    return y, state


@selective_scan_op.register_fake
def _selective_scan_fake(u, dt, A, Bm, Cm, D):
    return u.new_empty(u.shape), u.new_empty((u.shape[0], u.shape[2], A.shape[1]), dtype=torch.float32)


def _entering_shape(u: torch.Tensor, A: torch.Tensor) -> tuple[int, ...]:
    return (u.shape[0], -(-u.shape[1] // CHUNK), u.shape[2], A.shape[1])


@torch.library.custom_op("repro_torch::selective_scan_states", mutates_args=(), device_types="cpu")
def selective_scan_states_op(u: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
                             D: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(y, final state, the state entering each ``CHUNK``-step chunk
    [B, chunks, C, N] float32): the plain version (CPU implementation)."""
    _check_selective(u, dt, A, Bm, Cm, D)
    return tuple(t.contiguous() for t in selective_scan_states(u, dt, A, Bm, Cm, D, chunk=CHUNK))


@selective_scan_states_op.register_kernel("cuda")
def _selective_scan_states_cuda(u: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
                                Cm: torch.Tensor, D: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    entering = torch.empty(_entering_shape(u, A), dtype=torch.float32, device=u.device)  # all written
    return (*_selective_scan_cuda(u, dt, A, Bm, Cm, D, entering), entering)


@selective_scan_states_op.register_fake
def _selective_scan_states_fake(u, dt, A, Bm, Cm, D):
    y, state = _selective_scan_fake(u, dt, A, Bm, Cm, D)
    return y, state, u.new_empty(_entering_shape(u, A), dtype=torch.float32)


@torch.library.custom_op("repro_torch::selective_scan_backward", mutates_args=())
def selective_scan_backward_op(u: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
                               Cm: torch.Tensor, D: torch.Tensor, entering: torch.Tensor, g_y: torch.Tensor,
                               g_state: torch.Tensor | None) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                                                      torch.Tensor, torch.Tensor, torch.Tensor]:
    """(du, ddt, dA, dB, dC, dD): ``ref.selective_scan_bwd``, plain PyTorch on every device."""
    with instrument.span(BACKWARD_SPAN, u.device):
        return tuple(g.contiguous() for g in selective_scan_bwd(u, dt, A, Bm, Cm, D, entering, g_y, g_state,
                                                                chunk=CHUNK))


@selective_scan_backward_op.register_fake
def _selective_scan_backward_fake(u, dt, A, Bm, Cm, D, entering, g_y, g_state):
    return tuple(t.new_empty(t.shape) for t in (u, dt, A, Bm, Cm, D))  # contiguous, as the op's are


def _register_sharding() -> None:
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding

    R, S0, S2 = Replicate(), Shard(0), Shard(2)
    ops = torch.ops.repro_torch

    @register_sharding(ops.selective_scan.default)
    def _scan(u, dt, A, Bm, Cm, D):
        return [([R, R], [R] * 6), ([S0, S0], [S0, S0, R, S0, S0, R]), ([S2, Shard(1)], [S2, S2, S0, R, R, S0])]

    @register_sharding(ops.selective_scan_states.default)
    def _states(u, dt, A, Bm, Cm, D):
        return [([R] * 3, [R] * 6), ([S0] * 3, [S0, S0, R, S0, S0, R]),
                ([S2, Shard(1), S2], [S2, S2, S0, R, R, S0])]

    @register_sharding(ops.selective_scan_backward.default)
    def _backward(u, dt, A, Bm, Cm, D, entering, g_y, g_state):
        gs = lambda p: None if g_state is None else p  # noqa: E731
        return [([R] * 6, [R] * 8 + [gs(R)]),
                ([S0, S0, Partial(), S0, S0, Partial()], [S0, S0, R, S0, S0, R, S0, S0, gs(S0)]),
                ([S2, S2, S0, Partial(), Partial(), S0], [S2, S2, S0, R, R, S0, S2, S2, gs(Shard(1))])]


_register_sharding()


class _SelectiveScan(torch.autograd.Function):
    """The scan with the entering states saved; its backward is plain PyTorch
    on the inputs' device (``ref.selective_scan_bwd``)."""

    @staticmethod
    def forward(ctx, u, dt, A, Bm, Cm, D):
        y, state, entering = selective_scan_states_op(u, dt, A, Bm, Cm, D)
        ctx.save_for_backward(u, dt, A, Bm, Cm, D, entering)
        ctx.set_materialize_grads(False)
        return y, state

    @staticmethod
    def backward(ctx, g_y, g_state):
        u, dt, A, Bm, Cm, D, entering = ctx.saved_tensors
        if g_y is None:
            g_y = torch.zeros_like(u)
        grads = selective_scan_backward_op(u, dt, A, Bm, Cm, D, entering, g_y.contiguous(),
                                           None if g_state is None else g_state.contiguous())
        return tuple(g if need else None for g, need in zip(grads, ctx.needs_input_grad))


def selective_scan(u: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
                   D: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """u [B, S, C], dt [B, S, C] (after softplus), A [C, N] (negative), B and C
    [B, S, N], D [C] -> (y [B, S, C] in u's type, final state [B, C, N] float32).
    Differentiable: with gradients on and an input that requires them, the
    launch also writes the states the backward starts from; else it writes
    y and the final state alone."""
    args = tuple(t.contiguous() for t in (u, dt, A, Bm, Cm, D))
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return _SelectiveScan.apply(*args)
    return selective_scan_op(*args)


def selective_scan_operations(Bt: int, S: int, C: int, N: int) -> int:
    """Operations of the recurrence: per (step, channel, state) dt A (1),
    decay*s + (dt u) B (3) and the C . s sum (2); per (step, channel) dt*u and
    u*D + the sum (3).  The exponential of each (step, channel, state) is not
    among them: it is counted apart, against the special-function unit."""
    return Bt * S * C * (6 * N + 3)
