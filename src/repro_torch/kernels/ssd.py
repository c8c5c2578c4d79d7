"""The Mamba2 chunked SSD scan as hand-written CUDA kernels (``csrc/ssd.cu``).

The op ``torch.ops.repro_torch.ssd_chunk_scan`` launches the kernels on CUDA
tensors and runs the plain version, ``ref.ssd_scan``, on CPU tensors.  Both
return the output and the final state, and both run in three phases: each
chunk's own state contribution, a pass that carries the state across the
chunks, and each chunk's output.  One op call launches three device kernels
(one when S = 0) and counts as one launch.  The chunk length is the kernel's
own (``CHUNK``): the chunked form is exact for any chunk, and a ragged last
chunk is masked, so any sequence length works.

With gradients on, :func:`ssd_chunk_scan` keeps the state entering each
chunk, which the kernels leave in their scratch (the plain version returns
it too), and its backward (``ref.ssd_scan_bwd``, plain PyTorch on the inputs'
device) starts from them; it is an op of its own,
``repro_torch::ssd_chunk_scan_backward``.

On DTensors the three ops have sharding rules: everything split over batch,
or over heads (A with them, B and C replicated; their gradients partial
sums), or replicated.  The sequence, P and N they need whole: a placement
there is redistributed, and each rank runs the kernels on its shard.
"""
from __future__ import annotations

import torch

from repro_torch import instrument
from repro_torch.kernels import runtime
from repro_torch.kernels.ref import ssd_scan, ssd_scan_bwd, ssd_scan_phases

CHUNK = 64  # csrc/ssd.cu's kChunk
TILE = 64  # csrc/ssd.cu's kTile: the scratch states pad N and P to a multiple of it
MAX_WIDTH = 128  # N and P the kernel's shared memory holds
MOST_HEADS = 4  # heads a block of the outputs kernel takes at most
# blocks of the outputs kernel the H100 holds at once at N = P = 64: its shared
# memory (~70 KB) and registers (165 a thread in bf16) allow 3 on each of 132 SMs
RESIDENT_BLOCKS = 3 * 132
BACKWARD_SPAN = "ssd_chunk_scan_backward"  # the backward's instrument.span
BACKWARD_RANGE = instrument.RANGE_PREFIX + BACKWARD_SPAN  # ... and its torch.profiler range


def _padded(n: int) -> int:
    return -(-n // TILE) * TILE


def heads_per_block(Bt: int, S: int, H: int) -> int:
    """Heads a block of the outputs kernel takes (1, 2 or 4; they share the
    chunk's B and C tiles and C B^T): the one whose grid should finish first,
    by waves of blocks (the grid over ``RESIDENT_BLOCKS``) times a block's
    work (a head's products each, and C B^T, about half a head's)."""
    def cost(hpb: int) -> float:
        blocks = Bt * -(-S // CHUNK) * -(-H // hpb)
        return -(-blocks // RESIDENT_BLOCKS) * (hpb + 0.5)

    return min((MOST_HEADS, 2, 1), key=cost)


def scratch_numel(Bt: int, S: int, H: int, P: int, N: int) -> int:
    """float32 elements of the kernels' scratch: the [N, P] state of each
    (batch, chunk, head), N and P padded to ``TILE``, then each one's decay."""
    return Bt * -(-S // CHUNK) * H * (_padded(N) * _padded(P) + 1)


def chunk_states(scratch: torch.Tensor, Bt: int, S: int, H: int, P: int, N: int) -> torch.Tensor:
    """The state entering each chunk, [Bt, chunks, H, N, P], as a view of a
    launch's scratch (``scratch_for``) after the kernels ran."""
    NP, PP = _padded(N), _padded(P)
    nc = -(-S // CHUNK)
    return scratch[:Bt * nc * H * NP * PP].view(Bt, nc, H, NP, PP)[..., :N, :P]


def _check(x, dt, A, Bm, Cm) -> None:
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"ssd_chunk_scan takes float32 or bfloat16 x, got {x.dtype}")
    if any(t.dtype != torch.float32 for t in (dt, A, Bm, Cm)):
        raise TypeError("ssd_chunk_scan takes float32 dt, A, B and C")
    if x.ndim != 4:
        raise ValueError(f"ssd_chunk_scan takes x [B,S,H,P], got {tuple(x.shape)}")
    Bt, S, H, _ = x.shape
    if (tuple(dt.shape) != (Bt, S, H) or tuple(A.shape) != (H,) or Bm.ndim != 3
            or tuple(Bm.shape[:2]) != (Bt, S) or Cm.shape != Bm.shape):
        raise ValueError(f"ssd_chunk_scan: dt {tuple(dt.shape)}, A {tuple(A.shape)}, B {tuple(Bm.shape)}, "
                         f"C {tuple(Cm.shape)} do not fit x {tuple(x.shape)}")
    if len({t.device for t in (x, dt, A, Bm, Cm)}) != 1:
        raise ValueError("ssd_chunk_scan: all inputs must be on one device")


@torch.library.custom_op("repro_torch::ssd_chunk_scan", mutates_args=(), device_types="cpu")
def ssd_chunk_scan_op(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
                      Cm: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version (CPU implementation of the op)."""
    _check(x, dt, A, Bm, Cm)
    # contiguous, as the kernels' outputs and the fake's are (DTensor views them)
    return tuple(t.contiguous() for t in ssd_scan(x, dt, A, Bm, Cm, chunk=CHUNK))


def scratch_for(x: torch.Tensor, Bt: int, S: int, H: int, P: int, N: int) -> torch.Tensor:
    """The kernels' scratch on ``x``'s device (uninitialised)."""
    return torch.empty(scratch_numel(Bt, S, H, P, N), dtype=torch.float32, device=x.device)


@ssd_chunk_scan_op.register_kernel("cuda")
def _ssd_chunk_scan_cuda(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
                         keep_states: bool = False) -> tuple[torch.Tensor, ...]:
    """Launch the kernels: (y, final state), and with ``keep_states`` (the
    states op's) the state entering each chunk [Bt, chunks, H, N, P]."""
    _check(x, dt, A, Bm, Cm)
    if not all(t.is_contiguous() for t in (x, dt, A, Bm, Cm)):
        raise ValueError("ssd_chunk_scan: inputs must be contiguous")
    Bt, S, H, P = x.shape
    N = Bm.shape[-1]
    if not (0 < P <= MAX_WIDTH and 0 < N <= MAX_WIDTH):
        raise ValueError(f"ssd_chunk_scan: P={P}, N={N} must lie in 1..{MAX_WIDTH}")
    y = torch.empty_like(x)
    state = torch.empty((Bt, H, N, P), dtype=torch.float32, device=x.device)
    if Bt * H == 0:  # no (batch, head) to scan, no launch
        return (y, state, x.new_zeros(_entering_shape(x, Bm), dtype=torch.float32)) if keep_states else (y, state)
    scratch = scratch_for(x, Bt, S, H, P, N)
    lib = runtime.library("ssd_chunk_scan")
    runtime.count_launch("ssd_chunk_scan")
    err = lib.ssd_chunk_scan_launch(x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
                                    y.data_ptr(), state.data_ptr(), scratch.data_ptr(), Bt, S, H, P, N,
                                    int(x.dtype == torch.bfloat16), heads_per_block(Bt, S, H),
                                    runtime.stream_handle(x))
    runtime.check_launch("ssd_chunk_scan", err)
    if not keep_states:
        return y, state
    # the scratch's states: a view where N and P fill its tiles, else a copy
    entering = chunk_states(scratch, Bt, S, H, P, N)
    return y, state, entering if entering.is_contiguous() else entering.contiguous()


@ssd_chunk_scan_op.register_fake
def _ssd_chunk_scan_fake(x, dt, A, Bm, Cm):
    Bt, _, H, P = x.shape
    return x.new_empty(x.shape), x.new_empty((Bt, H, Bm.shape[-1], P), dtype=torch.float32)


def _entering_shape(x: torch.Tensor, Bm: torch.Tensor) -> tuple[int, ...]:
    Bt, S, H, P = x.shape
    return (Bt, -(-S // CHUNK), H, Bm.shape[-1], P)


@torch.library.custom_op("repro_torch::ssd_chunk_scan_states", mutates_args=(), device_types="cpu")
def ssd_chunk_scan_states_op(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
                             Cm: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(y, final state, the state entering each chunk [B, chunks, H, N, P]
    float32): the plain version (CPU implementation)."""
    _check(x, dt, A, Bm, Cm)
    return tuple(t.contiguous() for t in ssd_scan_phases(x, dt, A, Bm, Cm, chunk=CHUNK))


@ssd_chunk_scan_states_op.register_kernel("cuda")
def _ssd_chunk_scan_states_cuda(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
                                Cm: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    return _ssd_chunk_scan_cuda(x, dt, A, Bm, Cm, keep_states=True)


@ssd_chunk_scan_states_op.register_fake
def _ssd_chunk_scan_states_fake(x, dt, A, Bm, Cm):
    y, state = _ssd_chunk_scan_fake(x, dt, A, Bm, Cm)
    return y, state, x.new_empty(_entering_shape(x, Bm), dtype=torch.float32)


@torch.library.custom_op("repro_torch::ssd_chunk_scan_backward", mutates_args=())
def ssd_chunk_scan_backward_op(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
                               Cm: torch.Tensor, entering: torch.Tensor, g_y: torch.Tensor,
                               g_state: torch.Tensor | None) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                                                      torch.Tensor, torch.Tensor]:
    """(dx, ddt, dA, dB, dC): ``ref.ssd_scan_bwd``, plain PyTorch on every device."""
    with instrument.span(BACKWARD_SPAN, x.device):
        return tuple(g.contiguous() for g in ssd_scan_bwd(x, dt, A, Bm, Cm, entering, g_y, g_state, chunk=CHUNK))


@ssd_chunk_scan_backward_op.register_fake
def _ssd_chunk_scan_backward_fake(x, dt, A, Bm, Cm, entering, g_y, g_state):
    return tuple(t.new_empty(t.shape) for t in (x, dt, A, Bm, Cm))  # contiguous, as the op's are


def _register_sharding() -> None:
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding

    R, S0 = Replicate(), Shard(0)
    ops = torch.ops.repro_torch

    @register_sharding(ops.ssd_chunk_scan.default)
    def _scan(x, dt, A, Bm, Cm):
        return [([R, R], [R] * 5), ([S0, S0], [S0, S0, R, S0, S0]),
                ([Shard(2), Shard(1)], [Shard(2), Shard(2), S0, R, R])]

    @register_sharding(ops.ssd_chunk_scan_states.default)
    def _states(x, dt, A, Bm, Cm):
        return [([R] * 3, [R] * 5), ([S0] * 3, [S0, S0, R, S0, S0]),
                ([Shard(2), Shard(1), Shard(2)], [Shard(2), Shard(2), S0, R, R])]

    @register_sharding(ops.ssd_chunk_scan_backward.default)
    def _backward(x, dt, A, Bm, Cm, entering, g_y, g_state):
        gs = lambda p: None if g_state is None else p  # noqa: E731
        return [([R] * 5, [R] * 7 + [gs(R)]),
                ([S0, S0, Partial(), S0, S0], [S0, S0, R, S0, S0, S0, S0, gs(S0)]),
                ([Shard(2), Shard(2), S0, Partial(), Partial()],
                 [Shard(2), Shard(2), S0, R, R, Shard(2), Shard(2), gs(Shard(1))])]


_register_sharding()


class _SSDChunkScan(torch.autograd.Function):
    """The scan with the entering states saved; its backward is plain PyTorch
    on the inputs' device (``ref.ssd_scan_bwd``)."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm):
        y, state, entering = ssd_chunk_scan_states_op(x, dt, A, Bm, Cm)
        ctx.save_for_backward(x, dt, A, Bm, Cm, entering)
        ctx.set_materialize_grads(False)
        return y, state

    @staticmethod
    def backward(ctx, g_y, g_state):
        x, dt, A, Bm, Cm, entering = ctx.saved_tensors
        if g_y is None:
            g_y = torch.zeros_like(x)
        grads = ssd_chunk_scan_backward_op(x, dt, A, Bm, Cm, entering, g_y.contiguous(),
                                           None if g_state is None else g_state.contiguous())
        return tuple(g if need else None for g, need in zip(grads, ctx.needs_input_grad))


def ssd_chunk_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
                   Cm: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x [B, S, H, P], dt [B, S, H] (after softplus), A [H] (negative), B and C
    [B, S, N] -> (y [B, S, H, P] in x's type, final state [B, H, N, P] float32).
    Differentiable: with gradients on and an input that requires them, the
    entering states stay for the backward; else the scratch is freed."""
    args = tuple(t.contiguous() for t in (x, dt, A, Bm, Cm))
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return _SSDChunkScan.apply(*args)
    return ssd_chunk_scan_op(*args)


def operations(Bt: int, S: int, H: int, P: int, N: int) -> int:
    """Operations of the recurrence (not of the chunked form's redundant
    products): per step and head, dt A (1), dt*x (P), the state update
    decay*s + (dt x) B (3 N P) and y = C . s (2 N P).  The exponential of each
    step and head is counted apart, against the special-function unit."""
    return Bt * S * H * (1 + P + 5 * N * P)
