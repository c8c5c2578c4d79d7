"""Population simulation — DSim's forward pass for P candidate designs
against one workload DFG, as a hand-written CUDA kernel (``csrc/popsim.cu``).

Packed layouts (see ops.pack_chw / ops.pack_graph):
  chw   [P, 27]: freq, cap_gbuf, bw[3], rlat[3], wlat[3], re_pb[3], we_pb[3],
                 e_flop[4], rate[4] (FLOP/cycle), sys_x, sys_y
                 (= CHW_COLS = 27; column slices below are the ground truth)
  graph [V, 16]: n_comp[4], n_read[3], n_write[3], n_alloc_gbuf, main_alloc,
                 dims[3], pad  (= GRAPH_COLS = 16)
Output [P, 8]: cycles, e_dyn, t_comp, t_mem, t_exposed, tiles, pad, pad.

The plain version is ``ref.popsim_reference``: a loop over the vertices,
vectorised over candidates, with the kernel's operation order.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import runtime

# chw packed column indices
FREQ, CAP_GBUF = 0, 1
BW = slice(2, 5)
RLAT = slice(5, 8)
WLAT = slice(8, 11)
RE_PB = slice(11, 14)
WE_PB = slice(14, 17)
E_FLOP = slice(17, 21)
RATE = slice(21, 25)
SYS_X, SYS_Y = 25, 26
CHW_COLS = 27

# graph packed column indices
G_COMP = slice(0, 4)
G_READ = slice(4, 7)
G_WRITE = slice(7, 10)
G_ALLOC_GBUF = 10
G_MAIN_PRESENT = 11
G_DIMS = slice(12, 15)
GRAPH_COLS = 16

# layout consistency: the column map must tile the declared widths exactly
assert RATE.stop == SYS_X and SYS_Y == CHW_COLS - 1, "chw column map out of sync"
assert G_DIMS.stop < GRAPH_COLS, "graph column map out of sync"

OUT_COLS = 8
_LOCAL, _GBUF, _MAIN = 0, 1, 2
_SYS = 0
HEADROOM = 0.9

# The float operations the function needs, each add, multiply, division, ceil,
# max/min and compare counted once (counted by hand from csrc/popsim.cu).
# Work that depends on both a candidate and a vertex is needed P*V times; work
# on a graph row alone (the row's activity sum and compare, max/ceil of N and
# K, the per-level read+write sums) V times; work on a design alone (the
# headroom-scaled capacity, each class's effective rate, each level's
# read+write latency) P times.  Twenty of the P*V operations are divisions,
# which take several instructions each, so a bound built on this is optimistic.
OPS_PER_CANDIDATE_VERTEX = 102
OPS_PER_VERTEX = 18
OPS_PER_CANDIDATE = 12


def operations(V: int, P: int) -> int:
    """Float operations one evaluation of P designs against V vertices needs."""
    return P * V * OPS_PER_CANDIDATE_VERTEX + V * OPS_PER_VERTEX + P * OPS_PER_CANDIDATE


def _check(graph_packed: torch.Tensor, chw_packed: torch.Tensor) -> None:
    if graph_packed.dtype != torch.float32 or chw_packed.dtype != torch.float32:
        raise TypeError("popsim takes float32 packed arrays")
    if graph_packed.ndim != 2 or graph_packed.shape[1] != GRAPH_COLS:
        raise ValueError(f"graph_packed must be [V, {GRAPH_COLS}], got {tuple(graph_packed.shape)}")
    if chw_packed.ndim != 2 or chw_packed.shape[1] != CHW_COLS:
        raise ValueError(f"chw_packed must be [P, {CHW_COLS}], got {tuple(chw_packed.shape)}")
    if graph_packed.device != chw_packed.device:
        raise ValueError("popsim: graph and designs must be on one device")


@torch.library.custom_op("repro_torch::popsim", mutates_args=(), device_types="cpu")
def popsim_op(graph_packed: torch.Tensor, chw_packed: torch.Tensor) -> torch.Tensor:
    """The plain version (CPU implementation of the op)."""
    from repro_torch.kernels.ref import popsim_reference

    _check(graph_packed, chw_packed)
    return popsim_reference(graph_packed, chw_packed)


@popsim_op.register_kernel("cuda")
def _popsim_cuda(graph_packed: torch.Tensor, chw_packed: torch.Tensor) -> torch.Tensor:
    _check(graph_packed, chw_packed)  # before any pointer reaches the kernel
    g = graph_packed.contiguous()
    c = chw_packed.contiguous()
    V, P = g.shape[0], c.shape[0]
    out = torch.empty((P, OUT_COLS), dtype=torch.float32, device=c.device)
    if P == 0:  # no candidate, no launch
        return out
    lib = runtime.library("popsim")
    runtime.count_launch("popsim")
    err = lib.popsim_launch(g.data_ptr(), c.data_ptr(), out.data_ptr(), V, P, runtime.stream_handle(c))
    runtime.check_launch("popsim", err)
    return out


@popsim_op.register_fake
def _popsim_fake(graph_packed: torch.Tensor, chw_packed: torch.Tensor) -> torch.Tensor:
    return chw_packed.new_empty((chw_packed.shape[0], OUT_COLS))


def popsim(graph_packed: torch.Tensor, chw_packed: torch.Tensor) -> torch.Tensor:
    """Evaluate P candidate designs against one DFG.  Returns [P, OUT_COLS].

    This is the torch op ``torch.ops.repro_torch.popsim``: on CUDA tensors it
    launches the kernel (128 threads, one per candidate, per block; a ragged
    last block is masked), on CPU tensors it runs the plain version."""
    return popsim_op(graph_packed, chw_packed)
