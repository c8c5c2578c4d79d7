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
# max/min and compare counted once (counted by hand from the plain version,
# ref.popsim_reference; a select is not counted, nor an add onto a zero).
# Work that depends on both a candidate and a vertex is needed P*V times: 94
# operations, 19 of them divisions, which take several instructions each, so a
# bound built on this is optimistic.  Of these, the systolic wave model's 14
# (m_t, the waves, the cycles a tile and the class's time) reach the output
# only where the row has systolic work, through the plain version's select, so
# they are needed only on those rows.  The plain version's prefetch gate (a
# division, an add, a compare, a multiply and a max a candidate and vertex),
# its occupancy carry (a multiply, an add and a min) and its capacity (a
# division a candidate) reach no output, since max(can_prefetch, bw_ok) =
# bw_ok: they are not counted.  Work on a graph row alone (the row's activity
# sum and compare, max/ceil of N and K, the per-level read+write sums) is
# needed V times; work on a design alone (the headroom-scaled capacity, the
# effective rate of classes 1-3, the systolic rate's floor, each level's
# read+write latency) P times.
OPS_PER_CANDIDATE_VERTEX = 94
OPS_WAVE_MODEL = 14
OPS_PER_VERTEX = 18
OPS_PER_CANDIDATE = 11


def operations(graph_packed: torch.Tensor, P: int) -> int:
    """Float operations one evaluation of P designs against the packed graph
    needs, counting the wave model only on the rows with systolic work."""
    V = graph_packed.shape[0]
    systolic = int((graph_packed[:, G_COMP.start] > 0).sum())
    per_design = V * (OPS_PER_CANDIDATE_VERTEX - OPS_WAVE_MODEL) + systolic * OPS_WAVE_MODEL
    return P * per_design + V * OPS_PER_VERTEX + P * OPS_PER_CANDIDATE


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
def _popsim_cuda(graph_packed: torch.Tensor, chw_packed: torch.Tensor, lanes: int = 0) -> torch.Tensor:
    # lanes: 0, the launcher's choice; others only through the popsim_lanes test seam
    _check(graph_packed, chw_packed)  # before any pointer reaches the kernel
    g = graph_packed.contiguous()
    c = chw_packed.contiguous()
    V, P = g.shape[0], c.shape[0]
    out = torch.empty((P, OUT_COLS), dtype=torch.float32, device=c.device)
    if P == 0:  # no candidate, no launch
        return out
    lib = runtime.library("popsim")
    runtime.count_launch("popsim")
    err = lib.popsim_launch(g.data_ptr(), c.data_ptr(), out.data_ptr(), V, P, lanes, runtime.stream_handle(c))
    runtime.check_launch("popsim", err)
    return out


# the kernel's instances: lanes a design, one vertex each a step
LANES = (2, 4, 8, 16, 32)


def popsim_lanes(graph_packed: torch.Tensor, chw_packed: torch.Tensor, lanes: int) -> torch.Tensor:
    """A test seam, not a user option: the kernel with ``lanes`` lanes a
    design (one of ``LANES``) in place of the launcher's choice, on CUDA
    tensors, so that the tests and the timing tool reach every instance."""
    if graph_packed.device.type != "cuda" or lanes not in LANES:
        raise ValueError(f"popsim_lanes takes CUDA tensors and lanes in {LANES}, got "
                         f"{graph_packed.device} and {lanes}")
    return _popsim_cuda(graph_packed, chw_packed, lanes)


@popsim_op.register_fake
def _popsim_fake(graph_packed: torch.Tensor, chw_packed: torch.Tensor) -> torch.Tensor:
    return chw_packed.new_empty((chw_packed.shape[0], OUT_COLS))


def popsim(graph_packed: torch.Tensor, chw_packed: torch.Tensor) -> torch.Tensor:
    """Evaluate P candidate designs against one DFG.  Returns [P, OUT_COLS].

    This is the torch op ``torch.ops.repro_torch.popsim``: on CUDA tensors it
    launches the kernel (128-thread blocks; each design's vertices spread over
    2 to 32 lanes, the most with which the grid fits on the card at once; a
    ragged last block is masked), on CPU tensors it runs the plain version."""
    return popsim_op(graph_packed, chw_packed)
