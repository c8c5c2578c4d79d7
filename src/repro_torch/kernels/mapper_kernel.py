"""The DSim mapper's carry-free stages around K1 as two hand-written CUDA
kernels (``csrc/mapper.cu``), for calls that need no gradient.

``core/mapper.py``'s prefix-scan path is per-vertex intrinsics, the two
Alg.-7 carries (K1, ``sscan.mapper_carries``), then gates, exposed time,
cycles and the reductions over V.  Eager PyTorch runs the first and last as
~100 full-size [R, V] elementwise passes; here they are one launch each:

* :func:`mapper_intrinsics_op` writes only K1's input ``bw_x`` [R, V];
* :func:`mapper_finish_op` recomputes the same terms, takes K1's carries and
  returns the MapState fields that depend on them: planar [5, R] (``SUMS``)
  and bw_util [R, 3].

Row r is design ``r // span`` of the packed designs [Hn, DESIGN_COLS] against
graph row ``r % Gn`` of the packed graph [Gn, V, GRAPH_COLS].  The mapper
(``core.mapper.fused``) decides from a call's inputs whether the kernels
apply, packs them, and registers the ops' plain versions for the CPU: its own
torch stages on the rows of the packed arrays.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import runtime

# packed graph columns: n_comp[4], n_read[3], n_write[3], n_alloc[3], dims[3]
GRAPH_COLS = 16
# packed design columns: frequency, capacity[globalBuf], mem_bw[3], read +
# write latency[3], flops_per_cycle[4], sys_x, sys_y
DESIGN_COLS = 14
SUMS = ("cycles", "t_comp", "t_mem", "t_exposed_main", "n_tiles")  # the rows of the finish op's planar output


# --------------------------------------------------------------------------- #
# the ops
# --------------------------------------------------------------------------- #


def check(graph: torch.Tensor, designs: torch.Tensor, span: int, *rv: torch.Tensor) -> tuple[int, int, int]:
    """(R, V, Gn) after checking dtypes, shapes and devices."""
    if any(t.dtype != torch.float32 for t in (graph, designs, *rv)):
        raise TypeError("mapper kernels take float32 arrays")
    if graph.ndim != 3 or graph.shape[2] != GRAPH_COLS or designs.ndim != 2 or designs.shape[1] != DESIGN_COLS:
        raise ValueError(f"mapper kernels: graph {tuple(graph.shape)}, designs {tuple(designs.shape)} are not "
                         f"[Gn, V, {GRAPH_COLS}], [Hn, {DESIGN_COLS}]")
    Gn, V, _ = graph.shape
    R = designs.shape[0] * span
    if span < 1 or Gn < 1 or R % Gn:
        raise ValueError(f"mapper kernels: {designs.shape[0]} designs spanning {span} rows each do not cover "
                         f"{Gn} graph rows")
    if any(tuple(t.shape) != (R, V) for t in rv):
        raise ValueError(f"mapper_finish: carries {[tuple(t.shape) for t in rv]} are not [{R}, {V}]")
    if len({t.device for t in (graph, designs, *rv)}) != 1:
        raise ValueError("mapper kernels: all inputs must be on one device")
    return R, V, Gn


@torch.library.custom_op("repro_torch::mapper_intrinsics", mutates_args=(), device_types="cuda")
def mapper_intrinsics_op(graph: torch.Tensor, designs: torch.Tensor, span: int, headroom: float) -> torch.Tensor:
    """bw_x [R, V], K1's input.  Plain version (CPU): ``core.mapper``'s
    ``_vertex_intrinsics`` on the packed rows."""
    R, V, Gn = check(graph, designs, span)
    graph, designs = graph.contiguous(), designs.contiguous()
    bw_x = torch.empty((R, V), dtype=torch.float32, device=graph.device)
    lib = runtime.library("mapper")
    runtime.count_launch("mapper_intrinsics")
    err = lib.mapper_intrinsics_launch(graph.data_ptr(), designs.data_ptr(), bw_x.data_ptr(), R, V, span, Gn,
                                       float(headroom), runtime.stream_handle(graph))
    runtime.check_launch("mapper_intrinsics", err)
    return bw_x


@mapper_intrinsics_op.register_fake
def _mapper_intrinsics_fake(graph, designs, span, headroom):
    R, V, _ = check(graph, designs, span)
    return graph.new_empty((R, V))


@torch.library.custom_op("repro_torch::mapper_finish", mutates_args=(), device_types="cuda")
def mapper_finish_op(graph: torch.Tensor, designs: torch.Tensor, occ_prev: torch.Tensor, bw_prev: torch.Tensor,
                     span: int, headroom: float, prefetch: bool,
                     streaming: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """(sums [5, R] in ``SUMS`` order, bw_util [R, 3]) from K1's carries
    [R, V].  Plain version (CPU): ``core.mapper``'s ``_vertex_finish`` on the
    packed rows."""
    R, V, Gn = check(graph, designs, span, occ_prev, bw_prev)
    graph, designs = graph.contiguous(), designs.contiguous()
    occ_prev, bw_prev = occ_prev.contiguous(), bw_prev.contiguous()
    sums = torch.empty((len(SUMS), R), dtype=torch.float32, device=graph.device)
    bw_util = torch.empty((R, 3), dtype=torch.float32, device=graph.device)
    lib = runtime.library("mapper")
    runtime.count_launch("mapper_finish")
    err = lib.mapper_finish_launch(graph.data_ptr(), designs.data_ptr(), occ_prev.data_ptr(), bw_prev.data_ptr(),
                                   sums.data_ptr(), bw_util.data_ptr(), R, V, span, Gn, float(headroom),
                                   int(prefetch), int(streaming), runtime.stream_handle(graph))
    runtime.check_launch("mapper_finish", err)
    return sums, bw_util


@mapper_finish_op.register_fake
def _mapper_finish_fake(graph, designs, occ_prev, bw_prev, span, headroom, prefetch, streaming):
    R, _, _ = check(graph, designs, span, occ_prev, bw_prev)
    return graph.new_empty((len(SUMS), R)), graph.new_empty((R, 3))
