"""The differentiable mapper (paper §5.2, Algorithms 1/2/7).

Maps a workload DFG onto a concrete hardware model CH and produces cycle
counts plus the memory/compute state the energy model consumes.

  * MAPVERTEX's vertex *splitting* when the working set exceeds memory
    capacity becomes continuous tiling, ``n_tiles = ceil(alloc / 0.9*cap)``
    with a straight-through ceil: the forward value is the discrete split
    count, the backward pass sees a smooth surrogate.
  * Alg. 7's prefetch & streaming decisions become hard gates forward with
    sigmoid surrogate gradients.
  * ``t = max(t_mem, t_comp)``: the subgradient of max flows only through
    the critical term (zero gradient when latency is entirely hidden).

Everything the mapper computes per vertex is elementwise except the two
inter-vertex carries Alg. 7 threads through the topological order:

  * decaying buffer occupancy   ``o' = min(0.5*o + alloc, capacity)``
  * bandwidth-utilization EMA   ``b' = 0.8*b + 0.2*x``

Both are first-order (min-)affine recurrences whose inputs depend only on
the vertex, so the mapper is: per-vertex intrinsics elementwise, the two
carries as prefix scans, gates/exposed time/cycles elementwise, reduce.

The graph's arrays carry explicit leading batch axes ([W, V, ...] for a
``Graph.stack``); the ConcreteHW fields may carry the same leading axes or
none.  Reductions run over the vertex axis.

``MapperCfg.scan_impl`` selects the implementation:

  * ``"auto"``   (default) — ``"assoc"`` for graphs with >= 32 vertices,
    else the sequential ``"ref"``;
  * ``"assoc"``  — the prefix-scan formulation above.  Both carries go
    through one call of ``kernels.sscan.mapper_carries`` (K1): on a CUDA
    tensor one kernel launch forward and one for the closed-form backward,
    on a CPU tensor their plain doubling scans.  Where the call needs no
    gradient and its CUDA float32 inputs have a layout the kernels index
    (:func:`fused`), the intrinsics and the gates and reductions around K1
    are one kernel launch each as well (``csrc/mapper.cu``); otherwise they
    are the torch stages below;
  * ``"pallas"`` — the reference package's name for the kernel dispatch;
    here it is the same computation as ``"assoc"``;
  * ``"ref"``    — the sequential loop over vertices with the whole vertex
    computation inlined, kept as the independent semantic oracle.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch import instrument
from repro_torch.core.dgen import ConcreteHW
from repro_torch.core.graph import Graph
from repro_torch.core.params import COMP_IDX, MEM_IDX, TensorTree, const, max_const
from repro_torch.kernels import mapper_kernel
from repro_torch.kernels.ref import affine_scan_reference, minaffine_scan_reference
from repro_torch.kernels.sscan import mapper_carries

_GBUF = MEM_IDX["globalBuf"]
_MAIN = MEM_IDX["mainMem"]
_LOCAL = MEM_IDX["localMem"]
_SYS = COMP_IDX["systolicArray"]

_OCC_DECAY = 0.5  # buffer-residency decay per vertex (Alg. 7 carry)
_BW_DECAY = 0.8  # bandwidth-EMA decay per vertex
_BW_GAIN = 0.2  # weight of the vertex's own utilization in the EMA
_ASSOC_MIN_V = 32  # "auto": below this the sequential scan is used


def _clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    return torch.minimum(max_const(x, lo), const(x, hi))


# --------------------------------------------------------------------------- #
# straight-through helpers
# --------------------------------------------------------------------------- #


def ste(hard: torch.Tensor, soft: torch.Tensor) -> torch.Tensor:
    """Forward = hard (exact discrete semantics); backward = d soft."""
    return soft + (hard - soft).detach()


def ceil_ste(x: torch.Tensor) -> torch.Tensor:
    return ste(torch.ceil(x), x)


def gate_below_ste(x: torch.Tensor, thresh, tau: float = 0.1) -> torch.Tensor:
    """1.0 when x < thresh (hard forward), sigmoid surrogate backward."""
    if not torch.is_tensor(thresh):
        thresh = const(x, thresh)
    hard = (x < thresh).to(torch.float32)
    soft = torch.sigmoid((thresh - x) / (tau * torch.abs(thresh) + 1e-30))
    return ste(hard, soft)


# --------------------------------------------------------------------------- #
# Mapper config + state
# --------------------------------------------------------------------------- #


@dataclass(frozen=True)
class MapperCfg:
    headroom: float = 0.9  # paper Alg. 7 thresholds
    prefetch: bool = True
    streaming: bool = True
    merge_threshold: float = 0.0  # compute-merge pass threshold (FLOPs)
    scan_impl: str = "auto"  # auto | assoc | ref | pallas (see module docstring)


@dataclass
class MapState(TensorTree):
    """paper ⟨z, ms, cs⟩: cycle count + memory state + compute state."""

    cycles: torch.Tensor
    reads: torch.Tensor  # [N_MEM] total bytes read
    writes: torch.Tensor  # [N_MEM] total bytes written
    comp_ops: torch.Tensor  # [N_COMP] total FLOPs issued
    peak_alloc: torch.Tensor  # [N_MEM] peak working set
    t_comp: torch.Tensor  # total compute-critical seconds (diagnostic)
    t_mem: torch.Tensor  # total memory-critical seconds (diagnostic)
    t_exposed_main: torch.Tensor  # main-memory time not hidden by prefetch
    bw_util: torch.Tensor  # [N_MEM] average bandwidth utilization
    n_tiles: torch.Tensor  # total vertex splits (diagnostic)


def _hw(chw: ConcreteHW) -> dict:
    """The ConcreteHW fields the mapper reads, shaped to broadcast against
    per-vertex arrays [..., V] (scalars) and [..., V, k] (vectors)."""
    return dict(
        freq=chw.frequency[..., None],
        cap=chw.capacity[..., _GBUF, None],
        bw=chw.mem_bw[..., None, :],
        lat=(chw.read_latency + chw.write_latency)[..., None, :],
        fpc=chw.flops_per_cycle[..., None, :],
        sys_x=chw.sys_x[..., None],
        sys_y=chw.sys_y[..., None],
    )


# --------------------------------------------------------------------------- #
# per-vertex intrinsics (carry-independent, [..., V]-vectorized)
# --------------------------------------------------------------------------- #


def _vertex_intrinsics(h: dict, g: Graph, cfg: MapperCfg) -> dict:
    """Everything MAPVERTEX computes that does not depend on the carry, from
    the design's fields as ``_hw`` gives them."""
    freq = h["freq"]
    cap_gbuf = h["cap"] * cfg.headroom
    bw = h["bw"]  # [..., 1, N_MEM] bytes/s

    alloc_gbuf = g.n_alloc[..., _GBUF]
    # ---------------- tiling (MAPVERTEX split, lines 20-23) -----------------
    tiles = max_const(ceil_ste(alloc_gbuf / cap_gbuf), 1.0)

    # ---------------- compute time per class --------------------------------
    # systolic array: discrete wave model; each (sys_x x sys_y) output tile
    # streams K MACs + a fill/drain bubble of sx+sy cycles
    M, N, K = g.dims[..., 0], g.dims[..., 1], g.dims[..., 2]
    m_t = max_const(M / tiles, 1.0)
    waves_m = ceil_ste(m_t / h["sys_x"])
    waves_n = ceil_ste(max_const(N, 1.0) / h["sys_y"])
    k_cycles = ceil_ste(max_const(K, 1.0))
    fill = h["sys_x"] + h["sys_y"]
    cyc_sys_tile = waves_m * waves_n * (k_cycles + fill)
    ops_sys_tile = g.n_comp[..., _SYS] / tiles
    cyc_sys_tile = torch.maximum(cyc_sys_tile, ops_sys_tile / max_const(h["fpc"][..., _SYS], 1e-9))
    t_sys = torch.where(ops_sys_tile > 0, tiles * cyc_sys_tile / freq, 0.0)
    # other classes: rate model
    eff_rate = max_const(h["fpc"], 1e-9) * freq[..., None]  # [..., 1, N_COMP] FLOP/s
    t_comp_cls = g.n_comp / eff_rate
    t_other = torch.cat([torch.zeros_like(t_comp_cls[..., :1]), t_comp_cls[..., 1:]], -1)
    t_comp = torch.maximum(torch.amax(t_other, -1), t_sys)

    # ---------------- memory time per level ---------------------------------
    # burst-quantized transfers with the average bank-conflict factor of the
    # reference walker + per-tile access latency
    conflict = 1.04
    t_lvl = (g.n_read + g.n_write) / bw * conflict  # [..., V, N_MEM]
    t_tile_lat = tiles[..., None] * h["lat"]
    t_onchip = torch.maximum(t_lvl[..., _GBUF] + t_tile_lat[..., _GBUF], t_lvl[..., _LOCAL])
    t_main = t_lvl[..., _MAIN] + t_tile_lat[..., _MAIN] * (g.n_alloc[..., _MAIN] > 0)
    t_core = torch.maximum(t_comp, t_onchip)

    # ---------------- demanded bandwidth utilization (EMA input) ------------
    # the no-overlap vertex time: what Alg. 7 inspects when deciding whether
    # bandwidth headroom exists — independent of the gate it feeds, so the
    # EMA is a pure affine recurrence
    t_full = tiles * ceil_ste((t_core + t_main) * freq / max_const(tiles, 1.0)) / freq
    bytes_gbuf = g.n_read[..., _GBUF] + g.n_write[..., _GBUF]
    used_bw = torch.where(t_full > 0, bytes_gbuf / max_const(t_full, 1e-30) / bw[..., _GBUF], 0.0)
    bw_x = _clip(used_bw, 0.0, 2.0)

    # no-op (padding) vertices cost nothing — this is what makes
    # Graph.stack()'s pad_to exactly free in the batched-workload path
    active = (
        torch.sum(g.n_comp, -1) + torch.sum(g.n_read, -1) + torch.sum(g.n_write, -1)
        + torch.sum(g.n_alloc, -1)
    ) > 0

    return dict(
        tiles=tiles,
        alloc_gbuf=alloc_gbuf,
        t_comp=t_comp,
        t_onchip=t_onchip,
        t_main=t_main,
        t_core=t_core,
        t_lvl=t_lvl,
        used_bw=used_bw,
        bw_x=bw_x,
        active=active.to(torch.float32),
    )


def _vertex_exec(h: dict, g: Graph, cfg: MapperCfg, iv: dict,
                 occ_prev: torch.Tensor, bw_prev: torch.Tensor) -> dict:
    """Per-vertex gates, exposed time and cycles — elementwise from the
    prefix carries."""
    freq = h["freq"]

    # ---------------- prefetch / streaming gates (Alg. 7) -------------------
    can_prefetch = (
        gate_below_ste(occ_prev + iv["alloc_gbuf"] / iv["tiles"], h["cap"] * cfg.headroom)
        * gate_below_ste(bw_prev, cfg.headroom)
        * (1.0 if cfg.prefetch else 0.0)
    )
    # streaming: if over capacity but bw available, overlap main-mem traffic
    # with compute
    can_stream = gate_below_ste(bw_prev, cfg.headroom) * (1.0 if cfg.streaming else 0.0)
    hide = torch.maximum(can_prefetch, can_stream)

    # exposed main-memory time: hidden behind compute when gated on
    t_main_exposed = max_const(iv["t_main"] - hide * iv["t_core"], 0.0)
    # integer-cycle quantization per tile (exact forward via STE)
    per_tile_cyc = (iv["t_core"] + t_main_exposed) * freq / iv["tiles"]
    t_vertex = iv["tiles"] * ceil_ste(per_tile_cyc) / freq * iv["active"]
    return dict(t_vertex=t_vertex, cycles_v=t_vertex * freq, t_main_exposed=t_main_exposed)


def _bw_util(used_bw: torch.Tensor, cycles_v: torch.Tensor, total_cyc: torch.Tensor) -> torch.Tensor:
    gbuf = torch.sum(used_bw * cycles_v, -1) / max_const(total_cyc, 1e-30)
    z = torch.zeros_like(gbuf)
    return torch.stack([z, gbuf, z], -1)


def _vertex_finish(h: dict, g: Graph, cfg: MapperCfg, iv: dict,
                   occ_prev: torch.Tensor, bw_prev: torch.Tensor) -> MapState:
    """The reductions into MapState, from the shared per-vertex execution."""
    ex = _vertex_exec(h, g, cfg, iv, occ_prev, bw_prev)
    cycles_v = ex["cycles_v"]
    total_cyc = torch.sum(cycles_v, -1)
    return MapState(
        cycles=total_cyc,
        reads=torch.sum(g.n_read, -2),
        writes=torch.sum(g.n_write, -2),
        comp_ops=torch.sum(g.n_comp, -2),
        peak_alloc=torch.amax(g.n_alloc, -2),
        t_comp=torch.sum(iv["t_comp"], -1),
        t_mem=torch.sum(iv["t_onchip"] * iv["active"], -1),
        t_exposed_main=torch.sum(ex["t_main_exposed"], -1),
        bw_util=_bw_util(iv["used_bw"], cycles_v, total_cyc),
        # diagnostics also exclude no-op (padding) vertices
        n_tiles=torch.sum(iv["tiles"] * iv["active"], -1),
    )


# --------------------------------------------------------------------------- #
# carry prefixes: the public doubling scans and the carries kernel's call
# --------------------------------------------------------------------------- #


def affine_prefix_assoc(decay: float, add: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix of ``s' = decay*s + add_i`` (s0 = 0) along the last
    axis, O(log V) depth.  Elements are affine maps (a, b): s -> a*s + b;
    composition (later ∘ earlier) is (a1*a2, a2*b1 + b2)."""
    return affine_scan_reference(decay, add)


def minaffine_prefix_assoc(decay: float, add: torch.Tensor, cap: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix of ``s' = min(decay*s + add_i, cap)`` (s0 = 0), O(log V)
    depth: maps s -> min(a*s + b, c) compose, later (a2,b2,c2) ∘ earlier
    (a1,b1,c1) = (a1*a2, a2*b1 + b2, min(a2*c1 + b2, c2)) for a2 >= 0."""
    return minaffine_scan_reference(decay, add, cap)


def _carry_prefixes(chw: ConcreteHW, cfg: MapperCfg, iv: dict) -> tuple[torch.Tensor, torch.Tensor]:
    """The two Alg.-7 carries as exclusive prefixes (pre-vertex states), in
    one call of the carries kernel's wrapper."""
    return mapper_carries(iv["alloc_gbuf"], iv["bw_x"], chw.capacity[..., _GBUF], _OCC_DECAY, _BW_DECAY, _BW_GAIN)


# --------------------------------------------------------------------------- #
# the no-gradient CUDA path: the kernels around K1 (kernels/mapper_kernel.py)
# --------------------------------------------------------------------------- #

GRAPH_FIELDS = ("n_comp", "n_read", "n_write", "n_alloc", "dims")
_GRAPH_WIDTHS = (4, 3, 3, 3, 3)  # the packed graph columns, in GRAPH_FIELDS order
_HW_COLS = {"freq": 1, "cap": 1, "bw": 3, "lat": 3, "fpc": 4, "sys_x": 1, "sys_y": 1}  # _hw's, packed in order
_HW_VECTORS = ("bw", "lat", "fpc")  # [..., 1, k] in _hw; the others [..., 1]
_HW_FIELDS = ("frequency", "capacity", "mem_bw", "read_latency", "write_latency", "flops_per_cycle", "sys_x",
              "sys_y")  # the ConcreteHW fields _hw reads


@dataclass(frozen=True)
class Fused:
    """A call's inputs packed for the kernels."""

    graph: torch.Tensor  # [Gn, V, GRAPH_COLS]
    designs: torch.Tensor  # [Hn, DESIGN_COLS]
    span: int  # rows a design spans: row r is design r // span against graph row r % Gn
    lead: tuple  # the rows' shape (the broadcast of the designs' and the graph's leading axes)


def _on_card(t: torch.Tensor) -> bool:
    """A plain (not a DTensor, not a fake) CUDA float32 tensor."""
    return type(t) in (torch.Tensor, torch.nn.Parameter) and t.is_cuda and t.dtype == torch.float32


def fused(chw: ConcreteHW, g: Graph) -> Fused | None:
    """The packed inputs when the kernels apply to ``map_workload(chw, g)`` on
    the prefix-scan path, else None (the torch stages run).  They apply where
    every tensor the mapper reads is a plain CUDA float32 tensor, no gradient
    is needed (grad mode off, or no input requires grad), and :func:`pack`
    takes the layout."""
    ts = [*(getattr(chw, f) for f in _HW_FIELDS), *(getattr(g, f) for f in GRAPH_FIELDS)]
    if not all(_on_card(t) for t in ts):
        return None
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        return None
    return pack(chw, g)


def pack(chw: ConcreteHW, g: Graph) -> Fused | None:
    """Pack the design's fields as ``_hw`` gives them and the graph, on their
    device, if the kernels index their layout, else None: the graph's arrays
    share their leading axes, which broadcast against the designs' as a suffix
    of the rows' shape, and the designs' leading axes are a prefix of it
    followed by 1s (so [P, 1] or [] against a [W, V] or [V] graph, and [nb, 1]
    against [nb, W, V])."""
    gr = [getattr(g, f) for f in GRAPH_FIELDS]
    if any(t.ndim < 2 or t.shape[-1] != w or t.shape[:-1] != gr[0].shape[:-1] for t, w in zip(gr, _GRAPH_WIDTHS)):
        return None
    h = _hw(chw)
    if any(h[k].shape[-1] != w for k, w in _HW_COLS.items()):
        return None
    V = gr[0].shape[-2]
    G = tuple(gr[0].shape[:-2])
    try:
        H = tuple(torch.broadcast_shapes(*(h[k].shape[:-2 if k in _HW_VECTORS else -1] for k in _HW_COLS)))
        lead = tuple(torch.broadcast_shapes(H, G))
    except RuntimeError:
        return None
    n = len(lead)
    Hp, Gp = (1,) * (n - len(H)) + H, (1,) * (n - len(G)) + G
    k = max((d + 1 for d in range(n) if Hp[d] != 1), default=0)  # designs: lead[:k], then 1s
    j = min((d for d in range(n) if Gp[d] != 1), default=n)  # graph rows: 1s, then lead[j:]
    if Hp[:k] != lead[:k] or Gp[j:] != lead[j:] or V == 0 or math.prod(lead) == 0:
        return None
    graph = torch.cat(gr, -1).reshape(-1, V, mapper_kernel.GRAPH_COLS)
    cols = [(h[k] if k in _HW_VECTORS else h[k][..., None]).expand(*H, 1, w) for k, w in _HW_COLS.items()]
    designs = torch.cat(cols, -1).reshape(-1, mapper_kernel.DESIGN_COLS)
    return Fused(graph, designs, math.prod(lead[k:]), lead)


def _rows(graph: torch.Tensor, designs: torch.Tensor, span: int) -> tuple[dict, Graph]:
    """The rows of a packed call, for the ops' plain versions: row r's design
    fields as ``_hw`` gives them, from design r // span, and its graph, from
    graph row r % Gn (op kinds and edges, which the stages never read, zero)."""
    R, V = designs.shape[0] * span, graph.shape[1]
    r = torch.arange(R, device=graph.device)
    d = designs[r // span][:, None, :]  # [R, 1, DESIGN_COLS]: a vertex axis to broadcast against
    parts = torch.split(d, tuple(_HW_COLS.values()), -1)
    h = {k: x if k in _HW_VECTORS else x[..., 0] for k, x in zip(_HW_COLS, parts)}
    cols = dict(zip(GRAPH_FIELDS, torch.split(graph[r % graph.shape[0]], _GRAPH_WIDTHS, -1)))
    g = Graph(**cols, op_kind=torch.zeros(R, V, dtype=torch.int32, device=graph.device),
              edges=torch.zeros(0, 2, dtype=torch.int32, device=graph.device))
    return h, g


@mapper_kernel.mapper_intrinsics_op.register_kernel("cpu")
def _mapper_intrinsics_plain(graph: torch.Tensor, designs: torch.Tensor, span: int, headroom: float) -> torch.Tensor:
    mapper_kernel.check(graph, designs, span)
    h, g = _rows(graph, designs, span)
    return _vertex_intrinsics(h, g, MapperCfg(headroom=headroom))["bw_x"].contiguous()


@mapper_kernel.mapper_finish_op.register_kernel("cpu")
def _mapper_finish_plain(graph: torch.Tensor, designs: torch.Tensor, occ_prev: torch.Tensor, bw_prev: torch.Tensor,
                         span: int, headroom: float, prefetch: bool,
                         streaming: bool) -> tuple[torch.Tensor, torch.Tensor]:
    mapper_kernel.check(graph, designs, span, occ_prev, bw_prev)
    h, g = _rows(graph, designs, span)
    cfg = MapperCfg(headroom=headroom, prefetch=prefetch, streaming=streaming)
    ms = _vertex_finish(h, g, cfg, _vertex_intrinsics(h, g, cfg), occ_prev, bw_prev)
    return torch.stack([getattr(ms, f) for f in mapper_kernel.SUMS]), ms.bw_util.contiguous()


def _fused_intrinsics(g: Graph, cfg: MapperCfg, fz: Fused) -> dict:
    """What K1 takes, from the intrinsics kernel: bw_x, and alloc from the graph."""
    bw_x = mapper_kernel.mapper_intrinsics_op(fz.graph, fz.designs, fz.span, cfg.headroom)
    return dict(alloc_gbuf=g.n_alloc[..., _GBUF], bw_x=bw_x.view(*fz.lead, g.n_vertices))


def _fused_finish(g: Graph, cfg: MapperCfg, fz: Fused, occ_prev: torch.Tensor, bw_prev: torch.Tensor) -> MapState:
    """The MapState from the finish kernel's sums; the graph-only fields keep
    their torch reductions."""
    R, V = math.prod(fz.lead), g.n_vertices
    sums, bw_util = mapper_kernel.mapper_finish_op(fz.graph, fz.designs, occ_prev.reshape(R, V),
                                                   bw_prev.reshape(R, V), fz.span, cfg.headroom, cfg.prefetch,
                                                   cfg.streaming)
    fields = {f: sums[i].view(fz.lead) for i, f in enumerate(mapper_kernel.SUMS)}
    return MapState(
        reads=torch.sum(g.n_read, -2),
        writes=torch.sum(g.n_write, -2),
        comp_ops=torch.sum(g.n_comp, -2),
        peak_alloc=torch.amax(g.n_alloc, -2),
        bw_util=bw_util.view(*fz.lead, 3),
        **fields,
    )


def _map_workload_assoc(chw: ConcreteHW, g: Graph, cfg: MapperCfg) -> MapState:
    dev = chw.frequency.device
    with instrument.span("mapper.intrinsics", dev):
        fz = fused(chw, g)
        iv = _vertex_intrinsics(_hw(chw), g, cfg) if fz is None else _fused_intrinsics(g, cfg, fz)
    with instrument.span("mapper.carries", dev):
        occ_prev, bw_prev = _carry_prefixes(chw, cfg, iv)
    with instrument.span("mapper.finish", dev):
        if fz is None:
            return _vertex_finish(_hw(chw), g, cfg, iv, occ_prev, bw_prev)
        return _fused_finish(g, cfg, fz, occ_prev, bw_prev)


def map_workload_breakdown(chw: ConcreteHW, g: Graph, cfg: MapperCfg = MapperCfg()) -> dict:
    """Per-vertex / per-level mapping diagnostics (the ``explain`` path).

    Runs the prefix-scan formulation's per-vertex pipeline and returns the
    arrays *before* the MapState reductions:

      * ``time_v`` / ``cycles_v`` [..., V] — each vertex's wall time and
        cycles (padding vertices are exactly zero);
      * ``t_comp_v`` [..., V] — compute-critical seconds per vertex;
      * ``t_main_exposed_v`` [..., V] — main-memory time not hidden;
      * ``tiles_v`` [..., V] — MAPVERTEX split counts;
      * ``t_level`` [..., N_MEM] — total demanded transfer time per level;
      * ``active`` [..., V] — 1.0 for real vertices, 0.0 for padding.
    """
    iv = _vertex_intrinsics(_hw(chw), g, cfg)
    occ_prev, bw_prev = _carry_prefixes(chw, cfg, iv)
    ex = _vertex_exec(_hw(chw), g, cfg, iv, occ_prev, bw_prev)
    return dict(
        time_v=ex["t_vertex"],
        cycles_v=ex["cycles_v"],
        t_comp_v=iv["t_comp"] * iv["active"],
        t_main_exposed_v=ex["t_main_exposed"] * iv["active"],
        tiles_v=iv["tiles"] * iv["active"],
        t_level=torch.sum(iv["t_lvl"] * iv["active"][..., None], -2),
        active=iv["active"],
    )


def map_workload_scan(chw: ConcreteHW, g: Graph, cfg: MapperCfg = MapperCfg()) -> MapState:
    """Sequential-reference MAPWORKLOAD: one loop over the (topologically
    ordered) vertex list with the whole per-vertex computation inlined,
    O(V) depth.

    Deliberately *not* written in terms of ``_vertex_intrinsics`` — it is
    the independent oracle the prefix-scan formulation is tested against.
    """
    freq = chw.frequency
    cap = chw.capacity[..., _GBUF]
    cap_gbuf = cap * cfg.headroom
    bw = chw.mem_bw  # [..., N_MEM] bytes/s
    lat = chw.read_latency + chw.write_latency
    fpc = chw.flops_per_cycle
    eff_rate = max_const(fpc, 1e-9) * freq[..., None]  # FLOP/s
    one = torch.ones((), device=freq.device)
    batch = g.n_comp.shape[:-2]
    occupancy = torch.zeros(batch, device=freq.device)
    bw_ema = torch.zeros(batch, device=freq.device)
    outs = {k: [] for k in ("cycles", "t_comp", "t_mem", "t_main_exposed", "tiles", "bw_now")}

    for v in range(g.n_vertices):
        n_comp, n_read = g.n_comp[..., v, :], g.n_read[..., v, :]
        n_write, n_alloc, dims = g.n_write[..., v, :], g.n_alloc[..., v, :], g.dims[..., v, :]
        # ---------------- tiling (MAPVERTEX split, lines 20-23) -------------
        alloc_gbuf = n_alloc[..., _GBUF]
        tiles = torch.maximum(ceil_ste(alloc_gbuf / cap_gbuf), one)

        # ---------------- compute time per class ---------------------------
        M, N, K = dims[..., 0], dims[..., 1], dims[..., 2]
        m_t = torch.maximum(M / tiles, one)
        waves_m = ceil_ste(m_t / chw.sys_x)
        waves_n = ceil_ste(torch.maximum(N, one) / chw.sys_y)
        k_cycles = ceil_ste(torch.maximum(K, one))
        fill = chw.sys_x + chw.sys_y
        cyc_sys_tile = waves_m * waves_n * (k_cycles + fill)
        ops_sys_tile = n_comp[..., _SYS] / tiles
        cyc_sys_tile = torch.maximum(cyc_sys_tile, ops_sys_tile / max_const(fpc[..., _SYS], 1e-9))
        t_sys = torch.where(ops_sys_tile > 0, tiles * cyc_sys_tile / freq, 0.0)
        t_comp_cls = n_comp / eff_rate
        t_other = torch.cat([torch.zeros_like(t_comp_cls[..., :1]), t_comp_cls[..., 1:]], -1)
        t_comp = torch.maximum(torch.amax(t_other, -1), t_sys)

        # ---------------- memory time per level ----------------------------
        conflict = 1.04
        t_lvl = (n_read + n_write) / bw * conflict
        t_tile_lat = tiles[..., None] * lat
        t_onchip = torch.maximum(t_lvl[..., _GBUF] + t_tile_lat[..., _GBUF], t_lvl[..., _LOCAL])
        t_main = t_lvl[..., _MAIN] + t_tile_lat[..., _MAIN] * (n_alloc[..., _MAIN] > 0)
        t_core = torch.maximum(t_comp, t_onchip)

        # ---------------- prefetch / streaming gates (Alg. 7) --------------
        can_prefetch = (
            gate_below_ste(occupancy + alloc_gbuf / tiles, cap * cfg.headroom)
            * gate_below_ste(bw_ema, cfg.headroom)
            * (1.0 if cfg.prefetch else 0.0)
        )
        can_stream = gate_below_ste(bw_ema, cfg.headroom) * (1.0 if cfg.streaming else 0.0)
        hide = torch.maximum(can_prefetch, can_stream)

        t_main_exposed = max_const(t_main - hide * t_core, 0.0)
        per_tile_cyc = (t_core + t_main_exposed) * freq / tiles
        active = (torch.sum(n_comp, -1) + torch.sum(n_read, -1) + torch.sum(n_write, -1)
                  + torch.sum(n_alloc, -1)) > 0
        t_vertex = tiles * ceil_ste(per_tile_cyc) / freq * active

        # ---------------- state updates -------------------------------------
        # the EMA input is the *demanded* (no-overlap) utilization
        t_full = tiles * ceil_ste((t_core + t_main) * freq / torch.maximum(tiles, one)) / freq
        used_bw = torch.where(
            t_full > 0, (n_read[..., _GBUF] + n_write[..., _GBUF]) / max_const(t_full, 1e-30) / bw[..., _GBUF], 0.0
        )
        bw_ema = _BW_DECAY * bw_ema + 0.2 * _clip(used_bw, 0.0, 2.0)
        occupancy = torch.minimum(_OCC_DECAY * occupancy + alloc_gbuf, cap)  # decaying residency

        outs["cycles"].append(t_vertex * freq)
        outs["t_comp"].append(t_comp)
        outs["t_mem"].append(t_onchip * active)
        outs["t_main_exposed"].append(t_main_exposed)
        outs["tiles"].append(tiles * active)
        outs["bw_now"].append(used_bw)

    o = {k: torch.stack(torch.broadcast_tensors(*vs), -1) for k, vs in outs.items()}
    total_cyc = torch.sum(o["cycles"], -1)
    return MapState(
        cycles=total_cyc,
        reads=torch.sum(g.n_read, -2),
        writes=torch.sum(g.n_write, -2),
        comp_ops=torch.sum(g.n_comp, -2),
        peak_alloc=torch.amax(g.n_alloc, -2),
        t_comp=torch.sum(o["t_comp"], -1),
        t_mem=torch.sum(o["t_mem"], -1),
        t_exposed_main=torch.sum(o["t_main_exposed"], -1),
        bw_util=_bw_util(o["bw_now"], o["cycles"], total_cyc),
        n_tiles=torch.sum(o["tiles"], -1),
    )


def map_workload(chw: ConcreteHW, g: Graph, cfg: MapperCfg = MapperCfg()) -> MapState:
    """MAPWORKLOAD (paper Alg. 1): map the vertex list onto CH, tiling /
    streaming / prefetching per vertex.  Dispatches on ``cfg.scan_impl``.
    Traced, span ``mapper.map``; on the prefix-scan path it holds
    ``mapper.intrinsics``, ``mapper.carries`` and ``mapper.finish``."""
    impl = cfg.scan_impl
    if impl == "auto":
        impl = "ref" if g.n_vertices < _ASSOC_MIN_V else "assoc"
    if impl not in ("ref", "assoc", "pallas"):
        raise ValueError(f"unknown MapperCfg.scan_impl {cfg.scan_impl!r}")
    with instrument.span("mapper.map", chw.frequency.device):
        return map_workload_scan(chw, g, cfg) if impl == "ref" else _map_workload_assoc(chw, g, cfg)
