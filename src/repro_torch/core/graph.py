"""Workload dataflow graphs (paper §4).

A workload is a DAG of operator vertices, held as a struct-of-arrays: per-
vertex resource stats (compute ops per compute class, bytes read/written/
allocated per memory unit) plus matmul-ish dims for utilization modelling and
an op-kind tag.  Edges are kept for the graph-level compiler passes
(compute-merge, paper Alg. 3); the mapper consumes vertices in topological
order.  Construction is numpy (bit-equal to the reference package's arrays);
the finished :class:`Graph` holds tensors on one device.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core.params import MEM_IDX, N_MEM
from repro_torch.kernels.runtime import resolve_device

# op kinds
MATMUL, ELEMWISE, REDUCTION, SCAN, GATHER, SOFTMAX, CONV, MISC = range(8)
KIND_NAMES = ("matmul", "elemwise", "reduction", "scan", "gather", "softmax", "conv", "misc")

# routing of op kinds onto compute classes (fractions of the op's FLOPs):
#                         sysArr vector macTree fpu
_KIND_ROUTE = np.array(
    [
        [1.00, 0.00, 0.00, 0.00],  # matmul  -> systolic array
        [0.00, 1.00, 0.00, 0.00],  # elemwise-> vector
        [0.00, 0.20, 0.80, 0.00],  # reduction -> mac tree (+ vector epilogue)
        [0.00, 0.90, 0.00, 0.10],  # scan    -> vector w/ fpu control
        [0.00, 0.50, 0.00, 0.50],  # gather  -> address calc on fpu
        [0.00, 0.60, 0.40, 0.00],  # softmax -> vector exp + tree reductions
        [1.00, 0.00, 0.00, 0.00],  # conv    -> systolic array
        [0.00, 0.00, 0.00, 1.00],  # misc    -> fpu
    ],
    np.float32,
)

DATA_FIELDS = ("n_comp", "n_read", "n_write", "n_alloc", "dims", "op_kind", "edges")


@dataclass
class Graph:
    """Struct-of-arrays DFG.  Data arrays have a vertex axis V, after any
    leading workload axis W (``Graph.stack``)."""

    n_comp: torch.Tensor  # [..., V, N_COMP] FLOPs routed per compute class
    n_read: torch.Tensor  # [..., V, N_MEM]  bytes read
    n_write: torch.Tensor  # [..., V, N_MEM]  bytes written
    n_alloc: torch.Tensor  # [..., V, N_MEM]  bytes that must be resident (working set)
    dims: torch.Tensor  # [..., V, 3]  (M, N, K) for utilization modelling
    op_kind: torch.Tensor  # [..., V] int32
    edges: torch.Tensor  # [E, 2] int32 (src, dst)
    names: tuple = field(default=())  # static metadata

    @property
    def n_vertices(self) -> int:
        return self.n_comp.shape[-2]

    @property
    def device(self) -> torch.device:
        return self.n_comp.device

    @property
    def total_flops(self) -> torch.Tensor:
        return torch.sum(self.n_comp)

    def to(self, device) -> "Graph":
        return Graph(**{f: getattr(self, f).to(device) for f in DATA_FIELDS}, names=self.names)

    @staticmethod
    def from_numpy(d: dict, names: tuple = (), device=None) -> "Graph":
        """Build from a dict of numpy arrays keyed by field name."""
        dev = resolve_device(device)
        dt = {"op_kind": np.int32, "edges": np.int32}
        return Graph(
            **{f: torch.tensor(np.array(d[f], dt.get(f, np.float32)), device=dev)
               for f in DATA_FIELDS},
            names=tuple(names),
        )

    def pad_to(self, v: int) -> "Graph":
        """Pad vertex arrays to ``v`` (no-op vertices) for batched DSE."""
        cur = self.n_vertices
        if cur == v:
            return self
        assert cur < v, (cur, v)
        p = v - cur
        ax = self.n_comp.ndim - 2  # the vertex axis follows any workload axis

        def pad(x):
            shape = list(x.shape)
            shape[ax] = p
            return torch.cat([x, x.new_zeros(shape)], ax)

        return Graph(
            n_comp=pad(self.n_comp),
            n_read=pad(self.n_read),
            n_write=pad(self.n_write),
            n_alloc=pad(self.n_alloc),
            dims=pad(self.dims),
            op_kind=pad(self.op_kind),
            edges=self.edges,
            names=self.names + ("pad",) * p,
        )

    @staticmethod
    def stack(graphs: "list[Graph]") -> "Graph":
        """Stack workloads into one Graph with a leading workload axis W.

        Every data array becomes [W, V_max, ...] (vertex lists padded with
        no-op vertices via :meth:`pad_to`; the mapper prices no-op vertices at
        zero cycles and excludes them from the diagnostics, so padding is exact
        for the whole MapState).  Edges are ragged across workloads and unused
        by the mapper, so the stacked graph carries an empty edge list.
        """
        assert graphs, "Graph.stack needs at least one graph"
        vmax = max(g.n_vertices for g in graphs)
        gs = [g.pad_to(vmax) for g in graphs]
        stk = lambda f: torch.stack([getattr(g, f) for g in gs])  # noqa: E731
        return Graph(
            n_comp=stk("n_comp"),
            n_read=stk("n_read"),
            n_write=stk("n_write"),
            n_alloc=stk("n_alloc"),
            dims=stk("dims"),
            op_kind=stk("op_kind"),
            edges=torch.zeros((len(gs), 0, 2), dtype=torch.int32, device=gs[0].device),
            names=tuple(g.names for g in gs),
        )


class GraphBuilder:
    """Imperative construction (numpy), immutable Graph output."""

    def __init__(self):
        self._rows: list[dict] = []
        self._edges: list[tuple[int, int]] = []
        self._last: int | None = None

    def add(
        self,
        name: str,
        kind: int,
        flops: float,
        *,
        gbuf_read: float = 0.0,
        gbuf_write: float = 0.0,
        main_read: float = 0.0,
        main_write: float = 0.0,
        alloc: float = 0.0,
        dims: tuple[float, float, float] = (1.0, 1.0, 1.0),
        deps: list[int] | None = None,
        chain: bool = True,
    ) -> int:
        """Add a vertex; returns its index.

        ``alloc`` is the on-chip working set (globalBuf).  localMem traffic is
        modelled as operand/register traffic proportional to FLOPs.
        """
        vid = len(self._rows)
        local = flops * 1.0  # ~1 byte of register-file traffic per FLOP
        n_read = np.zeros(N_MEM, np.float32)
        n_write = np.zeros(N_MEM, np.float32)
        n_alloc = np.zeros(N_MEM, np.float32)
        n_read[MEM_IDX["localMem"]] = local
        n_write[MEM_IDX["localMem"]] = local * 0.5
        n_read[MEM_IDX["globalBuf"]] = gbuf_read
        n_write[MEM_IDX["globalBuf"]] = gbuf_write
        n_read[MEM_IDX["mainMem"]] = main_read
        n_write[MEM_IDX["mainMem"]] = main_write
        n_alloc[MEM_IDX["globalBuf"]] = alloc
        n_alloc[MEM_IDX["mainMem"]] = main_read + main_write
        self._rows.append(
            dict(
                name=name,
                kind=kind,
                n_comp=_KIND_ROUTE[kind] * np.float32(flops),
                n_read=n_read,
                n_write=n_write,
                n_alloc=n_alloc,
                dims=np.asarray(dims, np.float32),
            )
        )
        if deps is not None:
            for d in deps:
                self._edges.append((d, vid))
        elif chain and self._last is not None:
            self._edges.append((self._last, vid))
        self._last = vid
        return vid

    def build(self, device=None) -> Graph:
        assert self._rows, "empty graph"
        dev = resolve_device(device)
        t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
        return Graph(
            n_comp=t(np.stack([r["n_comp"] for r in self._rows])),
            n_read=t(np.stack([r["n_read"] for r in self._rows])),
            n_write=t(np.stack([r["n_write"] for r in self._rows])),
            n_alloc=t(np.stack([r["n_alloc"] for r in self._rows])),
            dims=t(np.stack([r["dims"] for r in self._rows])),
            op_kind=t(np.array([r["kind"] for r in self._rows], np.int32)),
            edges=t(
                np.array(self._edges, np.int32).reshape(-1, 2)
                if self._edges
                else np.zeros((0, 2), np.int32)
            ),
            names=tuple(r["name"] for r in self._rows),
        )


# --------------------------------------------------------------------------- #
# Graph-level compiler passes (paper Alg. 3: workloadOptimize)
# --------------------------------------------------------------------------- #


def compute_merge(g: Graph, flops_threshold: float = 1e6) -> Graph:
    """Compute Merge Optimizer (paper Alg. 3): greedily merge consecutive
    small vertices (all below threshold) into one, summing their stats.
    Operates on the topological order; preserves total work exactly."""
    nc = g.n_comp.cpu().numpy()
    small = nc.sum(-1) < flops_threshold
    rows = []
    group: list[int] = []

    def flush():
        if group:
            rows.append(list(group))
            group.clear()

    for v in range(g.n_vertices):
        if small[v]:
            group.append(v)
            if sum(nc[group].sum(-1)) >= flops_threshold:
                flush()
        else:
            flush()
            rows.append([v])
    flush()

    dev = g.device
    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731

    def merge(x):
        x = x.cpu().numpy()
        return t(np.stack([x[idx].sum(0) for idx in rows]))

    dims = g.dims.cpu().numpy()
    kind = g.op_kind.cpu().numpy()
    alloc = g.n_alloc.cpu().numpy()
    return Graph(
        n_comp=merge(g.n_comp),
        n_read=merge(g.n_read),
        n_write=merge(g.n_write),
        n_alloc=t(np.stack([alloc[idx].max(0) for idx in rows])),
        dims=t(np.stack([dims[idx[0]] for idx in rows])),
        op_kind=t(np.array([kind[idx[0]] for idx in rows], np.int32)),
        edges=torch.zeros((0, 2), dtype=torch.int32, device=dev),
        names=tuple("+".join(g.names[i] for i in idx) if len(idx) > 1 else g.names[idx[0]] for idx in rows),
    )


def workload_optimize(g: Graph, merge_threshold: float = 0.0) -> Graph:
    """paper §5.2 workloadOptimize: DFG partitioning + compute merge.
    The struct-of-arrays graph is already topologically ordered by
    construction; optionally merge small vertices."""
    if merge_threshold > 0:
        g = compute_merge(g, merge_threshold)
    return g
