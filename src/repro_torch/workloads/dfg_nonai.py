"""Non-AI workload DFGs (the paper's 'Non-AI Workloads' column, Table 1).

The paper ingests LLVM IR / Python ASTs; here the three canonical kernels
are emitted directly as operator DFGs with exact op/byte counts — the same
representation the paper's frontend would produce after its scheduling pass
(§11.1).  All are memory- or control-dominated, exercising the vector /
macTree / fpu compute classes rather than the systolic array.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.graph import ELEMWISE, GATHER, MISC, REDUCTION, GraphBuilder, Graph

BYTES = 4.0  # fp32 for scientific/non-AI kernels


def stencil2d(n: int = 4096, iters: int = 8, device=None) -> Graph:
    """Jacobi 5-point stencil on an n x n grid, ``iters`` sweeps.

    Per point per sweep: 4 adds + 1 mul = 5 FLOPs; reads 5 neighbours
    (perfect reuse leaves ~1 fresh read/point from the streaming row
    buffer), writes 1.
    """
    b = GraphBuilder()
    pts = float(n * n)
    for it in range(iters):
        b.add(
            f"sweep{it}",
            ELEMWISE,
            pts * 5.0,
            gbuf_read=pts * 3.0 * BYTES,  # 3 rows resident
            gbuf_write=pts * BYTES,
            main_read=pts * BYTES,  # stream grid in
            main_write=pts * BYTES,  # stream grid out
            alloc=3.0 * n * BYTES * 64,  # 3-row working set (64 cols blocked)
            dims=(pts, 1.0, 1.0),
        )
    return b.build(device)


def merge_sort(n: int = 1 << 24, device=None) -> Graph:
    """Bottom-up merge sort of n fp32 keys: log2(n) passes, each streaming
    the full array with ~1 compare+select per element."""
    b = GraphBuilder()
    passes = int(np.log2(n))
    for p in range(passes):
        b.add(
            f"pass{p}",
            MISC,  # compare/branch -> fpu
            float(n) * 2.0,  # compare + select
            gbuf_read=float(n) * BYTES,
            gbuf_write=float(n) * BYTES,
            main_read=float(n) * BYTES,
            main_write=float(n) * BYTES,
            alloc=2.0 * min(n, 1 << 16) * BYTES,  # double-buffered run window
            dims=(float(n), 1.0, 1.0),
        )
    return b.build(device)


def bfs_graph(n_vertices: int = 1 << 20, avg_degree: int = 16, frontier_rounds: int = 12, device=None) -> Graph:
    """Level-synchronous BFS over a sparse graph in CSR.

    Each round gathers neighbour lists (random access — mainMem latency
    bound) and updates the frontier bitmap.  Round sizes follow the classic
    expanding/contracting frontier profile.
    """
    b = GraphBuilder()
    # frontier fraction per round (expand then contract)
    profile = np.array([0.001, 0.01, 0.05, 0.2, 0.4, 0.2, 0.08, 0.03, 0.01, 0.004, 0.001, 0.0005])
    profile = profile[:frontier_rounds] / profile[:frontier_rounds].sum()
    edges = float(n_vertices * avg_degree)
    for r, frac in enumerate(profile):
        e = edges * float(frac)
        v = n_vertices * float(frac)
        b.add(
            f"round{r}.expand",
            GATHER,
            e * 2.0,  # visited-check + dist update per edge
            main_read=e * (BYTES + 4.0),  # neighbour id + random-access visit flag
            gbuf_read=v * BYTES,
            gbuf_write=e * 0.3 * BYTES,  # next-frontier appends
            alloc=min(v * BYTES, 2.0e6),
            dims=(e, 1.0, 1.0),
        )
        b.add(
            f"round{r}.compact",
            REDUCTION,
            e * 1.0,
            gbuf_read=e * 0.3 * BYTES,
            gbuf_write=v * BYTES,
            alloc=min(e * 0.3 * BYTES, 2.0e6),
            dims=(e * 0.3, 1.0, 1.0),
        )
    return b.build(device)
