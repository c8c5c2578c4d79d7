"""GNN workloads (paper Table 1 claims GNN support: 'DLRMs/Transformers/GNNs').

Message-passing layers as DFGs: sparse gather (neighbor features, mainMem-
bound), per-edge/per-node dense transforms (systolic), and scatter-reduce
aggregation (macTree). Two standard models:

  * GCN:  H' = σ(Â H W)         — aggregate then transform
  * GraphSAGE (mean): H' = σ([H | mean_N(H)] W)
"""
from __future__ import annotations

from repro_torch.core.graph import ELEMWISE, GATHER, Graph, GraphBuilder, MATMUL, REDUCTION

BYTES = 2.0


def _mp_layer(b: GraphBuilder, name: str, n_nodes: float, n_edges: float,
              d_in: float, d_out: float, mode: str, concat_self: bool = False):
    mult = 3.0 if mode == "train" else 1.0
    feat = n_nodes * d_in * BYTES
    edge_feat = n_edges * d_in * BYTES
    # neighbor gather: irregular reads of node features along edges
    b.add(f"{name}.gather", GATHER, n_edges * d_in,
          main_read=edge_feat, gbuf_write=edge_feat,
          alloc=edge_feat, dims=(n_edges, d_in, 1.0))
    # scatter-reduce aggregation (sum/mean over incident edges)
    b.add(f"{name}.aggregate", REDUCTION, n_edges * d_in * mult,
          gbuf_read=edge_feat * mult, gbuf_write=feat * mult,
          alloc=edge_feat + feat, dims=(n_nodes, d_in, 1.0))
    # dense transform
    k = d_in * (2.0 if concat_self else 1.0)
    w = k * d_out * BYTES
    b.add(f"{name}.transform", MATMUL, 2.0 * n_nodes * k * d_out * mult,
          gbuf_read=(n_nodes * k * BYTES + w) * mult,
          gbuf_write=n_nodes * d_out * BYTES * mult,
          main_read=w * (2.0 if mode == "train" else 1.0),
          main_write=w if mode == "train" else 0.0,
          alloc=n_nodes * (k + d_out) * BYTES + w,
          dims=(n_nodes, d_out, k))
    b.add(f"{name}.act", ELEMWISE, n_nodes * d_out * mult,
          gbuf_read=n_nodes * d_out * BYTES, gbuf_write=n_nodes * d_out * BYTES,
          alloc=2 * n_nodes * d_out * BYTES, dims=(n_nodes * d_out, 1.0, 1.0))


def gcn(n_nodes: int = 1 << 20, avg_degree: int = 16, d: int = 256,
        layers: int = 3, n_classes: int = 64, mode: str = "inference", device=None) -> Graph:
    """GCN on an ogbn-products-scale graph."""
    b = GraphBuilder()
    e = float(n_nodes * avg_degree)
    dims = [d] * layers + [n_classes]
    for i in range(layers):
        _mp_layer(b, f"L{i}", float(n_nodes), e, float(dims[i]), float(dims[i + 1]), mode)
    return b.build(device)


def graphsage(n_nodes: int = 1 << 20, avg_degree: int = 16, d: int = 256,
              layers: int = 2, mode: str = "inference", device=None) -> Graph:
    """GraphSAGE-mean with self-concat."""
    b = GraphBuilder()
    e = float(n_nodes * avg_degree)
    for i in range(layers):
        _mp_layer(b, f"L{i}", float(n_nodes), e, float(d), float(d), mode,
                  concat_self=True)
    return b.build(device)
