"""Workload DFG builders for DRAGON (paper §4: AI and non-AI workloads).

dfg_lm       — the 10 assigned LM architectures (via core.trace) as DSim DFGs
dfg_classic  — the paper's own evaluation set: CNNs, LSTMs, DLRMs, BERT
dfg_nonai    — non-AI workloads: stencil, sort, graph-BFS (paper's non-AI claim)
"""
from repro_torch.workloads.dfg_classic import (  # noqa: F401
    bert_base,
    bert_large,
    dlrm,
    lstm,
    resnet50,
    vgg16,
)
from repro_torch.workloads.dfg_gnn import gcn, graphsage  # noqa: F401
from repro_torch.workloads.dfg_lm import lm_cell, lm_workloads  # noqa: F401
from repro_torch.workloads.dfg_nonai import bfs_graph, merge_sort, stencil2d  # noqa: F401

WORKLOAD_FAMILIES = {
    "vision": ("resnet50", "vgg16"),
    "language": ("bert_base", "bert_large", "lstm"),
    "recommendation": ("dlrm",),
    "graph": ("gcn", "graphsage"),
    "non_ai": ("stencil2d", "merge_sort", "bfs_graph"),
}


def get_workload(name: str, device=None, **kw):
    import repro_torch.workloads.dfg_classic as c
    import repro_torch.workloads.dfg_gnn as gg
    import repro_torch.workloads.dfg_nonai as n

    for mod in (c, gg, n):
        if hasattr(mod, name):
            return getattr(mod, name)(device=device, **kw)
    raise KeyError(f"unknown workload {name!r}")
