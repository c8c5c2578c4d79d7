"""The 10 assigned LM architectures as DRAGON workload DFGs.

Each (arch x shape) cell becomes an operator-level dataflow graph consumed
by DSim/DOpt.
"""
from __future__ import annotations

from repro_torch.configs import SHAPES, all_archs, get_config
from repro_torch.core.graph import Graph
from repro_torch.core.trace import trace_lm


def lm_cell(arch: str, shape: str, device=None) -> Graph:
    """DFG for one (architecture x shape) cell."""
    return trace_lm(get_config(arch), SHAPES[shape], device)


def lm_workloads(shape: str = "train_4k", archs: list[str] | None = None, device=None) -> dict[str, Graph]:
    """All assigned architectures traced at one shape (runnable cells only)."""
    out = {}
    for a in archs or all_archs():
        cfg = get_config(a)
        if shape == "long_500k" and not cfg.subquadratic():
            continue
        out[a] = trace_lm(cfg, SHAPES[shape], device)
    return out
