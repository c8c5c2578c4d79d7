"""DRAGON core in PyTorch.

DGen  : params.py + dgen.py     (hardware model generation)
DSim  : graph.py + trace.py + mapper.py + dsim.py
DOpt  : dopt.py
"""
from repro_torch.core.dgen import ConcreteHW, specialize  # noqa: F401
from repro_torch.core.dopt import OptResult, optimize  # noqa: F401
from repro_torch.core.dsim import (  # noqa: F401
    PARETO_METRICS,
    PerfEstimate,
    mixed_log_objective,
    simulate,
    simulate_breakdown,
    simulate_chw,
    simulate_stacked,
    stacked_log_metrics,
    stacked_log_objective,
)
from repro_torch.core.graph import Graph, GraphBuilder, workload_optimize  # noqa: F401
from repro_torch.core.mapper import MapperCfg, MapState, map_workload, map_workload_scan  # noqa: F401
from repro_torch.core.params import ArchParams, ArchSpec, TechParams  # noqa: F401
from repro_torch.core.trace import model_flops, trace_lm  # noqa: F401
