"""DRAGON core in PyTorch.

DGen  : params.py + dgen.py     (hardware model generation; dhdl.py, the .dhd language)
DSim  : graph.py + trace.py + mapper.py + dsim.py (+ refsim.py baseline)
DOpt  : dopt.py (+ popsim.py and pareto.py, population Pareto DSE)
"""
from repro_torch.core.dgen import ConcreteHW, specialize  # noqa: F401
from repro_torch.core.dhdl import (  # noqa: F401
    CompiledArch,
    DhdlError,
    library_archs,
    load_arch,
    parse_arch,
    serialize_arch,
)
from repro_torch.core.dopt import OptResult, derive_tech_targets, optimize  # noqa: F401
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
from repro_torch.core.pareto import (  # noqa: F401
    hv_ref_point,
    hypervolume,
    non_dominated_mask,
    pareto_front,
)
from repro_torch.core.popsim import (  # noqa: F401
    ParetoResult,
    pareto_dse,
    population_chunk,
    sample_objective_mixes,
    seed_population,
)
from repro_torch.core.graph import Graph, GraphBuilder, workload_optimize  # noqa: F401
from repro_torch.core.mapper import MapperCfg, MapState, map_workload, map_workload_scan  # noqa: F401
from repro_torch.core.params import ArchParams, ArchSpec, TechParams  # noqa: F401
from repro_torch.core.trace import model_flops, trace_lm  # noqa: F401
