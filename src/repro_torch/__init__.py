"""DRAGON in PyTorch: the Session façade over DGen, DSim, DOpt, the .dhd
language and population Pareto DSE, with hand-written CUDA kernels for Hopper.

    from repro_torch import Session

    sess = Session("edge")                 # on the card
    print(sess.simulate("bert_base"))      # an explainable SimReport
    opt = sess.optimize("bert_base", steps=40)

The engines below the façade keep their names here too (``simulate``,
``optimize``, ``pareto_dse``, ...): they are the oracle the façade is held
against, bit for bit.

Every constructor that makes tensors (``Session`` too) takes ``device=None``,
meaning the card; it raises when no GPU is present.  Pass ``device="cpu"`` to run the plain
PyTorch versions of the kernels on the CPU.

Names are imported lazily, so ``import repro_torch`` itself is cheap.
"""
from __future__ import annotations

_EXPORTS = {
    "Session": "repro_torch.api",
    "Architecture": "repro_torch.api",
    "Workload": "repro_torch.api",
    "CacheStats": "repro_torch.api",
    "SimReport": "repro_torch.api",
    "OptResult": "repro_torch.api",
    "FrontierResult": "repro_torch.api",
    "Attribution": "repro_torch.api",
    "ArchParams": "repro_torch.core.params",
    "ArchSpec": "repro_torch.core.params",
    "TechParams": "repro_torch.core.params",
    "Graph": "repro_torch.core.graph",
    "GraphBuilder": "repro_torch.core.graph",
    "ConcreteHW": "repro_torch.core.dgen",
    "specialize": "repro_torch.core.dgen",
    "MapperCfg": "repro_torch.core.mapper",
    "map_workload": "repro_torch.core.mapper",
    "PerfEstimate": "repro_torch.core.dsim",
    "simulate": "repro_torch.core.dsim",
    "simulate_stacked": "repro_torch.core.dsim",
    "stacked_log_objective": "repro_torch.core.dsim",
    "mixed_log_objective": "repro_torch.core.dsim",
    "optimize": "repro_torch.core.dopt",
    "derive_tech_targets": "repro_torch.core.dopt",
    "pareto_dse": "repro_torch.core.popsim",
    "load_arch": "repro_torch.core.dhdl",
    "parse_arch": "repro_torch.core.dhdl",
    "serialize_arch": "repro_torch.core.dhdl",
    "get_workload": "repro_torch.workloads",
    "lm_cell": "repro_torch.workloads",
    "WORKLOAD_FAMILIES": "repro_torch.workloads",
    "pack_chw": "repro_torch.kernels.ops",
    "pack_graph": "repro_torch.kernels.ops",
    "popsim": "repro_torch.kernels.ops",
}

__all__ = list(_EXPORTS)


def __getattr__(name: str):
    if name in _EXPORTS:
        import importlib

        value = getattr(importlib.import_module(_EXPORTS[name]), name)
        globals()[name] = value  # cache: __getattr__ only fires on misses
        return value
    raise AttributeError(f"module 'repro_torch' has no attribute {name!r}")


def __dir__():
    return sorted({*globals(), *__all__})
