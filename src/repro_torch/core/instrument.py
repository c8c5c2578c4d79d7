"""The build counter under the reference's name (``repro.core.instrument``).

The counter lives in :mod:`repro_torch.instrument`, a module that imports
nothing of the package, so that ``kernels.runtime`` below ``core`` can import
it at top level; these are the same functions and the same counts.
"""
from repro_torch.instrument import count_trace, reset, snapshot, trace_count

__all__ = ["count_trace", "trace_count", "snapshot", "reset"]
