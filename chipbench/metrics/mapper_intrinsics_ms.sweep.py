"""The mapper's per-vertex intrinsics in a sweep (span
``mapper.intrinsics``), device-stream ms a request."""
from chipbench.metrics import _spans


def read(trace):
    return _spans.ms_per("mapper.intrinsics", "popsim.log_metrics")
