"""The mapper's gates, exposed time, cycles and reductions after the
carries in a sweep (span ``mapper.finish``), device-stream ms a request."""
from chipbench.metrics import _spans


def read(trace):
    return _spans.ms_per("mapper.finish", "popsim.log_metrics")
