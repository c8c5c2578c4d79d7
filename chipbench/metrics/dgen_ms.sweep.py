"""DGen in a sweep (span ``dgen.specialize``: the designs' concrete
hardware), device-stream ms a request."""
from chipbench.metrics import _spans


def read(trace):
    return _spans.ms_per("dgen.specialize", "popsim.log_metrics")
