"""The objective's forward in a descent (span ``popsim.forward``: DGen,
the mapper and its K1 launch, DSim, the scalarization), device-stream ms
an epoch."""
from chipbench.metrics import _spans


def read(trace):
    return _spans.ms_per("popsim.forward", "popsim.epoch")
