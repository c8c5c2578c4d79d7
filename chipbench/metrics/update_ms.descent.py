"""The population update in a descent (span ``popsim.update``: the finite
checks, Adam over both trees, the clamp, the per-member rollback, the
epoch's row), device-stream ms an epoch."""
from chipbench.metrics import _spans


def read(trace):
    return _spans.ms_per("popsim.update", "popsim.epoch")
