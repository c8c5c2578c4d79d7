"""The objective's backward in a descent (span ``popsim.backward``,
``torch.autograd.grad``: K1's backward launch among it), device-stream ms
an epoch."""
from chipbench.metrics import _spans


def read(trace):
    return _spans.ms_per("popsim.backward", "popsim.epoch")
