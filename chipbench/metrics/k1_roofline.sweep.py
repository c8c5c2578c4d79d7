"""K1's share of its roofline in a sweep: the carries forward alone
(``carries_kernel<true>``), each launch at [P * W, V]."""
from chipbench.harness import roofline
from chipbench.metrics import _k1


def read(trace):
    return _k1.share(trace, (roofline.K1_FORWARD,))
