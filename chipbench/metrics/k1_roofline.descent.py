"""K1's share of its roofline in a descent: the carries forward
(``carries_kernel<true>``) and their closed-form backward
(``carries_backward_kernel``), each launch at [P * W, V]."""
from chipbench.harness import roofline
from chipbench.metrics import _k1


def read(trace):
    return _k1.share(trace, (roofline.K1_FORWARD, roofline.K1_BACKWARD))
