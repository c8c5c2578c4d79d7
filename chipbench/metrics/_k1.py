"""K1's share of its roofline over a traced window: the least time its
launches could take at the card's peaks, from the bytes and operations its
[R, V] rows need (``harness.roofline``), over the device time the profiler
gives those launches."""
from chipbench.harness import roofline


def share(trace, kernels) -> float | None:
    R, V = trace.shapes["k1"]
    counts = {roofline.K1_FORWARD: roofline.k1_forward(R, V), roofline.K1_BACKWARD: roofline.k1_backward(R, V)}
    least = seconds = 0.0
    for name, _, dur in trace.kernels:
        for kernel in kernels:
            if kernel in name:
                least += roofline.least_seconds(*counts[kernel])
                seconds += dur / 1e6
    return 100.0 * least / seconds if seconds > 0 else None
