"""The yardstick's peaks and the work of the kernels it holds to a roofline.

Peaks: one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at the 700 W limit):
HBM3 at 3.35 TB/s, 67 TFLOP/s in float32 outside the tensor cores.  A share
is stated against these, with the card's power limit beside it in the
result's ``device`` field.

K1 (the mapper's two Alg.-7 carries, ``carries_kernel<true>`` forward and
``carries_backward_kernel`` backward) is counted from the shape of the rows
it scans, [R, V], as the program's own kernel check counts it (frozen from
``chip_smoke.carries_records`` when the benchmark was defined):

  * forward: alloc, bw_x (float32 [R, V]) and cap (float32 [R]) read;
    occ_prev, bw_prev (float32 [R, V]) and the clamp code (uint8 [R, V])
    written: 17 R V + 4 R bytes; 7 operations a vertex;
  * backward: g_occ, g_bw (float32 [R, V]) and the code read; grad_bw_x
    (float32 [R, V]) and grad_cap (float32 [R]) written (no gradient of the
    graph's alloc): 13 R V + 4 R bytes; 9 operations a vertex.

The mapper hands K1 every input as its own [R, V] array (the graph's alloc
and each member's capacity are expanded to one row a member and workload), so
these are the bytes each launch must move.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

K1_FORWARD = "carries_kernel<true>"
K1_BACKWARD = "carries_backward_kernel"


def k1_forward(R: int, V: int) -> tuple[int, int]:
    """(bytes, operations) of one forward launch over [R, V]."""
    return 17 * R * V + 4 * R, 7 * R * V


def k1_backward(R: int, V: int) -> tuple[int, int]:
    """(bytes, operations) of one backward launch over [R, V]."""
    return 13 * R * V + 4 * R, 9 * R * V


def least_seconds(nbytes: float, ops: float) -> float:
    """The least time the card could take: the larger of the bytes over the
    HBM rate and the operations over the float32 rate."""
    return max(nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S)
