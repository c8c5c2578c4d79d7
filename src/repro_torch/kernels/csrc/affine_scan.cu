// First-order affine prefix scan: s_i = decay * s_{i-1} + b_i, s_{-1} = 0,
// over the last axis of a contiguous [R, V] float32 array.
//
// Replaces the TPU kernel src/repro/kernels/sscan.py::_affine_scan_pallas
// (_affine_scan_kernel), the DSim mapper's bandwidth-EMA carry.  The same
// kernel with reverse = 1 scans from the end of each row, which is the
// closed-form backward (db_k = sum_{i>=k} decay^(i-k) g_i) without flip copies.
//
// What bounds it on an H100: bytes.  It reads R*V floats and writes R*V
// floats and does two operations per element; at the mapper's shapes
// (R = workloads, V <= 4096) it moves tens of kilobytes, so a launch is
// latency-bound.  Design: one warp per row, four rows per 128-thread block.
// The warp walks its row in chunks of 32; within a chunk the lanes run an
// inclusive Hillis-Steele scan of affine pairs with shuffles, combining
// (a1, b1) then (a2, b2) into (a1*a2, a2*b1 + b2); the chunk's result is then
// applied to the carry of the previous chunk, s = A*carry + B, and lane 31
// hands the new carry on.  Any V >= 1 works: lanes past the end of the row
// load the identity (1, 0) and store nothing.
#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kRowsPerBlock = 4;

__global__ void affine_scan_kernel(const float* __restrict__ b, float* __restrict__ s,
                                   int rows, int V, float decay, int reverse) {
  const int lane = threadIdx.x % kWarp;
  const int row = blockIdx.x * kRowsPerBlock + threadIdx.x / kWarp;
  if (row >= rows) return;  // whole warps leave together: no shuffle is split
  const float* bin = b + static_cast<long long>(row) * V;
  float* sout = s + static_cast<long long>(row) * V;
  float carry = 0.0f;
  for (int base = 0; base < V; base += kWarp) {
    const int k = base + lane;                      // position along the scan
    const bool live = k < V;
    const int idx = reverse ? (V - 1 - k) : k;      // position in memory
    float A = live ? decay : 1.0f;
    float B = live ? bin[idx] : 0.0f;
#pragma unroll
    for (int off = 1; off < kWarp; off <<= 1) {
      const float a_prev = __shfl_up_sync(0xffffffffu, A, off);
      const float b_prev = __shfl_up_sync(0xffffffffu, B, off);
      if (lane >= off) {
        B = A * b_prev + B;
        A = a_prev * A;
      }
    }
    const float out = A * carry + B;
    if (live) sout[idx] = out;
    carry = __shfl_sync(0xffffffffu, out, kWarp - 1);
  }
}

}  // namespace

extern "C" int affine_scan_launch(const float* b, float* s, int rows, int V, float decay,
                                  int reverse, void* stream) {
  if (rows <= 0 || V <= 0) return 0;
  const int blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  affine_scan_kernel<<<blocks, kRowsPerBlock * kWarp, 0, static_cast<cudaStream_t>(stream)>>>(
      b, s, rows, V, decay, reverse);
  return static_cast<int>(cudaGetLastError());
}
