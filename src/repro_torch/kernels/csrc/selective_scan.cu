// Mamba1 selective scan with a diagonal A, per (batch, channel c, state n):
//   s_t = exp(dt_t A_cn) s_{t-1} + dt_t u_t B_tn;   y_t = sum_n C_tn s_tn + D_c u_t
// u [Bt, S, C] (float32 or bfloat16), dt [Bt, S, C], A [C, N], B and C [Bt, S, N],
// D [C] (float32).  Writes y [Bt, S, C] in u's type and the final state
// [Bt, C, N] in float32.  The state starts at zero.
//
// Replaces the TPU kernel src/repro/kernels/sscan.py::selective_scan_pallas
// (_scan_kernel), which keeps a [block_c, N] state in scratch memory across a
// sequential grid axis over chunks and returns y only.  This kernel also
// returns the final state: its oracle, models/mamba.selective_scan, returns it
// and the prefill hands it to decode.
//
// What bounds it on an H100: bytes.  Per (step, channel) it reads u and dt and
// writes y (8 bytes at bf16 u), against ~7 N + 3 operations (112 + 3 at
// N = 16): ~14 operations a byte, below the float32 ridge of 20.  Design: one
// thread per (batch, channel) with its N <= 16 states and its row of A in
// registers, walking S in order.  The block's 64 threads are 64 neighbouring
// channels, so each step's u and dt loads are coalesced; a time tile of 32 steps
// of u and dt is loaded at once (64 loads in flight per thread) and the tile's
// B_t and C_t rows, the same for every channel, are staged once in shared
// memory for the whole block.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;  // channels per block
constexpr int kTile = 32;     // time steps staged at once
constexpr int kMaxN = 16;

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
selective_scan_kernel(const T* __restrict__ u, const float* __restrict__ dt, const float* __restrict__ A,
                      const float* __restrict__ Bm, const float* __restrict__ Cm, const float* __restrict__ Dv,
                      T* __restrict__ y, float* __restrict__ state_out, int S, int C, int N) {
  __shared__ float us[kTile][kThreads];
  __shared__ float dts[kTile][kThreads];
  __shared__ float bsh[kTile][kMaxN];
  __shared__ float csh[kTile][kMaxN];

  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int c = blockIdx.x * kThreads + tid;
  const bool live = c < C;

  float a[kMaxN], s[kMaxN];
#pragma unroll
  for (int n = 0; n < kMaxN; ++n) {
    a[n] = (live && n < N) ? A[static_cast<long long>(c) * N + n] : 0.0f;
    s[n] = 0.0f;
  }
  const float dc = live ? Dv[c] : 0.0f;
  const long long row0 = static_cast<long long>(b) * S;

  for (int t0 = 0; t0 < S; t0 += kTile) {
    const int nt = min(kTile, S - t0);
    __syncthreads();  // the previous tile is consumed
#pragma unroll 8
    for (int r = 0; r < kTile; ++r) {
      const bool in = live && r < nt;
      const long long idx = (row0 + t0 + r) * C + c;
      us[r][tid] = in ? load_f(u + idx) : 0.0f;
      dts[r][tid] = in ? dt[idx] : 0.0f;
    }
    for (int e = tid; e < kTile * kMaxN; e += kThreads) {
      const int r = e / kMaxN, n = e % kMaxN;
      const bool in = r < nt && n < N;
      const long long idx = (row0 + t0 + r) * N + n;
      bsh[r][n] = in ? Bm[idx] : 0.0f;
      csh[r][n] = in ? Cm[idx] : 0.0f;
    }
    __syncthreads();
    for (int r = 0; r < nt; ++r) {
      const float uu = us[r][tid], dd = dts[r][tid];
      const float du = dd * uu;
      float yy = 0.0f;
#pragma unroll
      for (int n = 0; n < kMaxN; ++n) {
        if (n < N) {
          s[n] = expf(dd * a[n]) * s[n] + du * bsh[r][n];
          yy += s[n] * csh[r][n];
        }
      }
      if (live) store_f(y + (row0 + t0 + r) * C + c, yy + uu * dc);
    }
  }
  if (!live) return;
#pragma unroll
  for (int n = 0; n < kMaxN; ++n)
    if (n < N) state_out[(static_cast<long long>(b) * C + c) * N + n] = s[n];
}

template <typename T>
int launch_typed(const void* u, const float* dt, const float* A, const float* Bm, const float* Cm,
                 const float* Dv, void* y, float* state, int Bt, int S, int C, int N, cudaStream_t stream) {
  const dim3 grid((C + kThreads - 1) / kThreads, Bt);
  selective_scan_kernel<T><<<grid, kThreads, 0, stream>>>(static_cast<const T*>(u), dt, A, Bm, Cm, Dv,
                                                          static_cast<T*>(y), state, S, C, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// u [Bt, S, C] and y (bf16 != 0: bfloat16, else float32); dt [Bt, S, C], A [C, N],
// B and C [Bt, S, N], D [C], state [Bt, C, N] float32; all contiguous.  N <= 16.
extern "C" int selective_scan_launch(const void* u, const float* dt, const float* A, const float* Bm,
                                     const float* Cm, const float* Dv, void* y, float* state, int Bt, int S,
                                     int C, int N, int bf16, void* stream) {
  if (Bt <= 0 || C <= 0) return 0;
  if (N <= 0 || N > kMaxN) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) return launch_typed<__nv_bfloat16>(u, dt, A, Bm, Cm, Dv, y, state, Bt, S, C, N, s);
  return launch_typed<float>(u, dt, A, Bm, Cm, Dv, y, state, Bt, S, C, N, s);
}
