// Mamba2 SSD scan (state-space dual form), per (batch, head), with one B and C
// shared by every head:
//   state_t = exp(dt_t A_h) state_{t-1} + dt_t B_t (x) x_t      [N, P]
//   y_t     = C_t . state_t                                       [P]
// x [Bt, S, H, P] (float32 or bfloat16), dt [Bt, S, H], A [H], B and C [Bt, S, N]
// (float32).  Writes y [Bt, S, H, P] in x's type and the final state
// [Bt, H, N, P] in float32.  The state starts at zero.
//
// Replaces the TPU kernel src/repro/kernels/ssd.py::ssd_chunk_scan (_ssd_kernel)
// and computes its chunked form, per chunk of L steps:
//   cum = cumsum(dt A);  scores[i, j] = (C_i . B_j) exp(cum_i - cum_j) dt_j  (i >= j)
//   y = scores x + exp(cum) (C state);  state = exp(cum_L) state + B^T (exp(cum_L - cum) dt x)
// The TPU walks the chunks on a sequential grid axis with the state in scratch
// memory; here one block per (batch, head) walks them in a loop and keeps the
// [N, P] float32 state in shared memory.  The decay exp(cum_i - cum_j) is taken
// only where i >= j: above the diagonal the exponent is positive, overflows to
// inf, and inf * 0 would be NaN.
//
// What bounds it on an H100: operations.  The recurrence needs about 5 N P
// operations per step and head against 2 P bytes of x and y (bf16), so at
// N = P = 64 it does ~160 operations a byte.  Design: simple and right first,
// float32 products from shared memory on the CUDA cores (no tensor cores yet).
// The chunk is the kernel's own choice, since the chunked form is exact: L = 64
// keeps x, B, C, the scores and the state (~82 KB at N = P = 64) in one block's
// dynamic shared memory, where the TPU's 256 would need a 256 KB score tile
// alone.  B and C rows are padded by one float so that the score products,
// whose threads walk B's rows, hit distinct banks.  A ragged last chunk is
// padded with x = dt = B = C = 0: a zero dt makes those steps the identity.
// At batch 1, zamba2's 64 heads give 64 blocks for the card's 132 SMs.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 64;     // L
constexpr int kThreads = 256;

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

size_t smem_floats(int P, int N) {
  const int ldb = N + 1;
  return static_cast<size_t>(kChunk) * P     // x
         + 2 * static_cast<size_t>(kChunk) * ldb  // B, C
         + static_cast<size_t>(N) * P        // state
         + static_cast<size_t>(kChunk) * kChunk  // scores
         + 4 * kChunk;                       // dt, cum, exp(cum), state-update weights
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_chunk_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ A,
                      const float* __restrict__ Bm, const float* __restrict__ Cm, T* __restrict__ y,
                      float* __restrict__ state_out, int S, int H, int P, int N) {
  extern __shared__ float smem[];
  const int ldb = N + 1;
  float* xs = smem;                      // [L, P]
  float* bs = xs + kChunk * P;           // [L, ldb]
  float* cs = bs + kChunk * ldb;         // [L, ldb]
  float* st = cs + kChunk * ldb;         // [N, P]
  float* sc = st + N * P;                // [L, L]
  float* dts = sc + kChunk * kChunk;     // [L]
  float* cum = dts + kChunk;             // [L]
  float* ecum = cum + kChunk;            // [L] exp(cum)
  float* wj = ecum + kChunk;             // [L] exp(cum_L - cum) dt

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const float a = A[h];

  for (int e = tid; e < N * P; e += kThreads) st[e] = 0.0f;

  for (int c0 = 0; c0 < S; c0 += kChunk) {
    const int nl = min(kChunk, S - c0);
    __syncthreads();  // the previous chunk's state update is done
    for (int e = tid; e < kChunk * P; e += kThreads) {
      const int j = e / P, p = e % P;
      xs[e] = j < nl ? load_f(x + ((static_cast<long long>(b) * S + c0 + j) * H + h) * P + p) : 0.0f;
    }
    for (int e = tid; e < kChunk * N; e += kThreads) {
      const int j = e / N, n = e % N;
      const long long src = (static_cast<long long>(b) * S + c0 + j) * N + n;
      bs[j * ldb + n] = j < nl ? Bm[src] : 0.0f;
      cs[j * ldb + n] = j < nl ? Cm[src] : 0.0f;
    }
    for (int j = tid; j < kChunk; j += kThreads)
      dts[j] = j < nl ? dt[(static_cast<long long>(b) * S + c0 + j) * H + h] : 0.0f;
    __syncthreads();
    if (tid == 0) {
      float run = 0.0f;
      for (int j = 0; j < kChunk; ++j) {
        run += dts[j] * a;
        cum[j] = run;
        ecum[j] = expf(run);
      }
    }
    __syncthreads();
    const float last = cum[kChunk - 1];  // padded steps leave cum unchanged
    for (int j = tid; j < kChunk; j += kThreads) wj[j] = expf(last - cum[j]) * dts[j];
    // scores[i, j], j fastest across threads (B rows padded: distinct banks)
    for (int e = tid; e < kChunk * kChunk; e += kThreads) {
      const int i = e / kChunk, j = e % kChunk;
      float val = 0.0f;
      if (j <= i) {
        float dot = 0.0f;
        for (int n = 0; n < N; ++n) dot += cs[i * ldb + n] * bs[j * ldb + n];
        val = dot * expf(cum[i] - cum[j]) * dts[j];
      }
      sc[e] = val;
    }
    __syncthreads();
    // y = scores x + exp(cum) (C state), from the state carried in
    for (int e = tid; e < kChunk * P; e += kThreads) {
      const int i = e / P, p = e % P;
      if (i >= nl) continue;
      float intra = 0.0f;
      for (int j = 0; j <= i; ++j) intra += sc[i * kChunk + j] * xs[j * P + p];
      float inter = 0.0f;
      for (int n = 0; n < N; ++n) inter += cs[i * ldb + n] * st[n * P + p];
      store_f(y + ((static_cast<long long>(b) * S + c0 + i) * H + h) * P + p, intra + ecum[i] * inter);
    }
    __syncthreads();  // every y has read the state before it moves on
    const float decay = ecum[kChunk - 1];
    for (int e = tid; e < N * P; e += kThreads) {
      const int n = e / P, p = e % P;
      float upd = 0.0f;
      for (int j = 0; j < kChunk; ++j) upd += bs[j * ldb + n] * (wj[j] * xs[j * P + p]);
      st[e] = decay * st[e] + upd;
    }
  }
  __syncthreads();
  float* so = state_out + (static_cast<long long>(b) * H + h) * N * P;
  for (int e = tid; e < N * P; e += kThreads) so[e] = st[e];
}

template <typename T>
int launch_typed(const void* x, const float* dt, const float* A, const float* Bm, const float* Cm, void* y,
                 float* state, int Bt, int S, int H, int P, int N, cudaStream_t stream) {
  const size_t bytes = smem_floats(P, N) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(ssd_chunk_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_chunk_scan_kernel<T><<<dim3(H, Bt), kThreads, bytes, stream>>>(
      static_cast<const T*>(x), dt, A, Bm, Cm, static_cast<T*>(y), state, S, H, P, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x [Bt, S, H, P] and y (bf16 != 0: bfloat16, else float32); dt [Bt, S, H], A [H],
// B and C [Bt, S, N], state [Bt, H, N, P] float32; all contiguous.  N, P <= 128.
extern "C" int ssd_chunk_scan_launch(const void* x, const float* dt, const float* A, const float* Bm,
                                     const float* Cm, void* y, float* state, int Bt, int S, int H, int P,
                                     int N, int bf16, void* stream) {
  if (Bt <= 0 || H <= 0) return 0;
  if (P <= 0 || N <= 0 || P > 128 || N > 128) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) return launch_typed<__nv_bfloat16>(x, dt, A, Bm, Cm, y, state, Bt, S, H, P, N, s);
  return launch_typed<float>(x, dt, A, Bm, Cm, y, state, Bt, S, H, P, N, s);
}
