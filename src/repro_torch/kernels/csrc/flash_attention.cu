// Causal (or full) attention with grouped KV heads and an online softmax:
//   o[b, h, i] = softmax_j(scale * q[b, h, i] . k[b, h / group, j]) v[b, h / group, j]
// over contiguous [B, H, S, D] arrays, float32 or bfloat16, output in q's type.
// It takes float32 at D = 16, 32 or 64 (a tensor-core product would be TF32, off
// the reference's 2e-5) and bf16 at D = 16 or 32; bf16 at 64 or 128 runs on the
// tensor cores in flash_attention_sm90.cu.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::flash_attention
// (_attn_kernel) and keeps its numerics: scores, the running max m, the running
// sum l and the accumulator in float32; masked scores set to the finite -1e30;
// the running max starts at -1e30; the output is acc / max(l, 1e-30).  The mask
// is suffix-causal: query i sees key j when j <= i + (Skv - Sq).
//
// What bounds it on an H100: operations.  At the zamba2 prefill's shape (32
// heads of 64, S = 4096, causal) it does 2 D multiply-adds for each of the
// ~S*S/2 (query, key) pairs the mask keeps, per head, against ~2 MB of q, k, v
// and o per head (bf16), far past the 295 operations a byte at
// which bf16 products stop being bound by memory.  Design: simple and right
// first, on the float32 pipes (no tensor cores yet).  One block per (q tile of
// 64 rows, q head, batch), one thread per query row holding its q row and its
// accumulator in registers.  K and V tiles are staged through shared memory
// (every thread reads the same key at once: a broadcast, no bank conflict) and
// scored 16 keys at a time, so the accumulator is rescaled once per 16 keys.
// The loops over D and over those 16 keys are unrolled to keep q, the
// accumulator and the scores in registers.  The unrolled size sets the build
// time: with D = 128 as well (255 registers and spills) nvcc 12.9 took 159 s
// over this file, so D stops at 64.  A step of 8 keys builds faster still but
// ran 44% slower at the zamba2 shape.  The loop over K/V tiles stops at the
// tile's causal limit q_last + (Skv - Sq); a row that sees no key at all
// (Sq > Skv) takes the plain mean of every value, as the dense version does,
// so such a tile walks every key.  Ragged Sq and Skv are masked here: no tile size has to divide
// them.  Keys past Skv are left out of the softmax altogether.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kBlockQ = 64;  // query rows per block, one thread each
constexpr int kSub = 16;     // keys scored at once by each thread

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <typename T, int D>
__global__ void __launch_bounds__(kBlockQ)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                       T* __restrict__ o, int Hq, int Hkv, int Sq, int Skv, int causal, float scale) {
  constexpr int kBlockK = 64;  // keys per shared-memory tile: 2 x 64 x D floats, 32 KB at D = 64
  __shared__ float ks[kBlockK][D];
  __shared__ float vs[kBlockK][D];

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int off = Skv - Sq;
  const int q0 = blockIdx.x * kBlockQ;
  const int row = q0 + threadIdx.x;
  const bool live = row < Sq;

  const long long qrow = ((static_cast<long long>(b) * Hq + h) * Sq + (live ? row : 0)) * D;
  const long long kvbase = (static_cast<long long>(b) * Hkv + hk) * Skv * D;

  float qr[D], acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qr[d] = live ? load_f(q + qrow + d) : 0.0f;
    acc[d] = 0.0f;
  }
  float m = kNegInf, l = 0.0f;

  int kv_end = Skv;
  if (causal && q0 + off >= 0) kv_end = min(Skv, min(q0 + kBlockQ, Sq) - 1 + off + 1);

  for (int k0 = 0; k0 < kv_end; k0 += kBlockK) {
    const int nk = min(kBlockK, kv_end - k0);
    __syncthreads();  // the previous tile is consumed by every thread
    for (int i = threadIdx.x; i < kBlockK * D; i += kBlockQ) {
      const int r = i / D, c = i % D;
      const bool in = r < nk;
      ks[r][c] = in ? load_f(k + kvbase + static_cast<long long>(k0 + r) * D + c) : 0.0f;
      vs[r][c] = in ? load_f(v + kvbase + static_cast<long long>(k0 + r) * D + c) : 0.0f;
    }
    __syncthreads();
    for (int j0 = 0; j0 < nk; j0 += kSub) {
      float s[kSub];
      float mt = kNegInf;
#pragma unroll
      for (int j = 0; j < kSub; ++j) {
        float dot = 0.0f;
#pragma unroll
        for (int d = 0; d < D; ++d) dot += qr[d] * ks[j0 + j][d];
        float sj = dot * scale;
        if (causal && k0 + j0 + j > row + off) sj = kNegInf;
        s[j] = sj;
        if (j0 + j < nk) mt = fmaxf(mt, sj);
      }
      const float m_new = fmaxf(m, mt);
      const float alpha = expf(m - m_new);
      float psum = 0.0f;
#pragma unroll
      for (int j = 0; j < kSub; ++j) {
        const float p = j0 + j < nk ? expf(s[j] - m_new) : 0.0f;  // keys past the tile: left out
        s[j] = p;
        psum += p;
      }
      l = alpha * l + psum;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        float a = acc[d] * alpha;
#pragma unroll
        for (int j = 0; j < kSub; ++j) a += s[j] * vs[j0 + j][d];
        acc[d] = a;
      }
      m = m_new;
    }
  }
  if (!live) return;
  const float denom = fmaxf(l, 1e-30f);
#pragma unroll
  for (int d = 0; d < D; ++d) store_f(o + qrow + d, acc[d] / denom);
}

template <typename T>
int launch_typed(const void* q, const void* k, const void* v, void* o, int B, int Hq, int Hkv, int Sq,
                 int Skv, int D, int causal, float scale, cudaStream_t stream) {
  const dim3 grid((Sq + kBlockQ - 1) / kBlockQ, Hq, B);
  const T* qq = static_cast<const T*>(q);
  const T* kk = static_cast<const T*>(k);
  const T* vv = static_cast<const T*>(v);
  T* oo = static_cast<T*>(o);
  switch (D) {
    case 16:
      flash_attention_kernel<T, 16><<<grid, kBlockQ, 0, stream>>>(qq, kk, vv, oo, Hq, Hkv, Sq, Skv, causal, scale);
      break;
    case 32:
      flash_attention_kernel<T, 32><<<grid, kBlockQ, 0, stream>>>(qq, kk, vv, oo, Hq, Hkv, Sq, Skv, causal, scale);
      break;
    case 64:  // bf16 at 64 runs on the tensor cores (flash_attention_sm90.cu)
      if constexpr (std::is_same_v<T, float>) {
        flash_attention_kernel<T, 64><<<grid, kBlockQ, 0, stream>>>(qq, kk, vv, oo, Hq, Hkv, Sq, Skv, causal, scale);
        break;
      } else {
        return static_cast<int>(cudaErrorInvalidValue);
      }
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q [B, Hq, Sq, D], k and v [B, Hkv, Skv, D], o [B, Hq, Sq, D]; all contiguous and
// of one type (bf16 != 0: bfloat16, else float32).  D is 16, 32 or 64, and 64 only
// in float32.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o, int B, int Hq,
                                      int Hkv, int Sq, int Skv, int D, int causal, float scale, int bf16,
                                      void* stream) {
  if (B <= 0 || Hq <= 0 || Sq <= 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0 || Skv <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) return launch_typed<__nv_bfloat16>(q, k, v, o, B, Hq, Hkv, Sq, Skv, D, causal, scale, s);
  return launch_typed<float>(q, k, v, o, B, Hq, Hkv, Sq, Skv, D, causal, scale, s);
}
