// Causal (or full) attention with grouped KV heads and an online softmax, on the
// float32 pipes:
//   o[b, h, i] = softmax_j(scale * q[b, h, i] . k[b, h / group, j]) v[b, h / group, j]
// over contiguous [B, H, S, D] arrays, float32 or bfloat16 (loaded and widened to
// float32), output in q's type, any head width D from 1 to 256.  bf16 at D = 64 or
// 128 runs on the tensor cores instead (flash_attention_sm90.cu); the wrapper
// chooses from the dtype and D alone.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:88 flash_attention
// (_attn_kernel, :36-83), which tiles any D, and keeps its numerics: scores, the
// running max m, the running sum l and the accumulator in float32; masked scores
// set to the finite -1e30; the running max starts at -1e30; the output is
// acc / max(l, 1e-30).  The mask is suffix-causal: query i sees key j when
// j <= i + (Skv - Sq).  A row that sees no key at all (Sq > Skv) takes the plain
// mean of every value, as the dense version does, so its q tile walks every key.
// Ragged Sq and Skv are masked here: keys past Skv are left out of the softmax
// (p = 0, their V rows zero-filled).  Products stay in full float32 on the FP32
// pipes, no TF32: the reference holds float32 to an atol of 2e-5.
//
// What bounds it on an H100: operations.  At the agreement path's shape (32 heads
// of 64, S = 4096, causal) it does 2 D multiply-adds and one exponential for each
// of the ~S^2/2 kept (query, key) pairs, per head: 1.03 ms at the 67 TFLOP/s FP32
// rate, against 0.03 ms for moving q, k, v and o.  So the design is about issuing
// FFMAs back to back, as a SIMT matrix product does:
//   * Register tiling.  A block is kTr row groups of kTc lanes (Shape below).  Each
//     thread holds 8 query rows: S = Q K^T gives it 8 rows x kBN / kTc keys of a
//     K tile, O += P V 8 rows x DC / kTc output columns, held in registers across
//     all key tiles.  Q, K and V sit in shared memory row-major, 4 floats of
//     padding a row, so one 16-byte load brings 4 consecutive d (or columns) of a
//     row and feeds 8 to 32 FFMAs.  The PR 12 kernel, one thread a query row, read
//     one float from shared memory for each FFMA: near a quarter of the FP32 rate.
//   * At cap 64 a thread scores 8 x 8 and holds 8 x 8 outputs (128 threads, 128
//     rows, 2 blocks an SM); at cap 128, 8 x 4 and 8 x 8 (256 threads, 128 rows,
//     one block: the shared memory of 64-key tiles at D = 128 allows no second);
//     at cap 256, 8 x 2 and 8 x 16 (128 threads, 64 rows, 32-key tiles).
//   * S = Q K^T takes one key at a time against the 8 rows held, so consecutive
//     FFMAs write different scores (four d of one score in a row stall on the
//     FFMA latency).  A thread's rows are two runs of 4 (r, r + kBM / 2): one
//     16-byte load reads 4 of them from P^T, [key][row], in O += P V.
//   * Softmax in log2 units (the scale times log2 e, one ex2.approx a score).  The
//     row max crosses the kTc lanes of a row group by shuffles, once a tile; each
//     lane keeps its own part of l, summed across the lanes once at the end (every
//     lane rescales by the same alpha).  m, l and O are rescaled once a tile.
//   * Overlap.  The V tile's copy runs under S = Q K^T and the next K tile's under
//     O += P V, each into its one buffer: float32 by cp.async (16 bytes a copy, or
//     4 where D % 4 != 0 or a base is not 16-byte aligned, zero-filled past the
//     array), bf16 through registers (16-byte loads, widened on the store).  Two
//     barriers a tile.
//   * Causal.  Key tiles past a q tile's last row are never loaded; only tiles on
//     the diagonal (or past Skv) are masked.  The grid walks q tiles longest first.
//   * Head widths.  Three width caps are compiled, 64, 128 and 256, each taking any
//     D up to it; the product over d stops at D rounded up to 4 (the columns past D
//     up to there are zero-filled, so q . k is exact), and output columns past D
//     are never stored.
// Tried and dropped (tools/time_attention.py): Q and K stored transposed so that
// each step of d is one FFMA a score (the K tile then copied 4 bytes at a time);
// 3 blocks of 64 rows an SM at cap 64; 32- or 48-key tiles at cap 128: each was
// slower on the card.  What holds it back is in PERF.md (its time with either
// product cut out of the source).
// Six instances (two types x three caps), none unrolled over D, so nvcc builds the
// file in seconds; chip_smoke.py prints its build time.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr float kNegInf = -1e30f;  // a masked score, and where the running max starts
constexpr float kLog2e = 1.4426950408889634f;

// A block is kTr row groups of kTc lanes; a thread holds 8 query rows (two runs
// of 4, kBM / 2 apart), scores them against kBN / kTc keys a tile (kTc apart) and
// holds DC / kTc output columns (runs of 4, 4 kTc apart).
template <int DC>  // the width cap
struct Shape;
template <>
struct Shape<64> {  // 8 x 8 scores and 8 x 8 outputs a thread
  static constexpr int kTr = 16, kTc = 8, kBN = 64, kMinBlocks = 2;
};
template <>
struct Shape<128> {  // 8 x 4 scores and 8 x 8 outputs a thread
  static constexpr int kTr = 16, kTc = 16, kBN = 64, kMinBlocks = 1;
};
template <>
struct Shape<256> {  // 8 x 2 scores and 8 x 16 outputs a thread
  static constexpr int kTr = 8, kTc = 16, kBN = 32, kMinBlocks = 1;
};

template <int DC>
struct Cfg : Shape<DC> {
  using S = Shape<DC>;
  static constexpr int kThreads = S::kTr * S::kTc;
  static constexpr int kBM = 8 * S::kTr;  // query rows a block
  static constexpr int kLd = DC + 4;      // row stride of Q, K and V in shared memory, in floats
  static constexpr int kLdP = kBM + 4;    // row stride of P^T [key][row]
  static constexpr int kNJ = S::kBN / S::kTc;  // keys a thread scores
  static constexpr int kNC = DC / (4 * S::kTc);  // runs of 4 output columns a thread holds
  static constexpr int kSmem = ((kBM + 2 * S::kBN) * kLd + S::kBN * kLdP) * 4;
  static_assert(kBM * DC % (4 * kThreads) == 0 && S::kBN * DC % (8 * kThreads) == 0, "tiles split evenly");
};

// component x of v (x a constant once the loops are unrolled)
__device__ __forceinline__ float comp(const float4& v, int x) {
  return x == 0 ? v.x : x == 1 ? v.y : x == 2 ? v.z : v.w;
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }

// float32: copy rows [0, ROWS) of a tile whose row 0 is g (rows of D floats) into
// s [ROWS][DC + 4] by cp.async: columns up to D rounded up to 4, zeros past D and
// in rows >= valid.  vec: D % 4 == 0 and every row 16-byte aligned.
template <int ROWS, int DC, int kThreads>
__device__ __forceinline__ void copy_tile(float* s, const float* g, int valid, int D, bool vec) {
  constexpr int kCh = DC / 4;
#pragma unroll
  for (int it = 0; it < ROWS * kCh / kThreads; ++it) {
    const int i = it * kThreads + threadIdx.x, r = i / kCh, c = i % kCh;
    if (c * 4 >= D) continue;
    float* dst = s + r * (DC + 4) + c * 4;
    const float* src = g + static_cast<long long>(r) * D + c * 4;
    if (vec) {
      cp_async16(dst, r < valid ? src : g, r < valid ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool in = r < valid && c * 4 + e < D;
        cp_async4(dst + e, in ? src + e : g, in ? 4 : 0);
      }
    }
  }
}

// bf16: a tile on its way to shared memory, held in registers between fetch (the
// loads) and store (widened to float32), so that the loads overlap a product.
template <int ROWS, int DC, int kThreads>
struct Staged {
  static constexpr int kCh = DC / 8;  // 16-byte chunks of a row
  static constexpr int kN = ROWS * kCh / kThreads;
  uint4 r[kN];

  // vec: D % 8 == 0 and every row 16-byte aligned
  __device__ __forceinline__ void fetch(const __nv_bfloat16* g, int valid, int D, bool vec) {
#pragma unroll
    for (int it = 0; it < kN; ++it) {
      const int i = it * kThreads + threadIdx.x, row = i / kCh, c = i % kCh;
      r[it] = make_uint4(0, 0, 0, 0);
      if (c * 8 >= D || row >= valid) continue;
      const __nv_bfloat16* src = g + static_cast<long long>(row) * D + c * 8;
      if (vec) {
        r[it] = __ldg(reinterpret_cast<const uint4*>(src));
      } else {
        const unsigned short* h = reinterpret_cast<const unsigned short*>(src);
        unsigned w[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const unsigned lo = c * 8 + 2 * e < D ? h[2 * e] : 0u;
          const unsigned hi = c * 8 + 2 * e + 1 < D ? h[2 * e + 1] : 0u;
          w[e] = lo | (hi << 16);
        }
        r[it] = make_uint4(w[0], w[1], w[2], w[3]);
      }
    }
  }

  __device__ __forceinline__ void store(float* s, int D) const {
#pragma unroll
    for (int it = 0; it < kN; ++it) {
      const int i = it * kThreads + threadIdx.x, row = i / kCh, c = i % kCh;
      if (c * 8 >= D) continue;
      float4* dst = reinterpret_cast<float4*>(s + row * (DC + 4) + c * 8);
      const uint4 x = r[it];
      dst[0] = make_float4(__uint_as_float(x.x << 16), __uint_as_float(x.x & 0xffff0000u),
                           __uint_as_float(x.y << 16), __uint_as_float(x.y & 0xffff0000u));
      dst[1] = make_float4(__uint_as_float(x.z << 16), __uint_as_float(x.z & 0xffff0000u),
                           __uint_as_float(x.w << 16), __uint_as_float(x.w & 0xffff0000u));
    }
  }
};

__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <typename T, int DC>
__global__ void __launch_bounds__(Cfg<DC>::kThreads, Cfg<DC>::kMinBlocks)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                       T* __restrict__ o, int Hq, int Hkv, int Sq, int Skv, int D, int causal, float scale2,
                       int vec) {
  using C = Cfg<DC>;
  constexpr int kThreads = C::kThreads, kTc = C::kTc, kBM = C::kBM, kBN = C::kBN, kLd = C::kLd, kLdP = C::kLdP;
  constexpr int kNJ = C::kNJ, kNC = C::kNC;
  constexpr bool kAsync = std::is_same_v<T, float>;
  extern __shared__ float4 smem[];
  float* qs = reinterpret_cast<float*>(smem);  // [kBM][kLd]
  float* ks = qs + kBM * kLd;                  // [kBN][kLd]
  float* vs = ks + kBN * kLd;                  // [kBN][kLd]
  float* ps = vs + kBN * kLd;                  // P^T, [kBN][kLdP]

  const int h = blockIdx.x, b = blockIdx.z;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBM;  // the longest causal q tiles first
  const int off = Skv - Sq;
  const int tr = threadIdx.x / kTc, tc = threadIdx.x % kTc;
  const T* qg = q + ((static_cast<long long>(b) * Hq + h) * Sq + q0) * D;
  const long long kv = (static_cast<long long>(b) * Hkv + h / (Hq / Hkv)) * Skv * D;
  const T* kg = k + kv;
  const T* vg = v + kv;

  int kv_end = Skv;  // a tile holding a row that sees no key walks every key
  if (causal && q0 + off >= 0) kv_end = min(Skv, min(q0 + kBM, Sq) + off);
  const int n_tiles = (kv_end + kBN - 1) / kBN;
  const int nd = (D + 3) & ~3;  // d of the first product: zeros past D

  Staged<kBN, DC, kThreads> kst, vst;  // bf16 only
  if constexpr (kAsync) {
    copy_tile<kBM, DC, kThreads>(qs, qg, Sq - q0, D, vec);
    copy_tile<kBN, DC, kThreads>(ks, kg, Skv, D, vec);
    cp_async_commit();
  } else {
    {
      Staged<kBM, DC, kThreads> qst;
      qst.fetch(qg, Sq - q0, D, vec);
      qst.store(qs, D);
    }
    kst.fetch(kg, Skv, D, vec);
    kst.store(ks, D);
  }

  // a thread's rows: hh * kBM / 2 + tr * 4 + e; its keys in a tile: tc + kTc j;
  // its output columns: c * 4 kTc + tc * 4 + x
  float acc[2][4][kNC][4];
  float m[2][4], l[2][4];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      m[hh][e] = kNegInf;
      l[hh][e] = 0.0f;
#pragma unroll
      for (int c = 0; c < kNC; ++c)
#pragma unroll
        for (int x = 0; x < 4; ++x) acc[hh][e][c][x] = 0.0f;
    }

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBN;
    if constexpr (kAsync) cp_async_wait_all();
    __syncthreads();  // K tile t in; every thread done with V and P of tile t - 1
    if constexpr (kAsync) {
      copy_tile<kBN, DC, kThreads>(vs, vg + static_cast<long long>(k0) * D, Skv - k0, D, vec);
      cp_async_commit();
    } else {
      vst.fetch(vg + static_cast<long long>(k0) * D, Skv - k0, D, vec);
    }

    // S = Q K^T
    float s[2][4][kNJ];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int j = 0; j < kNJ; ++j) s[hh][e][j] = 0.0f;
#pragma unroll 2
    for (int d = 0; d < nd; d += 4) {
      float4 qf[2][4];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          qf[hh][e] = *reinterpret_cast<const float4*>(qs + (hh * kBM / 2 + tr * 4 + e) * kLd + d);
#pragma unroll
      for (int j = 0; j < kNJ; ++j) {  // one key at a time against the 8 rows held
        const float4 kf = *reinterpret_cast<const float4*>(ks + (tc + kTc * j) * kLd + d);
#pragma unroll
        for (int x = 0; x < 4; ++x)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[hh][e][j] = fmaf(comp(qf[hh][e], x), comp(kf, x), s[hh][e][j]);
      }
    }

    // online softmax in log2 units; keys past Skv at -inf (p = 0 whatever m is)
    const bool edge = (causal && k0 + kBN - 1 > q0 + off) || k0 + kBN > Skv;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = q0 + hh * kBM / 2 + tr * 4 + e;
        float mt = kNegInf;
#pragma unroll
        for (int j = 0; j < kNJ; ++j) {
          float x = s[hh][e][j] * scale2;
          if (edge) {
            const int key = k0 + tc + kTc * j;
            if (key >= Skv) x = __int_as_float(0xff800000u);  // -inf
            else if (causal && key > row + off) x = kNegInf;
          }
          s[hh][e][j] = x;
          mt = fmaxf(mt, x);
        }
#pragma unroll
        for (int w = kTc / 2; w >= 1; w >>= 1) mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, w));
        const float m_new = fmaxf(m[hh][e], mt);
        const float alpha = ex2(m[hh][e] - m_new);
        m[hh][e] = m_new;
        float ls = 0.0f;
#pragma unroll
        for (int j = 0; j < kNJ; ++j) {
          const float p = ex2(s[hh][e][j] - m_new);
          s[hh][e][j] = p;
          ls += p;
        }
        l[hh][e] = fmaf(l[hh][e], alpha, ls);
#pragma unroll
        for (int c = 0; c < kNC; ++c)
#pragma unroll
          for (int x = 0; x < 4; ++x) acc[hh][e][c][x] *= alpha;
      }

    // P^T into shared memory (free since the barrier above); then V tile t
#pragma unroll
    for (int j = 0; j < kNJ; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        *reinterpret_cast<float4*>(ps + (tc + kTc * j) * kLdP + hh * kBM / 2 + tr * 4) =
            make_float4(s[hh][0][j], s[hh][1][j], s[hh][2][j], s[hh][3][j]);
    if constexpr (kAsync) {
      cp_async_wait_all();
    } else {
      vst.store(vs, D);
    }
    __syncthreads();  // P and V in; every thread done with K tile t
    if (t + 1 < n_tiles) {
      if constexpr (kAsync) {
        copy_tile<kBN, DC, kThreads>(ks, kg + static_cast<long long>(k0 + kBN) * D, Skv - k0 - kBN, D, vec);
        cp_async_commit();
      } else {
        kst.fetch(kg + static_cast<long long>(k0 + kBN) * D, Skv - k0 - kBN, D, vec);
      }
    }

    // O += P V
#pragma unroll 4
    for (int kk = 0; kk < kBN; ++kk) {
      const float4 p0 = *reinterpret_cast<const float4*>(ps + kk * kLdP + tr * 4);
      const float4 p1 = *reinterpret_cast<const float4*>(ps + kk * kLdP + kBM / 2 + tr * 4);
      const float pr[2][4] = {{p0.x, p0.y, p0.z, p0.w}, {p1.x, p1.y, p1.z, p1.w}};
      float4 vf[kNC];
#pragma unroll
      for (int c = 0; c < kNC; ++c) vf[c] = *reinterpret_cast<const float4*>(vs + kk * kLd + c * 4 * kTc + tc * 4);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int e = 0; e < 4; ++e)
#pragma unroll
          for (int c = 0; c < kNC; ++c) {
            acc[hh][e][c][0] = fmaf(pr[hh][e], vf[c].x, acc[hh][e][c][0]);
            acc[hh][e][c][1] = fmaf(pr[hh][e], vf[c].y, acc[hh][e][c][1]);
            acc[hh][e][c][2] = fmaf(pr[hh][e], vf[c].z, acc[hh][e][c][2]);
            acc[hh][e][c][3] = fmaf(pr[hh][e], vf[c].w, acc[hh][e][c][3]);
          }
    }
    if constexpr (!kAsync) {
      if (t + 1 < n_tiles) kst.store(ks, D);  // K tile t is no longer read
    }
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float lt = l[hh][e];
#pragma unroll
      for (int w = kTc / 2; w >= 1; w >>= 1) lt += __shfl_xor_sync(0xffffffffu, lt, w);
      const int row = q0 + hh * kBM / 2 + tr * 4 + e;
      if (row >= Sq) continue;
      const float denom = fmaxf(lt, 1e-30f);
      T* orow = o + ((static_cast<long long>(b) * Hq + h) * Sq + row) * D;
#pragma unroll
      for (int c = 0; c < kNC; ++c)
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const int col = c * 4 * kTc + tc * 4 + x;
          if (col < D) store_f(orow + col, acc[hh][e][c][x] / denom);
        }
    }
}

bool aligned16(const void* p) { return reinterpret_cast<std::uintptr_t>(p) % 16 == 0; }

template <typename T, int DC>
int launch(const void* q, const void* k, const void* v, void* o, int B, int Hq, int Hkv, int Sq, int Skv, int D,
           int causal, float scale, cudaStream_t stream) {
  auto kernel = flash_attention_kernel<T, DC>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg<DC>::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vec = aligned16(q) && aligned16(k) && aligned16(v) && D % (16 / static_cast<int>(sizeof(T))) == 0;
  using C = Cfg<DC>;
  const dim3 grid(Hq, (Sq + C::kBM - 1) / C::kBM, B);
  kernel<<<grid, C::kThreads, C::kSmem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                                       static_cast<const T*>(v), static_cast<T*>(o), Hq, Hkv, Sq,
                                                       Skv, D, causal, scale * kLog2e, vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_typed(const void* q, const void* k, const void* v, void* o, int B, int Hq, int Hkv, int Sq, int Skv,
                 int D, int causal, float scale, cudaStream_t stream) {
  if (D <= 64) return launch<T, 64>(q, k, v, o, B, Hq, Hkv, Sq, Skv, D, causal, scale, stream);
  if (D <= 128) return launch<T, 128>(q, k, v, o, B, Hq, Hkv, Sq, Skv, D, causal, scale, stream);
  return launch<T, 256>(q, k, v, o, B, Hq, Hkv, Sq, Skv, D, causal, scale, stream);
}

}  // namespace

// q [B, Hq, Sq, D], k and v [B, Hkv, Skv, D], o [B, Hq, Sq, D]; all contiguous and
// of one type (bf16 != 0: bfloat16, else float32); 1 <= D <= 256.  Returns the
// launch's cudaError_t.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o, int B, int Hq,
                                      int Hkv, int Sq, int Skv, int D, int causal, float scale, int bf16,
                                      void* stream) {
  if (B <= 0 || Hq <= 0 || Sq <= 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0 || Skv <= 0 || D < 1 || D > 256 || B > 65535 || Sq > 65535 * 64)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) return launch_typed<__nv_bfloat16>(q, k, v, o, B, Hq, Hkv, Sq, Skv, D, causal, scale, s);
  return launch_typed<float>(q, k, v, o, B, Hq, Hkv, Sq, Skv, D, causal, scale, s);
}
