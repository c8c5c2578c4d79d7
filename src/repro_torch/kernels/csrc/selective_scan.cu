// Mamba1 selective scan with a diagonal A, per (batch, channel c, state n):
//   s_t = exp(dt_t A_cn) s_{t-1} + dt_t u_t B_tn;   y_t = sum_n C_tn s_tn + D_c u_t
// u [Bt, S, C] (float32 or bfloat16), dt [Bt, S, C], A [C, N], B and C [Bt, S, N],
// D [C] (float32).  Writes y [Bt, S, C] in u's type and the final state
// [Bt, C, N] in float32, and, where the caller passes a buffer for them (the
// training path's backward starts from them), the state entering each chunk of
// kChunk steps, [Bt, ceil(S / kChunk), C, N] float32.  The state starts at
// zero.  N <= 16, any S, C, Bt.
//
// Replaces the TPU kernel src/repro/kernels/sscan.py::selective_scan_pallas
// (_scan_kernel), which keeps a [block_c, N] state in scratch memory across a
// sequential grid axis over chunks and returns y only.  This kernel also
// returns the final state: its oracle, models/mamba.selective_scan, returns it
// and the prefill hands it to decode.
//
// What bounds it on an H100: the exponential unit.  Every (step, channel,
// state) needs one exp(dt A): 16 S C of them at N = 16, at 16 a clock per SM,
// against 8 bytes of u, dt and y per (step, channel) (bf16 u) and ~5 float32
// instructions per (step, channel, state).  The design:
//   * one ex2.approx per state and step: log2 e is folded into A once per
//     (channel, state), and the decay is exp2(dt * A log2 e);
//   * the states are split across warps to fill the card: a block owns 32
//     neighbouring channels (one a lane) and 8 warps, each holding 2 of the 16
//     states of every channel in registers (65,536 threads at C = 8192, all
//     resident at 16 warps an SM).  Every warp walks time in chunks of 48
//     steps on its carried state, and y sums the 8 warps' partial outputs
//     through shared memory, one row of 32 channels a step;
//   * coalesced, asynchronous tiles: one thread loads each chunk's [48 steps,
//     32 channels] tiles of dt and u and [48, 16] tiles of B and C by TMA into
//     a ring of two stages (the next chunk's while this one is computed,
//     completion on an mbarrier), and stores each chunk's y tile by TMA from
//     shared memory.  TMA fills what lies past S or C with zeros, so those
//     steps are the identity (dt = 0), and writes nothing there.  A C that is
//     not a multiple of 8, N other than 16 or a base not 16-byte aligned loads
//     and stores element by element instead.
// Designs tried (PERF.md): splitting time into 2-8 segments a chunk scanned in
// parallel and composed through shared memory, 4 states a thread, 64-channel
// blocks, cp.async in place of TMA; each was slower.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxN = 16;
constexpr int kW = 32;                   // channels a block, one a lane
constexpr int kNS = 2;                   // states a thread
constexpr int kG = kMaxN / kNS;          // state groups: warps a block
constexpr int kThreads = kW * kG;
constexpr int kChunk = 48;               // steps a chunk
constexpr int kStages = 2;               // chunks of tiles in flight
constexpr float kLog2e = 1.4426950408889634f;

template <typename T>
struct Smem {  // byte offsets into the block's dynamic shared memory (after 128-byte alignment)
  static constexpr int kDt = kChunk * kW * 4, kU = kChunk * kW * static_cast<int>(sizeof(T));
  static constexpr int kBC = kChunk * kMaxN * 4;
  static constexpr int kStage = kDt + kU + 2 * kBC;            // dt, u, B, C tiles of one chunk
  static constexpr int kYPart = kStages * kStage;              // [kG][kChunk][kW] float: each warp's y
  static constexpr int kYOut = kYPart + kG * kChunk * kW * 4;  // [2][kChunk][kW] T: y tiles on their way out
  static constexpr int kBar = kYOut + 2 * kU;                  // kStages mbarriers
  static constexpr int kBytes = 128 + kBar + kStages * 8;
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float from_f(float x, float*) { return x; }
__device__ __forceinline__ __nv_bfloat16 from_f(float x, __nv_bfloat16*) { return __float2bfloat16(x); }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("{\n.reg .b64 st;\nmbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n}\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// one box of a 3-D tensor map, {column, row, batch}, global -> shared, completing on bar
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint32_t bar, int col, int row, int b) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row), "r"(b)
      : "memory");
}

// one box shared -> global; what lies past the tensor's edge is not written
__device__ __forceinline__ void tma_store(const CUtensorMap* map, const void* src, int col, int row, int b) {
  asm volatile("cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map)),
               "r"(smem_u32(src)), "r"(col), "r"(row), "r"(b)
               : "memory");
}

__device__ __forceinline__ void bulk_commit() { asm volatile("cp.async.bulk.commit_group;\n" ::: "memory"); }
__device__ __forceinline__ void bulk_wait_read() { asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory"); }
__device__ __forceinline__ void fence_async_shared() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }

struct Maps {
  CUtensorMap dt, u, b, c, y;
};

// kTma: tiles in and out by TMA; else element by element
template <typename T, bool kTma>
__global__ void __launch_bounds__(kThreads)
selective_scan_kernel(const __grid_constant__ Maps maps, const T* __restrict__ u, const float* __restrict__ dt,
                      const float* __restrict__ A, const float* __restrict__ Bm, const float* __restrict__ Cm,
                      const float* __restrict__ Dv, T* __restrict__ y, float* __restrict__ state_out,
                      float* __restrict__ entering, int S, int C, int N) {
  using Z = Smem<T>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((128 - (smem_u32(smem_raw) & 127)) & 127);  // TMA boxes: 128-byte aligned
  auto tile_dt = [&](int st) { return reinterpret_cast<float*>(smem + st * Z::kStage); };
  auto tile_u = [&](int st) { return reinterpret_cast<T*>(smem + st * Z::kStage + Z::kDt); };
  auto tile_b = [&](int st) { return reinterpret_cast<float*>(smem + st * Z::kStage + Z::kDt + Z::kU); };
  auto tile_c = [&](int st) { return tile_b(st) + kChunk * kMaxN; };
  float* ypart = reinterpret_cast<float*>(smem + Z::kYPart);
  T* yout = reinterpret_cast<T*>(smem + Z::kYOut);
  const uint32_t bar0 = smem_u32(smem + Z::kBar);

  const int tid = threadIdx.x;
  const int col = tid % kW;  // this thread's channel in the block
  const int g = tid / kW;    // its warp: states kNS g .. kNS g + kNS - 1
  const int b = blockIdx.y;
  const int c0 = blockIdx.x * kW, c = c0 + col;
  const bool live = c < C;
  const long long row0 = static_cast<long long>(b) * S;

  float a2[kNS], s[kNS];
#pragma unroll
  for (int j = 0; j < kNS; ++j) {
    const int n = kNS * g + j;
    a2[j] = (live && n < N) ? A[static_cast<long long>(c) * N + n] * kLog2e : 0.0f;
    s[j] = 0.0f;
  }
  const float dc = live ? Dv[c] : 0.0f;
  const int nq = (S + kChunk - 1) / kChunk;

  auto issue = [&](int q, int st) {  // chunk q's tiles into stage st, by one thread
    const uint32_t bar = bar0 + 8 * st;
    mbar_expect_tx(bar, Z::kStage);
    tma_load(tile_dt(st), &maps.dt, bar, c0, q * kChunk, b);
    tma_load(tile_u(st), &maps.u, bar, c0, q * kChunk, b);
    tma_load(tile_b(st), &maps.b, bar, 0, q * kChunk, b);
    tma_load(tile_c(st), &maps.c, bar, 0, q * kChunk, b);
  };
  auto load = [&](int q, int st) {  // the same, element by element, by every thread
    float* dts = tile_dt(st);
    T* us = tile_u(st);
    float *bs = tile_b(st), *cs = tile_c(st);
    const int t0 = q * kChunk;
    for (int e = tid; e < kChunk * kW; e += kThreads) {
      const int r = e / kW, cl = e % kW;
      const bool ok = t0 + r < S && c0 + cl < C;
      const long long idx = (row0 + t0 + r) * C + c0 + cl;
      dts[e] = ok ? dt[idx] : 0.0f;
      us[e] = ok ? u[idx] : T(0.0f);
    }
    for (int e = tid; e < kChunk * kMaxN; e += kThreads) {
      const int r = e / kMaxN, n = e % kMaxN;
      const bool ok = t0 + r < S && n < N;
      const long long idx = (row0 + t0 + r) * N + n;
      bs[e] = ok ? Bm[idx] : 0.0f;
      cs[e] = ok ? Cm[idx] : 0.0f;
    }
  };

  if constexpr (kTma) {
    if (tid == 0) {
      for (int st = 0; st < kStages; ++st) mbar_init(bar0 + 8 * st, 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      for (int st = 0; st < kStages - 1 && st < nq; ++st) issue(st, st);
    }
    __syncthreads();
  }
  for (int q = 0; q < nq; ++q) {
    const int st = q % kStages;
    if (entering != nullptr && live) {  // the state entering chunk q, this thread's 2 states of its channel
#pragma unroll
      for (int j = 0; j < kNS; ++j) {
        const int n = kNS * g + j;
        if (n < N) entering[((static_cast<long long>(b) * nq + q) * C + c) * N + n] = s[j];
      }
    }
    if constexpr (kTma) {
      mbar_wait(bar0 + 8 * st, (q / kStages) & 1);
      if (tid == 0) bulk_wait_read();  // the y tile stored two chunks ago has left its buffer
      __syncthreads();                 // chunk q-1 is consumed and its y tile written
      if (tid == 0) {
        if (q > 0) {
          tma_store(&maps.y, yout + ((q - 1) & 1) * kChunk * kW, c0, (q - 1) * kChunk, b);
          bulk_commit();
        }
        if (q + kStages - 1 < nq) issue(q + kStages - 1, (q + kStages - 1) % kStages);
      }
    } else {
      __syncthreads();
      load(q, st);
      __syncthreads();
    }
    const float* dts = tile_dt(st);
    const T* us = tile_u(st);
    const float *bs = tile_b(st) + kNS * g, *cs = tile_c(st) + kNS * g;
#pragma unroll
    for (int r = 0; r < kChunk; ++r) {
      const float dtv = dts[r * kW + col];
      const float du = dtv * to_f(us[r * kW + col]);
      const float2 bv = *reinterpret_cast<const float2*>(bs + r * kMaxN);
      const float2 cv = *reinterpret_cast<const float2*>(cs + r * kMaxN);
      s[0] = fmaf(ex2(dtv * a2[0]), s[0], du * bv.x);
      s[1] = fmaf(ex2(dtv * a2[1]), s[1], du * bv.y);
      ypart[(g * kChunk + r) * kW + col] = fmaf(cv.y, s[1], cv.x * s[0]);
    }
    __syncthreads();
    // y = the warps' partial outputs + D u, one row of 32 channels a step (this
    // thread's channel is the same in every row); by TMA from a staging tile
    // (stored at the next chunk's start, or after the loop), else straight out
    T* yt = yout + (q & 1) * kChunk * kW;
    for (int r = g; r < kChunk; r += kG) {
      float yy = to_f(us[r * kW + col]) * dc;
#pragma unroll
      for (int gg = 0; gg < kG; ++gg) yy += ypart[(gg * kChunk + r) * kW + col];
      if constexpr (kTma) {
        yt[r * kW + col] = from_f(yy, yt);
      } else {
        const int t = q * kChunk + r;
        if (t < S && live) y[(row0 + t) * C + c] = from_f(yy, y);
      }
    }
    if constexpr (kTma) fence_async_shared();  // the y tile, written here, is read by the TMA store
  }
  if constexpr (kTma) {
    __syncthreads();
    if (tid == 0 && nq > 0) {
      tma_store(&maps.y, yout + ((nq - 1) & 1) * kChunk * kW, c0, (nq - 1) * kChunk, b);
      bulk_commit();
      bulk_wait_read();  // shared memory must outlive the store's read
    }
  }
  if (live) {
#pragma unroll
    for (int j = 0; j < kNS; ++j) {
      const int n = kNS * g + j;
      if (n < N) state_out[(static_cast<long long>(b) * C + c) * N + n] = s[j];
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the CUDA runtime (no -lcuda)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// [Bt, S, width] as a 3-D map with [kChunk rows, cols] boxes, unswizzled; what
// a box holds past the tensor's edge is read as zeros and never written
bool make_map(CUtensorMap* map, EncodeTiled encode, CUtensorMapDataType type, int esize, const void* ptr, int Bt,
              int S, int width, int cols) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(width), static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(Bt)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(width) * esize, static_cast<cuuint64_t>(S) * width * esize};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(cols), kChunk, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, type, 3, const_cast<void*>(ptr), dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T>
int launch_typed(const void* u, const float* dt, const float* A, const float* Bm, const float* Cm, const float* Dv,
                 void* y, float* state, float* entering, int Bt, int S, int C, int N, cudaStream_t stream) {
  const auto aligned = [](const void* p) { return reinterpret_cast<std::uintptr_t>(p) % 16 == 0; };
  // TMA takes rows whose strides are multiples of 16 bytes, from 16-byte aligned bases
  const bool tma = C % 8 == 0 && N == kMaxN && S > 0 && aligned(u) && aligned(dt) && aligned(Bm) &&
                   aligned(Cm) && aligned(y);
  Maps maps = {};
  if (tma) {
    const EncodeTiled encode = encode_tiled();
    if (encode == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
    const CUtensorMapDataType ut = sizeof(T) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
    const CUtensorMapDataType f32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
    const int es = static_cast<int>(sizeof(T));
    if (!make_map(&maps.dt, encode, f32, 4, dt, Bt, S, C, kW) || !make_map(&maps.u, encode, ut, es, u, Bt, S, C, kW) ||
        !make_map(&maps.b, encode, f32, 4, Bm, Bt, S, N, kMaxN) ||
        !make_map(&maps.c, encode, f32, 4, Cm, Bt, S, N, kMaxN) || !make_map(&maps.y, encode, ut, es, y, Bt, S, C, kW))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kern = tma ? selective_scan_kernel<T, true> : selective_scan_kernel<T, false>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, Smem<T>::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<dim3((C + kW - 1) / kW, Bt), kThreads, Smem<T>::kBytes, stream>>>(
      maps, static_cast<const T*>(u), dt, A, Bm, Cm, Dv, static_cast<T*>(y), state, entering, S, C, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// u [Bt, S, C] and y (bf16 != 0: bfloat16, else float32); dt [Bt, S, C], A [C, N],
// B and C [Bt, S, N], D [C], state [Bt, C, N] float32; entering null or
// [Bt, ceil(S / 48), C, N] float32; all contiguous.  N <= 16.
extern "C" int selective_scan_launch(const void* u, const float* dt, const float* A, const float* Bm,
                                     const float* Cm, const float* Dv, void* y, float* state, float* entering,
                                     int Bt, int S, int C, int N, int bf16, void* stream) {
  if (Bt <= 0 || C <= 0) return 0;
  if (N <= 0 || N > kMaxN || Bt > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) return launch_typed<__nv_bfloat16>(u, dt, A, Bm, Cm, Dv, y, state, entering, Bt, S, C, N, s);
  return launch_typed<float>(u, dt, A, Bm, Cm, Dv, y, state, entering, Bt, S, C, N, s);
}
