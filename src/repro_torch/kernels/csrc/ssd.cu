// Mamba2 SSD scan (state-space dual form), with one B and C shared by every head:
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
// The TPU walks the chunks in order on one core with the state in scratch
// memory.  Here the chunks run in parallel, in three kernels:
//   1. chunk states (grid: chunk x head group x batch): each chunk's own
//      contribution dS_c = B^T diag(exp(cum_L - cum) dt) x, [N, P], and its
//      decay exp(cum_L), into a scratch tensor;
//   2. state pass (grid: float4 columns of N P x head x batch): the only
//      sequential part, S_c = exp(cum_L,c) S_{c-1} + dS_c, one float4 of the
//      state a thread, with the loads of 16 chunks in flight.  It writes the
//      state entering each chunk over dS_c, and the final state;
//   3. chunk outputs (kernel 1's grid): y = (CB o decay o dt) x + exp(cum) (C S_{c-1}).
// A block of kernels 1 and 3 takes a few heads of one chunk: they share the
// chunk's B and C tiles and, in kernel 3, C B^T.  The wrapper picks the heads
// a block (ssd.heads_per_block) by the waves of blocks the grid makes.
//
// What bounds it on an H100.  The chunked form does about
// 4 N P + L P / 2 + L N / heads FMAs per step and head (N = P = L = 64: ~11 k),
// all float32 on the CUDA cores, against 2 P bytes of x and y in bf16; and the
// scratch states (4 N P bytes a chunk and head) are written once and read
// twice beside them.  Every product is register-tiled: a block of 4 warps
// takes a 64x64 product, a thread 32 outputs of it (8x4, or two 4x4 tiles),
// and a warp reads each shared-memory operand as 4 distinct float4s (a
// broadcast) or 8 contiguous ones, one wavefront each: 3 loads feed 32 FMAs.
// The triangular y = scores x pairs rows 4u.. with rows L-4-4u.. in each
// thread, so that every warp does the same work.  A thread issues its global
// loads in batches before it stores any of them to shared memory.  The cumsum
// is a warp scan, a warp a head, in float64 for the differences taken of it;
// the decay exp(cum_i - cum_j) is taken only where i >= j (above the diagonal
// the exponent is positive, overflows to inf, and inf * 0 would be NaN).  N
// and P are padded to a multiple of 64 with zeros, and a ragged last chunk
// with x = dt = B = C = 0: a zero dt makes those steps the identity.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 64;            // L
constexpr int kTile = 64;             // N and P are padded to a multiple of this
constexpr int kThreads = 128;         // kernels 1 and 3: 4 warps, 32 outputs of a 64x64 product a thread
constexpr int kWarps = kThreads / 32;
constexpr int kLdt = kChunk + 4;      // row stride of kernel 3's transposed C and B (16-byte rows)
constexpr int kPassThreads = 256;
constexpr int kPassDepth = 16;        // chunks whose loads the pass keeps in flight
constexpr double kLog2e = 1.4426950408889634;
// the cumsum takes 2 steps a lane of one warp; 4 warps of 8 x 16 tiles cover a 64x64 product
static_assert(kChunk == 64 && kTile == 64 && kThreads == 128, "a 64-step chunk for 4 warps");

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }
// four consecutive outputs at a 4-element aligned offset
__device__ __forceinline__ void store4(float* p, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float a, float b, float c, float d) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(a, b), hi = __floats2bfloat162_rn(c, d);
  uint2 u;
  u.x = *reinterpret_cast<unsigned*>(&lo);
  u.y = *reinterpret_cast<unsigned*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}
// outputs p .. p+3 of a row of P, those that lie inside it
template <typename T>
__device__ __forceinline__ void store_cols(T* row, int p, int P, float a, float b, float c, float d) {
  if (P % 4 == 0 && p + 4 <= P) {
    store4(row + p, a, b, c, d);
    return;
  }
  if (p < P) store_f(row + p, a);
  if (p + 1 < P) store_f(row + p + 1, b);
  if (p + 2 < P) store_f(row + p + 2, c);
  if (p + 3 < P) store_f(row + p + 3, d);
}

__host__ __device__ __forceinline__ int padded(int n) { return (n + kTile - 1) / kTile * kTile; }

__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }

// Copies `total` elements with the block's threads, K a thread at a time: a
// thread issues its K loads before its first store waits on one, so that it
// keeps K loads in flight rather than one.
template <int K, typename Load, typename Store>
__device__ __forceinline__ void copy_batched(int total, int tid, Load load, Store store) {
  for (int base = tid; base < total; base += K * kThreads) {
    decltype(load(0)) v[K];
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (base + k * kThreads < total) v[k] = load(base + k * kThreads);
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (base + k * kThreads < total) store(base + k * kThreads, v[k]);
  }
}

// 8 consecutive elements of x from a 16-byte aligned address, as loaded and widened to float
struct Float8 {
  float4 lo, hi;
};
__device__ __forceinline__ Float8 raw8(const float* p) { return {ld4(p), ld4(p + 4)}; }
__device__ __forceinline__ uint4 raw8(const __nv_bfloat16* p) { return *reinterpret_cast<const uint4*>(p); }
__device__ __forceinline__ void widen(const Float8& r, float (&v)[8]) {
  v[0] = r.lo.x; v[1] = r.lo.y; v[2] = r.lo.z; v[3] = r.lo.w;
  v[4] = r.hi.x; v[5] = r.hi.y; v[6] = r.hi.z; v[7] = r.hi.w;
}
__device__ __forceinline__ void widen(const uint4& u, float (&v)[8]) {
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {  // a bf16 is the high half of the float it widens to
    v[2 * k] = __uint_as_float(w[k] << 16);
    v[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
  }
}

// log2 of a padded width (64 or 128)
__device__ __forceinline__ int log2_width(int padded_width) { return padded_width == 64 ? 6 : 7; }

// dst [L, PP] = x of head h over the chunk as float, row j times scale[j] (if
// given); zeros past nl steps and P columns.  8 elements a load where P allows.
template <typename T>
__device__ __forceinline__ void load_x(float* dst, const T* __restrict__ x, long long row0, int nl, int H, int h,
                                       int P, int PP, const float* scale, int tid) {
  if (P % 8 == 0 && (reinterpret_cast<size_t>(x) & 15) == 0) {
    const int sh = log2_width(PP) - 3;  // 8-element groups a row: 1 << sh
    using Raw = decltype(raw8(x));
    copy_batched<4>(
        kChunk << sh, tid,
        [&](int e) {
          const int j = e >> sh, p = (e & ((1 << sh) - 1)) * 8;
          Raw r{};
          if (j < nl && p < P) r = raw8(x + ((row0 + j) * H + h) * P + p);
          return r;
        },
        [&](int e, const Raw& r) {
          const int j = e >> sh, p = (e & ((1 << sh) - 1)) * 8;
          float v[8];
          widen(r, v);
          const float f = scale ? scale[j] : 1.0f;
          float4* d = reinterpret_cast<float4*>(dst + j * PP + p);
          d[0] = make_float4(f * v[0], f * v[1], f * v[2], f * v[3]);
          d[1] = make_float4(f * v[4], f * v[5], f * v[6], f * v[7]);
        });
  } else {
    for (int e = tid; e < kChunk * PP; e += kThreads) {
      const int j = e / PP, p = e % PP;
      dst[e] = (j < nl && p < P) ? (scale ? scale[j] : 1.0f) * load_f(x + ((row0 + j) * H + h) * P + p) : 0.0f;
    }
  }
}

// calls put(j, n, v) with 4 consecutive columns n.. of each row j of a [L, NP]
// tile of B or C, read 4 floats a load where N allows; zeros past nl steps and
// N columns
template <typename F>
__device__ __forceinline__ void load_rows(const float* __restrict__ m, long long row0, int nl, int N, int NP, int tid,
                                          F put) {
  const bool vec = N % 4 == 0 && (reinterpret_cast<size_t>(m) & 15) == 0;
  const int sh = log2_width(NP) - 2;  // 4-element groups a row: 1 << sh
  copy_batched<8>(
      kChunk << sh, tid,
      [&](int e) {
        const int j = e >> sh, n = (e & ((1 << sh) - 1)) * 4;
        float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (j < nl) {
          const float* src = m + (row0 + j) * N + n;
          if (vec) {
            if (n < N) v = ld4(src);
          } else {
            v.x = n < N ? src[0] : 0.0f;
            v.y = n + 1 < N ? src[1] : 0.0f;
            v.z = n + 2 < N ? src[2] : 0.0f;
            v.w = n + 3 < N ? src[3] : 0.0f;
          }
        }
        return v;
      },
      [&](int e, float4 v) { put(e >> sh, (e & ((1 << sh) - 1)) * 4, v); });
}

// acc[r][q] += a[r] b[q]
__device__ __forceinline__ void outer4(float (&acc)[4][4], float4 a, float4 b) {
  const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[r][q] = fmaf(av[r], bv[q], acc[r][q]);
}

// cum[j] = sum_{t <= j} dt[t] a over the chunk, by one warp: lane l holds steps
// 2l and 2l+1 (d0, d1), and a shuffle scan adds the lanes below.  In float64:
// the decays are exponentials of differences cum_i - cum_j, which float32
// would take to within an ulp of |cum| (~1e-5 at |cum| ~ 200), and exp(0) must
// stay 1 where a ragged chunk's padded steps add zeros in another order.  Both
// kernels that need cum call this, so they see the same one.
__device__ __forceinline__ void chunk_cumsum(float d0, float d1, float a, int lane, double& c0, double& c1) {
  const double a0 = static_cast<double>(d0) * a;  // exact: a product of two floats
  const double a1 = a0 + static_cast<double>(d1) * a;
  double run = a1;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const double v = __shfl_up_sync(0xffffffffu, run, d);
    if (lane >= d) run += v;
  }
  double below = __shfl_up_sync(0xffffffffu, run, 1);
  if (lane == 0) below = 0.0;
  c0 = below + a0;
  c1 = below + a1;
}

// v as a float and the float left over: their sum keeps v's digits, and the
// difference of two such pairs, taken part by part, is accurate to a float
// ulp of the difference itself, not of v
__device__ __forceinline__ float2 split_float(double v) {
  const float hi = static_cast<float>(v);
  return make_float2(hi, static_cast<float>(v - hi));
}

// dt of steps 2 lane and 2 lane + 1 of head h, zero past the chunk's nl steps
__device__ __forceinline__ void load_dt_pair(const float* __restrict__ dt, long long row0, int nl, int H, int h,
                                             int lane, float& d0, float& d1) {
  d0 = 2 * lane < nl ? dt[(row0 + 2 * lane) * H + h] : 0.0f;
  d1 = 2 * lane + 1 < nl ? dt[(row0 + 2 * lane + 1) * H + h] : 0.0f;
}

// A thread's place in a 64x64 product, 32 outputs of it: a warp covers 4 row
// groups x 8 column groups, so each operand it reads from shared memory is 4
// distinct float4s (a broadcast) or 8 contiguous ones: one wavefront each.
__device__ __forceinline__ int group_row(int warp, int lane) { return (warp >> 1) * 4 + (lane >> 3); }  // 0..7
__device__ __forceinline__ int group_col(int warp, int lane) { return (warp & 1) * 8 + (lane & 7); }   // 0..15

// ------------------------------------------------------------------------- //
// 1. chunk states: dS_c [NP, PP] and exp(cum_L) of each (batch, chunk, head)
// ------------------------------------------------------------------------- //
template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_chunk_states_kernel(const T* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ A,
                        const float* __restrict__ Bm, float* __restrict__ states, float* __restrict__ decays,
                        int S, int H, int P, int N, int hpb) {
  extern __shared__ float4 smem4[];
  const int NP = padded(N), PP = padded(P);
  float* bs = reinterpret_cast<float*>(smem4);  // [L, NP] B
  float* wx = bs + kChunk * NP;                  // [L, PP] exp(cum_L - cum_j) dt_j x_j of one head
  float* w = wx + kChunk * PP;                   // [hpb, L] exp(cum_L - cum_j) dt_j of each head

  const int c = blockIdx.x, nc = gridDim.x, b = blockIdx.z;
  const int c0 = c * kChunk, nl = min(kChunk, S - c0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long row0 = static_cast<long long>(b) * S + c0;  // the chunk's first step
  const int h0 = blockIdx.y * hpb, nh = min(hpb, H - h0);

  load_rows(Bm, row0, nl, N, NP, tid,
            [&](int j, int n, float4 v) { *reinterpret_cast<float4*>(bs + j * NP + n) = v; });
  for (int k = warp; k < nh; k += kWarps) {  // a warp a head: its weights and the chunk's decay
    float d0, d1;
    double cum0, cum1;
    load_dt_pair(dt, row0, nl, H, h0 + k, lane, d0, d1);
    chunk_cumsum(d0, d1, A[h0 + k], lane, cum0, cum1);
    const double last = __shfl_sync(0xffffffffu, cum1, 31);  // padded steps leave cum unchanged
    w[k * kChunk + 2 * lane] = expf(static_cast<float>(last - cum0)) * d0;
    w[k * kChunk + 2 * lane + 1] = expf(static_cast<float>(last - cum1)) * d1;
    if (lane == 31) decays[(static_cast<long long>(b) * nc + c) * H + h0 + k] = expf(static_cast<float>(last));
  }
  // this thread's 8x4 tile of each 64x64 tile of dS: rows n = 8 ry.., columns p = 4 cx..
  const int ry = group_row(warp, lane), cx = group_col(warp, lane);
  for (int k = 0; k < nh; ++k) {
    __syncthreads();  // B and w are in; the previous head's product is done with wx
    load_x(wx, x, row0, nl, H, h0 + k, P, PP, w + k * kChunk, tid);
    __syncthreads();
    float* out = states + ((static_cast<long long>(b) * nc + c) * H + h0 + k) * NP * PP;
    for (int n0 = 0; n0 < NP; n0 += kTile) {
      for (int p0 = 0; p0 < PP; p0 += kTile) {
        float lo[4][4] = {}, hi[4][4] = {};
#pragma unroll 4
        for (int j = 0; j < kChunk; ++j) {
          const float* a = bs + j * NP + n0 + 8 * ry;
          const float4 v = ld4(wx + j * PP + p0 + 4 * cx);
          outer4(lo, ld4(a), v);
          outer4(hi, ld4(a + 4), v);
        }
        float* o = out + (n0 + 8 * ry) * PP + p0 + 4 * cx;
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          store4(o + r * PP, lo[r][0], lo[r][1], lo[r][2], lo[r][3]);
          store4(o + (r + 4) * PP, hi[r][0], hi[r][1], hi[r][2], hi[r][3]);
        }
      }
    }
  }
}

// ------------------------------------------------------------------------- //
// 2. state pass: the state entering each chunk (over dS_c) and the final state
// ------------------------------------------------------------------------- //
__global__ void __launch_bounds__(kPassThreads)
ssd_state_pass_kernel(float* __restrict__ states, const float* __restrict__ decays, float* __restrict__ state_out,
                      int nc, int H, int P, int N) {
  const int NP = padded(N), PP = padded(P);
  const int quads = NP * PP / 4;
  const int e = blockIdx.x * kPassThreads + threadIdx.x;  // this thread's float4 of [NP, PP]
  const int h = blockIdx.y, b = blockIdx.z;
  if (e >= quads) return;
  float4* st = reinterpret_cast<float4*>(states) + (static_cast<long long>(b) * nc * H + h) * quads + e;
  const float* dec = decays + static_cast<long long>(b) * nc * H + h;
  const long long step = static_cast<long long>(H) * quads;  // from one chunk to the next
  float4 s = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int c0 = 0; c0 < nc; c0 += kPassDepth) {
    float4 v[kPassDepth];
    float d[kPassDepth];
#pragma unroll
    for (int u = 0; u < kPassDepth; ++u) {
      if (c0 + u < nc) {
        v[u] = __ldcs(st + (c0 + u) * step);  // dS's last use: evicted first from L2
        d[u] = dec[static_cast<long long>(c0 + u) * H];
      }
    }
#pragma unroll
    for (int u = 0; u < kPassDepth; ++u) {
      if (c0 + u < nc) {
        st[(c0 + u) * step] = s;
        s = make_float4(fmaf(d[u], s.x, v[u].x), fmaf(d[u], s.y, v[u].y), fmaf(d[u], s.z, v[u].z),
                        fmaf(d[u], s.w, v[u].w));
      }
    }
  }
  const int n = 4 * e / PP, p = 4 * e % PP;
  if (n >= N) return;
  float* so = state_out + ((static_cast<long long>(b) * H + h) * N + n) * P;
  const float sv[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
  for (int q = 0; q < 4; ++q)
    if (p + q < P) so[p + q] = sv[q];
}

// ------------------------------------------------------------------------- //
// 3. chunk outputs: y = (CB o decay o dt) x + exp(cum) (C S_{c-1})
// ------------------------------------------------------------------------- //
template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_chunk_outputs_kernel(const T* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ A,
                         const float* __restrict__ Bm, const float* __restrict__ Cm,
                         const float* __restrict__ states, T* __restrict__ y, int S, int H, int P, int N,
                         int hpb) {
  extern __shared__ float4 smem4[];
  const int NP = padded(N), PP = padded(P);
  float* ct = reinterpret_cast<float*>(smem4);  // [NP, kLdt] C^T
  float* xs = ct + NP * kLdt;                    // [L, PP] x of one head
  float* ss = xs + kChunk * PP;                  // [NP, PP] the state entering the chunk, one head
  float* bt = xs;                                // [NP, kLdt] B^T, over xs and ss until C B^T is taken
  float* sct = ss + NP * PP;                     // [L, L] scores of one head, transposed: sct[j L + i]
  float2* cum = reinterpret_cast<float2*>(sct + kChunk * kChunk);  // [hpb, L] cum log2(e) of each head, hi + lo
  float* dts = reinterpret_cast<float*>(cum + hpb * kChunk);        // [hpb, L]
  float* ecum = dts + hpb * kChunk;                                  // [hpb, L] exp(cum)

  const int c = blockIdx.x, nc = gridDim.x, b = blockIdx.z;
  const int c0 = c * kChunk, nl = min(kChunk, S - c0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long row0 = static_cast<long long>(b) * S + c0;
  const int h0 = blockIdx.y * hpb, nh = min(hpb, H - h0);

  const auto transpose_into = [](float* t) {
    return [t](int j, int n, float4 v) {
      t[n * kLdt + j] = v.x;
      t[(n + 1) * kLdt + j] = v.y;
      t[(n + 2) * kLdt + j] = v.z;
      t[(n + 3) * kLdt + j] = v.w;
    };
  };
  load_rows(Cm, row0, nl, N, NP, tid, transpose_into(ct));
  load_rows(Bm, row0, nl, N, NP, tid, transpose_into(bt));
  for (int k = warp; k < nh; k += kWarps) {  // a warp a head
    float d0, d1;
    double cum0, cum1;
    load_dt_pair(dt, row0, nl, H, h0 + k, lane, d0, d1);
    chunk_cumsum(d0, d1, A[h0 + k], lane, cum0, cum1);
    const int i = k * kChunk + 2 * lane;
    cum[i] = split_float(cum0 * kLog2e);
    cum[i + 1] = split_float(cum1 * kLog2e);
    dts[i] = d0;
    dts[i + 1] = d1;
    ecum[i] = expf(static_cast<float>(cum0));
    ecum[i + 1] = expf(static_cast<float>(cum1));
  }
  __syncthreads();
  // C B^T once for the block's heads: this thread's 8x4 tile, rows i = 8 ry.., columns j = 4 cx..
  const int ry = group_row(warp, lane), cx = group_col(warp, lane);
  const bool above = (warp >> 1) < (warp & 1);  // warp 1's tiles, rows 0..31 by columns 32..63
  float cb[2][4][4] = {};  // rows 8 ry + 4 g + r
#pragma unroll 4
  for (int n = 0; n < NP; ++n) {
    const float4 v = ld4(bt + n * kLdt + 4 * cx);
    outer4(cb[0], ld4(ct + n * kLdt + 8 * ry), v);
    outer4(cb[1], ld4(ct + n * kLdt + 8 * ry + 4), v);
  }

  // y: rows 4u.. (upper) and L-4-4u.. (lower) by columns 4 cg.. of each 64-column
  // tile.  A warp's upper rows end below ja_end and its lower rows below jb_end,
  // so scores[i, j] is 0 past those for all of its threads: every warp does the
  // same work on the triangle.
  const int u = group_row(warp, lane), cg = group_col(warp, lane);
  const int iu = 4 * u, id = kChunk - 4 - 4 * u;
  const int ja_end = 16 * (warp >> 1) + 16, jb_end = kChunk - 16 * (warp >> 1);

  for (int k = 0; k < nh; ++k) {
    const int h = h0 + k;
    __syncthreads();  // C B^T is taken (bt is free); the previous head is done with xs, ss, sct
    load_x(xs, x, row0, nl, H, h, P, PP, static_cast<const float*>(nullptr), tid);
    const float4* src = reinterpret_cast<const float4*>(states) +
                        ((static_cast<long long>(b) * nc + c) * H + h) * (NP * PP / 4);
    copy_batched<8>(NP * PP / 4, tid, [&](int e) { return src[e]; },
                    [&](int e, float4 v) { reinterpret_cast<float4*>(ss)[e] = v; });
    // scores from this thread's C B^T tile, stored transposed; the decay only where i >= j
    const float2* cm = cum + k * kChunk;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j = 4 * cx + q;
      const float dj = dts[k * kChunk + j];
      float v[8];
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int i = 8 * ry + r;
        v[r] = i >= j && !above ? cb[r >> 2][r & 3][q] * exp2f((cm[i].x - cm[j].x) + (cm[i].y - cm[j].y)) * dj
                                : 0.0f;
      }
      store4(sct + j * kChunk + 8 * ry, v[0], v[1], v[2], v[3]);
      store4(sct + j * kChunk + 8 * ry + 4, v[4], v[5], v[6], v[7]);
    }
    __syncthreads();
    for (int p0 = 0; p0 < PP; p0 += kTile) {
      const int p = p0 + 4 * cg;
      float up[4][4] = {}, dn[4][4] = {};
      // the carried state: C S_{c-1}, then scaled by exp(cum_i)
#pragma unroll 4
      for (int n = 0; n < NP; ++n) {
        const float4 v = ld4(ss + n * PP + p);
        outer4(up, ld4(ct + n * kLdt + iu), v);
        outer4(dn, ld4(ct + n * kLdt + id), v);
      }
      const float* ec = ecum + k * kChunk;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          up[r][q] *= ec[iu + r];
          dn[r][q] *= ec[id + r];
        }
      }
      // the chunk's own steps: scores x, both row groups up to ja_end, the lower one alone after
#pragma unroll 4
      for (int j = 0; j < ja_end; ++j) {
        const float4 v = ld4(xs + j * PP + p);
        outer4(up, ld4(sct + j * kChunk + iu), v);
        outer4(dn, ld4(sct + j * kChunk + id), v);
      }
#pragma unroll 4
      for (int j = ja_end; j < jb_end; ++j) outer4(dn, ld4(sct + j * kChunk + id), ld4(xs + j * PP + p));
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        if (iu + r < nl) store_cols(y + ((row0 + iu + r) * H + h) * P, p, P, up[r][0], up[r][1], up[r][2], up[r][3]);
        if (id + r < nl) store_cols(y + ((row0 + id + r) * H + h) * P, p, P, dn[r][0], dn[r][1], dn[r][2], dn[r][3]);
      }
    }
  }
}

size_t states_smem_bytes(int P, int N, int hpb) {
  return (static_cast<size_t>(kChunk) * (padded(N) + padded(P)) + static_cast<size_t>(hpb) * kChunk) * sizeof(float);
}

size_t outputs_smem_bytes(int P, int N, int hpb) {
  const size_t NP = padded(N), PP = padded(P);
  // cum (float64), dts and exp(cum) of each head: 4 floats a step
  return (NP * kLdt + kChunk * PP + NP * PP + kChunk * kChunk + 4 * static_cast<size_t>(hpb) * kChunk) *
         sizeof(float);
}

template <typename T>
int launch_typed(const void* x, const float* dt, const float* A, const float* Bm, const float* Cm, void* y,
                 float* state, float* scratch, int Bt, int S, int H, int P, int N, int hpb, cudaStream_t stream) {
  const int nc = (S + kChunk - 1) / kChunk;
  const int NP = padded(N), PP = padded(P);
  float* states = scratch;  // [Bt, nc, H, NP, PP]
  float* decays = scratch + static_cast<size_t>(Bt) * nc * H * NP * PP;  // [Bt, nc, H]
  const dim3 grid(nc, (H + hpb - 1) / hpb, Bt);
  cudaError_t err;
  if (nc > 0) {
    const size_t bytes = states_smem_bytes(P, N, hpb);
    err = cudaFuncSetAttribute(ssd_chunk_states_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    ssd_chunk_states_kernel<T><<<grid, kThreads, bytes, stream>>>(static_cast<const T*>(x), dt, A, Bm, states,
                                                                  decays, S, H, P, N, hpb);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 pass_grid((NP * PP / 4 + kPassThreads - 1) / kPassThreads, H, Bt);
  ssd_state_pass_kernel<<<pass_grid, kPassThreads, 0, stream>>>(states, decays, state, nc, H, P, N);
  err = cudaGetLastError();
  if (err != cudaSuccess || nc == 0) return static_cast<int>(err);
  const size_t bytes = outputs_smem_bytes(P, N, hpb);
  err = cudaFuncSetAttribute(ssd_chunk_outputs_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_chunk_outputs_kernel<T><<<grid, kThreads, bytes, stream>>>(static_cast<const T*>(x), dt, A, Bm, Cm, states,
                                                                 static_cast<T*>(y), S, H, P, N, hpb);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x [Bt, S, H, P] and y (bf16 != 0: bfloat16, else float32); dt [Bt, S, H], A [H],
// B and C [Bt, S, N], state [Bt, H, N, P] float32; all contiguous.  N, P <= 128.
// scratch: float32, Bt ceil(S / 64) H (NP PP + 1) elements, NP and PP being N
// and P rounded up to a multiple of 64.  hpb: heads a block of kernels 1 and 3.
extern "C" int ssd_chunk_scan_launch(const void* x, const float* dt, const float* A, const float* Bm,
                                     const float* Cm, void* y, float* state, float* scratch, int Bt, int S,
                                     int H, int P, int N, int bf16, int hpb, void* stream) {
  if (Bt <= 0 || H <= 0) return 0;
  if (P <= 0 || N <= 0 || P > 128 || N > 128 || S < 0 || hpb <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) return launch_typed<__nv_bfloat16>(x, dt, A, Bm, Cm, y, state, scratch, Bt, S, H, P, N, hpb, s);
  return launch_typed<float>(x, dt, A, Bm, Cm, y, state, scratch, Bt, S, H, P, N, hpb, s);
}
