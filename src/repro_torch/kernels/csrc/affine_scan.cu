// The DSim mapper's two Alg.-7 carries as one block-per-row scan, forward and
// backward, and the bare first-order affine scan, over the last axis of [R, V]
// float32 arrays.
//
// Replaces the TPU kernel src/repro/kernels/sscan.py::_affine_scan_pallas
// (_affine_scan_kernel, with its VJP) and, in the same launch, what the
// reference computes in plain JAX beside it, core/mapper.py::
// minaffine_prefix_assoc.  Per row, with s and t the states before vertex j:
//
//   occupancy   s' = min(occ_decay*s + alloc_j, cap)    (min-affine)
//   bandwidth   t' = bw_decay*t + bw_gain*x_j            (affine)
//
// mapper_carries writes the exclusive prefixes occ_prev_j = s, bw_prev_j = t
// (0 at vertex 0) and a clamp code per vertex, 2*m_j with m_j = d s'/d u for
// u = occ_decay*s + alloc_j: 1 where u < cap, 0 where u > cap, 1/2 on a tie
// (torch.minimum's split).  mapper_carries_backward is the closed form of the
// gradient as one reverse scan, from the codes the forward decided:
//
//   lambda_j = g_occ[j+1] + occ_decay*m_{j+1}*lambda_{j+1}   (lambda_{V-1} = 0)
//   grad_alloc_j = m_j*lambda_j,  grad_cap = sum_j (1 - m_j)*lambda_j
//   mu_j = g_bw[j+1] + bw_decay*mu_{j+1},  grad_x_j = bw_gain*mu_j
//
// affine_scan_launch is the bare inclusive scan s_i = decay*s_{i-1} + b_i
// (optionally from the end of each row): the forward kernel with the
// occupancy carry compiled out.
//
// What bounds it on an H100: neither bytes nor operations.  At the mapper's
// shapes ([1..11, 256..1024]) a call moves tens of kilobytes, so its time is
// the latency of its dependent steps.  Design: one block a row, a loop over
// tiles of 4 elements a thread (1,024 a tile at 256 threads) in place of the
// TPU's sequential grid.  A thread issues all its loads of a tile (and of the
// next tile, before this one's scan) at once, composes its 4 elements' maps in
// registers, the warp scans the composed maps with shuffles, the warp totals
// cross through shared memory with one barrier, and each thread applies the
// totals of the warps before it to the state entering the tile, then walks
// its own elements in order, which is the sequential recurrence itself.  So a
// row of 1,024 takes one memory round trip, where a warp walking it in
// chunks of 32 took 32.  Composing min-affine maps, later (a2,b2,c2) after
// earlier (a1,b1,c1) = (a1*a2, a2*b1 + b2, min(a2*c1 + b2, c2)), needs
// a2 >= 0: the wrapper refuses a negative occ_decay.  Built with
// --fmad=false: every product and sum rounds on its own, as in the plain
// PyTorch versions, since the mapper's ceil turns one ulp into whole cycles.
// Finite inputs: a NaN is not carried as torch.minimum would carry it.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kPer = 4;            // elements a thread holds in a tile
constexpr int kThreads = 256;      // most threads a block
constexpr int kWarps = kThreads / kWarp;
constexpr unsigned kAll = 0xffffffffu;

struct Aff {  // s -> a*s + b
  float a, b;
};
struct MinAff {  // s -> min(a*s + b, c)
  float a, b, c;
};

// `l` after `e`
__device__ __forceinline__ Aff then(Aff e, Aff l) { return {e.a * l.a, l.a * e.b + l.b}; }
__device__ __forceinline__ MinAff then(MinAff e, MinAff l) {
  return {e.a * l.a, l.a * e.b + l.b, fminf(l.a * e.c + l.b, l.c)};
}
__device__ __forceinline__ float apply(Aff m, float s) { return m.a * s + m.b; }
__device__ __forceinline__ float apply(MinAff m, float s) { return fminf(m.a * s + m.b, m.c); }
__device__ __forceinline__ Aff shfl_up(Aff m, int d) {
  return {__shfl_up_sync(kAll, m.a, d), __shfl_up_sync(kAll, m.b, d)};
}
__device__ __forceinline__ MinAff shfl_up(MinAff m, int d) {
  return {__shfl_up_sync(kAll, m.a, d), __shfl_up_sync(kAll, m.b, d), __shfl_up_sync(kAll, m.c, d)};
}

// Inclusive scan of the lanes' maps (Hillis-Steele; lanes below the shift are
// complete, so no identity is composed).
template <class M>
__device__ __forceinline__ M warp_inclusive(M m, int lane) {
#pragma unroll
  for (int d = 1; d < kWarp; d <<= 1) {
    const M p = shfl_up(m, d);
    if (lane >= d) m = then(p, m);
  }
  return m;
}

// After the barrier: the state entering this thread's elements, from the
// state entering the tile (`carry`), the warp totals `tot` and the thread's
// exclusive in-warp prefix `ex` (none for lane 0).  The totals are applied
// one by one, never composed, so no identity meets an infinite bound.
// `carry` becomes the state leaving the tile.
template <class M>
__device__ __forceinline__ float enter(const M* tot, M ex, int lane, int warp, int warps, float& carry) {
  float s = carry, mine = carry;
  for (int w = 0; w < warps; ++w) {
    if (w == warp) mine = s;
    s = apply(tot[w], s);
  }
  carry = s;
  return lane == 0 ? mine : apply(ex, mine);
}

// Forward.  kOcc: both carries (mapper_carries, exclusive); without it the
// bare affine scan of x (bw_decay the decay, bw_gain 1, inclusive, reverse
// as asked).  Inputs are read through (row, element) strides, a row stride of
// 0 broadcasting one row over all; outputs are contiguous [R, V].
template <bool kOcc>
__global__ void __launch_bounds__(kThreads) carries_kernel(
    const float* __restrict__ alloc, long long a_rs, long long a_cs, const float* __restrict__ x,
    long long x_rs, long long x_cs, const float* __restrict__ cap, long long cap_s, float* __restrict__ occ_out,
    float* __restrict__ x_out, uint8_t* __restrict__ code, int V, float occ_decay, float bw_decay, float bw_gain,
    int inclusive, int reverse) {
  __shared__ MinAff occ_tot[2][kWarps];  // two buffers: one barrier a tile
  __shared__ Aff x_tot[2][kWarps];
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp, warps = blockDim.x / kWarp;
  const long long row = blockIdx.x;
  const int span = blockDim.x * kPer;
  alloc += row * a_rs;
  x += row * x_rs;
  const long long out = row * V;
  const float c = kOcc ? cap[row * cap_s] : 0.0f;

  float al[kPer], xv[kPer], al_n[kPer], xv_n[kPer];
  auto load = [&](int base, float* a_dst, float* x_dst) {
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int p = base + threadIdx.x * kPer + k;  // position along the scan
      const long long j = reverse ? V - 1 - p : p;  // position in the row
      const bool live = p < V;
      x_dst[k] = live ? x[j * x_cs] : 0.0f;
      if constexpr (kOcc) a_dst[k] = live ? alloc[j * a_cs] : 0.0f;
    }
  };
  load(0, al_n, xv_n);
  float occ_carry = 0.0f, x_carry = 0.0f;
  for (int base = 0, it = 0; base < V; base += span, it ^= 1) {
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      al[k] = al_n[k];
      xv[k] = xv_n[k];
    }
    if (base + span < V) load(base + span, al_n, xv_n);  // in flight during this tile's scan

    const int first = base + threadIdx.x * kPer;
    MinAff om = {1.0f, 0.0f, INFINITY};  // identity; dead threads keep it, and come last
    Aff xm = {1.0f, 0.0f};
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      xv[k] = bw_gain * xv[k];
      if (first + k < V) {
        xm = then(xm, Aff{bw_decay, xv[k]});
        if constexpr (kOcc) om = then(om, MinAff{occ_decay, al[k], c});
      }
    }
    const Aff xi = warp_inclusive(xm, lane), xe = shfl_up(xi, 1);
    MinAff oi, oe;
    if (lane == kWarp - 1) x_tot[it][warp] = xi;
    if constexpr (kOcc) {
      oi = warp_inclusive(om, lane);
      oe = shfl_up(oi, 1);
      if (lane == kWarp - 1) occ_tot[it][warp] = oi;
    }
    __syncthreads();
    float t = enter(x_tot[it], xe, lane, warp, warps, x_carry);
    float s = 0.0f;
    if constexpr (kOcc) s = enter(occ_tot[it], oe, lane, warp, warps, occ_carry);

#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int p = first + k;
      if (p >= V) break;
      const long long o = out + (reverse ? V - 1 - p : p);
      if (inclusive) {
        t = bw_decay * t + xv[k];
        x_out[o] = t;
      } else {
        x_out[o] = t;
        t = bw_decay * t + xv[k];
      }
      if constexpr (kOcc) {
        occ_out[o] = s;
        const float u = occ_decay * s + al[k];
        code[o] = u < c ? 2 : (u == c ? 1 : 0);
        s = u < c ? u : c;
      }
    }
  }
}

// Backward: one reverse scan of both adjoints.  grad_alloc may be null (not
// written); grad_cap gets one sum a row, reduced in a fixed order.
__global__ void __launch_bounds__(kThreads) carries_backward_kernel(
    const float* __restrict__ g_occ, long long go_rs, long long go_cs, const float* __restrict__ g_bw,
    long long gb_rs, long long gb_cs, const uint8_t* __restrict__ code, float* __restrict__ grad_alloc,
    float* __restrict__ grad_x, float* __restrict__ grad_cap, int V, float occ_decay, float bw_decay,
    float bw_gain) {
  __shared__ Aff occ_tot[2][kWarps], x_tot[2][kWarps];
  __shared__ float part[kWarps];
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp, warps = blockDim.x / kWarp;
  const long long row = blockIdx.x;
  const int span = blockDim.x * kPer;
  g_occ += row * go_rs;
  g_bw += row * gb_rs;
  const long long out = row * V;

  float go[kPer], gb[kPer], m[kPer], go_n[kPer], gb_n[kPer], m_n[kPer];
  auto load = [&](int base, float* go_dst, float* gb_dst, float* m_dst) {
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int p = base + threadIdx.x * kPer + k;  // position along the reverse scan
      const long long j = V - 1 - p;
      const bool live = p < V;
      go_dst[k] = live ? g_occ[j * go_cs] : 0.0f;
      gb_dst[k] = live ? g_bw[j * gb_cs] : 0.0f;
      m_dst[k] = live ? 0.5f * code[out + j] : 0.0f;
    }
  };
  load(0, go_n, gb_n, m_n);
  float occ_carry = 0.0f, x_carry = 0.0f, acc = 0.0f;
  for (int base = 0, it = 0; base < V; base += span, it ^= 1) {
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      go[k] = go_n[k];
      gb[k] = gb_n[k];
      m[k] = m_n[k];
    }
    if (base + span < V) load(base + span, go_n, gb_n, m_n);

    const int first = base + threadIdx.x * kPer;
    Aff om = {1.0f, 0.0f}, xm = {1.0f, 0.0f};
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      if (first + k < V) {
        om = then(om, Aff{occ_decay * m[k], go[k]});
        xm = then(xm, Aff{bw_decay, gb[k]});
      }
    }
    const Aff oi = warp_inclusive(om, lane), oe = shfl_up(oi, 1);
    const Aff xi = warp_inclusive(xm, lane), xe = shfl_up(xi, 1);
    if (lane == kWarp - 1) {
      occ_tot[it][warp] = oi;
      x_tot[it][warp] = xi;
    }
    __syncthreads();
    float lam = enter(occ_tot[it], oe, lane, warp, warps, occ_carry);
    float mu = enter(x_tot[it], xe, lane, warp, warps, x_carry);

#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int p = first + k;
      if (p >= V) break;
      const long long o = out + (V - 1 - p);
      if (grad_alloc) grad_alloc[o] = m[k] * lam;
      acc = acc + (1.0f - m[k]) * lam;
      lam = occ_decay * m[k] * lam + go[k];
      grad_x[o] = bw_gain * mu;
      mu = bw_decay * mu + gb[k];
    }
  }
#pragma unroll
  for (int d = kWarp / 2; d > 0; d >>= 1) acc += __shfl_xor_sync(kAll, acc, d);
  if (lane == 0) part[warp] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    float sum = 0.0f;
    for (int w = 0; w < warps; ++w) sum += part[w];
    grad_cap[row] = sum;
  }
}

// threads a block for a row of V: enough for one tile, whole warps, at most kThreads
int threads_for(int V) {
  const int need = (V + kPer - 1) / kPer;
  const int t = (need + kWarp - 1) / kWarp * kWarp;
  return t < kThreads ? t : kThreads;
}

}  // namespace

extern "C" int affine_scan_launch(const float* b, float* s, int rows, int V, float decay, int reverse,
                                  void* stream) {
  if (rows <= 0 || V <= 0) return 0;
  carries_kernel<false><<<rows, threads_for(V), 0, static_cast<cudaStream_t>(stream)>>>(
      nullptr, 0, 0, b, V, 1, nullptr, 0, nullptr, s, nullptr, V, 0.0f, decay, 1.0f, 1, reverse);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mapper_carries_launch(const float* alloc, long long a_rs, long long a_cs, const float* x,
                                     long long x_rs, long long x_cs, const float* cap, long long cap_s,
                                     float* occ_prev, float* bw_prev, uint8_t* code, int rows, int V,
                                     float occ_decay, float bw_decay, float bw_gain, void* stream) {
  if (rows <= 0 || V <= 0) return 0;
  carries_kernel<true><<<rows, threads_for(V), 0, static_cast<cudaStream_t>(stream)>>>(
      alloc, a_rs, a_cs, x, x_rs, x_cs, cap, cap_s, occ_prev, bw_prev, code, V, occ_decay, bw_decay, bw_gain, 0,
      0);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mapper_carries_backward_launch(const float* g_occ, long long go_rs, long long go_cs,
                                              const float* g_bw, long long gb_rs, long long gb_cs,
                                              const uint8_t* code, float* grad_alloc, float* grad_x,
                                              float* grad_cap, int rows, int V, float occ_decay, float bw_decay,
                                              float bw_gain, void* stream) {
  if (rows <= 0 || V <= 0) return 0;
  carries_backward_kernel<<<rows, threads_for(V), 0, static_cast<cudaStream_t>(stream)>>>(
      g_occ, go_rs, go_cs, g_bw, gb_rs, gb_cs, code, grad_alloc, grad_x, grad_cap, V, occ_decay, bw_decay, bw_gain);
  return static_cast<int>(cudaGetLastError());
}
