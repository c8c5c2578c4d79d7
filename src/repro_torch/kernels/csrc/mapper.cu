// The DSim mapper's two carry-free stages around K1 (core/mapper.py's
// prefix-scan path), for no-gradient calls: R rows (a design against one
// workload graph row) of V vertices each.
//
//   mapper_intrinsics  per (row, vertex) everything MAPVERTEX computes that
//                      does not depend on a carry, and writes only what K1
//                      takes: the bandwidth-EMA input bw_x [R, V];
//   (K1, affine_scan.cu's mapper_carries, runs between them, unchanged)
//   mapper_finish      recomputes the same terms, reads K1's carries occ_prev
//                      and bw_prev [R, V], applies the Alg.-7 prefetch and
//                      streaming gates, the exposed main-memory time and the
//                      integer cycles a tile, and reduces over V to the
//                      MapState fields: planar [5, R] (cycles, t_comp, t_mem,
//                      t_exposed_main, n_tiles) and bw_util [R, 3] (0, gbuf, 0).
//
// They replace no TPU kernel: on the TPU, XLA fused these elementwise chains
// under jit.  Eager PyTorch runs them as ~100 full-size [R, V] passes, each
// writing its intermediate; here the only [R, V] traffic is bw_x out, and
// occ_prev and bw_prev in.  The finish kernel recomputes the carry-free terms
// rather than reading them from the intrinsics kernel: they are ~20 IEEE
// divisions a (row, vertex) on values already in registers, where storing the
// six terms it needs would move another 6 x 4 bytes each way an element.
//
// Layout.  Designs are packed [Hn, 14] (freq, capacity[gbuf], mem_bw[3],
// read + write latency[3], flops_per_cycle[4], sys_x, sys_y), graph rows
// [Gn, V, 16] (n_comp[4], n_read[3], n_write[3], n_alloc[3], dims[3]).  Row r
// is design r / span against graph row r % Gn (core/mapper.py's pack takes
// only the layouts that broadcast so).  A warp holds 32 designs
// against one graph row (where Gn divides span: every layout but one design
// a graph row), so every lane reads the same vertex, the graph loads
// broadcast and every branch on the graph row goes one way.  A block's four
// warps take its 32 rows' vertices in chunks of kChunk, in turns; [R, V]
// arrays go through a per-warp shared tile, so each global access is a run
// of kChunk consecutive vertices of one row.  The finish kernel copies the
// next chunk's carries into a second tile with cp.async while it computes on
// the current one (a quarter off its time at the sweep's shape).
//
// Numerics follow core/mapper.py's _vertex_intrinsics and _vertex_exec op for
// op: --fmad=false and no fast math, so '/' and ceilf are IEEE and nothing is
// contracted; max and min propagate NaN (max.NaN.f32) as torch.maximum does;
// a zero numerator takes no division (quot()).  The straight-through
// estimators' forward values are computed without their surrogates:
//  * ceil_ste(x) = x + (ceil(x) - x) is evaluated literally (two operations),
//    which is ceil(x) exactly for finite x (Sterbenz for x >= 1 or x <= -1;
//    in (0, 1) the sum is 1 + e with |e| <= 2^-25, which rounds to 1) and NaN
//    for an infinite x, as in torch;
//  * a gate s + (h - s), h in {0, 1}, s = sigmoid(...) in [0, 1], is h
//    exactly: h - s and s cancel for h = 0; for h = 1, 1 - s is exact where
//    s >= 1/2 and within 2^-25 of it where s < 1/2, and 1 + e rounds to 1.  The
//    sigmoid's argument (t - x) / (0.1|t| + 1e-30) is NaN only where x is NaN
//    or the threshold t is not finite, and then so is the gate.  So the
//    kernels compare and evaluate no sigmoid.
// A padding vertex (a graph row of +0.0 entries; most of a bucketed stack)
// has terms that depend on the design alone: each thread computes them once
// and takes them for every such row, so those rows cost no division.
// The sums over V run in another order than torch.sum's (each warp's chunks
// in vertex order, then the four warps in turn): the same rows give the same
// bits whatever the layout, and the sums differ from the torch path's by
// float32 rounding (the tests' rtol).  The activity flag sums the graph row's
// entries in order; for the non-negative counts a graph holds, the flag does
// not depend on the order.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kGraphCols = 16;
constexpr int kChwCols = 14;
constexpr int kWarps = 4;
constexpr int kBlock = 32 * kWarps;
constexpr int kChunk = 16;            // vertices a warp takes at once
constexpr int kTile = 32 * (kChunk + 1);  // a warp's [32 rows, kChunk] tile, rows padded against bank conflicts
constexpr int kSums = 6;

// design columns
constexpr int FREQ = 0, CAP = 1, BW = 2, LAT = 5, FPC = 8, SYS_X = 12, SYS_Y = 13;
// graph columns
constexpr int G_COMP = 0, G_READ = 4, G_WRITE = 7, G_ALLOC = 10, G_DIMS = 13;
constexpr int LOCAL = 0, GBUF = 1, MAIN = 2;

__device__ __forceinline__ float nan_max(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}
__device__ __forceinline__ float nan_min(float a, float b) {
  float d;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

// a / b, IEEE.  A zero numerator would take the division's slow path (a call)
// though its quotient is known: a zero whose sign is the signs' xor, or NaN
// where b is 0 or NaN (as popsim.cu).
__device__ __forceinline__ float quot(float a, float b) {
  if (a != 0.f) return a / b;
  return (b == 0.f || b != b) ? __int_as_float(0x7fffffff)
                              : __int_as_float((__float_as_int(a) ^ __float_as_int(b)) & 0x80000000);
}

// an asynchronous 4-byte copy from device to shared memory (cp.async), and its group fences
__device__ __forceinline__ void copy_async(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void copy_commit() { asm volatile("cp.async.commit_group;"); }
__device__ __forceinline__ void copy_wait_all_but_last() { asm volatile("cp.async.wait_group 1;"); }

// the straight-through ceil's forward value, as torch computes it
__device__ __forceinline__ float ceil_ste(float x) { return x + (ceilf(x) - x); }

// a hard gate's forward value: 1 where x < t, NaN where the surrogate is NaN
__device__ __forceinline__ float gate_below(float x, float t) {
  if (x != x || !isfinite(t)) return __int_as_float(0x7fffffff);
  return x < t ? 1.f : 0.f;
}

struct Design {
  float freq, cap_h, sys_x, sys_y, fill, rate_sys;
  float eff[3];  // classes 1..3: max(flops_per_cycle, 1e-9) * freq
  float bw[3], lat[3];
};

__device__ __forceinline__ Design load_design(const float* __restrict__ c, float headroom) {
  Design z;
  z.freq = c[FREQ];
  z.cap_h = c[CAP] * headroom;
  z.sys_x = c[SYS_X];
  z.sys_y = c[SYS_Y];
  z.fill = z.sys_x + z.sys_y;
  z.rate_sys = nan_max(c[FPC], 1e-9f);
#pragma unroll
  for (int k = 0; k < 3; ++k) z.eff[k] = nan_max(c[FPC + 1 + k], 1e-9f) * z.freq;
#pragma unroll
  for (int l = 0; l < 3; ++l) {
    z.bw[l] = c[BW + l];
    z.lat[l] = c[LAT + l];
  }
  return z;
}

// the carry-free terms of one (design, vertex): _vertex_intrinsics
struct Terms {
  float tiles, alloc, t_comp, t_onchip, t_main, t_core, t_full, used_bw, bw_x, active;
};

// a graph row: q[0] comp[0..3]; q[1] read[0..2], write[0]; q[2] write[1..2],
// alloc[0..1]; q[3] alloc[2], M, N, K
struct Row {
  float4 q[4];
};

__device__ __forceinline__ Row load_row(const float* __restrict__ row) {
  Row w;
#pragma unroll
  for (int k = 0; k < 4; ++k) w.q[k] = __ldg(reinterpret_cast<const float4*>(row) + k);
  return w;
}

// every entry +0.0: a padding vertex, whose terms depend on the design alone
__device__ __forceinline__ bool is_zero(const Row& w) {
  unsigned bits = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k)
    bits |= __float_as_uint(w.q[k].x) | __float_as_uint(w.q[k].y) | __float_as_uint(w.q[k].z) |
            __float_as_uint(w.q[k].w);
  return bits == 0;
}

__device__ __forceinline__ Terms vertex_terms(const Row& w, const Design& z) {
  const float4 q0 = w.q[0], q1 = w.q[1], q2 = w.q[2], q3 = w.q[3];
  const float comp[4] = {q0.x, q0.y, q0.z, q0.w};
  const float rd[3] = {q1.x, q1.y, q1.z}, wr[3] = {q1.w, q2.x, q2.y}, al[3] = {q2.z, q2.w, q3.x};
  const float M = q3.y, N = q3.z, K = q3.w;

  Terms t;
  t.alloc = al[GBUF];
  // tiling (MAPVERTEX split)
  const float tiles = nan_max(ceil_ste(quot(al[GBUF], z.cap_h)), 1.f);
  t.tiles = tiles;

  // systolic wave model, kept by torch's select only where the class has work
  const float ops_sys_tile = quot(comp[0], tiles);
  float t_sys = 0.f;
  if (ops_sys_tile > 0.f) {
    const float m_t = nan_max(quot(M, tiles), 1.f);
    const float waves_m = ceil_ste(m_t / z.sys_x);
    const float waves_n = ceil_ste(nan_max(N, 1.f) / z.sys_y);
    const float k_cycles = ceil_ste(nan_max(K, 1.f));
    float cyc = waves_m * waves_n * (k_cycles + z.fill);
    cyc = nan_max(cyc, ops_sys_tile / z.rate_sys);
    t_sys = tiles * cyc / z.freq;
  }
  float t_other = 0.f;  // the systolic class's slot is zeroed
#pragma unroll
  for (int k = 0; k < 3; ++k) t_other = nan_max(t_other, quot(comp[k + 1], z.eff[k]));
  t.t_comp = nan_max(t_other, t_sys);

  // memory time per level
  float t_lvl[3];
#pragma unroll
  for (int l = 0; l < 3; ++l) t_lvl[l] = quot(rd[l] + wr[l], z.bw[l]) * 1.04f;
  t.t_onchip = nan_max(t_lvl[GBUF] + tiles * z.lat[GBUF], t_lvl[LOCAL]);
  t.t_main = t_lvl[MAIN] + tiles * z.lat[MAIN] * (al[MAIN] > 0.f ? 1.f : 0.f);
  t.t_core = nan_max(t.t_comp, t.t_onchip);

  // the demanded (no-overlap) bandwidth utilization, the EMA's input
  t.t_full = tiles * ceil_ste((t.t_core + t.t_main) * z.freq / nan_max(tiles, 1.f)) / z.freq;
  t.used_bw = 0.f;
  if (t.t_full > 0.f) t.used_bw = quot(quot(rd[GBUF] + wr[GBUF], nan_max(t.t_full, 1e-30f)), z.bw[GBUF]);
  t.bw_x = nan_min(nan_max(t.used_bw, 0.f), 2.f);

  const float mass = (((comp[0] + comp[1]) + comp[2]) + comp[3]) + ((rd[0] + rd[1]) + rd[2]) +
                     ((wr[0] + wr[1]) + wr[2]) + ((al[0] + al[1]) + al[2]);
  t.active = mass > 0.f ? 1.f : 0.f;
  return t;
}

struct Args {
  const float* graph;  // [Gn, V, kGraphCols]
  const float* chw;    // [Hn, kChwCols]
  const float* occ;    // [R, V] (finish)
  const float* bwp;    // [R, V] (finish)
  float* bw_x;         // [R, V] (intrinsics)
  float* sums;         // [5, R] (finish)
  float* bw_util;      // [R, 3] (finish)
  long long R, span, Gn, Hn;
  int V;
  float headroom, prefetch, streaming;
};

// Block b takes designs 32 * (b % groups) + lane against row-in-span b / groups.
template <bool kFinish>
__global__ void __launch_bounds__(kBlock) mapper_kernel(const Args a) {
  // intrinsics: a tile a warp; finish: two buffers of (occ_prev, bw_prev) tiles a warp
  constexpr int kTiles = kFinish ? 4 : 1;
  __shared__ float tiles_all[kWarps * kTiles * kTile];
  __shared__ float part[kWarps * kSums * 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long groups = (a.Hn + 31) / 32;
  const long long h0 = (blockIdx.x % groups) * 32, i = blockIdx.x / groups;
  const long long h = h0 + lane;
  const bool live = h < a.Hn;
  const long long hl = live ? h : a.Hn - 1;  // a dead lane computes a live row's terms and writes nothing
  const long long r = hl * a.span + i;
  const float* __restrict__ grow = a.graph + (r % a.Gn) * a.V * kGraphCols;
  const Design z = load_design(a.chw + hl * kChwCols, a.headroom);
  const int rows = static_cast<int>(min(32LL, a.Hn - h0));  // live rows of the block
  // global [row, vertex] <-> a tile: two rows of kChunk vertices a warp access
  const int jj = lane / kChunk, k = lane % kChunk;
  constexpr int kStride = kWarps * kChunk;

  const Terms padding = vertex_terms(Row{}, z);
  float* tw = tiles_all + warp * kTiles * kTile;
  float acc[kSums];
#pragma unroll
  for (int s = 0; s < kSums; ++s) acc[s] = 0.f;

  // finish: the carries of the chunk at v0 into buffer b, by cp.async
  auto stage = [&](int v0, int b) {
    const int n = min(kChunk, a.V - v0);
    float* t0 = tw + 2 * b * kTile;
    for (int j = jj; j < rows; j += 32 / kChunk) {
      if (k < n) {
        const long long off = ((h0 + j) * a.span + i) * a.V + v0 + k;
        copy_async(t0 + j * (kChunk + 1) + k, a.occ + off);
        copy_async(t0 + kTile + j * (kChunk + 1) + k, a.bwp + off);
      }
    }
    copy_commit();
  };
  if (kFinish && warp * kChunk < a.V) stage(warp * kChunk, 0);

  int b = 0;
  for (int v0 = warp * kChunk; v0 < a.V; v0 += kStride, b ^= 1) {
    const int n = min(kChunk, a.V - v0);
    float* t0 = tw + (kFinish ? 2 * b * kTile : 0);
    float* t1 = t0 + kTile;
    if (kFinish) {
      if (v0 + kStride < a.V) {
        stage(v0 + kStride, b ^ 1);
      } else {
        copy_commit();  // an empty group, so that the wait below leaves only it in flight
      }
      copy_wait_all_but_last();
      __syncwarp();
    }
    for (int v = 0; v < n; ++v) {
      const Row w = load_row(grow + static_cast<long long>(v0 + v) * kGraphCols);
      Terms t;
      if (is_zero(w)) {
        t = padding;
      } else {
        t = vertex_terms(w, z);
      }
      if (!kFinish) {
        t0[lane * (kChunk + 1) + v] = t.bw_x;
        continue;
      }
      // the Alg.-7 gates on the carries (_vertex_exec)
      const float occ_prev = t0[lane * (kChunk + 1) + v], bw_prev = t1[lane * (kChunk + 1) + v];
      const float bw_ok = gate_below(bw_prev, a.headroom);
      const float can_prefetch = gate_below(occ_prev + quot(t.alloc, t.tiles), z.cap_h) * bw_ok * a.prefetch;
      const float hide = nan_max(can_prefetch, bw_ok * a.streaming);
      const float t_exposed = nan_max(t.t_main - hide * t.t_core, 0.f);
      // where the exposed time is the main-memory time bit for bit, the
      // integer-cycle chain is t_full's on the same operands (tiles >= 1 or NaN)
      const float t_tiled = __float_as_int(t_exposed) == __float_as_int(t.t_main)
          ? t.t_full
          : t.tiles * ceil_ste((t.t_core + t_exposed) * z.freq / t.tiles) / z.freq;
      const float cyc = t_tiled * t.active * z.freq;
      acc[0] = acc[0] + cyc;
      acc[1] = acc[1] + t.t_comp;
      acc[2] = acc[2] + t.t_onchip * t.active;
      acc[3] = acc[3] + t_exposed;
      acc[4] = acc[4] + t.tiles * t.active;
      acc[5] = acc[5] + t.used_bw * cyc;
    }
    __syncwarp();
    if (!kFinish) {
      for (int j = jj; j < rows; j += 32 / kChunk) {
        if (k < n) a.bw_x[((h0 + j) * a.span + i) * a.V + v0 + k] = t0[j * (kChunk + 1) + k];
      }
      __syncwarp();
    }
  }
  if (!kFinish) return;
  // the four warps' partial sums, added in warp order
#pragma unroll
  for (int s = 0; s < kSums; ++s) part[(warp * kSums + s) * 32 + lane] = acc[s];
  __syncthreads();
  if (warp != 0 || !live) return;
  float tot[kSums];
#pragma unroll
  for (int s = 0; s < kSums; ++s) {
    tot[s] = part[s * 32 + lane];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) tot[s] = tot[s] + part[(w * kSums + s) * 32 + lane];
  }
  const long long row = h * a.span + i;
  a.sums[row] = tot[0];
  a.sums[a.R + row] = tot[1];
  a.sums[2 * a.R + row] = tot[2];
  a.sums[3 * a.R + row] = tot[3];
  a.sums[4 * a.R + row] = tot[4];
  a.bw_util[row * 3] = 0.f;
  a.bw_util[row * 3 + 1] = tot[5] / nan_max(tot[0], 1e-30f);
  a.bw_util[row * 3 + 2] = 0.f;
}

template <bool kFinish>
int launch(const Args& a, cudaStream_t stream) {
  if (a.R <= 0) return 0;
  const long long blocks = (a.Hn + 31) / 32 * a.span;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  mapper_kernel<kFinish><<<static_cast<unsigned>(blocks), kBlock, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

Args make_args(const float* graph, const float* chw, long long R, int V, long long span, long long Gn,
               float headroom) {
  Args a{};
  a.graph = graph;
  a.chw = chw;
  a.R = R;
  a.V = V;
  a.span = span;
  a.Gn = Gn;
  a.Hn = span > 0 ? R / span : 0;
  a.headroom = headroom;
  return a;
}

}  // namespace

// graph [Gn, V, 16], designs [R / span, 14] -> bw_x [R, V]; row r is design
// r / span against graph row r % Gn.  Returns cudaGetLastError().
extern "C" int mapper_intrinsics_launch(const float* graph, const float* chw, float* bw_x, long long R, int V,
                                        long long span, long long Gn, float headroom, void* stream) {
  Args a = make_args(graph, chw, R, V, span, Gn, headroom);
  a.bw_x = bw_x;
  return launch<false>(a, static_cast<cudaStream_t>(stream));
}

// ... and occ_prev, bw_prev [R, V] -> sums [5, R], bw_util [R, 3].
extern "C" int mapper_finish_launch(const float* graph, const float* chw, const float* occ, const float* bwp,
                                    float* sums, float* bw_util, long long R, int V, long long span, long long Gn,
                                    float headroom, int prefetch, int streaming, void* stream) {
  Args a = make_args(graph, chw, R, V, span, Gn, headroom);
  a.occ = occ;
  a.bwp = bwp;
  a.sums = sums;
  a.bw_util = bw_util;
  a.prefetch = prefetch ? 1.f : 0.f;
  a.streaming = streaming ? 1.f : 0.f;
  return launch<true>(a, static_cast<cudaStream_t>(stream));
}
