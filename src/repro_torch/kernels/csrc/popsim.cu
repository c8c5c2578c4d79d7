// Population simulation: P packed candidate designs [P, 27] against one packed
// workload DFG [V, 16], forward mapper semantics, output [P, 8] =
// (cycles, e_dyn, t_comp, t_mem, t_exposed, tiles, 0, 0).
//
// Replaces the TPU kernel src/repro/kernels/popsim_kernel.py::popsim
// (_popsim_kernel) and computes what it computes: per vertex the tiling, the
// systolic wave model, max(t_comp, t_mem), the hard stream gate on the
// bandwidth-EMA carry, integer cycles per tile and the dynamic energy, summed
// over the vertices in order.
//
// What bounds it on an H100: operations.  The inputs are small (V*64 bytes of
// graph, 108 bytes per design) and every design does ~100 float operations,
// twenty of them IEEE divisions, per vertex.  Each division compiles to a
// reciprocal, Newton steps, a range check and a branch to a slow-path call,
// ~12 instructions in a region of its own that nothing is scheduled across,
// so a thread's vertex is a chain of ~15 such regions (~1,750 cycles on its
// own) and the card needs many warps in flight to issue every cycle.  What
// the design does:
//
//  * Of a vertex's work only the stream gate and the six sums depend on the
//    vertices before it; the rest (the tiling, the wave model, the level
//    times, the demanded bandwidth that feeds the EMA, the energy) is
//    carry-free.  So a design's vertices are dealt out to L lanes (L = 2..32,
//    a template parameter), one each a step of L vertices.  The carries then
//    go through the step in vertex order: every lane of the design runs the
//    EMA over the step's inputs from shared memory and keeps the gate of its
//    own vertex, and each of the six sums is added up, one vertex at a time in
//    the plain version's order, by one lane.  The launcher picks the most
//    lanes with which the whole grid is resident at once, so 512 designs fill
//    the card as 65,536 do.
//  * A design's lanes sit in different warps, a warp holding one lane of 32
//    designs: its threads take one vertex, so the branches below on the graph
//    row (a zero numerator, a class without work) go one way.
//  * A numerator that a graph row can make zero (a class without work, a
//    level without traffic) takes no division when it is zero: the
//    division's range check would send it down the slow path, and its
//    quotient is known (quot()).  The systolic wave model runs only where the
//    plain version's select keeps it, and a vertex's integer-cycle chain is
//    t_full's where its operand is t_full's bit for bit.
//  * The graph is staged through shared memory in tiles of 128 rows, together
//    with the terms that every design shares (max(N, 1), ceil(max(K, 1)),
//    each level's read + write, the activity flag), computed once a row.
//  * NaN-propagating max and min are one instruction each (max.NaN.f32).
//
// Numerics follow the plain version exactly in operation order; the build
// passes --fmad=false and no fast-math flag, so '/' and ceilf are IEEE and
// nothing is contracted.  The plain version's prefetch gate is left out:
// it is max(can_prefetch, bw_ok) with can_prefetch = cond * bw_ok and both
// factors in {0, 1}, so max(cond * bw_ok, bw_ok) = bw_ok whatever cond is,
// and the occupancy carry and the division inside cond reach no output.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kGraphCols = 16;
constexpr int kChwCols = 27;
constexpr int kOutCols = 8;
constexpr int kBlock = 128;     // threads a block
constexpr int kMinBlocks = 8;   // blocks an SM holds at once: 64 registers a thread, 32 warps an SM
constexpr int kTileRows = 128;  // graph rows staged in shared memory at once
constexpr int kRow = 20;        // floats a staged row
constexpr int kSums = 6;
constexpr float kHeadroom = 0.9f;

// chw columns
constexpr int FREQ = 0, CAP_GBUF = 1, BW = 2, RLAT = 5, WLAT = 8, RE_PB = 11, WE_PB = 14,
              E_FLOP = 17, RATE = 21, SYS_X = 25, SYS_Y = 26;
// graph columns
constexpr int G_READ = 4, G_WRITE = 7, G_ALLOC_GBUF = 10, G_MAIN_PRESENT = 11, G_DIMS = 12;
// a staged row: comp[4], read[3], write[3] as in the graph, then read + write
// of each level, alloc_gbuf, has_main, M, max(N, 1), ceil(max(K, 1)), active
constexpr int R_RW = 10, R_ACTIVE = 18;

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

// a / b, IEEE.  The division's range check sends a zero numerator down its
// slow path (a call, many times the fast path's cost), though the quotient is
// known: a zero whose sign is the signs' xor, or NaN where b is 0 or NaN.  So a
// zero numerator takes no division here, and a nonzero one takes '/'.
__device__ __forceinline__ float quot(float a, float b) {
  if (a != 0.f) return a / b;
  return (b == 0.f || b != b) ? __int_as_float(0x7fffffff)
                              : __int_as_float((__float_as_int(a) ^ __float_as_int(b)) & 0x80000000);
}

// what a design brings to every vertex
struct Design {
  float freq, cap, sys_x, sys_y, rate_sys;
  float eff[3];  // classes 1..3: max(rate, 1e-9) * freq
  float bw[3], lat[3], re[3], we[3], ef[4];
};

__device__ __forceinline__ Design load_design(const float* __restrict__ chw, int p, bool live) {
  float c[kChwCols];
#pragma unroll
  for (int k = 0; k < kChwCols; ++k) c[k] = live ? chw[static_cast<long long>(p) * kChwCols + k] : 1.0f;
  Design z;
  z.freq = c[FREQ];
  z.cap = c[CAP_GBUF] * kHeadroom;
  z.sys_x = c[SYS_X];
  z.sys_y = c[SYS_Y];
  z.rate_sys = nan_max(c[RATE], 1e-9f);
#pragma unroll
  for (int k = 0; k < 3; ++k) z.eff[k] = nan_max(c[RATE + 1 + k], 1e-9f) * z.freq;
#pragma unroll
  for (int l = 0; l < 3; ++l) {
    z.bw[l] = c[BW + l];
    z.lat[l] = c[RLAT + l] + c[WLAT + l];
    z.re[l] = c[RE_PB + l];
    z.we[l] = c[WE_PB + l];
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) z.ef[k] = c[E_FLOP + k];
  return z;
}

// Stage graph rows [v0, v0 + n) and zero rows up to n_pad.
__device__ __forceinline__ void stage_rows(float* tile, const float* __restrict__ graph, int v0, int n,
                                           int n_pad) {
  for (int r = threadIdx.x; r < n_pad; r += kBlock) {
    float* s = tile + r * kRow;
    if (r >= n) {
#pragma unroll
      for (int k = 0; k < kRow; ++k) s[k] = 0.f;
      continue;
    }
    const float* g = graph + static_cast<long long>(v0 + r) * kGraphCols;
    float x[kGraphCols];
#pragma unroll
    for (int k = 0; k < kGraphCols; ++k) x[k] = g[k];
#pragma unroll
    for (int k = 0; k < 10; ++k) s[k] = x[k];
#pragma unroll
    for (int l = 0; l < 3; ++l) s[R_RW + l] = x[G_READ + l] + x[G_WRITE + l];
    s[13] = x[G_ALLOC_GBUF];
    s[14] = x[G_MAIN_PRESENT];
    s[15] = x[G_DIMS];
    s[16] = nan_max(x[G_DIMS + 1], 1.0f);
    s[17] = ceilf(nan_max(x[G_DIMS + 2], 1.0f));
    float mass = ((x[0] + x[1]) + x[2]) + x[3];
    mass = mass + ((x[4] + x[5]) + x[6]);
    mass = mass + ((x[7] + x[8]) + x[9]);
    s[R_ACTIVE] = ((mass + x[G_ALLOC_GBUF]) + x[G_MAIN_PRESENT]) > 0.f ? 1.f : 0.f;
    s[19] = 0.f;
  }
}

// the carry-free terms of one (design, vertex)
struct Terms {
  float tiles, t_core, t_main, t_full, active;
  float cb;                         // 0.2 * clip(demanded bandwidth), the EMA's input
  float t_comp, e_v, t_mem, n_tiles;  // addends of three sums and the energy
};

__device__ __forceinline__ Terms vertex_terms(const float* row, const Design& z) {
  const float4 q0 = *reinterpret_cast<const float4*>(row);       // comp[0..3]
  const float4 q1 = *reinterpret_cast<const float4*>(row + 4);   // read[0..2], write[0]
  const float4 q2 = *reinterpret_cast<const float4*>(row + 8);   // write[1..2], rw[0..1]
  const float4 q3 = *reinterpret_cast<const float4*>(row + 12);  // rw[2], alloc, has_main, M
  const float4 q4 = *reinterpret_cast<const float4*>(row + 16);  // max(N,1), ceil(max(K,1)), active
  const float comp[4] = {q0.x, q0.y, q0.z, q0.w};
  const float rd[3] = {q1.x, q1.y, q1.z}, wr[3] = {q1.w, q2.x, q2.y}, rw[3] = {q2.z, q2.w, q3.x};
  const float alloc = q3.y, has_main = q3.z, M = q3.w, N1 = q4.x, K1 = q4.y, active = q4.z;

  const float tiles = nan_max(ceilf(quot(alloc, z.cap)), 1.0f);

  // systolic wave model, whose time the plain version's select keeps only
  // where the class has work
  const float ops_sys_tile = quot(comp[0], tiles);
  float t_sys = 0.f;
  if (ops_sys_tile > 0.f) {
    const float m_t = nan_max(M / tiles, 1.0f);
    const float waves = ceilf(m_t / z.sys_x) * ceilf(N1 / z.sys_y);
    float cyc_sys_tile = waves * (K1 + z.sys_x + z.sys_y);
    cyc_sys_tile = nan_max(cyc_sys_tile, ops_sys_tile / z.rate_sys);
    t_sys = tiles * cyc_sys_tile / z.freq;
  }
  float t_other = 0.f;  // the systolic class's slot is zeroed
#pragma unroll
  for (int k = 0; k < 3; ++k) t_other = nan_max(t_other, quot(comp[k + 1], z.eff[k]));
  const float t_comp = nan_max(t_other, t_sys);

  float t_lvl[3];
#pragma unroll
  for (int l = 0; l < 3; ++l) t_lvl[l] = quot(rw[l], z.bw[l]) * 1.04f;
  const float t_onchip = nan_max(t_lvl[1] + tiles * z.lat[1], t_lvl[0]);
  const float t_main = t_lvl[2] + tiles * z.lat[2] * has_main;
  const float t_core = nan_max(t_comp, t_onchip);

  // the demanded (no-overlap) bandwidth utilization the EMA averages
  const float t_full = tiles * ceilf((t_core + t_main) * z.freq / tiles) / z.freq;
  float used_bw = 0.f;
  if (t_full > 0.f) used_bw = quot(quot(rw[1], nan_max(t_full, 1e-30f)), z.bw[1]);

  float e_mem = 0.f, e_comp = 0.f;
#pragma unroll
  for (int l = 0; l < 3; ++l) e_mem = e_mem + (rd[l] * z.re[l] + wr[l] * z.we[l]);
#pragma unroll
  for (int k = 0; k < 4; ++k) e_comp = e_comp + comp[k] * z.ef[k];

  Terms t;
  t.tiles = tiles;
  t.t_core = t_core;
  t.t_main = t_main;
  t.t_full = t_full;
  t.active = active;
  t.cb = 0.2f * nan_min(nan_max(used_bw, 0.f), 2.f);
  t.t_comp = t_comp;
  t.e_v = e_mem + e_comp;
  t.t_mem = t_onchip * active;
  t.n_tiles = tiles * active;
  return t;
}

// exposed main-memory time and the vertex's cycles once its gate is known.
// Where the exposed time is the main-memory time bit for bit (the gate shut,
// or no main-memory time), the integer-cycle chain is t_full's, on the same
// operand.
__device__ __forceinline__ void gated(const Terms& t, float hide, float freq, float& t_exposed, float& cyc) {
  t_exposed = nan_max(t.t_main - hide * t.t_core, 0.f);
  const float t_tiled = __float_as_int(t_exposed) == __float_as_int(t.t_main)
      ? t.t_full
      : t.tiles * ceilf((t.t_core + t_exposed) * freq / t.tiles) / freq;
  cyc = t_tiled * t.active * freq;
}

// L lanes a design, kBlock / L designs a block.  Lane j of design ds is
// thread j * (kBlock / L) + ds, and walks vertices j, j + L, j + 2L, ...  So a
// warp holds one lane of 32 designs where L <= kBlock / 32: its threads take
// the same vertex, and every branch on the graph row goes one way.
template <int L>
__global__ void __launch_bounds__(kBlock, kMinBlocks)
popsim_kernel(const float* __restrict__ graph, const float* __restrict__ chw, float* __restrict__ out, int V,
              int P) {
  constexpr int kDesigns = kBlock / L;
  constexpr int kLine = L + 1;                 // odd: the designs of a warp read other banks
  constexpr int kHand = (kSums + 1) * kLine;   // a design's hand-over: the EMA's inputs, then six addend lines
  constexpr int kOwned = (kSums + L - 1) / L;  // sums a lane adds up: j, j + L, ...
  static_assert(L >= 2 && kBlock % L == 0 && kTileRows % L == 0, "lanes must tile a block and a tile");

  __shared__ float4 tile4[kTileRows * kRow / 4];
  // two hand-overs, used by turns: a step writes one while a late lane may still read the other
  __shared__ float hand_all[2 * kDesigns * kHand];
  float* tile = reinterpret_cast<float*>(tile4);

  const int ds = threadIdx.x % kDesigns, j = threadIdx.x / kDesigns;
  const int p = blockIdx.x * kDesigns + ds;
  const bool live = p < P;
  const Design z = load_design(chw, p, live);

  float bw_ema = 0.f;
  float acc[kOwned];
#pragma unroll
  for (int m = 0; m < kOwned; ++m) acc[m] = 0.f;

  int turn = 0;
  for (int v0 = 0; v0 < V; v0 += kTileRows) {
    const int n = min(kTileRows, V - v0);
    __syncthreads();  // the previous tile is fully consumed
    stage_rows(tile, graph, v0, n, (n + L - 1) / L * L);
    __syncthreads();
    for (int b = 0; b < n; b += L, turn ^= 1) {
      const Terms t = vertex_terms(tile + (b + j) * kRow, z);
      // line 0: the EMA's inputs; line 1 + s: the addends of sum s
      float* hand = hand_all + (turn * kDesigns + ds) * kHand;
      hand[j] = t.cb;
      hand[2 * kLine + j] = t.e_v;
      hand[3 * kLine + j] = t.t_comp;
      hand[4 * kLine + j] = t.t_mem;
      hand[6 * kLine + j] = t.n_tiles;
      __syncthreads();
      // the EMA through the step in vertex order, on every lane of the design;
      // each lane keeps the gate of its own vertex
      float hide = 0.f;
#pragma unroll
      for (int i = 0; i < L; ++i) {
        if (b + i >= n) break;
        if (i == j) hide = bw_ema < kHeadroom ? 1.f : 0.f;
        bw_ema = 0.8f * bw_ema + hand[i];
      }
      float t_exposed, cyc;
      gated(t, hide, z.freq, t_exposed, cyc);
      hand[kLine + j] = cyc;
      hand[5 * kLine + j] = t_exposed;
      __syncthreads();
      // the sums in vertex order, one lane a sum
#pragma unroll
      for (int m = 0; m < kOwned; ++m) {
        const int s = j + m * L;
        if (s < kSums) {
          const float* line = hand + (s + 1) * kLine;
#pragma unroll
          for (int i = 0; i < L; ++i) {
            if (b + i >= n) break;
            acc[m] = acc[m] + line[i];
          }
        }
      }
    }
  }
  if (!live) return;
  float* o = out + static_cast<long long>(p) * kOutCols;
#pragma unroll
  for (int m = 0; m < kOwned; ++m)
    if (j + m * L < kSums) o[j + m * L] = acc[m];
  if (j == 0) {
    o[6] = 0.f;
    o[7] = 0.f;
  }
}

template <int L>
int launch(const float* graph, const float* chw, float* out, int V, int P, cudaStream_t stream) {
  constexpr int kDesigns = kBlock / L;
  const int blocks = static_cast<int>((static_cast<long long>(P) + kDesigns - 1) / kDesigns);
  popsim_kernel<L><<<blocks, kBlock, 0, stream>>>(graph, chw, out, V, P);
  return static_cast<int>(cudaGetLastError());
}

// Blocks of the L-lane instance the current device holds at once.
template <int L>
int resident_blocks(int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, popsim_kernel<L>, kBlock, 0);
  *blocks = sms * per_sm;
  return static_cast<int>(e);
}

// The lanes a design for P designs: the most (a power of two from 2 to 32)
// with which the whole grid is resident on the card at once, else 2.  Returns
// a CUDA error code, or 0 with *lanes set.  The resident blocks of each
// instance are asked of the runtime once a device.
int pick_lanes(int P, int* lanes) {
  constexpr int kDevices = 64;
  static int resident[kDevices][4];  // 0: not asked yet; for L = 32, 16, 8, 4
  int (*const ask[])(int*) = {resident_blocks<32>, resident_blocks<16>, resident_blocks<8>, resident_blocks<4>};
  int dev = 0;
  const cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= kDevices) return static_cast<int>(cudaErrorInvalidDevice);
  int L = 32;
  for (int i = 0; i < 4; ++i, L /= 2) {
    if (resident[dev][i] == 0) {
      const int err = ask[i](&resident[dev][i]);
      if (err != 0) return err;
    }
    if ((static_cast<long long>(P) * L + kBlock - 1) / kBlock <= resident[dev][i]) break;
  }
  *lanes = L;
  return 0;
}

}  // namespace

// lanes: 0 for pick_lanes' choice; 2, 4, 8, 16 or 32 force it (a seam for the
// tests and the timing tool, which cover each instance).
extern "C" int popsim_launch(const float* graph, const float* chw, float* out, int V, int P, int lanes,
                             void* stream) {
  if (P <= 0) return 0;
  if (lanes == 0) {
    const int err = pick_lanes(P, &lanes);
    if (err != 0) return err;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (lanes) {
    case 2: return launch<2>(graph, chw, out, V, P, s);
    case 4: return launch<4>(graph, chw, out, V, P, s);
    case 8: return launch<8>(graph, chw, out, V, P, s);
    case 16: return launch<16>(graph, chw, out, V, P, s);
    case 32: return launch<32>(graph, chw, out, V, P, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
