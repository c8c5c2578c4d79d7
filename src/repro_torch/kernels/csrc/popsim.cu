// Population simulation: P packed candidate designs [P, 27] against one packed
// workload DFG [V, 16], forward mapper semantics, output [P, 8] =
// (cycles, e_dyn, t_comp, t_mem, t_exposed, tiles, 0, 0).
//
// Replaces the TPU kernel src/repro/kernels/popsim_kernel.py::popsim
// (_popsim_kernel) and computes what it computes: per vertex the tiling, the
// systolic wave model, max(t_comp, t_mem), the hard prefetch/stream gates on
// the occupancy and bandwidth-EMA carries, integer cycles per tile and the
// dynamic energy; the vertices are walked in order because the two carries
// thread through them.
//
// What bounds it on an H100: operations.  The inputs are small (V*64 bytes of
// graph, 108 bytes per design) and every design does ~100 float operations,
// twenty of them IEEE divisions, per vertex; there is nothing to reuse across
// designs except the graph rows.  Design: one thread per candidate, 128
// threads per block, the 27 design values and the 8 carries/accumulators in
// registers.  The graph is staged through shared memory in tiles of 256 rows
// (16 KB), which every thread of the block then reads as broadcasts.  Threads
// with p >= P skip the arithmetic but still take part in every barrier.
//
// Numerics follow the plain version exactly in operation order; the build
// passes --fmad=false and no fast-math flag, so '/' and ceilf are IEEE and
// nothing is contracted.  Maxima propagate NaN as the reference's do.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kGraphCols = 16;
constexpr int kChwCols = 27;
constexpr int kOutCols = 8;
constexpr int kTileRows = 256;
constexpr int kBlockPop = 128;  // candidates (threads) per block
constexpr float kHeadroom = 0.9f;

// chw columns
constexpr int FREQ = 0, CAP_GBUF = 1, BW = 2, RLAT = 5, WLAT = 8, RE_PB = 11, WE_PB = 14,
              E_FLOP = 17, RATE = 21, SYS_X = 25, SYS_Y = 26;
// graph columns
constexpr int G_COMP = 0, G_READ = 4, G_WRITE = 7, G_ALLOC_GBUF = 10, G_MAIN_PRESENT = 11,
              G_DIMS = 12;

__device__ __forceinline__ float nan_max(float a, float b) {
  return (isnan(a) || isnan(b)) ? nanf("") : fmaxf(a, b);
}
__device__ __forceinline__ float nan_min(float a, float b) {
  return (isnan(a) || isnan(b)) ? nanf("") : fminf(a, b);
}

__global__ void popsim_kernel(const float* __restrict__ graph, const float* __restrict__ chw,
                              float* __restrict__ out, int V, int P) {
  __shared__ float tile[kTileRows * kGraphCols];
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = p < P;

  float c[kChwCols];
#pragma unroll
  for (int k = 0; k < kChwCols; ++k) c[k] = live ? chw[static_cast<long long>(p) * kChwCols + k] : 1.0f;
  const float freq = c[FREQ];
  const float cap_gbuf = c[CAP_GBUF] * kHeadroom;
  const float occ_cap = cap_gbuf / kHeadroom;
  const float sys_x = c[SYS_X], sys_y = c[SYS_Y];

  float cycles = 0.f, e_dyn = 0.f, t_comp_acc = 0.f, t_mem_acc = 0.f, t_exp_acc = 0.f,
        tiles_acc = 0.f, occupancy = 0.f, bw_ema = 0.f;

  for (int v0 = 0; v0 < V; v0 += kTileRows) {
    const int n = min(kTileRows, V - v0);
    __syncthreads();  // the previous tile is fully consumed
    for (int i = threadIdx.x; i < n * kGraphCols; i += blockDim.x)
      tile[i] = graph[static_cast<long long>(v0) * kGraphCols + i];
    __syncthreads();
    if (!live) continue;
    for (int j = 0; j < n; ++j) {
      const float* g = tile + j * kGraphCols;
      const float alloc_gbuf = g[G_ALLOC_GBUF];
      const float has_main = g[G_MAIN_PRESENT];
      const float M = g[G_DIMS], N = g[G_DIMS + 1], K = g[G_DIMS + 2];

      const float tiles = nan_max(ceilf(alloc_gbuf / cap_gbuf), 1.0f);

      // systolic wave model
      const float m_t = nan_max(M / tiles, 1.0f);
      const float waves = ceilf(m_t / sys_x) * ceilf(nan_max(N, 1.0f) / sys_y);
      float cyc_sys_tile = waves * (ceilf(nan_max(K, 1.0f)) + sys_x + sys_y);
      const float ops_sys_tile = g[G_COMP] / tiles;
      cyc_sys_tile = nan_max(cyc_sys_tile, ops_sys_tile / nan_max(c[RATE], 1e-9f));
      const float t_sys = ops_sys_tile > 0.f ? tiles * cyc_sys_tile / freq : 0.f;
      float t_other = 0.f;  // the systolic class's slot is zeroed
#pragma unroll
      for (int k = 1; k < 4; ++k) {
        const float eff = nan_max(c[RATE + k], 1e-9f) * freq;
        t_other = nan_max(t_other, g[G_COMP + k] / eff);
      }
      const float t_comp = nan_max(t_other, t_sys);

      float t_lvl[3], t_tile_lat[3];
#pragma unroll
      for (int l = 0; l < 3; ++l) {
        t_lvl[l] = (g[G_READ + l] + g[G_WRITE + l]) / c[BW + l] * 1.04f;
        t_tile_lat[l] = tiles * (c[RLAT + l] + c[WLAT + l]);
      }
      const float t_onchip = nan_max(t_lvl[1] + t_tile_lat[1], t_lvl[0]);
      const float t_main = t_lvl[2] + t_tile_lat[2] * has_main;

      const float bw_ok = bw_ema < kHeadroom ? 1.f : 0.f;
      const float can_prefetch = ((occupancy + alloc_gbuf / tiles) < cap_gbuf ? 1.f : 0.f) * bw_ok;
      const float hide = nan_max(can_prefetch, bw_ok);

      const float t_core = nan_max(t_comp, t_onchip);
      const float t_exposed = nan_max(t_main - hide * t_core, 0.f);
      const float mass = ((g[G_COMP] + g[G_COMP + 1]) + g[G_COMP + 2]) + g[G_COMP + 3] +
                         ((g[G_READ] + g[G_READ + 1]) + g[G_READ + 2]) +
                         ((g[G_WRITE] + g[G_WRITE + 1]) + g[G_WRITE + 2]) + alloc_gbuf + has_main;
      const float active = mass > 0.f ? 1.f : 0.f;
      const float t_vertex = tiles * ceilf((t_core + t_exposed) * freq / tiles) / freq * active;

      // EMA of the demanded (no-overlap) bandwidth utilization
      const float t_full = tiles * ceilf((t_core + t_main) * freq / tiles) / freq;
      const float used_bw = t_full > 0.f
          ? (g[G_READ + 1] + g[G_WRITE + 1]) / nan_max(t_full, 1e-30f) / c[BW + 1]
          : 0.f;
      bw_ema = 0.8f * bw_ema + 0.2f * nan_min(nan_max(used_bw, 0.f), 2.f);
      occupancy = nan_min(0.5f * occupancy + alloc_gbuf, occ_cap);

      float e_mem = 0.f, e_comp = 0.f;
#pragma unroll
      for (int l = 0; l < 3; ++l) e_mem = e_mem + (g[G_READ + l] * c[RE_PB + l] + g[G_WRITE + l] * c[WE_PB + l]);
#pragma unroll
      for (int k = 0; k < 4; ++k) e_comp = e_comp + g[G_COMP + k] * c[E_FLOP + k];

      cycles = cycles + t_vertex * freq;
      e_dyn = e_dyn + (e_mem + e_comp);
      t_comp_acc = t_comp_acc + t_comp;
      t_mem_acc = t_mem_acc + t_onchip * active;
      t_exp_acc = t_exp_acc + t_exposed;
      tiles_acc = tiles_acc + tiles * active;
    }
  }
  if (live) {
    float* o = out + static_cast<long long>(p) * kOutCols;
    o[0] = cycles; o[1] = e_dyn; o[2] = t_comp_acc; o[3] = t_mem_acc;
    o[4] = t_exp_acc; o[5] = tiles_acc; o[6] = 0.f; o[7] = 0.f;
  }
}

}  // namespace

extern "C" int popsim_launch(const float* graph, const float* chw, float* out, int V, int P,
                             void* stream) {
  if (P <= 0) return 0;
  const int blocks = (P + kBlockPop - 1) / kBlockPop;
  popsim_kernel<<<blocks, kBlockPop, 0, static_cast<cudaStream_t>(stream)>>>(graph, chw, out, V, P);
  return static_cast<int>(cudaGetLastError());
}
