// Causal (or full) attention with grouped KV heads and an online softmax, bf16 on
// Hopper's tensor cores:
//   o[b, h, i] = softmax_j(scale * q[b, h, i] . k[b, h / group, j]) v[b, h / group, j]
// over contiguous [B, H, S, D] bfloat16 arrays, D = 64, 112 or 128, output in bfloat16.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::flash_attention
// (_attn_kernel) for bf16 q, k and v of head width 64, 112 (kimi-k2) or 128;
// float32 and the other head widths stay on flash_attention.cu, chosen by the
// wrapper from the dtype and D alone.  Numerics kept from the TPU kernel: the
// scores, the running max m, the running sum l and the accumulator in float32; a
// masked causal score is the finite -1e30 and the running max starts at -1e30;
// the output is acc / max(l, 1e-30); keys past Skv are left out of the softmax
// (p = 0); the mask is suffix-causal, query i seeing key j when j <= i + (Skv - Sq).  A row that sees
// no key (Sq > Skv) comes out as the plain mean of the values, as the dense
// version gives it: its q tile walks every key with every score at -1e30.  The
// one change: P is rounded to bf16 before the P V product, as the tensor cores
// take it (the sum l is taken over the float32 p).
//
// What bounds it on an H100: operations.  At the zamba2 prefill's shape (32 heads
// of 64, S = 4096, causal) it does 2 D multiply-adds for each of the ~S^2/2 kept
// (query, key) pairs, ~69 GFLOP against ~67 MB of q, k, v and o: a thousand
// operations a byte, past the ~295 at which bf16 products stop being bound by
// memory.  So the products go to the tensor cores, and the design keeps them fed:
//   * wgmma.  S = Q K^T is m64n64k16 with Q and K both read from shared memory
//     (K-major); O += P V is m64nDk16 with P from registers (the S accumulator's
//     fragment is the A operand's, so P needs no trip through shared memory) and V
//     from shared memory, stored [keys, D] and so MN-major (the transpose bit).
//   * TMA.  One producer warp loads the block's Q once and K/V tiles of 64 keys
//     into a ring of 4 (D = 64) or 3 (D = 112, 128) stages, completion on mbarriers;
//     the consumers free a stage through a second mbarrier.  Tiles land 128-byte
//     swizzled, the layout the wgmma descriptors name (B128), so no thread touches
//     a K/V byte.  A row of 128 bytes is 64 columns, so at D = 112 and 128 each
//     tile is two 64-column boxes.  The tensor maps are 3-D, [B*H, S, D]: past Skv
//     (or Sq) TMA fills zeros instead of reading the next head's rows, and those
//     keys are masked too.  At D = 112 the map's rows stay 112 wide (224 bytes, a
//     multiple of 16, as TMA wants): the second box's columns 112-127 lie past the
//     row and TMA fills them with zeros too, counting them in the transaction bytes
//     like any other (so each box completes its full 8 KB on the mbarrier).  S =
//     Q K^T then runs 7 k-steps of 16 columns, never reading the zero columns, and
//     O += P V is m64n112k16: its B descriptor names the same two 64-column
//     swizzle atoms as n128's, and the product reads 48 columns of the second.
//   * Two consumer warpgroups of 64 query rows share each K/V tile: 128 rows a
//     block.  The softmax runs on the S fragment in registers (each thread holds
//     two rows; a row's max and sum cross four lanes by shuffles), in log2 units
//     for exp2, the scale folded into the exponent's FMA wherever no mask applies
//     and the scale is not negative (the softmax, not the tensor cores, sets the
//     pace: it takes several instructions a score).  At D = 64 a thread needs
//     ~90 registers, so two blocks (four consumer warpgroups) share an SM and
//     one's softmax overlaps another's products.
//   * Causal order: q tiles are walked heaviest first (the last tile, which sees
//     the most keys, has the lowest block index), so the short tiles fill the tail.
//     A tile stops at its causal limit, and a K/V tile clear of the diagonal and of
//     Skv skips the per-element mask.
//   * The warpgroup index is broadcast from lane 0, so the compiler can prove every
//     branch around a wgmma warp-uniform; otherwise it serializes the wgmmas (2x
//     slower at the zamba2 shape).
// Not yet: overlap of one tile's softmax with the next tile's products inside a
// warpgroup (tried: nvcc 12.9 serialized the wgmmas, C7513, and it ran slower),
// warp specialisation with setmaxnreg, persistence.  Launch: one block per
// (batch x head, 128-row q tile), 2 x 128 consumer threads and one producer warp.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

namespace {

constexpr int kRowsWG = 64;                      // query rows per consumer warpgroup (the wgmma M)
constexpr int kConsumers = 2;                    // consumer warpgroups per block
constexpr int kBlockM = kRowsWG * kConsumers;    // query rows per block
constexpr int kBlockN = 64;                      // keys per K/V tile
constexpr int kThreads = 128 * kConsumers + 32;  // the consumers and one producer warp
constexpr int kBox = 64;                         // columns per TMA box: 128 bytes, the swizzle span
constexpr int kBoxBytes = 64 * kBox * 2;         // one [64 rows, 64 columns] bf16 box
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Cfg {
  static constexpr int kHalves = (D + kBox - 1) / kBox;     // 64-column boxes per row (D = 112: 2)
  static constexpr int kStages = D == 64 ? 4 : 3;           // K/V ring depth
  static constexpr int kPV = D;                             // N of O += P V: the accumulator's columns
  static constexpr int kTileBytes = kHalves * kBoxBytes;    // 64 rows of q, k or v
  static constexpr int kQBytes = kConsumers * kTileBytes;   // the block's q rows
  static constexpr int kSmem = kQBytes + 2 * kStages * kTileBytes + 1024;  // + slack to align to 1 KB
};

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

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("{\n.reg .b64 st;\nmbarrier.arrive.shared::cta.b64 st, [%0];\n}\n" ::"r"(bar) : "memory");
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

// one box of a 3-D tensor map, {column, row, batch x head}, into shared memory
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar, int col, int row,
                                         int bh) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row), "r"(bh)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand: start address,
// leading and stride byte offsets (in 16-byte units), layout B128
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_wait() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }

// keeps the compiler from moving reads or writes of accumulator registers across
// an asynchronous wgmma
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// d[32] (+)= A . B, m64n64k16, A and B both K-major in shared memory (S = Q K^T);
// ``accumulate`` 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d[32] += A . B, m64n64k16: A, four registers of bf16 pairs; B in shared memory, MN-major
// (transpose bit set): O += P V with V stored [keys, D].
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d[56] += A . B, m64n112k16: A, four registers of bf16 pairs; B in shared memory, MN-major
// (transpose bit set): O += P V at D = 112, V stored [keys, 112] in two 64-column swizzle atoms.
__device__ __forceinline__ void wgmma_rs_n112(float (&d)[56], const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %61, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55"
      "}, {%56, %57, %58, %59}, %60, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d[64] += A . B, m64n128k16: A, four registers of bf16 pairs; B in shared memory, MN-major
// (transpose bit set): O += P V with V stored [keys, D].
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_sm90_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
                            const __grid_constant__ CUtensorMap vmap, __nv_bfloat16* __restrict__ o, int Hq,
                            int Hkv, int Sq, int Skv, int causal, float scale_log2) {
  using C = Cfg<D>;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[C::kStages], empty[C::kStages], qbar;

  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;  // swizzled tiles start on 1 KB
  const uint32_t qs = base;                                      // [consumer][box][64 rows][64 cols]
  const uint32_t ks = base + C::kQBytes;                         // [stage][box][64 keys][64 cols]
  const uint32_t vs = ks + C::kStages * C::kTileBytes;

  const int bh = blockIdx.x;                                  // b * Hq + h
  const int bhk = (bh / Hq) * Hkv + (bh % Hq) / (Hq / Hkv);   // b * Hkv + h / group
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlockM;      // heaviest q tiles first
  const int off = Skv - Sq;
  // keys the 64 rows from r0 need: up to the causal limit of the last row; every
  // key when a row sees none; none when every row lies past Sq
  auto kv_end_of = [&](int r0) {
    if (r0 >= Sq) return 0;
    if (!causal || r0 + off < 0) return Skv;
    return min(Skv, min(r0 + kRowsWG, Sq) + off);
  };
  const int n_tiles = (max(kv_end_of(q0), kv_end_of(q0 + kRowsWG)) + kBlockN - 1) / kBlockN;

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(smem_u32(&full[s]), 1);
      mbar_init(smem_u32(&empty[s]), 128 * kConsumers);
    }
    mbar_init(smem_u32(&qbar), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the warpgroup and warp, broadcast from lane 0 so that the compiler sees they
  // are warp-uniform (a wgmma under a branch it cannot prove uniform is serialized)
  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x / 128), 0);
  const int warp = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x % 128 / 32), 0);
  if (wg == kConsumers) {  // the producer warp: one thread issues every load
    if (threadIdx.x % 32 != 0) return;
    const int n_q = q0 + kRowsWG < Sq ? 2 : 1;  // consumers with a row below Sq
    mbar_expect_tx(smem_u32(&qbar), n_q * C::kTileBytes);
    for (int c = 0; c < n_q; ++c)
      for (int h = 0; h < C::kHalves; ++h)
        tma_load(qs + (c * C::kHalves + h) * kBoxBytes, &qmap, smem_u32(&qbar), h * kBox, q0 + c * kRowsWG, bh);
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % C::kStages;
      mbar_wait(smem_u32(&empty[s]), ((j / C::kStages) & 1) ^ 1);  // the first pass finds every stage free
      mbar_expect_tx(smem_u32(&full[s]), 2 * C::kTileBytes);
      for (int h = 0; h < C::kHalves; ++h) {
        tma_load(ks + s * C::kTileBytes + h * kBoxBytes, &kmap, smem_u32(&full[s]), h * kBox, j * kBlockN, bhk);
        tma_load(vs + s * C::kTileBytes + h * kBoxBytes, &vmap, smem_u32(&full[s]), h * kBox, j * kBlockN, bhk);
      }
    }
    return;
  }

  // a consumer warpgroup: 64 query rows from r0; each thread holds rows ra and ra + 8
  // of the wgmma fragments, columns 8 t + 2 (lane % 4) + {0, 1} of each 8-column chunk t
  const int lane = threadIdx.x % 32;
  const int r0 = q0 + wg * kRowsWG;
  const int ra = r0 + warp * 16 + lane / 4;
  const int kv_end = kv_end_of(r0);
  const uint32_t qw = qs + wg * C::kTileBytes;

  float acc[C::kPV / 2];
#pragma unroll
  for (int i = 0; i < C::kPV / 2; ++i) acc[i] = 0.0f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};  // l: this thread's part of the row sum
  if (kv_end > 0) mbar_wait(smem_u32(&qbar), 0);

  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % C::kStages;
    mbar_wait(smem_u32(&full[s]), (j / C::kStages) & 1);
    const int k0 = j * kBlockN;
    if (k0 < kv_end) {
      // S = Q K^T: D / 16 steps of 16 columns, 32 bytes along the swizzled rows (at
      // D = 112: four in the first box, three in the second; its zero columns unread)
      float sc[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] = 0.0f;  // overwritten (accumulate 0); set so no register is read unset
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t col = (kk / 4) * kBoxBytes + (kk % 4) * 32;
        wgmma_ss_n64(sc, smem_desc(qw + col, 16, 1024), smem_desc(ks + s * C::kTileBytes + col, 16, 1024), kk > 0);
      }
      wgmma_commit();
      wgmma_wait();
      reg_fence(sc);

      // the online softmax on the fragment, in log2 units.  A tile clear of the
      // diagonal and of Skv needs no mask: its max is taken on the raw scores and the
      // scale folds into the exponent's FMA (sl = scale_log2): one instruction a score
      // fewer than scaling first, a quarter of the kernel's time at the zamba2 shape
      // on an H100.  A tile on an edge, or any tile under a negative scale (which
      // turns the raw max into the scaled min), is scaled and masked first (sl = 1).
      const bool edge = scale_log2 < 0.0f || k0 + kBlockN > Skv || (causal && k0 + kBlockN - 1 > r0 + off);
      float sl = scale_log2;
      if (edge) {
        sl = 1.0f;
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int key = k0 + 8 * (i / 4) + 2 * (lane % 4) + (i % 2);
          const int row = ra + ((i & 2) ? 8 : 0);
          if (key >= Skv) sc[i] = -CUDART_INF_F;  // left out: p = 0
          else if (causal && key > row + off) sc[i] = kNegInf;
          else sc[i] *= scale_log2;
        }
      }
      float mx[2] = {-CUDART_INF_F, -CUDART_INF_F}, alpha[2];
#pragma unroll
      for (int i = 0; i < 32; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r] * sl);
        alpha[r] = ex2(m[r] - m_new);
        m[r] = m_new;
        l[r] *= alpha[r];
      }
      uint32_t p[16];  // P in bf16: the A fragments of the four 16-key steps of P V
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int r = (i >> 1) & 1;
        const float p0 = ex2(fmaf(sc[i], sl, -m[r])), p1 = ex2(fmaf(sc[i + 1], sl, -m[r]));
        l[r] += p0 + p1;
        p[i / 2] = pack_bf16(p0, p1);
      }
#pragma unroll
      for (int i = 0; i < C::kPV / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];

      // O += P V: 4 steps of 16 keys, 16 rows x 128 bytes apart in the swizzled V tile
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBlockN / 16; ++kk) {
        const uint64_t b = smem_desc(vs + s * C::kTileBytes + kk * 2048, kBoxBytes, 1024);
        if constexpr (C::kPV == 64) wgmma_rs_n64(acc, p + 4 * kk, b);
        else if constexpr (C::kPV == 112) wgmma_rs_n112(acc, p + 4 * kk, b);
        else wgmma_rs_n128(acc, p + 4 * kk, b);
      }
      wgmma_commit();
      wgmma_wait();
      reg_fence(acc);
    }
    mbar_arrive(smem_u32(&empty[s]));  // this thread is done with the stage
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = fmaxf(l[r], 1e-30f);
  }
  const long long obase = static_cast<long long>(bh) * Sq;
#pragma unroll
  for (int t = 0; t < D / 8; ++t) {  // columns 0 to D - 1 alone: no byte past the row
    const int col = 8 * t + 2 * (lane % 4);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = ra + 8 * r;
      if (row < Sq) {
        const __nv_bfloat162 v = __floats2bfloat162_rn(acc[4 * t + 2 * r] / l[r], acc[4 * t + 2 * r + 1] / l[r]);
        *reinterpret_cast<__nv_bfloat162*>(o + (obase + row) * D + col) = v;
      }
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

// [bh, rows, D] bf16 as a 3-D map with [64 rows, 64 columns] boxes, 128-byte
// swizzled; what a box holds past ``rows`` (or past column D) is filled with zeros
bool make_map(CUtensorMap* map, EncodeTiled encode, const void* ptr, int bh, int rows, int D) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(bh)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(D) * 2, static_cast<cuuint64_t>(rows) * D * 2};
  const cuuint32_t box[3] = {kBox, 64, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch(EncodeTiled encode, const void* q, const void* k, const void* v, void* o, int B, int Hq, int Hkv, int Sq,
           int Skv, int causal, float scale, cudaStream_t stream) {
  CUtensorMap qm, km, vm;
  if (!make_map(&qm, encode, q, B * Hq, Sq, D) || !make_map(&km, encode, k, B * Hkv, Skv, D) ||
      !make_map(&vm, encode, v, B * Hkv, Skv, D))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = flash_attention_sm90_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg<D>::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * Hq, (Sq + kBlockM - 1) / kBlockM);
  kernel<<<grid, kThreads, Cfg<D>::kSmem, stream>>>(qm, km, vm, static_cast<__nv_bfloat16*>(o), Hq, Hkv, Sq, Skv,
                                                    causal, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q [B, Hq, Sq, D], k and v [B, Hkv, Skv, D], o [B, Hq, Sq, D]; all contiguous bf16
// with 16-byte aligned bases; D is 64, 112 or 128.  Returns the launch's cudaError_t.
extern "C" int flash_attention_sm90_launch(const void* q, const void* k, const void* v, void* o, int B, int Hq,
                                           int Hkv, int Sq, int Skv, int D, int causal, float scale,
                                           void* stream) {
  if (B <= 0 || Hq <= 0 || Sq <= 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0 || Skv <= 0 || (D != 64 && D != 112 && D != 128))
    return static_cast<int>(cudaErrorInvalidValue);
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64) return launch<64>(encode, q, k, v, o, B, Hq, Hkv, Sq, Skv, causal, scale, s);
  if (D == 112) return launch<112>(encode, q, k, v, o, B, Hq, Hkv, Sq, Skv, causal, scale, s);
  return launch<128>(encode, q, k, v, o, B, Hq, Hkv, Sq, Skv, causal, scale, s);
}
