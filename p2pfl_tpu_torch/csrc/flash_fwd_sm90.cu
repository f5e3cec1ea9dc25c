// Flash attention forward for Hopper (sm_90a): TMA loads, wgmma products
// and the online softmax in registers.
//
// Port of the Pallas kernels in p2pfl_tpu/ops/flash_attention.py:
//   p2p_flash_fwd       <- _flash_kernel      (+ _fwd_tile)       kernel 1
//   p2p_flash_fwd_offs  <- _flash_kernel_offs (+ _fwd_tile_offs)  kernel 5
// Both are flash_fwd_sm90<OFFS>. With OFFS the causal mask is in global
// coordinates: q row i attends k row j where q_off + i >= k_off + j, the
// two offsets being plain int arguments (SMEM scalars on the TPU); loop
// bounds divide with C's '/', which truncates toward zero like lax.div.
//
// Layout: q, k, v, o are [BH, T, 64] bf16, contiguous; lse is [BH, T] fp32
// in natural log. T must be a multiple of 64. Rounding points follow the
// JAX kernel: scores accumulate in fp32, P is cast to bf16 before P.V,
// the output is acc / max(l, 1e-30), and a row that sees nothing keeps
// O = 0 and lse = NEG_INF (-1e30, finite).
//
// Bound on the H100: the causal forward at T = 1024, D = 64 does 2 T^2 D
// flops a head against about 8 T D bytes, T / 4 = 256 flop/byte, below the
// card's ~295 flop/byte ridge: the least time is set by the bytes, and the
// tensor-core work is close behind. At D = 64 the exponentials cost as
// much as the products: one exp2 a score on the special-function unit (16
// a clock an SM) against 4 D = 256 tensor-core flops. So the design keeps
// every intermediate out of shared memory, keeps the loads in flight and
// the softmax short:
//   - one block per (bh, 128-row q tile), every head's longest causal rows
//     first across the grid: two consumer warpgroups own 64 q rows each
//     end to end, and one producer warp issues the TMA loads;
//   - the producer loads the block's Q tile once and streams 64-row K and
//     V tiles into a ring of STAGES stages, each with its own full
//     barriers (K, V) and one empty barrier (both warpgroups release it);
//   - tiles land with the 128-byte swizzle (a 64-wide bf16 row is exactly
//     128 bytes), which the wgmma shared-memory descriptors name too;
//   - S = Q K^T is wgmma m64n64k16 from shared memory into registers; the
//     online softmax runs on the accumulator layout (a row spans the four
//     threads of a quad) with ex2.approx.ftz (no handling of denormal
//     results, which exp2f adds), scale * log2(e) folded into one FMA, and
//     the mask compiled into the tiles past the causal frontier only;
//   - P is converted to bf16 in registers and is the register A operand of
//     O += P V (wgmma m64n64k16, V as an MN-major B from shared memory);
//     O stays in fp32 registers for the whole k loop;
//   - a warpgroup waits on each product before it reads the result; the
//     softmax overlaps the tensor cores through the other warpgroup and the
//     SM's second block (96 registers, 2 blocks an SM). Issuing
//     S_{j+1} = Q K_{j+1}^T with P_j V_j needs more registers than two
//     blocks leave (ptxas holds them to 96), and ptxas then serialises the
//     wgmmas. Forms with the registers for that overlap (three
//     warpgroups in one block an SM; or thread 0 issuing the loads in
//     place of the producer warp, 256 threads and up to 128 registers)
//     were slower on the card than this one;
//   - the epilogue stages O / l as bf16 in the warpgroup's half of the Q
//     tile (swizzled, no bank conflicts) and writes it with 16-byte
//     stores; a warpgroup whose rows see no tile writes zeros and the
//     sentinel without loading anything.
// The tensor maps hold the tensors' base addresses, so the C entry points
// encode them per call (cuTensorMapEncodeTiled, reached through the
// runtime's driver entry point: the library links the runtime alone) and
// pass them as __grid_constant__ parameters.
//
// Each extern "C" entry point launches one kernel on the given stream and
// returns cudaGetLastError() so the Python wrapper can raise on a refused
// launch. Nothing here allocates or synchronises.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <cmath>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int D = 64;          // head_dim, the only width built
constexpr int BQ = 128;        // q rows per block: two warpgroups of 64
constexpr int WG_ROWS = 64;    // q rows per consumer warpgroup (wgmma M)
constexpr int BK = 64;         // k rows per tile
constexpr int STAGES = 3;      // K/V ring depth
constexpr int N_CONSUMERS = 2; // consumer warpgroups
constexpr int NTHREADS = N_CONSUMERS * 128 + 32;  // + one producer warp
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

constexpr uint32_t ROW_BYTES = D * sizeof(bf16);        // 128: one swizzle row
constexpr uint32_t Q_BYTES = BQ * ROW_BYTES;            // 16 KB
constexpr uint32_t KV_BYTES = BK * ROW_BYTES;           // 8 KB
// shared memory: [Q | K0 V0 | K1 V1 | ... | barriers], every tile 1024-byte
// aligned (the swizzle pattern repeats every 8 rows of 128 bytes)
constexpr uint32_t OFF_Q = 0;
constexpr uint32_t OFF_KV = OFF_Q + Q_BYTES;
constexpr uint32_t OFF_BAR = OFF_KV + STAGES * 2 * KV_BYTES;
constexpr uint32_t N_BARS = 1 + 3 * STAGES;  // q, then full K, full V, empty per stage
constexpr uint32_t SMEM_BYTES = 1024 + OFF_BAR + N_BARS * 8;  // + alignment slack

// ---- PTX wrappers: mbarrier, TMA, wgmma ----

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Wait until the barrier's phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One [rows, 64] bf16 box of a [BH, T, 64] tensor map into shared memory,
// completing on `bar`; rows past T arrive as zeros.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int row, int bh) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(0), "r"(row), "r"(bh)
      : "memory");
}

// wgmma shared-memory descriptor of a tile written with the 128-byte
// swizzle: 8-row groups 1024 bytes apart (SBO), layout type SWIZZLE_128B.
// The same form serves the K-major Q and K tiles and the MN-major V tile
// (64 columns = one swizzle atom, so the leading offset is unused).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads of an accumulator above the wait
// of the asynchronous wgmma that writes it.
__device__ __forceinline__ void reg_fence(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define ACC32(d)                                                                                   \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),    \
      "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),  \
      "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]),  \
      "+f"(d[29]), "+f"(d[30]), "+f"(d[31])

#define ACC32_REGS                                                                           \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

// d[64 x 64] (+)= A[64 x 16] . B[16 x 64], A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " ACC32_REGS
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : ACC32(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[64 x 64] += A[64 x 16] . B[16 x 64], A in registers (bf16 pairs), B
// MN-major in shared memory (the transpose bit of the bf16 instruction).
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " ACC32_REGS
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 2^x on the special-function unit; results below 2^-126 flush to zero
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ int clampi(int x, int lo, int hi) { return min(max(x, lo), hi); }

// k tiles [0, n) that the 64 q rows from local row r0 stream (the offset
// form is _fwd_tile_offs's n_blocks: global coordinates, truncating
// division); 0 for rows past T.
template <bool OFFS>
__device__ __forceinline__ int wg_k_tiles(int r0, int T, int causal, int q_off, int k_off) {
  if (r0 >= T) return 0;
  if (OFFS) return clampi((q_off + r0 + WG_ROWS - 1 - k_off) / BK + 1, 0, T / BK);
  return causal ? (r0 + WG_ROWS) / BK : T / BK;
}

// S[64 x 64] = Q[64 x 64] . K[64 x 64]^T for one warpgroup, Q and K
// K-major tiles in shared memory: four k16 steps, each 32 bytes further
// along the swizzled rows. Issued, not waited on.
__device__ __forceinline__ void qk(float (&sc)[32], uint64_t dq, uint64_t dk) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) wgmma_ss(sc, dq + 2 * kk, dk + 2 * kk, kk > 0);
}

// O[64 x 64] += P[64 x 64] . V[64 x 64] for one warpgroup: P in
// registers as bf16 pairs (the accumulator layout of S is the A-register
// layout of its k16 slices: columns 16kk .. 16kk + 15 are blocks 2kk and
// 2kk + 1), V an MN-major tile in shared memory, each k16 step 16 rows of
// 128 bytes further. Issued, not waited on.
__device__ __forceinline__ void pv(float (&acc)[32], const uint32_t (&pa)[16], uint64_t dv) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) wgmma_rs(acc, pa + 4 * kk, dv + (16 * ROW_BYTES >> 4) * kk);
}

// O's rows times their softmax rescale factors
__device__ __forceinline__ void rescale(float (&acc)[32], const float (&alpha)[2]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    acc[4 * i + 0] *= alpha[0];
    acc[4 * i + 1] *= alpha[0];
    acc[4 * i + 2] *= alpha[1];
    acc[4 * i + 3] *= alpha[1];
  }
}

// Online softmax of one tile of scores on the accumulator layout: thread
// (g, t) of warp wi holds rows 16 wi + g + 8h, columns 8i + 2t + e in
// sc[4i + 2h + e]. Masks (MASKED tiles only) the columns past each row,
// updates the running max m (log2 units) and this thread's share of the
// row sum l, returns the rescale factor alpha of the rows' output, and
// leaves P (fp32) in sc.
template <bool MASKED>
__device__ __forceinline__ void softmax_tile(float (&sc)[32], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], int diff, float scale_log2) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    // element (i, e) of row h is masked where 8i + e passes the row
    const int lim = diff + 8 * h;
    float mx = -INFINITY;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = sc[4 * i + 2 * h + e];
        if (MASKED && 8 * i + e > lim) x = -INFINITY;
        mx = fmaxf(mx, x);
      }
    const float m_new = fmaxf(m[h], quad_max(mx) * scale_log2);
    // a row that has seen nothing yet stays at -inf: p = exp2(-inf) = 0
    const float m_use = (MASKED && m_new == -INFINITY) ? 0.f : m_new;
    alpha[h] = ex2(m[h] - m_use);
    m[h] = m_new;
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = sc[4 * i + 2 * h + e];
        x = ex2(fmaf(x, scale_log2, -m_use));
        sum += x;
      }
    l[h] = l[h] * alpha[h] + sum;  // this thread's share; the quad sums at the end
  }
}

// P as bf16 pairs in the A-register layout of the P.V product
__device__ __forceinline__ void pack_p(const float (&sc)[32], uint32_t (&pa)[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) pa[i] = pack_bf16(sc[2 * i], sc[2 * i + 1]);
}

// ---------------------------------------------------------------------------
// The kernel. Threads 0-255 are the two consumer warpgroups, 256-287 the
// producer warp; after the barrier set-up the two roles never meet at a
// block-wide barrier again.
// ---------------------------------------------------------------------------
template <bool OFFS>
__global__ void __launch_bounds__(NTHREADS, 2)
flash_fwd_sm90(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv, bf16* __restrict__ o,
               float* __restrict__ lse, int T, int causal, int q_off, int k_off, float scale_log2) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t sq = base + OFF_Q;
  const uint32_t bar_q = base + OFF_BAR;
  auto kv_tile = [&](int s, int which) { return base + OFF_KV + (2 * s + which) * KV_BYTES; };
  auto full_k = [&](int s) { return bar_q + 8 * (1 + s); };
  auto full_v = [&](int s) { return bar_q + 8 * (1 + STAGES + s); };
  auto empty = [&](int s) { return bar_q + 8 * (1 + 2 * STAGES + s); };

  // blocks start in index order with x fastest, so every head's longest
  // causal rows go first across the whole grid, and the short ones fill
  // the tail
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int qo = OFFS ? q_off : 0, ko = OFFS ? k_off : 0;  // global offsets
  // the block streams the k tiles its longer warpgroup needs
  const int n_blk = max(wg_k_tiles<OFFS>(q0, T, causal, qo, ko),
                        wg_k_tiles<OFFS>(q0 + WG_ROWS, T, causal, qo, ko));

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_k(s), 1);
      mbar_init(full_v(s), 1);
      mbar_init(empty(s), N_CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  if (warp == N_CONSUMERS * 4) {
    // ---- producer: one thread issues every TMA load ----
    if (threadIdx.x % 32 == 0 && n_blk > 0) {
      mbar_expect_tx(bar_q, Q_BYTES);
      tma_load(sq, &tq, bar_q, q0, bh);
      for (int j = 0; j < n_blk; ++j) {
        const int s = j % STAGES, use = j / STAGES;
        if (use > 0) mbar_wait(empty(s), (use - 1) & 1);  // both warpgroups released it
        mbar_expect_tx(full_k(s), KV_BYTES);
        tma_load(kv_tile(s, 0), &tk, full_k(s), j * BK, bh);
        mbar_expect_tx(full_v(s), KV_BYTES);
        tma_load(kv_tile(s, 1), &tv, full_v(s), j * BK, bh);
      }
    }
    return;
  }

  // ---- consumer warpgroup wg: q rows [r0, r0 + 64) of the block ----
  const int wg = warp / 4, tid = threadIdx.x % 128;
  const int wi = warp % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;  // row in the 8-row group, column pair
  const int r0 = q0 + wg * WG_ROWS;
  const int n_own = wg_k_tiles<OFFS>(r0, T, causal, qo, ko);
  // the two rows this thread holds, relative to column 2t of a tile
  const int row_lo = qo + r0 + 16 * wi + g;

  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // m in log2 units of scaled scores
  float alpha[2];
  float sc[32];
  uint32_t pa[16];  // P of the tile whose P.V is next, bf16 pairs

  const uint64_t dq = smem_desc(sq + wg * WG_ROWS * ROW_BYTES);
  if (n_blk > 0) mbar_wait(bar_q, 0);  // also orders the epilogue's reuse of the Q tile
  // a tile whose last column passes the warpgroup's first row takes the mask
  auto masked = [&](int j) { return (OFFS || causal) && (ko + j * BK + BK - 1 > qo + r0); };
  auto diff = [&](int j) { return row_lo - (ko + j * BK + 2 * t); };

  // Each k tile in turn: S = Q K^T (wgmma from shared memory into
  // registers), the online softmax on the accumulator layout, O rescaled
  // and O += P V (P from registers), each product waited on before its
  // result is read. While one warpgroup runs its softmax, the other
  // warpgroup and the SM's second block keep the tensor cores busy. Only
  // the tiles past the causal frontier run the masked softmax. A
  // warpgroup past its last tile (its twin's last, or all of them for
  // rows past T) only releases the stage once it has landed.
  for (int j = 0; j < n_blk; ++j) {
    const int s = j % STAGES;
    const uint32_t parity = (j / STAGES) & 1;
    mbar_wait(full_k(s), parity);
    if (j < n_own) {
      wgmma_fence();
      qk(sc, dq, smem_desc(kv_tile(s, 0)));
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(sc);
      if (masked(j)) softmax_tile<true>(sc, m, l, alpha, diff(j), scale_log2);
      else softmax_tile<false>(sc, m, l, alpha, diff(j), scale_log2);
      rescale(acc, alpha);
      pack_p(sc, pa);
      mbar_wait(full_v(s), parity);
      wgmma_fence();
      pv(acc, pa, smem_desc(kv_tile(s, 1)));
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(acc);
    } else {
      mbar_wait(full_v(s), parity);
    }
    if (tid == 0) mbar_arrive(empty(s));  // both tiles of the stage are consumed
  }

  // ---- epilogue: O / l as bf16 through the warpgroup's half of the Q tile ----
  if (r0 >= T) return;  // the rows past T of a half tile
  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] = quad_sum(l[h]);
    inv[h] = 1.f / fmaxf(l[h], 1e-30f);
    if (t == 0)
      lse[(size_t)bh * T + r0 + 16 * wi + g + 8 * h] =
          (m[h] == -INFINITY) ? NEG_INF : m[h] * LN2 + logf(fmaxf(l[h], 1e-30f));
  }
  unsigned char* stage = smem + OFF_Q + wg * WG_ROWS * ROW_BYTES;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 16 * wi + g + 8 * h;
      *reinterpret_cast<uint32_t*>(stage + r * ROW_BYTES + ((i ^ (r & 7)) << 4) + 4 * t) =
          pack_bf16(acc[4 * i + 2 * h] * inv[h], acc[4 * i + 2 * h + 1] * inv[h]);
    }
  // the warpgroup's own named barrier (0 is __syncthreads')
  if (wg == 0) asm volatile("bar.sync 1, 128;\n" ::: "memory");
  else asm volatile("bar.sync 2, 128;\n" ::: "memory");
  bf16* out = o + ((size_t)bh * T + r0) * D;
#pragma unroll
  for (int n = 0; n < WG_ROWS * ROW_BYTES / 16 / 128; ++n) {
    const int c = tid + 128 * n, r = c / 8, cc = c % 8;
    *reinterpret_cast<uint4*>(out + r * D + cc * 8) =
        *reinterpret_cast<const uint4*>(stage + r * ROW_BYTES + ((cc ^ (r & 7)) << 4));
  }
}

// ---- host side ----

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, found once through the runtime
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// [BH, T, 64] bf16 at `ptr`, read in boxes of [rows, 64] with the 128-byte swizzle
bool encode(EncodeTiled fn, CUtensorMap* map, const void* ptr, int bh, int T, int rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)T, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)ROW_BYTES, (cuuint64_t)T * ROW_BYTES};
  const cuuint32_t box[3] = {(cuuint32_t)D, (cuuint32_t)rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <bool OFFS>
int launch(const void* q, const void* k, const void* v, void* o, void* lse, int bh, int T,
           int causal, int q_off, int k_off, cudaStream_t stream) {
  EncodeTiled fn = encoder();
  if (fn == nullptr) return (int)cudaErrorSymbolNotFound;
  CUtensorMap mq, mk, mv;
  if (!encode(fn, &mq, q, bh, T, BQ) || !encode(fn, &mk, k, bh, T, BK) ||
      !encode(fn, &mv, v, bh, T, BK))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_sm90<OFFS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(bh, (T + BQ - 1) / BQ);
  flash_fwd_sm90<OFFS><<<grid, NTHREADS, SMEM_BYTES, stream>>>(
      mq, mk, mv, (bf16*)o, (float*)lse, T, causal, q_off, k_off, LOG2E / sqrtf((float)D));
  return (int)cudaGetLastError();
}

constexpr int BAD_SHAPE = -1;

bool bad_shape(const void* q, const void* k, const void* v, const void* o, int bh, int T, int d) {
  // TMA reads from 16-byte aligned addresses; the 16-byte stores need the same of o
  const uintptr_t any = (uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)o;
  return d != D || T % BK != 0 || T <= 0 || bh <= 0 || (any & 15) != 0;
}

}  // namespace

// ---- plain C interface (bound with ctypes) ----
// Every function returns 0 on success, a cudaError_t on a failed launch or
// tensor-map encoding, or -1 for a head_dim / length / alignment it was not
// built for.

extern "C" int p2p_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                             int bh, int T, int head_dim, int causal, void* stream) {
  if (bad_shape(q, k, v, o, bh, T, head_dim)) return BAD_SHAPE;
  return launch<false>(q, k, v, o, lse, bh, T, causal, 0, 0, (cudaStream_t)stream);
}

// offset-aware (ring attention hops); causal by construction
extern "C" int p2p_flash_fwd_offs(const void* q, const void* k, const void* v, void* o,
                                  void* lse, int bh, int T, int head_dim, int q_off, int k_off,
                                  void* stream) {
  if (bad_shape(q, k, v, o, bh, T, head_dim)) return BAD_SHAPE;
  return launch<true>(q, k, v, o, lse, bh, T, 1, q_off, k_off, (cudaStream_t)stream);
}

// dynamic shared memory of one block of the forward, in bytes
extern "C" int p2p_flash_fwd_smem_bytes() { return (int)SMEM_BYTES; }
