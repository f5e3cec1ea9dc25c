// Flash attention split backward, the dQ pass, for Hopper (sm_90a): TMA
// loads, wgmma products, P and dS in registers.
//
// Port of the Pallas kernels in p2pfl_tpu/ops/flash_attention.py:
//   p2p_flash_bwd_dq       <- _dq_kernel       kernel 3
//   p2p_flash_bwd_dq_offs  <- _dq_kernel_offs  kernel 7
// Both are flash_bwd_dq_sm90<D, OFFS>; the pass's dK and dV are
// flash_bwd_sm90.cu's. With OFFS the causal mask is in global coordinates
// (q row i sees k row j where q_off + i >= k_off + j, the two offsets
// being plain int arguments), loop bounds divide with C's '/' (truncating
// like lax.div), a q row at the lse sentinel (it sees nothing in the
// call) gets P = 0, and the lse cotangent enters as
// dS = P (dP - delta + g_lse).
//
// Layout: q, k, v, dO, dq are [BH, T, D] bf16, contiguous, D = 32, 64 or
// 128 (one instantiation a width; sm90_common.cuh has the shared-memory
// layout of each); lse, delta and g_lse are [BH, T] fp32 (natural log). T
// must be a multiple of 64.
// Rounding points follow the JAX kernel: bf16 operands and fp32 sums, dS
// cast to bf16 before dS K, dQ scaled once at the end. A q row that no k
// row reaches gets dQ = 0 exactly.
//
// Bound on the H100: the causal dQ pass at T = 1024, D = 64 does 3
// products of 2 D flops a visible (q, k) pair (S, dP, dS K) against about
// 10 T D bytes a head, T·3/10 ~ 300 flop/byte, at the card's ~295
// flop/byte ridge: the tensor cores and the loads set the least time
// about equally, and one exp2 a pair against 6 D = 384 tensor-core flops
// keeps the special-function unit behind both. The design is the
// forward's (flash_fwd_sm90.cu) with dQ in place of O:
//   - one block per (bh, 192 q rows), every head's longest causal rows
//     first across the grid: three consumer warpgroups own 64 q rows each
//     end to end, and one producer warp issues the TMA loads;
//   - the producer loads the block's Q and dO tiles once and streams
//     64-row K and V tiles into a ring of STAGES stages, each with one
//     full barrier (K and V land together: both products of a tile need
//     them) and one empty barrier (every warpgroup releases it);
//   - each thread holds its two q rows' lse (log2 units), delta and g_lse
//     in registers, read once from global memory;
//   - S = Q K^T and dP = dO V^T are wgmma m64n64k16 from shared memory
//     (all K-major) into registers, issued together and waited on once;
//     P = exp2(S scale log2e - lse log2e) (ex2.approx.ftz, one FMA; the
//     mask compiled into the tiles past the causal frontier only) and
//     dS = P (dP - delta) convert in registers into the bf16 A operand of
//     dQ += dS K (wgmma m64nDk16, K an MN-major B from the same stage);
//     dQ stays in fp32 registers for the whole k loop. No cross-block
//     state, no atomics;
//   - dQ, S and dP (96 fp32 registers) are live at once, more than the 96
//     registers a thread gets at two blocks of two warpgroups an SM (a
//     sub-partition holds five of their 18 warps; ptxas spilled about 400
//     bytes and serialised the wgmmas), so one block runs an SM, with
//     three consumer warpgroups: 13 warps, at most four on a
//     sub-partition, 128 registers a thread (two warpgroups took 168 and
//     ran 3-10% slower). At D = 128 dQ alone is 64 registers and a
//     block's Q and dO 96 KB: two consumer warpgroups (128 q rows a
//     block) beside a whole producer warpgroup, which hands them its
//     registers (setmaxnreg: 240 a consumer thread, 24 a producer
//     thread). Each product is waited on before its result is
//     read, and the other warpgroups keep the tensor cores busy meanwhile;
//   - the epilogue stages dQ scale as bf16 in the warpgroup's rows of the
//     Q tile (swizzled) and writes it with 16-byte stores; a warpgroup
//     whose rows see no tile writes zeros without loading anything.
// The tensor maps hold the tensors' base addresses, so the C entry points
// encode them per call (cuTensorMapEncodeTiled, reached through the
// runtime's driver entry point: the library links the runtime alone) and
// pass them as __grid_constant__ parameters.
//
// Each extern "C" entry point launches one kernel on the given stream and
// returns cudaGetLastError() so the Python wrapper can raise on a refused
// launch. Nothing here allocates or synchronises.

#include "sm90_common.cuh"

namespace {

constexpr int N_CONSUMERS = 3; // consumer warpgroups
constexpr int WG_ROWS = 64;    // q rows per consumer warpgroup (wgmma M)
constexpr int BK = 64;         // k rows per tile
constexpr int STAGES = 4;      // K/V ring depth

// the dQ pass at width D: shared memory [Q | dO | K0 V0 | K1 V1 | ... |
// barriers], every tile 1024-byte aligned; at D = 128 two consumer
// warpgroups and a producer warpgroup that gives them its registers
template <int D>
struct Dq {
  typedef Swz<2 * D> S;
  static constexpr bool REG_SPLIT = D == 128;
  static constexpr int NC = REG_SPLIT ? 2 : N_CONSUMERS;  // consumer warpgroups
  static constexpr int NTHREADS = NC * 128 + (REG_SPLIT ? 128 : 32);  // + the producer
  static constexpr int BQ = NC * WG_ROWS;  // q rows per block
  static constexpr int NS = REG_SPLIT ? 3 : STAGES;  // K/V ring depth
  static constexpr uint32_t Q_BYTES = BQ * 2 * D;  // the block's Q (or dO)
  static constexpr uint32_t KV_BYTES = BK * 2 * D;  // a tile of K (or V)
  static constexpr uint32_t OFF_Q = 0;
  static constexpr uint32_t OFF_DO = OFF_Q + Q_BYTES;
  static constexpr uint32_t OFF_KV = OFF_DO + Q_BYTES;
  static constexpr uint32_t OFF_BAR = OFF_KV + NS * 2 * KV_BYTES;
  static constexpr uint32_t N_BARS = 1 + 2 * NS;  // Q and dO, then full and empty per stage
  static constexpr uint32_t SMEM_BYTES = 1024 + OFF_BAR + N_BARS * 8;  // + alignment slack
};

// k tiles [0, n) that the 64 q rows from local row r0 stream (the offset
// form is _dq_kernel_offs's bound: global coordinates, truncating
// division); 0 for rows past T.
template <bool OFFS>
__device__ __forceinline__ int wg_k_tiles(int r0, int T, int causal, int q_off, int k_off) {
  if (r0 >= T) return 0;
  if (OFFS) return clampi((q_off + r0 + WG_ROWS - 1 - k_off) / BK + 1, 0, T / BK);
  return causal ? (r0 + WG_ROWS) / BK : T / BK;
}

// dS of one tile on the accumulator layout of S and dP: thread (g, t) of
// warp wi holds q rows 16 wi + g + 8h, k columns 8i + 2t + e in
// sc[4i + 2h + e]. Masks (MASKED tiles only) the columns past each row;
// m[h] is the row's lse in log2 units, +inf at the sentinel (P = 0).
// Leaves dS packed as bf16 pairs in the A-register layout of the dS K
// product (columns 16kk .. 16kk + 15 are blocks 2kk and 2kk + 1).
template <bool MASKED, bool OFFS>
__device__ __forceinline__ void softmax_grad(const float (&sc)[32], const float (&dp)[32],
                                             uint32_t (&da)[16], const float (&m)[2],
                                             const float (&dl)[2], const float (&gl)[2], int diff,
                                             float scale_log2) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float ds[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int idx = 4 * i + 2 * h + e;
        float pv = ex2(fmaf(sc[idx], scale_log2, -m[h]));
        if (MASKED && 8 * i + e > diff + 8 * h) pv = 0.f;
        ds[e] = OFFS ? pv * (dp[idx] - dl[h] + gl[h]) : pv * (dp[idx] - dl[h]);
      }
      da[2 * i + h] = pack_bf16(ds[0], ds[1]);
    }
}

// ---------------------------------------------------------------------------
// The kernel. The first 128 NC threads are the consumer warpgroups, the
// rest the producer (a warp, or at D = 128 a warpgroup); after the barrier
// set-up the two roles never meet at a block-wide barrier again. Named
// barrier 1 + wg is warpgroup wg's own (0 is __syncthreads').
// ---------------------------------------------------------------------------
template <int D, bool OFFS>
__global__ void __launch_bounds__(Dq<D>::NTHREADS, 1)
flash_bwd_dq_sm90(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                  const float* __restrict__ lse, const float* __restrict__ delta,
                  const float* __restrict__ glse, bf16* __restrict__ dq, int T, int causal,
                  int q_off, int k_off, float scale, float scale_log2) {
  typedef Dq<D> L;
  typedef typename L::S S;
  constexpr int NC = L::NC, BQ = L::BQ, STAGES = L::NS;
  constexpr uint32_t OFF_Q = L::OFF_Q, OFF_DO = L::OFF_DO, OFF_KV = L::OFF_KV, OFF_BAR = L::OFF_BAR;
  constexpr uint32_t Q_BYTES = L::Q_BYTES, KV_BYTES = L::KV_BYTES;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t bar_q = base + OFF_BAR;
  auto kv_tile = [&](int s, int which) { return base + OFF_KV + (2 * s + which) * KV_BYTES; };
  auto full = [&](int s) { return bar_q + 8 * (1 + s); };
  auto empty = [&](int s) { return bar_q + 8 * (1 + STAGES + s); };

  // blocks start in index order with x fastest, so every head's longest
  // causal rows go first across the whole grid, and the short ones fill
  // the tail
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int qo = OFFS ? q_off : 0, ko = OFFS ? k_off : 0;  // global offsets
  // the block streams the k tiles its longest warpgroup needs
  int n_blk = 0;
#pragma unroll
  for (int w = 0; w < NC; ++w) n_blk = max(n_blk, wg_k_tiles<OFFS>(q0 + w * WG_ROWS, T, causal, qo, ko));

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), NC);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  if (warp >= NC * 4) {
    // ---- producer: one thread issues every TMA load ----
    if constexpr (L::REG_SPLIT) reg_dealloc<24>();
    if (threadIdx.x == NC * 128 && n_blk > 0) {
      mbar_expect_tx(bar_q, 2 * Q_BYTES);
      tma_load_tile<D>(base + OFF_Q, &tq, bar_q, BQ, q0, bh);
      tma_load_tile<D>(base + OFF_DO, &tdo, bar_q, BQ, q0, bh);
      for (int j = 0; j < n_blk; ++j) {
        const int s = j % STAGES, use = j / STAGES;
        if (use > 0) mbar_wait(empty(s), (use - 1) & 1);  // every warpgroup released it
        mbar_expect_tx(full(s), 2 * KV_BYTES);
        tma_load_tile<D>(kv_tile(s, 0), &tk, full(s), BK, j * BK, bh);
        tma_load_tile<D>(kv_tile(s, 1), &tv, full(s), BK, j * BK, bh);
      }
    }
    return;
  }

  // ---- consumer warpgroup wg: q rows [r0, r0 + 64) of the block ----
  if constexpr (L::REG_SPLIT) reg_alloc<240>();
  const int wg = warp / 4, tid = threadIdx.x % 128;
  const int wi = warp % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;  // row in the 8-row group, column pair
  const int r0 = q0 + wg * WG_ROWS;
  const int n_own = wg_k_tiles<OFFS>(r0, T, causal, qo, ko);
  // the first of the two rows this thread holds, global, against column 2t of a tile
  const int row_lo = qo + r0 + 16 * wi + g;

  // this thread's two rows: lse in log2 units (+inf at the sentinel, so
  // P = exp2(-inf) = 0 there), delta and the lse cotangent
  float m[2] = {0.f, 0.f}, dl[2] = {0.f, 0.f}, gl[2] = {0.f, 0.f};
  if (n_own > 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const size_t row = (size_t)bh * T + r0 + 16 * wi + g + 8 * h;
      const float l = lse[row];
      m[h] = (OFFS && l <= NEG_INF / 2) ? INFINITY : l * LOG2E;
      dl[h] = delta[row];
      if (OFFS) gl[h] = glse[row];
    }
  }

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float sc[32], dp[32];
  uint32_t da[16];  // dS of the tile, bf16 pairs

  // the warpgroup's first rows of Q and dO (atom 0)
  const uint32_t q_rows = base + OFF_Q + wg * WG_ROWS * S::RB;
  const uint32_t do_rows = base + OFF_DO + wg * WG_ROWS * S::RB;
  if (n_blk > 0) mbar_wait(bar_q, 0);  // also orders the epilogue's reuse of the Q tile
  // a tile whose last column passes the warpgroup's first row takes the mask
  auto masked = [&](int j) { return (OFFS || causal) && (ko + j * BK + BK - 1 > qo + r0); };
  auto diff = [&](int j) { return row_lo - (ko + j * BK + 2 * t); };

  // Each k tile in turn: S = Q K^T and dP = dO V^T (wgmma from shared
  // memory into registers), dS in registers, dQ += dS K (dS from
  // registers), each product waited on before its result is read. While
  // one warpgroup runs its softmax gradient, the others keep the tensor
  // cores busy. Only the tiles past the causal frontier run the masked
  // form. A warpgroup past its last tile
  // (its twin's last, or all of them for rows past T) only releases the
  // stage once it has landed and all its warps have seen it.
  for (int j = 0; j < n_blk; ++j) {
    const int s = j % STAGES;
    mbar_wait(full(s), (j / STAGES) & 1);
    if (j < n_own) {
      const uint32_t k_tile = kv_tile(s, 0), v_tile = kv_tile(s, 1);
      constexpr uint32_t QA = BQ * S::RB, KA = BK * S::RB;  // column atoms' distances
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) wgmma_ss(sc, S::k_desc(q_rows, QA, kk), S::k_desc(k_tile, KA, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) wgmma_ss(dp, S::k_desc(do_rows, QA, kk), S::k_desc(v_tile, KA, kk), kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(sc);
      reg_fence(dp);
      if (masked(j)) softmax_grad<true, OFFS>(sc, dp, da, m, dl, gl, diff(j), scale_log2);
      else softmax_grad<false, OFFS>(sc, dp, da, m, dl, gl, diff(j), scale_log2);
      // dQ += dS K: K an MN-major B, each k16 step 16 k rows further
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) wgmma_rs<D>(acc, da + 4 * kk, S::mn_desc(k_tile, KA, kk));
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(acc);
    } else {
      named_bar(1 + wg, 128);
    }
    if (tid == 0) mbar_arrive(empty(s));  // both tiles of the stage are consumed
  }

  // ---- epilogue: dQ scale as bf16 through the warpgroup's rows of the Q tile ----
  if (r0 >= T) return;  // the rows past T of the last block
  unsigned char* stage = smem + OFF_Q;  // the warpgroup's rows of the Q tile
  const int srow = wg * WG_ROWS;
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 16 * wi + g + 8 * h;
      *reinterpret_cast<uint32_t*>(stage + S::off(BQ, srow + r, i, 4 * t)) =
          pack_bf16(acc[4 * i + 2 * h] * scale, acc[4 * i + 2 * h + 1] * scale);
    }
  named_bar(1 + wg, 128);
  bf16* out = dq + ((size_t)bh * T + r0) * D;
#pragma unroll
  for (int n = 0; n < WG_ROWS * 2 * D / 16 / 128; ++n) {
    const int c = tid + 128 * n, r = c / (D / 8), cc = c % (D / 8);
    *reinterpret_cast<uint4*>(out + r * D + cc * 8) =
        *reinterpret_cast<const uint4*>(stage + S::off(BQ, srow + r, cc));
  }
}

// ---- host side ----

template <int D, bool OFFS>
int launch(const void* q, const void* k, const void* v, const void* dO, const void* lse,
           const void* delta, const void* glse, void* dq, int bh, int T, int causal, int q_off,
           int k_off, cudaStream_t stream) {
  typedef Dq<D> L;
  EncodeTiled fn = encoder();
  if (fn == nullptr) return (int)cudaErrorSymbolNotFound;
  CUtensorMap mq, mk, mv, mdo;
  if (!encode_bf16<D>(fn, &mq, q, bh, T, L::BQ) || !encode_bf16<D>(fn, &mk, k, bh, T, BK) ||
      !encode_bf16<D>(fn, &mv, v, bh, T, BK) || !encode_bf16<D>(fn, &mdo, dO, bh, T, L::BQ))
    return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  static bool smem_set[MAX_DEVICES] = {};  // the attribute, once a device
  if (dev >= MAX_DEVICES || !smem_set[dev]) {
    err = cudaFuncSetAttribute(flash_bwd_dq_sm90<D, OFFS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)L::SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    if (dev < MAX_DEVICES) smem_set[dev] = true;
  }
  const float scale = 1.0f / sqrtf((float)D);
  dim3 grid(bh, (T + L::BQ - 1) / L::BQ);
  flash_bwd_dq_sm90<D, OFFS><<<grid, L::NTHREADS, L::SMEM_BYTES, stream>>>(
      mq, mk, mv, mdo, (const float*)lse, (const float*)delta, (const float*)glse, (bf16*)dq, T,
      causal, q_off, k_off, scale, scale * LOG2E);
  return (int)cudaGetLastError();
}

// TMA reads from 16-byte aligned addresses; the 16-byte stores need the same of dq
bool bad_shape(const void* q, const void* k, const void* v, const void* dO, const void* dq, int bh,
               int T) {
  const uintptr_t any = (uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)dO | (uintptr_t)dq;
  return T % BK != 0 || T <= 0 || bh <= 0 || (any & 15) != 0;
}

}  // namespace

// ---- plain C interface (bound with ctypes) ----
// Every function returns 0 on success, a cudaError_t on a failed launch or
// tensor-map encoding, or -1 for a head_dim / length / alignment it was not
// built for.

extern "C" int p2p_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dO,
                                const void* lse, const void* delta, void* dq, int bh, int T,
                                int D, int causal, void* stream) {
  if (bad_shape(q, k, v, dO, dq, bh, T)) return BAD_SHAPE;
  return by_width(D, [&](auto w) {
    return launch<decltype(w)::value, false>(q, k, v, dO, lse, delta, nullptr, dq, bh, T, causal, 0, 0,
                                             (cudaStream_t)stream);
  });
}

// offset-aware (ring attention hops); causal by construction
extern "C" int p2p_flash_bwd_dq_offs(const void* q, const void* k, const void* v, const void* dO,
                                     const void* lse, const void* delta, const void* glse,
                                     void* dq, int bh, int T, int D, int q_off, int k_off,
                                     void* stream) {
  if (bad_shape(q, k, v, dO, dq, bh, T)) return BAD_SHAPE;
  return by_width(D, [&](auto w) {
    return launch<decltype(w)::value, true>(q, k, v, dO, lse, delta, glse, dq, bh, T, 1, q_off, k_off,
                                            (cudaStream_t)stream);
  });
}

// dynamic shared memory of one block of the dQ pass at a head width, in
// bytes (-1 for a width not built)
extern "C" int p2p_flash_bwd_dq_smem_bytes(int head_dim) {
  return by_width(head_dim, [](auto w) { return (int)Dq<decltype(w)::value>::SMEM_BYTES; });
}
