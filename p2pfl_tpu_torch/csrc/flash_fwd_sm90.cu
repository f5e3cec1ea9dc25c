// Flash attention forward for Hopper (sm_90a): TMA loads, wgmma products
// and the online softmax in registers.
//
// Port of the Pallas kernels in p2pfl_tpu/ops/flash_attention.py:
//   p2p_flash_fwd       <- _flash_kernel      (+ _fwd_tile)       kernel 1
//   p2p_flash_fwd_offs  <- _flash_kernel_offs (+ _fwd_tile_offs)  kernel 5
// Both are flash_fwd_sm90<D, OFFS>. With OFFS the causal mask is in global
// coordinates: q row i attends k row j where q_off + i >= k_off + j, the
// two offsets being plain int arguments (SMEM scalars on the TPU); loop
// bounds divide with C's '/', which truncates toward zero like lax.div.
//
// Layout: q, k, v, o are [BH, T, D] bf16, contiguous, D = 32, 64 or 128
// (flash_fwd_sm90<D, OFFS>, one instantiation a width; sm90_common.cuh
// has the shared-memory layout of each); lse is [BH, T] fp32 in natural
// log. T must be a multiple of 64. Rounding points follow the
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
//   - tiles land swizzled (a 64-wide bf16 row is exactly one 128-byte
//     swizzle row; D = 32 takes the 64-byte swizzle, D = 128 two column
//     atoms), which the wgmma shared-memory descriptors name too;
//   - S = Q K^T is wgmma m64n64k16 from shared memory into registers (D / 16
//     k16 steps); the
//     online softmax runs on the accumulator layout (a row spans the four
//     threads of a quad) with ex2.approx.ftz (no handling of denormal
//     results, which exp2f adds), scale * log2(e) folded into one FMA, and
//     the mask compiled into the tiles past the causal frontier only;
//   - P is converted to bf16 in registers and is the register A operand of
//     O += P V (wgmma m64nDk16, V as an MN-major B from shared memory);
//     O stays in fp32 registers (D / 2 a thread) for the whole k loop;
//   - a warpgroup waits on each product before it reads the result; the
//     softmax overlaps the tensor cores through the other warpgroup and the
//     SM's second block (96 registers, 2 blocks an SM; at D = 128 the
//     128 KB of Q and the K/V ring leave room for one block an SM, and O
//     takes 64 registers a thread). Issuing
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

#include "sm90_common.cuh"

namespace {

constexpr int BQ = 128;        // q rows per block: two warpgroups of 64
constexpr int WG_ROWS = 64;    // q rows per consumer warpgroup (wgmma M)
constexpr int BK = 64;         // k rows per tile
constexpr int STAGES = 3;      // K/V ring depth
constexpr int N_CONSUMERS = 2; // consumer warpgroups
constexpr int NTHREADS = N_CONSUMERS * 128 + 32;  // + one producer warp
constexpr float LN2 = 0.6931471805599453f;

// shared memory of width D: [Q | K0 V0 | K1 V1 | ... | barriers], every
// tile 1024-byte aligned (the swizzle pattern repeats every 1024 bytes)
template <int D>
struct Fwd {
  typedef Swz<2 * D> S;
  static constexpr uint32_t Q_BYTES = BQ * 2 * D;   // 16 KB at D = 64
  static constexpr uint32_t KV_BYTES = BK * 2 * D;  // 8 KB at D = 64
  static constexpr uint32_t OFF_Q = 0;
  static constexpr uint32_t OFF_KV = OFF_Q + Q_BYTES;
  static constexpr uint32_t OFF_BAR = OFF_KV + STAGES * 2 * KV_BYTES;
  static constexpr uint32_t N_BARS = 1 + 3 * STAGES;  // q, then full K, full V, empty per stage
  static constexpr uint32_t SMEM_BYTES = 1024 + OFF_BAR + N_BARS * 8;  // + alignment slack
  static constexpr int MIN_BLOCKS = D == 128 ? 1 : 2;  // blocks an SM
};

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// k tiles [0, n) that the 64 q rows from local row r0 stream (the offset
// form is _fwd_tile_offs's n_blocks: global coordinates, truncating
// division); 0 for rows past T.
template <bool OFFS>
__device__ __forceinline__ int wg_k_tiles(int r0, int T, int causal, int q_off, int k_off) {
  if (r0 >= T) return 0;
  if (OFFS) return clampi((q_off + r0 + WG_ROWS - 1 - k_off) / BK + 1, 0, T / BK);
  return causal ? (r0 + WG_ROWS) / BK : T / BK;
}

// S[64 x 64] = Q[64 x D] . K[64 x D]^T for one warpgroup, Q and K K-major
// tiles in shared memory: D / 16 k16 steps along the swizzled rows (and
// across the column atoms). Issued, not waited on.
template <int D>
__device__ __forceinline__ void qk(float (&sc)[32], uint32_t q, uint32_t k) {
  typedef Fwd<D> L;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss(sc, L::S::k_desc(q, BQ * L::S::RB, kk), L::S::k_desc(k, BK * L::S::RB, kk), kk > 0);
}

// O[64 x D] += P[64 x 64] . V[64 x D] for one warpgroup: P in registers as
// bf16 pairs (the accumulator layout of S is the A-register layout of its
// k16 slices: columns 16kk .. 16kk + 15 are blocks 2kk and 2kk + 1), V an
// MN-major tile in shared memory, each k16 step 16 rows further. Issued,
// not waited on.
template <int D>
__device__ __forceinline__ void pv(float (&acc)[D / 2], const uint32_t (&pa)[16], uint32_t v) {
  typedef Fwd<D> L;
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) wgmma_rs<D>(acc, pa + 4 * kk, L::S::mn_desc(v, BK * L::S::RB, kk));
}

// O's rows times their softmax rescale factors
template <int N>
__device__ __forceinline__ void rescale(float (&acc)[N], const float (&alpha)[2]) {
#pragma unroll
  for (int i = 0; i < N / 4; ++i) {
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
template <int D, bool OFFS>
__global__ void __launch_bounds__(NTHREADS, Fwd<D>::MIN_BLOCKS)
flash_fwd_sm90(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv, bf16* __restrict__ o,
               float* __restrict__ lse, int T, int causal, int q_off, int k_off, float scale_log2) {
  typedef Fwd<D> L;
  typedef typename L::S S;
  constexpr uint32_t OFF_Q = L::OFF_Q, OFF_KV = L::OFF_KV, OFF_BAR = L::OFF_BAR;
  constexpr uint32_t Q_BYTES = L::Q_BYTES, KV_BYTES = L::KV_BYTES;
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
      tma_load_tile<D>(sq, &tq, bar_q, BQ, q0, bh);
      for (int j = 0; j < n_blk; ++j) {
        const int s = j % STAGES, use = j / STAGES;
        if (use > 0) mbar_wait(empty(s), (use - 1) & 1);  // both warpgroups released it
        mbar_expect_tx(full_k(s), KV_BYTES);
        tma_load_tile<D>(kv_tile(s, 0), &tk, full_k(s), BK, j * BK, bh);
        mbar_expect_tx(full_v(s), KV_BYTES);
        tma_load_tile<D>(kv_tile(s, 1), &tv, full_v(s), BK, j * BK, bh);
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

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // m in log2 units of scaled scores
  float alpha[2];
  float sc[32];
  uint32_t pa[16];  // P of the tile whose P.V is next, bf16 pairs

  const uint32_t q_rows = sq + wg * WG_ROWS * S::RB;  // the warpgroup's first row, atom 0
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
      qk<D>(sc, q_rows, kv_tile(s, 0));
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(sc);
      if (masked(j)) softmax_tile<true>(sc, m, l, alpha, diff(j), scale_log2);
      else softmax_tile<false>(sc, m, l, alpha, diff(j), scale_log2);
      rescale(acc, alpha);
      pack_p(sc, pa);
      mbar_wait(full_v(s), parity);
      wgmma_fence();
      pv<D>(acc, pa, kv_tile(s, 1));
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
  unsigned char* stage = smem + OFF_Q;  // the warpgroup's rows of the Q tile
  const int srow = wg * WG_ROWS;
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 16 * wi + g + 8 * h;
      *reinterpret_cast<uint32_t*>(stage + S::off(BQ, srow + r, i, 4 * t)) =
          pack_bf16(acc[4 * i + 2 * h] * inv[h], acc[4 * i + 2 * h + 1] * inv[h]);
    }
  // the warpgroup's own named barrier (0 is __syncthreads')
  if (wg == 0) asm volatile("bar.sync 1, 128;\n" ::: "memory");
  else asm volatile("bar.sync 2, 128;\n" ::: "memory");
  bf16* out = o + ((size_t)bh * T + r0) * D;
#pragma unroll
  for (int n = 0; n < WG_ROWS * 2 * D / 16 / 128; ++n) {
    const int c = tid + 128 * n, r = c / (D / 8), cc = c % (D / 8);
    *reinterpret_cast<uint4*>(out + r * D + cc * 8) =
        *reinterpret_cast<const uint4*>(stage + S::off(BQ, srow + r, cc));
  }
}

// ---- host side ----

template <int D, bool OFFS>
int launch(const void* q, const void* k, const void* v, void* o, void* lse, int bh, int T,
           int causal, int q_off, int k_off, cudaStream_t stream) {
  typedef Fwd<D> L;
  EncodeTiled fn = encoder();
  if (fn == nullptr) return (int)cudaErrorSymbolNotFound;
  CUtensorMap mq, mk, mv;
  if (!encode_bf16<D>(fn, &mq, q, bh, T, BQ) || !encode_bf16<D>(fn, &mk, k, bh, T, BK) ||
      !encode_bf16<D>(fn, &mv, v, bh, T, BK))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_sm90<D, OFFS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(bh, (T + BQ - 1) / BQ);
  flash_fwd_sm90<D, OFFS><<<grid, NTHREADS, L::SMEM_BYTES, stream>>>(
      mq, mk, mv, (bf16*)o, (float*)lse, T, causal, q_off, k_off, LOG2E / sqrtf((float)D));
  return (int)cudaGetLastError();
}

bool bad_shape(const void* q, const void* k, const void* v, const void* o, int bh, int T) {
  // TMA reads from 16-byte aligned addresses; the 16-byte stores need the same of o
  const uintptr_t any = (uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)o;
  return T % BK != 0 || T <= 0 || bh <= 0 || (any & 15) != 0;
}

}  // namespace

// ---- plain C interface (bound with ctypes) ----
// Every function returns 0 on success, a cudaError_t on a failed launch or
// tensor-map encoding, or -1 for a head_dim / length / alignment it was not
// built for.

extern "C" int p2p_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                             int bh, int T, int head_dim, int causal, void* stream) {
  if (bad_shape(q, k, v, o, bh, T)) return BAD_SHAPE;
  return by_width(head_dim, [&](auto w) {
    return launch<decltype(w)::value, false>(q, k, v, o, lse, bh, T, causal, 0, 0, (cudaStream_t)stream);
  });
}

// offset-aware (ring attention hops); causal by construction
extern "C" int p2p_flash_fwd_offs(const void* q, const void* k, const void* v, void* o,
                                  void* lse, int bh, int T, int head_dim, int q_off, int k_off,
                                  void* stream) {
  if (bad_shape(q, k, v, o, bh, T)) return BAD_SHAPE;
  return by_width(head_dim, [&](auto w) {
    return launch<decltype(w)::value, true>(q, k, v, o, lse, bh, T, 1, q_off, k_off, (cudaStream_t)stream);
  });
}

// dynamic shared memory of one block of the forward at a head width, in
// bytes (-1 for a width not built)
extern "C" int p2p_flash_fwd_smem_bytes(int head_dim) {
  return by_width(head_dim, [](auto w) { return (int)Fwd<decltype(w)::value>::SMEM_BYTES; });
}
