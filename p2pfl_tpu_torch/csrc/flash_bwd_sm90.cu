// Flash attention backward for Hopper (sm_90a), fused and the split dK/dV
// pass: TMA loads, wgmma products with P and dS in registers, dQ (fused
// only) added by bulk tensor reductions.
//
// Port of the Pallas kernels in p2pfl_tpu/ops/flash_attention.py:
//   p2p_flash_bwd_dkvq      <- _dkvq_kernel      (+ _dkv_step with dq_acc)       kernel 2
//   p2p_flash_bwd_dkvq_offs <- _dkvq_kernel_offs (+ _dkv_step_offs,
//                                                  _offs_kv_bounds)             kernel 6
//   p2p_flash_bwd_dkv       <- _dkv_kernel       (+ _dkv_step)                   kernel 4
//   p2p_flash_bwd_dkv_offs  <- _dkv_kernel_offs  (+ _dkv_step_offs)              kernel 8
// All four are flash_bwd_sm90<D, OFFS, WITH_DQ>. With WITH_DQ they compute dQ,
// dK and dV in one sweep, five block products per (q, k) tile pair; without
// it (the split pass, whose dQ is flash_bwd_dq_sm90.cu's) dK and dV alone,
// four products a pair, and every dQ step below is compiled out. With
// OFFS the causal mask is in global coordinates (q row i sees k row j
// where q_off + i >= k_off + j, the two offsets being plain int
// arguments), loop bounds divide with C's '/' (truncating like lax.div), a
// q row at the lse sentinel (it sees nothing in the call) gets P = 0, and
// the lse cotangent enters as dS = P (dP - delta + g_lse).
//
// Layout: q, k, v, dO, dk, dv are [BH, T, D] bf16, contiguous, D = 32, 64
// or 128 (one instantiation a width; sm90_common.cuh has the
// shared-memory layout of each); lse, delta and g_lse are [BH, T] fp32
// (natural log); dq_acc is [BH, T, D] fp32 followed by 16 bytes (the blocks' work counter), all zeroed by the
// caller, which casts dQ afterwards. Without dQ, dv is followed by the 16
// zeroed bytes of the counter. T must be a multiple of 64. Rounding
// points follow the JAX kernel: bf16 operands and fp32 sums, P cast to
// bf16 before P^T dO, dS cast to bf16 before dS^T Q and dS K, dK scaled
// once at the end, dQ's share scaled by `scale` before it is added.
//
// Bound on the H100: the causal backward at T = 1024, D = 64 does 5
// products of 2 D flops a visible (q, k) pair against about 14 T D bytes
// a head, T·5/14 ~ 360 flop/byte, above the card's ~295 flop/byte ridge:
// the tensor cores set the least time. One exp2 a pair against 10 D = 640
// tensor-core flops leaves the special-function unit far behind them. So
// the design keeps every product on wgmma with its operands where the
// tensor cores read them, and keeps the loads out of the way:
//   - persistent blocks, one an SM: a work item is (bh, 128 k rows); two
//     consumer warpgroups own 64 k rows each for the item's whole q
//     sweep, and one producer warp issues the TMA loads and takes the
//     next item from a counter all blocks share, so a block that finishes
//     early takes more. Items go out 16 heads at a time (the blocks in
//     flight share those heads' Q, dO and dQ rows in L2; all heads at once
//     overflow it), and within the 16 k block by k block, so the longest
//     blocks start first;
//   - the producer loads each item's K and V once, into one of two
//     buffers, so the next item's K and V and first q tiles load while
//     this item runs; each 64-row q tile's Q and dO (128-byte swizzle)
//     and its lse, delta (and g_lse) rows stream through a ring of STAGES
//     stages with one full and one empty barrier each, which runs on
//     across items;
//   - products with swapped operands: S^T = K Q^T and dP^T = V dO^T are
//     wgmma m64n64k16 from shared memory (both K-major, D / 16 k16
//     steps), so the
//     accumulators lie by k row; P^T = exp2(S^T scale log2e - lse log2e)
//     (ex2.approx.ftz, one FMA; the mask compiled into the tiles at the
//     causal frontier only) and dS^T = P^T (dP^T - delta) convert in
//     registers into the A operands of dV += P^T dO and dK += dS^T Q
//     (wgmma m64nDk16, dO and Q MN-major B operands from the stage); dK
//     and dV stay in fp32 registers for the whole sweep;
//   - dQ = dS K contracts over the item's 128 k rows: each warpgroup
//     writes its dS^T rows to a swizzled shared tile (double-buffered),
//     the two meet at a named barrier, and each computes one half of D
//     (wgmma m64n(D/2)k16, dS an MN-major A from shared memory, K^T a
//     K-major B transposed once per item into shared memory);
//   - each warpgroup stages its fp32 [64, D / 2] half of the tile's dQ
//     (swizzled, double-buffered) and one thread adds it into dq_acc with
//     bulk tensor reductions (cp.reduce.async.bulk.tensor ... add.f32, one
//     box a 128-byte column atom), in place of per-element atomics;
//   - a warpgroup whose k rows no row of the q tile sees (or past T)
//     skips S, dP and the softmax gradient and contributes dS = 0; an
//     item whose k rows no q row sees loads nothing and writes dK = dV =
//     0;
//   - 288 threads: a sub-partition of the SM holds three of the nine
//     warps, which caps a thread at 168 registers. dK, dV, S^T, dP^T and
//     the packed P^T and dS^T fit there, and each product is waited on
//     before its result is read. Forms that keep more in flight (S^T and
//     dP^T of the next tile issued behind this tile's dQ; P^T computed
//     while dP^T runs) need more: ptxas then serialises the wgmmas
//     (C7512), and the first, given 240 registers by setmaxnreg on a full
//     producer warpgroup, was no faster on the card;
//   - at D = 128 dK and dV alone are 128 registers a thread: the block
//     takes a whole producer warpgroup (384 threads), which hands the
//     consumers its registers (setmaxnreg: 240 a consumer thread, 24 a
//     producer thread), and shared memory holds one item's K and V (64
//     KB), two Q/dO stages and one dQ staging buffer a warpgroup, so the
//     fused kernel's 227 KB fit; the dK/dV pass keeps two items' K and V
//     and two stages;
//   - the epilogue stages dK and dV as bf16 in the warpgroup's halves of
//     the item's K and V tiles (swizzled) and writes them with 16-byte
//     stores;
//   - without dQ (kernels 4 and 8) the K^T tiles, the dS^T tiles, the dQ
//     staging, the named barrier of the two warpgroups and the bulk
//     reductions all go: each warpgroup runs S^T, dP^T, the softmax
//     gradient and the dV and dK products on its own, and meets only its
//     own warps at a named barrier before it releases a stage. The work
//     counter follows dv.
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

constexpr int BK = 128;        // k rows per block: two warpgroups of 64
constexpr int WG_ROWS = 64;    // k rows per consumer warpgroup (wgmma M)
constexpr int BQ = 64;         // q rows per streamed tile
constexpr int STAGES = 3;      // Q/dO ring depth
constexpr int SPLIT_STAGES = 3;  // the same without dQ
constexpr int N_CONSUMERS = 2; // consumer warpgroups

constexpr uint32_t ROWS_BYTES = BQ * sizeof(float);     // 256: a tile's lse (delta, g_lse)
constexpr uint32_t DST_BYTES = BK * BQ * 2;             // 16 KB: a tile's dS^T, [128 k, 64 q] bf16
// shared memory of width D, every tile 1024-byte aligned (the swizzle
// repeats every 1024 bytes):
// [K0 V0 K1 V1 (NKV items' K and V) | K^T (two [D, 64 k] tiles) |
//  Q0 dO0 Q1 dO1 ... | dS^T x 2 | dQ staging: warpgroup 0 x NDQ, warpgroup 1 x NDQ |
//  rows: lse, delta, g_lse a stage | barriers: full and empty per K/V
//  buffer, then full and empty per stage | item ids]; without dQ the K^T,
// dS^T and staging tiles take no room. K^T and dS^T rows are 64 k or q
// values (128 bytes) at every width.
template <int D, bool WITH_DQ>
struct Smem {
  typedef Swz<2 * D> S;   // bf16 tiles of K, V, Q, dO; also the fp32 dQ staging, D / 2 wide
  static constexpr bool REG_SPLIT = D == 128;  // a producer warpgroup hands its registers over
  static constexpr int NTHREADS = N_CONSUMERS * 128 + (REG_SPLIT ? 128 : 32);  // + the producer
  static constexpr int NS = D == 128 ? 2 : (WITH_DQ ? STAGES : SPLIT_STAGES);  // ring depth
  static constexpr int NKV = D == 128 && WITH_DQ ? 1 : 2;  // items' K/V buffers
  static constexpr int NDQ = D == 128 ? 1 : 2;             // dQ staging buffers a warpgroup
  static constexpr uint32_t KV_BYTES = BK * 2 * D;         // a block's K (or V)
  static constexpr uint32_t WG_BYTES = WG_ROWS * 2 * D;    // a warpgroup's rows of it
  static constexpr uint32_t TILE_BYTES = BQ * 2 * D;       // a q tile of Q (or dO)
  static constexpr uint32_t KT_BYTES = D * 64 * 2;         // a [D, 64 k] tile of K^T
  static constexpr uint32_t DQ_HALF_BYTES = BQ * (D / 2) * sizeof(float);  // [64, D / 2] fp32
  static constexpr uint32_t N_BARS = 2 * NKV + 2 * NS;
  static constexpr uint32_t KV = 0;
  static constexpr uint32_t KT = KV + NKV * 2 * KV_BYTES;
  static constexpr uint32_t QDO = KT + (WITH_DQ ? 2 * KT_BYTES : 0);
  static constexpr uint32_t DS = QDO + NS * 2 * TILE_BYTES;
  static constexpr uint32_t DQ = DS + (WITH_DQ ? 2 * DST_BYTES : 0);
  static constexpr uint32_t ROWS = DQ + (WITH_DQ ? N_CONSUMERS * NDQ * DQ_HALF_BYTES : 0);
  static constexpr uint32_t BAR = ROWS + NS * 3 * ROWS_BYTES;
  static constexpr uint32_t BYTES = 1024 + BAR + N_BARS * 8 + NKV * 4;  // + item ids, alignment slack
  static_assert(BYTES <= 232448, "a block's shared memory on the H100");
};

// First q tile that k block `k0` streams (the offset form is
// _offs_kv_bounds's start: global coordinates, truncating division); q
// tiles before it end before the block's first key.
template <bool OFFS>
__device__ __forceinline__ int first_q_tile(int k0, int nq, int causal, int q_off, int k_off) {
  if (OFFS) return clampi((k_off + k0 - q_off) / BQ, 0, nq);
  return causal ? k0 / BQ : 0;
}

// P^T and dS^T of one tile on the accumulator layout of S^T and dP^T:
// thread (g, t) of warp wi holds k rows 16 wi + g + 8h, q columns 8i + 2t
// + e in sc[4i + 2h + e]. Masks (MASKED tiles only) the columns that come
// before each row; q columns at the lse sentinel (OFFS) get P = 0. Leaves
// P^T and dS^T packed as bf16 pairs in the A-register layout of the dV
// and dK products (columns 16kk .. 16kk + 15 are blocks 2kk and 2kk + 1).
template <bool MASKED, bool OFFS>
__device__ __forceinline__ void softmax_grad(const float (&sc)[32], const float (&dp)[32],
                                             uint32_t (&pa)[16], uint32_t (&da)[16],
                                             const float* lse_s, const float* delta_s,
                                             const float* glse_s, int lim0, int t,
                                             float scale_log2) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float2 l = *reinterpret_cast<const float2*>(lse_s + 8 * i + 2 * t);
    const float2 dl = *reinterpret_cast<const float2*>(delta_s + 8 * i + 2 * t);
    float2 gl = make_float2(0.f, 0.f);
    if (OFFS) gl = *reinterpret_cast<const float2*>(glse_s + 8 * i + 2 * t);
    float p[2][2], ds[2][2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float lse = e ? l.y : l.x;
      // exp2(S scale log2e - lse log2e): a sentinel column's -inf exponent gives 0
      const float m = (OFFS && lse <= NEG_INF / 2) ? INFINITY : lse * LOG2E;
      const float dl_e = e ? dl.y : dl.x, gl_e = e ? gl.y : gl.x;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int idx = 4 * i + 2 * h + e;
        float pv = ex2(fmaf(sc[idx], scale_log2, -m));
        if (MASKED && 8 * i + e < lim0 + 8 * h) pv = 0.f;
        p[h][e] = pv;
        ds[h][e] = OFFS ? pv * (dp[idx] - dl_e + gl_e) : pv * (dp[idx] - dl_e);
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      pa[2 * i + h] = pack_bf16(p[h][0], p[h][1]);
      da[2 * i + h] = pack_bf16(ds[h][0], ds[h][1]);
    }
  }
}

// dV += P^T dO and dK += dS^T Q for one warpgroup and tile: A from
// registers, dO and Q MN-major B operands from the stage, each k16 step 16
// q rows further. Issued, not waited on.
template <int D>
__device__ __forceinline__ void dkv_products(float (&dv_acc)[D / 2], float (&dk_acc)[D / 2], const uint32_t (&pa)[16],
                                             const uint32_t (&da)[16], uint32_t do_tile, uint32_t q_tile) {
  typedef Swz<2 * D> S;
#pragma unroll
  for (int kk = 0; kk < BQ / 16; ++kk) wgmma_rs<D>(dv_acc, pa + 4 * kk, S::mn_desc(do_tile, BQ * S::RB, kk));
#pragma unroll
  for (int kk = 0; kk < BQ / 16; ++kk) wgmma_rs<D>(dk_acc, da + 4 * kk, S::mn_desc(q_tile, BQ * S::RB, kk));
}

// One work item: the k block k0 of head bh and the q tiles it streams.
struct Item {
  int bh, k0, start, n_tiles;
};

constexpr int GROUP = 16;  // heads whose items are handed out together

// Item w of a launch. Items go out group by group of GROUP heads (the
// blocks in flight share few heads' Q, dO and dQ rows in L2); inside a
// group k block by k block, so each head's k block 0 (which sees every q
// tile) goes first and the short blocks last.
template <bool OFFS>
__device__ __forceinline__ Item item(int w, int n_bh, int T, int causal, int q_off, int k_off) {
  const int n_kb = (T + BK - 1) / BK;
  const int full_items = (n_bh / GROUP) * GROUP * n_kb;  // items of the whole groups
  const int heads = w < full_items ? GROUP : n_bh % GROUP;  // the group's heads
  const int first = w < full_items ? w / (GROUP * n_kb) * GROUP : n_bh - heads;
  const int r = w < full_items ? w % (GROUP * n_kb) : w - full_items;
  Item it;
  it.bh = first + r % heads;
  it.k0 = (r / heads) * BK;
  it.start = first_q_tile<OFFS>(it.k0, T / BQ, causal, q_off, k_off);
  it.n_tiles = T / BQ - it.start;
  return it;
}

// ---------------------------------------------------------------------------
// The kernel: persistent, one block an SM. The producer takes the next
// item from a counter the launch's blocks share (`next`, zeroed by the
// caller), so a block that finishes early takes more, and hands it to the
// consumers with the item's K/V buffer. Threads 0-255 are the two
// consumer warpgroups, the rest the producer (a warp, or at D = 128 a
// warpgroup of which one thread loads); after the barrier
// set-up the producer never meets the consumers at a barrier again. A
// tile counter runs across the block's items, so the Q/dO ring, the dS^T
// buffers and the dQ staging carry over from one item to the next; K and
// V alternate between two buffers, so the producer loads the next item's
// K and V and first tiles while this item runs, and an item's dK and dV
// leave through its own K/V buffer (at D = 128 with dQ there is one K/V
// buffer, so an item's loads wait for the last item's epilogue). Named
// barriers: 1 and 2 each warpgroup's own, 3 both
// consumer warpgroups (0 is __syncthreads'). WITH_DQ = false drops every
// step of dQ (K^T, dS^T, barrier 3, the staging and the reductions).
// ---------------------------------------------------------------------------
template <int D, bool OFFS, bool WITH_DQ>
__global__ void __launch_bounds__((Smem<D, WITH_DQ>::NTHREADS), 1)
flash_bwd_sm90(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
               const __grid_constant__ CUtensorMap tdq, const float* __restrict__ lse,
               const float* __restrict__ delta, const float* __restrict__ glse,
               bf16* __restrict__ dk, bf16* __restrict__ dv, int* __restrict__ next, int n_bh,
               int T, int causal, int q_off, int k_off, float scale, float scale_log2) {
  typedef Smem<D, WITH_DQ> L;
  typedef typename L::S S;
  constexpr int STAGES = L::NS;  // this pass's ring depth
  constexpr int NKV = L::NKV, NDQ = L::NDQ;
  constexpr uint32_t KV_BYTES = L::KV_BYTES, WG_BYTES = L::WG_BYTES, TILE_BYTES = L::TILE_BYTES;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t bar0 = base + L::BAR;
  auto k_buf = [&](int b) { return L::KV + (2 * b) * KV_BYTES; };  // V follows K
  auto kv_full = [&](int b) { return bar0 + 8 * b; };
  auto kv_empty = [&](int b) { return bar0 + 8 * (NKV + b); };
  auto q_tile = [&](int s) { return base + L::QDO + (2 * s) * TILE_BYTES; };
  auto do_tile = [&](int s) { return base + L::QDO + (2 * s + 1) * TILE_BYTES; };
  auto rows = [&](int s, int which) { return L::ROWS + (3 * s + which) * ROWS_BYTES; };
  auto full = [&](int s) { return bar0 + 8 * (2 * NKV + s); };
  auto empty = [&](int s) { return bar0 + 8 * (2 * NKV + STAGES + s); };
  // the item each K/V buffer holds, -1 when the launch's items are done
  volatile int* item_of = reinterpret_cast<volatile int*>(smem + L::BAR + L::N_BARS * 8);

  const int n_items = n_bh * ((T + BK - 1) / BK);
  const int qo = OFFS ? q_off : 0, ko = OFFS ? k_off : 0;  // global offsets

  if (threadIdx.x == 0) {
    for (int b = 0; b < NKV; ++b) {
      mbar_init(kv_full(b), 1);
      mbar_init(kv_empty(b), N_CONSUMERS);
    }
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), N_CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  if (warp >= N_CONSUMERS * 4) {
    // ---- producer: one thread issues every load ----
    if constexpr (L::REG_SPLIT) reg_dealloc<24>();
    if (threadIdx.x != N_CONSUMERS * 128) return;
    const uint32_t tile_tx = 2 * TILE_BYTES + (OFFS ? 3 : 2) * ROWS_BYTES;
    int c = 0;  // tiles loaded
    for (int n_kv = 0;; ++n_kv) {  // items handed out
      const int w = atomicAdd(next, 1);
      // the buffer's item NKV back is done (its dK and dV are written)
      const int b = n_kv % NKV;
      if (n_kv >= NKV) mbar_wait(kv_empty(b), (n_kv / NKV - 1) & 1);
      if (w >= n_items) {
        item_of[b] = -1;
        mbar_arrive(kv_full(b));
        break;
      }
      item_of[b] = w;
      const Item it = item<OFFS>(w, n_bh, T, causal, qo, ko);
      if (it.n_tiles == 0) {  // nothing to load: the consumers write zeros
        mbar_arrive(kv_full(b));
        continue;
      }
      mbar_expect_tx(kv_full(b), 2 * KV_BYTES);
      tma_load_tile<D>(base + k_buf(b), &tk, kv_full(b), BK, it.k0, it.bh);
      tma_load_tile<D>(base + k_buf(b) + KV_BYTES, &tv, kv_full(b), BK, it.k0, it.bh);
      const size_t row0 = (size_t)it.bh * T;
      for (int j = 0; j < it.n_tiles; ++j, ++c) {
        const int s = c % STAGES, use = c / STAGES;
        const int q0 = (it.start + j) * BQ;
        if (use > 0) mbar_wait(empty(s), (use - 1) & 1);  // both warpgroups released it
        mbar_expect_tx(full(s), tile_tx);
        tma_load_tile<D>(q_tile(s), &tq, full(s), BQ, q0, it.bh);
        tma_load_tile<D>(do_tile(s), &tdo, full(s), BQ, q0, it.bh);
        bulk_load(base + rows(s, 0), lse + row0 + q0, ROWS_BYTES, full(s));
        bulk_load(base + rows(s, 1), delta + row0 + q0, ROWS_BYTES, full(s));
        if (OFFS) bulk_load(base + rows(s, 2), glse + row0 + q0, ROWS_BYTES, full(s));
      }
    }
    return;
  }

  // ---- consumer warpgroup wg: k rows [k0 + 64 wg, k0 + 64 wg + 64) of each item ----
  if constexpr (L::REG_SPLIT) reg_alloc<240>();
  const int wg = warp / 4, tid = threadIdx.x % 128;
  const int wi = warp % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;  // row in the 8-row group, column pair
  const int lim_row = 16 * wi + g - 2 * t;
  float dk_acc[D / 2], dv_acc[D / 2], dq[D / 4];
  float sc[32], dp[32];
  uint32_t pa[16], da[16];  // P^T and dS^T, bf16 pairs
#pragma unroll
  for (int i = 0; i < D / 4; ++i) dq[i] = 0.f;
  int c = 0;  // tiles consumed

  for (int n_kv = 0;; ++n_kv) {
    const int b = n_kv % NKV;
    mbar_wait(kv_full(b), (n_kv / NKV) & 1);
    const int w = item_of[b];
    if (w < 0) break;
    const Item it = item<OFFS>(w, n_bh, T, causal, qo, ko);
    const int r0 = it.k0 + wg * WG_ROWS;
    const bool dead = r0 >= T;  // the k rows past T of a half block
    const size_t row0 = (size_t)it.bh * T;
    if (it.n_tiles == 0) {
      // no q row sees this k block: dK = dV = 0 without loading anything
      if (!dead) {
        const uint4 zero = make_uint4(0, 0, 0, 0);
#pragma unroll
        for (int n = 0; n < WG_BYTES / 16 / 128; ++n) {
          const int cc = tid + 128 * n, r = cc / (D / 8), ch = cc % (D / 8);
          *reinterpret_cast<uint4*>(dk + (row0 + r0 + r) * D + ch * 8) = zero;
          *reinterpret_cast<uint4*>(dv + (row0 + r0 + r) * D + ch * 8) = zero;
        }
      }
      // every warp has read the item id before the buffer can take the
      // next one (without this a late warp can miss a phase and hang)
      named_bar(1 + wg, 128);
      if (tid == 0) mbar_arrive(kv_empty(b));
      continue;
    }

    const uint32_t off_k = k_buf(b), off_v = off_k + KV_BYTES;
    // this warpgroup's first rows of the item's K and V (atom 0)
    const uint32_t k_rows = base + off_k + wg * WG_ROWS * S::RB;
    const uint32_t v_rows = base + off_v + wg * WG_ROWS * S::RB;
    if constexpr (WITH_DQ) {
      // both warpgroups are done with the last item's K^T
      named_bar(3, N_CONSUMERS * 128);
      // K^T for the dQ product: two K-major [D, 64 k] tiles, swizzled
      // (rows of 64 k, 128 bytes); each thread moves two 8-column chunks of
      // two neighbouring k rows
      for (int n = threadIdx.x; n < (BK / 2) * (D / 8); n += N_CONSUMERS * 128) {
        const int kr = 2 * (n % (BK / 2)), ch = n / (BK / 2);  // k rows kr, kr + 1; d columns 8ch ..
        const uint4 lo = *reinterpret_cast<const uint4*>(smem + off_k + S::off(BK, kr, ch));
        const uint4 hi = *reinterpret_cast<const uint4*>(smem + off_k + S::off(BK, kr + 1, ch));
        const uint16_t* ea = reinterpret_cast<const uint16_t*>(&lo);
        const uint16_t* eb = reinterpret_cast<const uint16_t*>(&hi);
        unsigned char* kt = smem + L::KT + (kr / 64) * L::KT_BYTES;
        const int kc = kr % 64;
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int d = 8 * ch + u;
          *reinterpret_cast<uint32_t*>(kt + d * 128 + (((kc / 8) ^ (d & 7)) << 4) + (kc % 8) * 2) =
              (uint32_t)ea[u] | ((uint32_t)eb[u] << 16);
        }
      }
      fence_async_smem();  // K^T is read by wgmma after the first named barrier 3
    }

#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
    // the tile's first q row against this warpgroup's first k row
    const int kq = ko + r0 - qo;

    for (int j = 0; j < it.n_tiles; ++j, ++c) {
      const int s = c % STAGES;
      const int q0 = (it.start + j) * BQ;
      mbar_wait(full(s), (c / STAGES) & 1);
      const float* lse_s = reinterpret_cast<const float*>(smem + rows(s, 0));
      const float* delta_s = reinterpret_cast<const float*>(smem + rows(s, 1));
      const float* glse_s = reinterpret_cast<const float*>(smem + rows(s, 2));
      constexpr uint32_t KA = BK * S::RB, QA = BQ * S::RB;  // column atoms' distances
      // a tile whose last q row comes before this warpgroup's first k row
      // adds nothing; one whose first q row comes before its last k row
      // takes the mask
      const bool skip = dead || ((OFFS || causal) && q0 + BQ - 1 < kq);
      if (!skip) {
        // S^T = K Q^T and dP^T = V dO^T, both from shared memory
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) wgmma_ss(sc, S::k_desc(k_rows, KA, kk), S::k_desc(q_tile(s), QA, kk), kk > 0);
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) wgmma_ss(dp, S::k_desc(v_rows, KA, kk), S::k_desc(do_tile(s), QA, kk), kk > 0);
        wgmma_commit();
        wgmma_wait<0>();
        reg_fence(sc);
        reg_fence(dp);
        const int lim0 = kq - q0 + lim_row;  // column 8i + e of row half h is masked below lim0 + 8h
        if ((OFFS || causal) && q0 < kq + WG_ROWS - 1)
          softmax_grad<true, OFFS>(sc, dp, pa, da, lse_s, delta_s, glse_s, lim0, t, scale_log2);
        else
          softmax_grad<false, OFFS>(sc, dp, pa, da, lse_s, delta_s, glse_s, lim0, t, scale_log2);
      } else if (WITH_DQ) {
#pragma unroll
        for (int i = 0; i < 16; ++i) pa[i] = da[i] = 0u;
      }
      if constexpr (WITH_DQ) {
        // this thread's bulk reduction of NDQ tiles ago has read its staging
        if (tid == 0) bulk_wait_read<NDQ - 1>();
        // dS^T rows of this warpgroup into the tile's dS^T buffer ([128 k,
        // 64 q], 128-byte rows at every width)
        typedef Swz<128> T128;
        unsigned char* ds_t = smem + L::DS + (c & 1) * DST_BYTES;
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = 16 * wi + g + 8 * h;
            *reinterpret_cast<uint32_t*>(ds_t + T128::off(BK, wg * WG_ROWS + r, i, 4 * t)) = da[2 * i + h];
          }
        fence_async_smem();
        // dV += P^T dO and dK += dS^T Q
        wgmma_fence();
        dkv_products<D>(dv_acc, dk_acc, pa, da, do_tile(s), q_tile(s));
        wgmma_commit();
        named_bar(3, N_CONSUMERS * 128);  // both halves of dS^T are written
        // dQ[:, D/2 wg .. D/2 wg + D/2 - 1] = dS K over the item's 128 k
        // rows: dS^T an MN-major A (16 k rows a step), K^T a K-major B (32
        // bytes a step; the warpgroup's D / 2 rows of each K^T tile)
        wgmma_fence();
        const uint32_t ds_all = base + L::DS + (c & 1) * DST_BYTES;
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          wgmma_ss_ta<D / 2>(dq, T128::desc(ds_all + kk * 16 * 128),
                             T128::desc(base + L::KT + (kk / 4) * L::KT_BYTES + wg * (D / 2) * 128) + 2 * (kk % 4),
                             kk > 0);
        wgmma_commit();
        wgmma_wait<0>();
        reg_fence(dv_acc);
        reg_fence(dk_acc);
        reg_fence(dq);
        if (tid == 0) mbar_arrive(empty(s));  // Q, dO and the rows of the stage are consumed
        // scale dQ's share into this warpgroup's staging half (fp32 rows of
        // 2D bytes, swizzled as a bf16 row of D) and add it into dq_acc
        // with one bulk reduction a column atom
        const uint32_t stage_off = L::DQ + (NDQ * wg + c % NDQ) * L::DQ_HALF_BYTES;
        unsigned char* st = smem + stage_off;
        constexpr int CPR = S::RB / 16;  // 16-byte chunks of an atom's row
#pragma unroll
        for (int i = 0; i < D / 16; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = 16 * wi + g + 8 * h;
            *reinterpret_cast<float2*>(st + S::at(BQ, 2 * i / CPR, r, 2 * i % CPR + (t >> 1), 8 * (t & 1))) =
                make_float2(dq[4 * i + 2 * h] * scale, dq[4 * i + 2 * h + 1] * scale);
          }
        fence_async_smem();
        named_bar(1 + wg, 128);
        if (tid == 0) {
#pragma unroll
          for (int a = 0; a < S::ATOMS; ++a)
            tma_reduce_add(&tdq, base + stage_off + a * BQ * S::RB, (D / 2) * wg + a * S::RB / 4, q0, it.bh);
          bulk_commit();
        }
      } else {
        if (!skip) {
          // dV += P^T dO and dK += dS^T Q
          wgmma_fence();
          dkv_products<D>(dv_acc, dk_acc, pa, da, do_tile(s), q_tile(s));
          wgmma_commit();
          wgmma_wait<0>();
          reg_fence(dv_acc);
          reg_fence(dk_acc);
        }
        // every warp is done with the stage (its rows, read outside any
        // wgmma, included), and none can fall a barrier phase behind
        // while its warpgroup skips tiles
        named_bar(1 + wg, 128);
        if (tid == 0) mbar_arrive(empty(s));
      }
    }
    // ---- dK scale and dV as bf16 through this warpgroup's halves of the
    // item's K and V tiles (only this warpgroup read them) ----
    if (dead) {
      if (tid == 0) mbar_arrive(kv_empty(b));
      continue;
    }
    unsigned char* out_k = smem + off_k;
    unsigned char* out_v = smem + off_v;
    const int srow = wg * WG_ROWS;  // this warpgroup's rows of the tiles
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 16 * wi + g + 8 * h;
        const uint32_t off = S::off(BK, srow + r, i, 4 * t);
        *reinterpret_cast<uint32_t*>(out_k + off) =
            pack_bf16(dk_acc[4 * i + 2 * h] * scale, dk_acc[4 * i + 2 * h + 1] * scale);
        *reinterpret_cast<uint32_t*>(out_v + off) = pack_bf16(dv_acc[4 * i + 2 * h], dv_acc[4 * i + 2 * h + 1]);
      }
    named_bar(1 + wg, 128);
    bf16* gk = dk + (row0 + r0) * D;
    bf16* gv = dv + (row0 + r0) * D;
#pragma unroll
    for (int n = 0; n < WG_BYTES / 16 / 128; ++n) {
      const int cc = tid + 128 * n, r = cc / (D / 8), ch = cc % (D / 8);
      const uint32_t off = S::off(BK, srow + r, ch);
      *reinterpret_cast<uint4*>(gk + r * D + ch * 8) = *reinterpret_cast<const uint4*>(out_k + off);
      *reinterpret_cast<uint4*>(gv + r * D + ch * 8) = *reinterpret_cast<const uint4*>(out_v + off);
    }
    named_bar(1 + wg, 128);  // the buffer is read: an item NKV on may load into it
    if (tid == 0) mbar_arrive(kv_empty(b));
  }
  if (WITH_DQ && tid == 0) bulk_wait_read<0>();  // the staging stays valid until read
}

// ---- host side ----

// streaming multiprocessors of the current device (the persistent grid's
// size), read once a device: the host work of a call counts in every ring hop
int sm_count(int dev) {
  static int n[MAX_DEVICES] = {};
  if (dev < 0 || dev >= MAX_DEVICES) return 132;
  if (n[dev] <= 0 && (cudaDeviceGetAttribute(&n[dev], cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
                      n[dev] <= 0))
    n[dev] = 132;
  return n[dev];
}

template <int D, bool OFFS, bool WITH_DQ>
int launch(const void* q, const void* k, const void* v, const void* dO, const void* lse,
           const void* delta, const void* glse, void* dk, void* dv, void* dq_acc, int bh, int T,
           int causal, int q_off, int k_off, cudaStream_t stream) {
  typedef Smem<D, WITH_DQ> L;
  EncodeTiled fn = encoder();
  if (fn == nullptr) return (int)cudaErrorSymbolNotFound;
  CUtensorMap mq, mk, mv, mdo, mdq = {};  // no dQ map without dQ
  // dq_acc is reduced into in boxes of [64 rows, one column atom of the
  // fp32 staging], whose rows are 2D bytes
  if (!encode_bf16<D>(fn, &mq, q, bh, T, BQ) || !encode_bf16<D>(fn, &mk, k, bh, T, BK) ||
      !encode_bf16<D>(fn, &mv, v, bh, T, BK) || !encode_bf16<D>(fn, &mdo, dO, bh, T, BQ) ||
      (WITH_DQ && !encode<L::S::RB>(fn, &mdq, dq_acc, bh, T, D, BQ, 4)))
    return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  constexpr uint32_t smem_bytes = L::BYTES;
  static bool smem_set[MAX_DEVICES] = {};  // the attribute, once a device
  if (dev >= MAX_DEVICES || !smem_set[dev]) {
    err = cudaFuncSetAttribute(flash_bwd_sm90<D, OFFS, WITH_DQ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem_bytes);
    if (err != cudaSuccess) return (int)err;
    if (dev < MAX_DEVICES) smem_set[dev] = true;
  }
  const float scale = 1.0f / sqrtf((float)D);
  const int n_items = bh * ((T + BK - 1) / BK);
  const size_t n = (size_t)bh * T * D;
  int* next = WITH_DQ ? reinterpret_cast<int*>(static_cast<float*>(dq_acc) + n)
                      : reinterpret_cast<int*>(static_cast<bf16*>(dv) + n);
  flash_bwd_sm90<D, OFFS, WITH_DQ><<<min(n_items, sm_count(dev)), L::NTHREADS, smem_bytes, stream>>>(
      mq, mk, mv, mdo, mdq, (const float*)lse, (const float*)delta, (const float*)glse, (bf16*)dk,
      (bf16*)dv, next, bh, T, causal, q_off, k_off, scale, scale * LOG2E);
  return (int)cudaGetLastError();
}

// TMA and the bulk copies read from 16-byte aligned addresses; the
// 16-byte stores need the same of dk and dv
bool bad_shape(const void* q, const void* k, const void* v, const void* dO, const void* lse,
               const void* delta, const void* glse, const void* dk, const void* dv,
               const void* dq_acc, int bh, int T) {
  const uintptr_t any = (uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)dO |
                        (uintptr_t)lse | (uintptr_t)delta | (uintptr_t)glse | (uintptr_t)dk |
                        (uintptr_t)dv | (uintptr_t)dq_acc;
  return T % BQ != 0 || T <= 0 || bh <= 0 || (any & 15) != 0;
}

}  // namespace

// ---- plain C interface (bound with ctypes) ----
// Every function returns 0 on success, a cudaError_t on a failed launch or
// tensor-map encoding, or -1 for a head_dim / length / alignment it was not
// built for.

extern "C" int p2p_flash_bwd_dkvq(const void* q, const void* k, const void* v, const void* dO,
                                  const void* lse, const void* delta, void* dk, void* dv,
                                  void* dq_acc, int bh, int T, int D, int causal,
                                  void* stream) {
  if (bad_shape(q, k, v, dO, lse, delta, nullptr, dk, dv, dq_acc, bh, T)) return BAD_SHAPE;
  return by_width(D, [&](auto w) {
    return launch<decltype(w)::value, false, true>(q, k, v, dO, lse, delta, nullptr, dk, dv, dq_acc, bh, T,
                                                   causal, 0, 0, (cudaStream_t)stream);
  });
}

// offset-aware (ring attention hops); causal by construction
extern "C" int p2p_flash_bwd_dkvq_offs(const void* q, const void* k, const void* v,
                                       const void* dO, const void* lse, const void* delta,
                                       const void* glse, void* dk, void* dv, void* dq_acc,
                                       int bh, int T, int D, int q_off, int k_off,
                                       void* stream) {
  if (bad_shape(q, k, v, dO, lse, delta, glse, dk, dv, dq_acc, bh, T)) return BAD_SHAPE;
  return by_width(D, [&](auto w) {
    return launch<decltype(w)::value, true, true>(q, k, v, dO, lse, delta, glse, dk, dv, dq_acc, bh, T, 1,
                                                  q_off, k_off, (cudaStream_t)stream);
  });
}

// the split pass's dK and dV; dv is followed by 16 zeroed bytes
extern "C" int p2p_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dO,
                                 const void* lse, const void* delta, void* dk, void* dv,
                                 int bh, int T, int D, int causal, void* stream) {
  if (bad_shape(q, k, v, dO, lse, delta, nullptr, dk, dv, nullptr, bh, T)) return BAD_SHAPE;
  return by_width(D, [&](auto w) {
    return launch<decltype(w)::value, false, false>(q, k, v, dO, lse, delta, nullptr, dk, dv, nullptr, bh, T,
                                                    causal, 0, 0, (cudaStream_t)stream);
  });
}

extern "C" int p2p_flash_bwd_dkv_offs(const void* q, const void* k, const void* v,
                                      const void* dO, const void* lse, const void* delta,
                                      const void* glse, void* dk, void* dv, int bh, int T,
                                      int D, int q_off, int k_off, void* stream) {
  if (bad_shape(q, k, v, dO, lse, delta, glse, dk, dv, nullptr, bh, T)) return BAD_SHAPE;
  return by_width(D, [&](auto w) {
    return launch<decltype(w)::value, true, false>(q, k, v, dO, lse, delta, glse, dk, dv, nullptr, bh, T, 1,
                                                   q_off, k_off, (cudaStream_t)stream);
  });
}

// dynamic shared memory of one block of the fused backward at a head
// width, in bytes (-1 for a width not built)
extern "C" int p2p_flash_bwd_smem_bytes(int head_dim) {
  return by_width(head_dim, [](auto w) { return (int)Smem<decltype(w)::value, true>::BYTES; });
}

// the same of the split dK/dV pass
extern "C" int p2p_flash_bwd_dkv_smem_bytes(int head_dim) {
  return by_width(head_dim, [](auto w) { return (int)Smem<decltype(w)::value, false>::BYTES; });
}
