// Flash attention for Hopper (sm_90a): forward, fused backward and split
// backward, hand-written in CUDA C++ with warp-level tensor-core products
// (nvcuda::wmma, bf16 operands, fp32 accumulation).
//
// Port of the Pallas kernels in p2pfl_tpu/ops/flash_attention.py:
//   p2p_flash_fwd      <- _flash_kernel (+ _fwd_tile)
//   p2p_flash_bwd_dkvq <- _dkvq_kernel  (+ _dkv_step with dq_acc)
//   p2p_flash_bwd_dq   <- _dq_kernel
//   p2p_flash_bwd_dkv  <- _dkv_kernel   (+ _dkv_step)
//
// Layout: q, k, v, o, dO, dq, dk, dv are [BH, T, D] bf16, contiguous;
// lse and delta are [BH, T] fp32 (the JAX [B, H, 1, T] row layout).
// T must be a multiple of 64; D (head_dim) is 64, the only width built.
//
// Rounding points follow the JAX kernels: operands stay bf16 and every
// product accumulates in fp32; P is cast to bf16 before P.V and P^T.dO;
// dS is cast to bf16 before dS.K and dS^T.Q; the output is
// acc / max(l, 1e-30); fully masked rows keep lse = NEG_INF.
//
// Each extern "C" entry point launches one kernel on the given stream and
// returns cudaGetLastError() so the Python wrapper can raise on a refused
// launch. Nothing here allocates or synchronises.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>
#include <cmath>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int BQ = 64;        // q rows per tile
constexpr int BK = 64;        // k rows per tile
constexpr int NWARPS = 4;     // each warp owns 16 rows of a 64-row tile
constexpr int NTHREADS = NWARPS * 32;
constexpr float NEG_INF = -1e30f;
constexpr int PAD_H = 8;      // bf16 row padding: 16 bytes
constexpr int PAD_F = 4;      // fp32 row padding: 16 bytes
constexpr int LDS = BK + PAD_F;  // fp32 [64, 64] score tiles
constexpr int LDP = BK + PAD_H;  // bf16 [64, 64] probability tiles

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> FragAT;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragB;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> FragBT;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

__host__ __device__ constexpr size_t align128(size_t n) { return (n + 127) / 128 * 128; }

// Copy a [rows, D] bf16 tile (row stride D) into shared memory (row
// stride D + PAD_H), 16 bytes per thread per step.
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int rows) {
  constexpr int PER_ROW = D / 8;
  for (int i = threadIdx.x; i < rows * PER_ROW; i += NTHREADS) {
    const int r = i / PER_ROW, c = (i % PER_ROW) * 8;
    *reinterpret_cast<uint4*>(dst + r * (D + PAD_H) + c) =
        *reinterpret_cast<const uint4*>(src + (size_t)r * D + c);
  }
}

// S[16, 64] = A[16, D] . B[64, D]^T for one warp: A is this warp's 16 rows
// (row stride D + PAD_H), B a whole 64-row tile; S is fp32 (stride LDS).
template <int D>
__device__ __forceinline__ void warp_abT(float* S, const bf16* A, const bf16* B) {
  FragA a;
  FragBT b;
  FragC c;
#pragma unroll
  for (int n = 0; n < BK / 16; ++n) {
    wmma::fill_fragment(c, 0.f);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wmma::load_matrix_sync(a, A + kk * 16, D + PAD_H);
      wmma::load_matrix_sync(b, B + n * 16 * (D + PAD_H) + kk * 16, D + PAD_H);
      wmma::mma_sync(c, a, b, c);
    }
    wmma::store_matrix_sync(S + n * 16, c, LDS, wmma::mem_row_major);
  }
}

// acc[n] += X[16, 64] . Y[64, D] for one warp: X is this warp's 16 rows of a
// bf16 [64, 64] tile (stride LDP), Y a bf16 tile (stride D + PAD_H).
template <int D>
__device__ __forceinline__ void warp_xy(FragC* acc, const bf16* X, const bf16* Y) {
  FragA a;
  FragB b;
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    wmma::load_matrix_sync(a, X + kk * 16, LDP);
#pragma unroll
    for (int n = 0; n < D / 16; ++n) {
      wmma::load_matrix_sync(b, Y + kk * 16 * (D + PAD_H) + n * 16, D + PAD_H);
      wmma::mma_sync(acc[n], a, b, acc[n]);
    }
  }
}

// acc[n] += X[:, 16w:16w+16]^T . Y[64, D]: the transposed product that
// dV = P^T dO and dK = dS^T Q need; X is a bf16 [64, 64] tile (stride LDP)
// read column-major, so no transpose is materialised.
template <int D>
__device__ __forceinline__ void warp_xTy(FragC* acc, const bf16* X, int col0, const bf16* Y) {
  FragAT a;
  FragB b;
#pragma unroll
  for (int kk = 0; kk < BQ / 16; ++kk) {
    wmma::load_matrix_sync(a, X + kk * 16 * LDP + col0, LDP);
#pragma unroll
    for (int n = 0; n < D / 16; ++n) {
      wmma::load_matrix_sync(b, Y + kk * 16 * (D + PAD_H) + n * 16, D + PAD_H);
      wmma::mma_sync(acc[n], a, b, acc[n]);
    }
  }
}

// One scaled, masked score: S = (Q K^T) * scale, NEG_INF above the causal
// diagonal (row < col in global coordinates).
__device__ __forceinline__ float masked_score(float s, float scale, bool masked, int row, int col) {
  s *= scale;
  return (masked && row < col) ? NEG_INF : s;
}

// Store this warp's 16 rows of fp32 fragments to staging, then write them
// as bf16 rows [row0, row0 + 16) of a [T, D] output.
template <int D>
__device__ __forceinline__ void warp_store_rows(bf16* out, float* stage, FragC* acc, int lane) {
#pragma unroll
  for (int n = 0; n < D / 16; ++n)
    wmma::store_matrix_sync(stage + n * 16, acc[n], D + PAD_F, wmma::mem_row_major);
  __syncwarp();
  for (int i = lane; i < 16 * D; i += 32) {
    const int r = i / D, c = i % D;
    out[(size_t)r * D + c] = __float2bfloat16(stage[r * (D + PAD_F) + c]);
  }
  __syncwarp();
}

// ---------------------------------------------------------------------------
// Forward.  Replaces _flash_kernel / _fwd_tile.
//
// Bound on the H100: at T = 1024, D = 64 the causal forward does ~2 T^2 D
// flops per head against 4 T D bytes, far above the card's ~295 flop/byte
// ridge, so it is bound by tensor-core work. Design: one block of 4 warps
// per (bh, 64-row q tile); each warp owns 16 q rows end to end (scores,
// online softmax, rescale, P.V), so only the K/V tile loads need a block
// barrier. The running output accumulates in fp32 shared memory and
// goes through the tensor cores as the wmma accumulator. Blocks are
// issued longest first (highest q tile) to shorten the causal tail.
// Simple and right first: no TMA, no wgmma, no pipelining of the K/V loads.
// ---------------------------------------------------------------------------
template <int D>
struct FwdSmem {
  static constexpr int LDH = D + PAD_H, LDO = D + PAD_F;
  static constexpr size_t q = 0;
  static constexpr size_t k = q + align128(BQ * LDH * sizeof(bf16));
  static constexpr size_t v = k + align128(BK * LDH * sizeof(bf16));
  static constexpr size_t s = v + align128(BK * LDH * sizeof(bf16));
  static constexpr size_t p = s + align128(BQ * LDS * sizeof(float));
  static constexpr size_t o = p + align128(BQ * LDP * sizeof(bf16));
  static constexpr size_t total = o + align128(BQ * LDO * sizeof(float));
};

template <int D>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o,
                 float* __restrict__ lse, int T, int causal, float scale) {
  typedef FwdSmem<D> L;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem + L::q);
  bf16* Ks = reinterpret_cast<bf16*>(smem + L::k);
  bf16* Vs = reinterpret_cast<bf16*>(smem + L::v);
  float* Ss = reinterpret_cast<float*>(smem + L::s);
  bf16* Ps = reinterpret_cast<bf16*>(smem + L::p);
  float* Os = reinterpret_cast<float*>(smem + L::o);

  const int qi = gridDim.x - 1 - blockIdx.x;  // longest causal rows first
  const size_t base = (size_t)blockIdx.y * T * D;
  const int q0 = qi * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r = lane >> 1, h = lane & 1;  // lane pair per row, half the columns each
  const int wrow = warp * 16;
  const int grow = q0 + wrow + r;  // this lane's global q row

  load_tile<D>(Qs, q + base + (size_t)q0 * D, BQ);
  for (int i = lane; i < 16 * D; i += 32)
    Os[(wrow + i / D) * L::LDO + i % D] = 0.f;

  float m = NEG_INF, l = 0.f;
  const int n_k = causal ? (q0 + BQ + BK - 1) / BK : T / BK;
  for (int j = 0; j < n_k; ++j) {
    const int k0 = j * BK;
    const bool masked = causal && (k0 + BK - 1 > q0);
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<D>(Ks, k + base + (size_t)k0 * D, BK);
    load_tile<D>(Vs, v + base + (size_t)k0 * D, BK);
    __syncthreads();

    warp_abT<D>(Ss + wrow * LDS, Qs + wrow * L::LDH, Ks);
    __syncwarp();

    float* srow = Ss + (wrow + r) * LDS + h * 32;
    float mx = NEG_INF;
#pragma unroll 8
    for (int c = 0; c < 32; ++c) {
      const float s = masked_score(srow[c], scale, masked, grow, k0 + h * 32 + c);
      srow[c] = s;
      mx = fmaxf(mx, s);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m, mx);
    const float alpha = (m <= NEG_INF / 2) ? 0.f : expf(m - m_new);
    const bool dead = m_new <= NEG_INF / 2;
    bf16* prow = Ps + (wrow + r) * LDP + h * 32;
    float sum = 0.f;
#pragma unroll 8
    for (int c = 0; c < 32; ++c) {
      const float p = dead ? 0.f : expf(srow[c] - m_new);
      sum += p;
      prow[c] = __float2bfloat16(p);
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    l = l * alpha + sum;
    m = m_new;
    float* orow = Os + (wrow + r) * L::LDO + h * (D / 2);
#pragma unroll
    for (int c = 0; c < D / 2; ++c) orow[c] *= alpha;
    __syncwarp();

    FragC acc[D / 16];
#pragma unroll
    for (int n = 0; n < D / 16; ++n)
      wmma::load_matrix_sync(acc[n], Os + wrow * L::LDO + n * 16, L::LDO, wmma::mem_row_major);
    warp_xy<D>(acc, Ps + wrow * LDP, Vs);
#pragma unroll
    for (int n = 0; n < D / 16; ++n)
      wmma::store_matrix_sync(Os + wrow * L::LDO + n * 16, acc[n], L::LDO, wmma::mem_row_major);
    __syncwarp();
  }

  const float l_safe = fmaxf(l, 1e-30f);
  const float* orow = Os + (wrow + r) * L::LDO + h * (D / 2);
  bf16* out = o + base + (size_t)grow * D + h * (D / 2);
#pragma unroll
  for (int c = 0; c < D / 2; ++c) out[c] = __float2bfloat16(orow[c] / l_safe);
  if (h == 0)
    lse[(size_t)blockIdx.y * T + grow] =
        (m <= NEG_INF / 2) ? NEG_INF : m + logf(fmaxf(l, 1e-30f));
}

// ---------------------------------------------------------------------------
// Backward, per k tile.  WITH_DQ = true replaces _dkvq_kernel (fused
// single pass), WITH_DQ = false replaces _dkv_kernel (split pass).
//
// Bound on the H100: tensor-core work again (5 block products per tile
// pair fused, 4 here plus 3 in the dq pass split). The TPU kernel carries
// dQ across a sequential k grid in VMEM scratch; blocks on Hopper run in
// no order, so each block adds its dQ share into an fp32 [BH, T, D]
// buffer with atomics (the wrapper zeroes it and casts it to bf16), which
// makes dQ's summation order vary from run to run. dK and dV stay in
// tensor-core accumulator registers for the whole q sweep. Each warp owns
// 16 q rows for the scores and 16 k rows for dK/dV, so one block barrier
// per q tile separates the two phases.
// ---------------------------------------------------------------------------
template <int D>
struct BwdSmem {
  static constexpr int LDH = D + PAD_H, LDQ = D + PAD_F;
  static constexpr size_t k = 0;
  static constexpr size_t v = k + align128(BK * LDH * sizeof(bf16));
  static constexpr size_t q = v + align128(BK * LDH * sizeof(bf16));
  static constexpr size_t dO = q + align128(BQ * LDH * sizeof(bf16));
  static constexpr size_t s = dO + align128(BQ * LDH * sizeof(bf16));
  static constexpr size_t dp = s + align128(BQ * LDS * sizeof(float));
  static constexpr size_t p = dp + align128(BQ * LDS * sizeof(float));
  static constexpr size_t ds = p + align128(BQ * LDP * sizeof(bf16));
  static constexpr size_t lse = ds + align128(BQ * LDP * sizeof(bf16));
  static constexpr size_t delta = lse + align128(BQ * sizeof(float));
  static constexpr size_t stage = delta + align128(BQ * sizeof(float));
  static constexpr size_t total = stage + align128(BQ * LDQ * sizeof(float));
};

// P = exp(S - lse) and dS = P * (dP - delta) for this lane's half row;
// S masked as in the forward. Writes both bf16 tiles.
__device__ __forceinline__ void softmax_grad_row(
    const float* srow, const float* dprow, bf16* prow, bf16* dsrow, float lse_r,
    float delta_r, float scale, bool masked, int grow, int col0) {
#pragma unroll 8
  for (int c = 0; c < 32; ++c) {
    const float s = masked_score(srow[c], scale, masked, grow, col0 + c);
    const float p = expf(s - lse_r);  // masked entries underflow to 0
    prow[c] = __float2bfloat16(p);
    dsrow[c] = __float2bfloat16(p * (dprow[c] - delta_r));
  }
}

template <int D, bool WITH_DQ>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_kv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dO,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    bf16* __restrict__ dk, bf16* __restrict__ dv,
                    float* __restrict__ dq_acc, int T, int causal, float scale) {
  typedef BwdSmem<D> L;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem + L::k);
  bf16* Vs = reinterpret_cast<bf16*>(smem + L::v);
  bf16* Qs = reinterpret_cast<bf16*>(smem + L::q);
  bf16* dOs = reinterpret_cast<bf16*>(smem + L::dO);
  float* Ss = reinterpret_cast<float*>(smem + L::s);
  float* dPs = reinterpret_cast<float*>(smem + L::dp);
  bf16* Ps = reinterpret_cast<bf16*>(smem + L::p);
  bf16* dSs = reinterpret_cast<bf16*>(smem + L::ds);
  float* lses = reinterpret_cast<float*>(smem + L::lse);
  float* deltas = reinterpret_cast<float*>(smem + L::delta);
  float* stage = reinterpret_cast<float*>(smem + L::stage);

  const int kj = blockIdx.x;
  const size_t base = (size_t)blockIdx.y * T * D;
  const size_t rbase = (size_t)blockIdx.y * T;
  const int k0 = kj * BK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r = lane >> 1, h = lane & 1;
  const int wrow = warp * 16;

  load_tile<D>(Ks, k + base + (size_t)k0 * D, BK);
  load_tile<D>(Vs, v + base + (size_t)k0 * D, BK);

  FragC dk_acc[D / 16], dv_acc[D / 16];
#pragma unroll
  for (int n = 0; n < D / 16; ++n) {
    wmma::fill_fragment(dk_acc[n], 0.f);
    wmma::fill_fragment(dv_acc[n], 0.f);
  }

  const int nq = T / BQ;
  // q tiles strictly above this k tile's diagonal never see it
  const int start = causal ? k0 / BQ : 0;
  for (int i = start; i < nq; ++i) {
    const int q0 = i * BQ;
    const bool masked = causal && (q0 < k0 + BK - 1);
    __syncthreads();  // the previous q tile's products are done
    load_tile<D>(Qs, q + base + (size_t)q0 * D, BQ);
    load_tile<D>(dOs, dO + base + (size_t)q0 * D, BQ);
    if (threadIdx.x < BQ) {
      lses[threadIdx.x] = lse[rbase + q0 + threadIdx.x];
      deltas[threadIdx.x] = delta[rbase + q0 + threadIdx.x];
    }
    __syncthreads();

    warp_abT<D>(Ss + wrow * LDS, Qs + wrow * L::LDH, Ks);
    warp_abT<D>(dPs + wrow * LDS, dOs + wrow * L::LDH, Vs);
    __syncwarp();
    const int row = wrow + r;
    softmax_grad_row(Ss + row * LDS + h * 32, dPs + row * LDS + h * 32,
                     Ps + row * LDP + h * 32, dSs + row * LDP + h * 32,
                     lses[row], deltas[row], scale, masked, q0 + row, k0 + h * 32);
    __syncthreads();  // dV/dK read every q row of P and dS

    warp_xTy<D>(dv_acc, Ps, wrow, dOs);
    warp_xTy<D>(dk_acc, dSs, wrow, Qs);
    if (WITH_DQ) {
      FragC dq_part[D / 16];
#pragma unroll
      for (int n = 0; n < D / 16; ++n) wmma::fill_fragment(dq_part[n], 0.f);
      warp_xy<D>(dq_part, dSs + wrow * LDP, Ks);
      float* st = stage + wrow * L::LDQ;
#pragma unroll
      for (int n = 0; n < D / 16; ++n)
        wmma::store_matrix_sync(st + n * 16, dq_part[n], L::LDQ, wmma::mem_row_major);
      __syncwarp();
      float* dst = dq_acc + base + (size_t)(q0 + wrow) * D;
      for (int e = lane; e < 16 * D; e += 32)
        atomicAdd(dst + e, scale * st[(e / D) * L::LDQ + e % D]);
      __syncwarp();
    }
  }

#pragma unroll
  for (int n = 0; n < D / 16; ++n)
#pragma unroll
    for (int e = 0; e < dk_acc[n].num_elements; ++e) dk_acc[n].x[e] *= scale;
  float* st = stage + wrow * L::LDQ;
  warp_store_rows<D>(dv + base + (size_t)(k0 + wrow) * D, st, dv_acc, lane);
  warp_store_rows<D>(dk + base + (size_t)(k0 + wrow) * D, st, dk_acc, lane);
}

// ---------------------------------------------------------------------------
// Backward dQ per q tile.  Replaces _dq_kernel (split pass).
//
// Bound on the H100: tensor-core work (S, dP and dS.K per tile pair). No
// cross-block state: each block owns 64 q rows, streams the K/V tiles up
// to the causal frontier (the loop bounds of _dq_kernel) and keeps dQ in
// accumulator registers; every warp's rows depend only on its own scores,
// so only the K/V loads need a block barrier.
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dO,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    bf16* __restrict__ dq, int T, int causal, float scale) {
  typedef BwdSmem<D> L;  // same tiles; K/V stream, Q/dO stay resident
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem + L::k);
  bf16* Vs = reinterpret_cast<bf16*>(smem + L::v);
  bf16* Qs = reinterpret_cast<bf16*>(smem + L::q);
  bf16* dOs = reinterpret_cast<bf16*>(smem + L::dO);
  float* Ss = reinterpret_cast<float*>(smem + L::s);
  float* dPs = reinterpret_cast<float*>(smem + L::dp);
  bf16* Ps = reinterpret_cast<bf16*>(smem + L::p);
  bf16* dSs = reinterpret_cast<bf16*>(smem + L::ds);
  float* stage = reinterpret_cast<float*>(smem + L::stage);

  const int qi = gridDim.x - 1 - blockIdx.x;  // longest causal rows first
  const size_t base = (size_t)blockIdx.y * T * D;
  const size_t rbase = (size_t)blockIdx.y * T;
  const int q0 = qi * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r = lane >> 1, h = lane & 1;
  const int wrow = warp * 16;
  const int row = wrow + r;

  load_tile<D>(Qs, q + base + (size_t)q0 * D, BQ);
  load_tile<D>(dOs, dO + base + (size_t)q0 * D, BQ);
  const float lse_r = lse[rbase + q0 + row];
  const float delta_r = delta[rbase + q0 + row];

  FragC acc[D / 16];
#pragma unroll
  for (int n = 0; n < D / 16; ++n) wmma::fill_fragment(acc[n], 0.f);

  const int n_k = causal ? (q0 + BQ + BK - 1) / BK : T / BK;
  for (int j = 0; j < n_k; ++j) {
    const int k0 = j * BK;
    const bool masked = causal && (k0 + BK - 1 > q0);
    __syncthreads();
    load_tile<D>(Ks, k + base + (size_t)k0 * D, BK);
    load_tile<D>(Vs, v + base + (size_t)k0 * D, BK);
    __syncthreads();

    warp_abT<D>(Ss + wrow * LDS, Qs + wrow * L::LDH, Ks);
    warp_abT<D>(dPs + wrow * LDS, dOs + wrow * L::LDH, Vs);
    __syncwarp();
    softmax_grad_row(Ss + row * LDS + h * 32, dPs + row * LDS + h * 32,
                     Ps + row * LDP + h * 32, dSs + row * LDP + h * 32,
                     lse_r, delta_r, scale, masked, q0 + row, k0 + h * 32);
    __syncwarp();
    warp_xy<D>(acc, dSs + wrow * LDP, Ks);
  }

#pragma unroll
  for (int n = 0; n < D / 16; ++n)
#pragma unroll
    for (int e = 0; e < acc[n].num_elements; ++e) acc[n].x[e] *= scale;
  warp_store_rows<D>(dq + base + (size_t)(q0 + wrow) * D, stage + wrow * L::LDQ, acc, lane);
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int D>
int launch_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int bh,
               int T, int causal, cudaStream_t stream) {
  cudaError_t err = allow_smem(flash_fwd_kernel<D>, FwdSmem<D>::total);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(T / BQ, bh);
  flash_fwd_kernel<D><<<grid, NTHREADS, FwdSmem<D>::total, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, (float*)lse, T, causal,
      1.0f / sqrtf((float)D));
  return (int)cudaGetLastError();
}

template <int D, bool WITH_DQ>
int launch_bwd_kv(const void* q, const void* k, const void* v, const void* dO,
                  const void* lse, const void* delta, void* dk, void* dv, void* dq_acc,
                  int bh, int T, int causal, cudaStream_t stream) {
  cudaError_t err = allow_smem(flash_bwd_kv_kernel<D, WITH_DQ>, BwdSmem<D>::total);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(T / BK, bh);
  flash_bwd_kv_kernel<D, WITH_DQ><<<grid, NTHREADS, BwdSmem<D>::total, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dO, (const float*)lse,
      (const float*)delta, (bf16*)dk, (bf16*)dv, (float*)dq_acc, T, causal,
      1.0f / sqrtf((float)D));
  return (int)cudaGetLastError();
}

template <int D>
int launch_bwd_dq(const void* q, const void* k, const void* v, const void* dO,
                  const void* lse, const void* delta, void* dq, int bh, int T, int causal,
                  cudaStream_t stream) {
  cudaError_t err = allow_smem(flash_bwd_dq_kernel<D>, BwdSmem<D>::total);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(T / BQ, bh);
  flash_bwd_dq_kernel<D><<<grid, NTHREADS, BwdSmem<D>::total, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dO, (const float*)lse,
      (const float*)delta, (bf16*)dq, T, causal, 1.0f / sqrtf((float)D));
  return (int)cudaGetLastError();
}

constexpr int BAD_SHAPE = -1;
constexpr int HEAD_DIM = 64;  // the slice's head width; add others when a path needs them

}  // namespace

// ---- plain C interface (bound with ctypes) ----
// Every function returns 0 on success, a cudaError_t on a failed launch,
// or -1 for a head_dim / length it was not built for.

extern "C" int p2p_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                             int bh, int T, int D, int causal, void* stream) {
  if (D != HEAD_DIM || T % BQ != 0 || T <= 0 || bh <= 0) return BAD_SHAPE;
  return launch_fwd<HEAD_DIM>(q, k, v, o, lse, bh, T, causal, (cudaStream_t)stream);
}

extern "C" int p2p_flash_bwd_dkvq(const void* q, const void* k, const void* v, const void* dO,
                                  const void* lse, const void* delta, void* dk, void* dv,
                                  void* dq_acc, int bh, int T, int D, int causal,
                                  void* stream) {
  if (D != HEAD_DIM || T % BK != 0 || T <= 0 || bh <= 0) return BAD_SHAPE;
  return launch_bwd_kv<HEAD_DIM, true>(q, k, v, dO, lse, delta, dk, dv, dq_acc, bh, T, causal,
                                       (cudaStream_t)stream);
}

extern "C" int p2p_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dO,
                                 const void* lse, const void* delta, void* dk, void* dv,
                                 int bh, int T, int D, int causal, void* stream) {
  if (D != HEAD_DIM || T % BK != 0 || T <= 0 || bh <= 0) return BAD_SHAPE;
  return launch_bwd_kv<HEAD_DIM, false>(q, k, v, dO, lse, delta, dk, dv, nullptr, bh, T, causal,
                                        (cudaStream_t)stream);
}

extern "C" int p2p_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dO,
                                const void* lse, const void* delta, void* dq, int bh, int T,
                                int D, int causal, void* stream) {
  if (D != HEAD_DIM || T % BQ != 0 || T <= 0 || bh <= 0) return BAD_SHAPE;
  return launch_bwd_dq<HEAD_DIM>(q, k, v, dO, lse, delta, dq, bh, T, causal, (cudaStream_t)stream);
}
