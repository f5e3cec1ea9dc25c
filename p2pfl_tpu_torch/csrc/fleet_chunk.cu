// One chunk step of the megafleet engine for Hopper (sm_90a): the
// sequential admission of a chunk's events, the window folds and their
// writebacks (passes B, C and D), in one launch of one thread block.
//
// It replaces no Pallas kernel: in the JAX package the whole fleet is one
// lax.scan, and a chunk step's passes B-D are XLA code inside it
// (p2pfl_tpu/ops/fleet_kernels.py, _make_chunk_body: the admission scan at
// :787, the flush loop at :979, the writebacks at :1136). Written as
// PyTorch ops, one event costs some twenty scalar launches; a million
// clients make four million events. So the chunk's events are walked here,
// in order, by one block.
//
// What it computes (ops/fleet_kernels.py::fleet_chunk_plain is the plain
// twin, line for line): pass A (PyTorch, before the launch) has trained
// every lane against the pre-chunk mint history and staged its payload.
// For each live event j in chunk order: adj = the chunk's mints older than
// its adoption time; a lane with adj > 0 adopted that in-chunk mint, so
// its client row is retrained from global v0 + adj (the consensus task's
// x + lr·(t − x); the honest row goes to w, the Byzantine transform to the
// payload). A gradient-task fleet's round is PyTorch's, so there the
// launch stops before such a lane instead: it writes its state back and
// the lane to `stop`, the host retrains the lane and stages its payload,
// and the next launch resumes at that lane (the chunk's mint times read
// back from `mint`). Then the admission: staleness τ, the bound, the rate gate, the
// insert into the regional window (hier) or the global window (flat), and
// at K the flush: sort the window by its two-word (origin, seq) key,
// fedavg (or the pad-aware median / trimmed mean), server merge. A
// regional flush offers its aggregate to the global window at the same
// position, through the (regional, up_seq) verdict grids.
//
// Layout of the work: every thread runs the scalar logic of every event
// (the same inputs give the same decisions, so no thread waits for another
// to decide); the chunk's event records and the regionals' counters are
// staged in shared memory first, by all threads at once, and a regional's
// state inside the chunk follows the host's prev_r links (last_r marks the
// lane whose state is written back). Threads split the dim-wide rows
// (corrections, inserts, folds) and the K-wide window keys; a fold is
// bracketed by __syncthreads. The global window's weights and keys and the
// histograms live in shared memory for the chunk.
//
// What bounds it: latency, not bytes or operations. A chunk of C events is
// a chain of C dependent steps, each a few hundred instructions of scalar
// logic; the bytes (C event records, the windows a flush reads) would take
// well under a microsecond at 3.35 TB/s. Staging the records in shared
// memory keeps device-memory latency off that chain except at a fold or a
// correction.
//
// fp32 as the twin: products and sums of the train step and the server
// merge are separate roundings (__fmul_rn/__fadd_rn, no contraction to fma)
// and equal the twin's bits; the fedavg and trimmed-mean sums run in key
// order here and in a library order there (ulps). Integers (merges,
// versions, histograms, counters) do not depend on params and are exact.
//
// The entry point returns cudaGetLastError() after the launch; it
// allocates nothing and does not synchronise.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;
constexpr int BAD_ARGS = -1;
constexpr int PAD_KEY = 0x7fffffff;

// The argument table: every field one 64-bit word, in the order of
// p2pfl_tpu_torch/ops/_kernels.py::FLEET_ARGS (floats travel as doubles).
struct FleetArgs {
  // event grids [S, C]
  const long long* client;
  const int* key_hi;
  const int* key_lo;
  const float* t_adopt;
  const float* t_arr;
  const unsigned char* send_ok;
  const unsigned char* live;
  const int* r;
  const int* k_r;
  const float* t_radopt;
  const int* prev_r;
  const unsigned char* last_r;
  const int* bkind;
  const float* blam;
  const int* bnoise;
  // pass A's outputs [C]
  const long long* base0;
  const long long* rv0;
  const float* rows0;  // [C, dim + 1]: the pre-chunk rows, version in column dim
  const float* payload;  // [C, dim]
  // per-client tables [N + 1]
  const float* targets;
  const float* samples;
  const float* noise;
  // the carry (updated in place)
  float* w;
  float* G;
  float* mint;
  float* gbuf;
  float* gwt;
  int* gkey_hi;
  int* gkey_lo;
  int* hist_edge;
  int* hist_glob;
  int* si;
  float* sf;
  float* rbuf;
  float* rwt;
  float* rsamp;
  int* rkey_hi;
  int* rkey_lo;
  int* rcount;
  int* radopt;
  int* up_seq;
  float* last_acc_r;
  float* rparams;
  int* stop;  // [3]: the lane a launch stopped at (chunk if none), its adj, v0
  // per-regional grids
  const unsigned char* reg_send_ok;
  const float* reg_jit;
  const float* agg_delay;
  const unsigned char* reg_dup;
  const int* akind;
  const float* alam;
  const int* agg_noise_idx;
  const float* agg_noise;
  const float* wtab;
  // shapes and knobs
  long long chunk, n_chunks, dim, k_glob, k_max, stride, hist_bins, max_staleness, hier, fold, trim, byz,
      dup, gf_cap, task;
  double local_lr, merge_keep, merge_lr, gap_reg, gap_glob;
};

// the int32 scalars of the carry (ops/fleet_kernels.py::SCALARS)
enum { S_VERSION, S_GCOUNT, S_MERGES, S_STALE_EDGE, S_RATE_EDGE, S_STALE_AGG, S_RATE_AGG, S_RMERGES,
       S_AGG_DROP, S_DUP_AGG, S_BYZ_AGG, S_COUNT };

enum { F_LIVE = 1, F_OK = 2, F_LAST = 4 };

// Shared memory: per-lane records, then the chunk's mint times, the global
// window's weights and keys, the histograms and the fold's scratch.
struct Layout {
  int C, gf, kg, kf, bins, sorted;
  __host__ __device__ explicit Layout(const FleetArgs& a)
      : C(static_cast<int>(a.chunk)), gf(static_cast<int>(a.gf_cap)), kg(static_cast<int>(a.k_glob)),
        kf(static_cast<int>(a.k_glob > a.k_max ? a.k_glob : a.k_max)), bins(static_cast<int>(a.hist_bins)),
        sorted(a.fold != 0 ? static_cast<int>(a.dim) * kf : 0) {}
  // 4-byte words: 22 a lane, then the rest; one byte of flags a lane last
  __host__ __device__ size_t words() const {
    return 22ull * C + gf + 3ull * kg + 2ull * bins + 4ull * kf + sorted;
  }
  __host__ __device__ size_t bytes() const { return 4 * words() + C; }
};

// A regional's counters enter a lane from the carry (cnt0, up0, lacc0:
// staged, never written in the loop) or from the lane prev_r links to
// (cnt, up, lacc: the lane's outputs). Two arrays, because threads run
// ahead of each other between barriers: a lane's staged input must not be
// the slot a faster thread already overwrote with its output.
struct Lanes {
  float *tadopt, *tarr, *tradopt, *lacc0, *lacc, *samp, *blam;
  int *base0, *prev0, *rv0, *r, *kr, *prevr, *cnt0, *cnt, *up0, *up, *khi, *klo, *bkind, *bnoise, *idx;
  float* nm;
  float* gwt;
  int *gkh, *gkl, *hist_e, *hist_g;
  float* fw;
  int *fhi, *flo, *perm;
  float* sorted;
  unsigned char* flags;
};

__device__ Lanes carve(unsigned char* base, const Layout& L) {
  Lanes s;
  float* f = reinterpret_cast<float*>(base);
  int C = L.C;
  s.tadopt = f; s.tarr = f + C; s.tradopt = f + 2 * C; s.lacc0 = f + 3 * C; s.lacc = f + 4 * C;
  s.samp = f + 5 * C; s.blam = f + 6 * C;
  int* i = reinterpret_cast<int*>(f + 7 * C);
  s.base0 = i; s.prev0 = i + C; s.rv0 = i + 2 * C; s.r = i + 3 * C; s.kr = i + 4 * C; s.prevr = i + 5 * C;
  s.cnt0 = i + 6 * C; s.cnt = i + 7 * C; s.up0 = i + 8 * C; s.up = i + 9 * C; s.khi = i + 10 * C;
  s.klo = i + 11 * C; s.bkind = i + 12 * C; s.bnoise = i + 13 * C; s.idx = i + 14 * C;
  float* rest = reinterpret_cast<float*>(i + 15 * C);
  s.nm = rest; rest += L.gf;
  s.gwt = rest; rest += L.kg;
  s.gkh = reinterpret_cast<int*>(rest); rest += L.kg;
  s.gkl = reinterpret_cast<int*>(rest); rest += L.kg;
  s.hist_e = reinterpret_cast<int*>(rest); rest += L.bins;
  s.hist_g = reinterpret_cast<int*>(rest); rest += L.bins;
  s.fw = rest; rest += L.kf;
  s.fhi = reinterpret_cast<int*>(rest); rest += L.kf;
  s.flo = reinterpret_cast<int*>(rest); rest += L.kf;
  s.perm = reinterpret_cast<int*>(rest); rest += L.kf;
  s.sorted = rest; rest += L.sorted;
  s.flags = reinterpret_cast<unsigned char*>(rest);
  return s;
}

__device__ __forceinline__ int bin_of(int tau, int bins) { return min(max(tau, 0), bins - 1); }

// The Byzantine transform of a sent value: 1 sign flip, 2 scale, 3 noise.
__device__ __forceinline__ float corrupt(int kind, float lam, const float* noise_row, int d, float x) {
  if (kind == 1) return -x;
  if (kind == 2) return __fmul_rn(lam, x);
  if (kind == 3 && noise_row != nullptr) return __fadd_rn(x, noise_row[d]);
  return x;
}

// One window flush: out[d] = merge(prev[d], fold(rows, weights, keys)[d]).
// Reads the window after a barrier; out may alias prev (each d is read and
// written by one thread). Ends with a barrier.
__device__ void fold_window(const FleetArgs& a, const Lanes& s, const float* rows, const float* wts,
                            const int* khi, const int* klo, int K, const float* prev, float* out) {
  const int tid = threadIdx.x;
  const int dim = static_cast<int>(a.dim);
  __syncthreads();  // the window's rows and weights are written
  for (int t = tid; t < K; t += kThreads) {
    s.fw[t] = wts[t];
    s.fhi[t] = khi[t];
    s.flo[t] = klo[t];
  }
  __syncthreads();
  // stable rank of each slot by (hi, lo): jnp.lexsort's order
  for (int t = tid; t < K; t += kThreads) {
    const int h = s.fhi[t], l = s.flo[t];
    int rank = 0;
    for (int u = 0; u < K; ++u) {
      const int hu = s.fhi[u], lu = s.flo[u];
      rank += (hu < h) || (hu == h && (lu < l || (lu == l && u < t)));
    }
    s.perm[rank] = t;
  }
  __syncthreads();
  const float keep = static_cast<float>(a.merge_keep), lr = static_cast<float>(a.merge_lr);
  if (a.fold == 0) {
    // fedavg: normalised weights in key order, one weighted sum a coordinate
    float total = 0.f;
    for (int i = 0; i < K; ++i) total = __fadd_rn(total, s.fw[s.perm[i]]);
    for (int d = tid; d < dim; d += kThreads) {
      float acc = 0.f;
      for (int i = 0; i < K; ++i) {
        const int slot = s.perm[i];
        acc = __fadd_rn(acc, __fmul_rn(__fdiv_rn(s.fw[slot], total), rows[static_cast<size_t>(slot) * dim + d]));
      }
      out[d] = __fadd_rn(__fmul_rn(keep, prev[d]), __fmul_rn(lr, acc));
    }
  } else {
    // the rank rules over the live (weight > 0) slots: each live value's
    // rank in its coordinate, then the middle pair or the trimmed sum
    int n = 0;
    for (int i = 0; i < K; ++i) n += s.fw[i] > 0.f;
    for (int item = tid; item < dim * K; item += kThreads) {
      const int d = item / K, i = item % K;
      if (!(s.fw[i] > 0.f)) continue;
      const float v = rows[static_cast<size_t>(i) * dim + d];
      int rank = 0;
      for (int u = 0; u < K; ++u) {
        if (!(s.fw[u] > 0.f)) continue;
        const float vu = rows[static_cast<size_t>(u) * dim + d];
        rank += (vu < v) || (vu == v && u < i);
      }
      s.sorted[d * K + rank] = v;
    }
    __syncthreads();
    for (int d = tid; d < dim; d += kThreads) {
      const float* col = s.sorted + d * K;
      float avg = 0.f;
      if (n >= 1 && a.fold == 2) {
        avg = __fmul_rn(0.5f, __fadd_rn(col[(n - 1) / 2], col[n / 2]));
      } else if (n >= 1) {
        const int t = min(static_cast<int>(a.trim), (n - 1) / 2);
        float acc = 0.f;
        for (int i = t; i < n - t; ++i) acc = __fadd_rn(acc, col[i]);
        avg = __fdiv_rn(acc, static_cast<float>(max(n - 2 * t, 1)));
      }
      out[d] = __fadd_rn(__fmul_rn(keep, prev[d]), __fmul_rn(lr, avg));
    }
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads, 1) fleet_chunk_kernel(const __grid_constant__ FleetArgs a, int chunk_idx, int j_start,
                                                                  int v0_in) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L(a);
  const Lanes s = carve(smem, L);
  const int tid = threadIdx.x;
  const int C = L.C, dim = static_cast<int>(a.dim), kg = L.kg, kmax = static_cast<int>(a.k_max);
  const int bins = L.bins, stride = static_cast<int>(a.stride);
  const bool hier = a.hier != 0, byz = a.byz != 0;
  const size_t base = static_cast<size_t>(chunk_idx) * C;

  // ---- stage the chunk's records, the global window's metadata, the
  // histograms and (hier) each lane's regional counters
  for (int j = tid; j < C; j += kThreads) {
    const size_t e = base + j;
    const bool live = a.live[e] != 0;
    s.flags[j] = (live ? F_LIVE : 0) | (a.send_ok[e] ? F_OK : 0) | (hier && a.last_r[e] ? F_LAST : 0);
    const long long client = a.client[e];
    s.idx[j] = static_cast<int>(client);
    s.khi[j] = a.key_hi[e];
    s.klo[j] = a.key_lo[e];
    s.tadopt[j] = a.t_adopt[e];
    s.tarr[j] = a.t_arr[e];
    s.samp[j] = a.samples[client];
    s.base0[j] = static_cast<int>(a.base0[j]);
    s.prev0[j] = static_cast<int>(a.rows0[static_cast<size_t>(j) * (dim + 1) + dim]);
    s.bkind[j] = byz ? a.bkind[e] : 0;
    s.blam[j] = byz ? a.blam[e] : 1.f;
    s.bnoise[j] = (byz && a.bnoise != nullptr) ? a.bnoise[e] : 0;
    if (hier) {
      const int r = a.r[e];
      s.r[j] = r;
      s.kr[j] = a.k_r[e];
      s.tradopt[j] = a.t_radopt[e];
      s.prevr[j] = a.prev_r[e];
      s.rv0[j] = static_cast<int>(a.rv0[j]);
      if (live) {
        s.cnt0[j] = a.rcount[r];
        s.up0[j] = a.up_seq[r];
        s.lacc0[j] = a.last_acc_r[r];
      }
    }
  }
  for (int t = tid; t < kg; t += kThreads) {
    s.gwt[t] = a.gwt[t];
    s.gkh[t] = a.gkey_hi[t];
    s.gkl[t] = a.gkey_lo[t];
  }
  for (int t = tid; t < bins; t += kThreads) {
    s.hist_e[t] = a.hist_edge[t];
    s.hist_g[t] = a.hist_glob[t];
  }
  // the scalar state, the same in every thread; a resumed launch
  // (v0_in >= 0) re-reads the mints its chunk has made so far
  int ver = a.si[S_VERSION], gcnt = a.si[S_GCOUNT];
  const bool resumed = v0_in >= 0;
  const int v0 = resumed ? v0_in : ver;
  int nmn = ver - v0;
  for (int m = tid; m < min(nmn, L.gf); m += kThreads) s.nm[m] = a.mint[v0 + m];
  __syncthreads();

  int cnt[S_COUNT];
  for (int q = 0; q < S_COUNT; ++q) cnt[q] = a.si[q];
  float lastm = a.sf[0], laccg = a.sf[1];
  int stop_j = C, stop_adj = 0;
  const float lr_local = static_cast<float>(a.local_lr);
  const float gap_glob = static_cast<float>(a.gap_glob), gap_reg = static_cast<float>(a.gap_reg);
  const int max_st = static_cast<int>(a.max_staleness);

  for (int j = j_start; j < C; ++j) {
    const unsigned char fl = s.flags[j];
    if (!(fl & F_LIVE)) continue;
    const float ta = s.tadopt[j];
    const int nmc = min(nmn, L.gf);
    int adj = 0;
    for (int m = 0; m < nmc; ++m) adj += s.nm[m] < ta;
    // the lane a resumed launch starts at was retrained by the host
    const bool staged = resumed && j == j_start;
    if (a.task && adj > 0 && !staged) {
      stop_j = j;
      stop_adj = adj;
      break;
    }
    const bool retrain = adj > 0 && !staged;
    const int v_a = max(s.base0[j] + adj, s.prev0[j]);
    const bool ok = (fl & F_OK) != 0;
    const float tarr = s.tarr[j];
    const int idx = s.idx[j];
    int tau, rv = 0, r = 0, cnt_in = 0, up_in = 0;
    float lacc_in = 0.f;
    bool ins;
    if (hier) {
      r = s.r[j];
      const float tr = s.tradopt[j];
      int radj = 0;
      for (int m = 0; m < nmc; ++m) radj += s.nm[m] < tr;
      rv = s.rv0[j] + radj;
      tau = max(rv - v_a, 0);
      const int p = s.prevr[j];
      cnt_in = p >= j_start ? s.cnt[p] : s.cnt0[j];
      up_in = p >= j_start ? s.up[p] : s.up0[j];
      lacc_in = p >= j_start ? s.lacc[p] : s.lacc0[j];
      const bool fresh = tau <= max_st;
      const bool rate_ok = !(gap_reg > 0.f) || __fsub_rn(tarr, lacc_in) >= gap_reg;
      ins = ok && fresh && rate_ok;
      cnt[S_STALE_EDGE] += ok && !fresh;
      cnt[S_RATE_EDGE] += ok && fresh && !rate_ok;
    } else {
      tau = max(ver - v_a, 0);
      const bool fresh = tau <= max_st;
      const bool rate_ok = !(gap_glob > 0.f) || __fsub_rn(tarr, laccg) >= gap_glob;
      ins = ok && fresh && rate_ok;
      cnt[S_STALE_EDGE] += ok && !fresh;
      cnt[S_RATE_EDGE] += ok && fresh && !rate_ok;
    }
    const int slot = hier ? cnt_in : gcnt;
    // ---- the lane's payload: retrained from in-chunk mint adj, or pass A's
    if (retrain || ins) {
      float* dst = !ins ? nullptr
                        : (hier ? a.rbuf + (static_cast<size_t>(r) * kmax + slot) * dim
                                : a.gbuf + static_cast<size_t>(slot) * dim);
      const float* g = a.G + static_cast<size_t>(v0 + adj) * dim;
      const float* t = a.targets + static_cast<size_t>(idx) * dim;
      float* wrow = a.w + static_cast<size_t>(idx) * (dim + 1);
      const float* noise_row = (s.bkind[j] == 3 && a.noise != nullptr)
                                   ? a.noise + static_cast<size_t>(s.bnoise[j]) * dim : nullptr;
      const float* pay = a.payload + static_cast<size_t>(j) * dim;
      for (int d = tid; d < dim; d += kThreads) {
        float v;
        if (retrain) {
          const float gd = g[d];
          const float honest = __fadd_rn(gd, __fmul_rn(lr_local, __fsub_rn(t[d], gd)));
          wrow[d] = honest;
          v = corrupt(s.bkind[j], s.blam[j], noise_row, d, honest);
        } else {
          v = pay[d];
        }
        if (dst != nullptr) dst[d] = v;
      }
      if (retrain && tid == 0) wrow[dim] = static_cast<float>(v0 + adj);
    }
    bool g_offer = false;  // an offer into the global window at this event
    float t_evt = tarr, g_w = 0.f;
    int g_hi = 0, g_lo = 0, g_bin = 0;
    float* g_row = nullptr;  // hier: the aggregate's row (rparams[r])
    if (!hier) {
      if (ins) {
        g_offer = true;
        g_w = __fmul_rn(s.samp[j], a.wtab[bin_of(tau, bins)]);
        g_hi = s.khi[j];
        g_lo = s.klo[j];
        g_bin = bin_of(tau, bins);
      }
    } else {
      int cnt_out = cnt_in, up_new = up_in;
      float lacc_out = lacc_in;
      if (ins) {
        if (tid == 0) {
          const size_t q = static_cast<size_t>(r) * kmax + slot;
          a.rwt[q] = __fmul_rn(s.samp[j], a.wtab[bin_of(tau, bins)]);
          a.rsamp[q] = s.samp[j];
          a.rkey_hi[q] = s.khi[j];
          a.rkey_lo[q] = s.klo[j];
          s.hist_e[bin_of(tau, bins)] += 1;
        }
        lacc_out = tarr;
        cnt_out = cnt_in + 1;
      }
      // >=: a churn epoch can shrink k below a part-filled window
      if (ins && cnt_out >= s.kr[j]) {
        cnt_out = 0;
        up_new = up_in + 1;
        // the regional's params: the freshest arrived global if newer
        // than its last adoption, then the fold
        const int radopt = a.radopt[r];
        float* rp = a.rparams + static_cast<size_t>(r) * dim;
        const float* cur = rv > radopt ? a.G + static_cast<size_t>(rv) * dim : rp;
        const size_t w0 = static_cast<size_t>(r) * kmax;
        fold_window(a, s, a.rbuf + w0 * dim, a.rwt + w0, a.rkey_hi + w0, a.rkey_lo + w0, kmax, cur, rp);
        float raw = 0.f;
        for (int q = 0; q < kmax; ++q) raw = __fadd_rn(raw, a.rsamp[w0 + q]);
        __syncthreads();  // every thread has read the window's samples and radopt
        for (int q = tid; q < kmax; q += kThreads) {
          a.rwt[w0 + q] = 0.f;
          a.rsamp[w0 + q] = 0.f;
          a.rkey_hi[w0 + q] = PAD_KEY;
          a.rkey_lo[w0 + q] = PAD_KEY;
        }
        if (tid == 0) a.radopt[r] = max(radopt, rv);
        __syncthreads();  // the reset lands before any later insert into this window
        cnt[S_RMERGES] += 1;
        const int sidx = min(max(up_new - 1, 0), stride - 1);
        const size_t gq = static_cast<size_t>(r) * stride + sidx;
        const bool agg_ok = a.reg_send_ok[gq] != 0;
        const float t_agg = __fadd_rn(__fadd_rn(tarr, a.agg_delay[r]), a.reg_jit[gq]);
        if (byz) cnt[S_BYZ_AGG] += a.akind[r] > 0;
        cnt[S_AGG_DROP] += !agg_ok;
        if (a.dup) cnt[S_DUP_AGG] += agg_ok && a.reg_dup[gq] != 0;
        const int tau_g = max(ver - rv, 0);
        const bool fresh_g = tau_g <= max_st;
        const bool rate_g_ok = !(gap_glob > 0.f) || __fsub_rn(t_agg, laccg) >= gap_glob;
        cnt[S_STALE_AGG] += agg_ok && !fresh_g;
        cnt[S_RATE_AGG] += agg_ok && fresh_g && !rate_g_ok;
        if (agg_ok && fresh_g && rate_g_ok) {
          g_offer = true;
          t_evt = t_agg;
          float raw_w = __fmul_rn(raw, a.wtab[bin_of(tau_g, bins)]);
          g_w = raw_w;
          g_hi = r;
          g_lo = up_new;
          g_bin = bin_of(tau_g, bins);
          g_row = rp;
        }
      }
      // every thread writes its own copy of the lane's outputs (the same
      // values): later lanes of the regional read them through prev_r
      s.cnt[j] = cnt_out;
      s.up[j] = up_new;
      s.lacc[j] = lacc_out;
    }
    if (!g_offer) continue;
    // ---- the global window: insert, and at K the flush
    if (g_row != nullptr) {
      // the regional's aggregate, corrupted if its regional is an attacker
      const int ak = byz ? a.akind[r] : 0;
      const float* nrow = nullptr;
      if (ak == 3) {
        const int sidx = min(max(g_lo - 1, 0), stride - 1);
        nrow = a.agg_noise + static_cast<size_t>(a.agg_noise_idx[static_cast<size_t>(r) * stride + sidx]) * dim;
      }
      const float alam = byz ? a.alam[r] : 1.f;
      for (int d = tid; d < dim; d += kThreads)
        a.gbuf[static_cast<size_t>(gcnt) * dim + d] = corrupt(ak, alam, nrow, d, g_row[d]);
    }
    s.gwt[gcnt] = g_w;  // every thread: the same value
    s.gkh[gcnt] = g_hi;
    s.gkl[gcnt] = g_lo;
    if (tid == 0) (hier ? s.hist_g : s.hist_e)[g_bin] += 1;
    laccg = t_evt;
    gcnt += 1;
    if (gcnt < kg) continue;
    gcnt = 0;
    fold_window(a, s, a.gbuf, s.gwt, s.gkh, s.gkl, kg, a.G + static_cast<size_t>(ver) * dim,
                a.G + static_cast<size_t>(ver + 1) * dim);
    // mint times clamped monotone: the searchsorted axis stays ascending
    lastm = fmaxf(t_evt, lastm);
    if (tid == 0) a.mint[ver] = lastm;
    s.nm[min(nmn, L.gf - 1)] = lastm;  // every thread: the same value
    nmn += 1;
    ver += 1;
    cnt[S_MERGES] += 1;
    for (int t = tid; t < kg; t += kThreads) {
      s.gwt[t] = 0.f;
      s.gkh[t] = PAD_KEY;
      s.gkl[t] = PAD_KEY;
    }
    __syncthreads();
  }

  // ---- write the chunk's state back
  __syncthreads();
  cnt[S_VERSION] = ver;
  cnt[S_GCOUNT] = gcnt;
  if (tid == 0) {
    for (int q = 0; q < S_COUNT; ++q) a.si[q] = cnt[q];
    a.sf[0] = lastm;
    a.sf[1] = laccg;
  }
  for (int t = tid; t < kg; t += kThreads) {
    a.gwt[t] = s.gwt[t];
    a.gkey_hi[t] = s.gkh[t];
    a.gkey_lo[t] = s.gkl[t];
  }
  for (int t = tid; t < bins; t += kThreads) {
    a.hist_edge[t] = s.hist_e[t];
    a.hist_glob[t] = s.hist_g[t];
  }
  if (hier && stop_j < C) {
    // stopped: each regional's newest state among the lanes this launch
    // ran, in lane order (a later lane of the chunk resumes from it)
    if (tid == 0) {
      for (int j = j_start; j < stop_j; ++j) {
        if (!(s.flags[j] & F_LIVE)) continue;
        const int r = s.r[j];
        a.rcount[r] = s.cnt[j];
        a.up_seq[r] = s.up[j];
        a.last_acc_r[r] = s.lacc[j];
      }
    }
  } else if (hier) {
    for (int j = j_start + tid; j < C; j += kThreads) {
      if ((s.flags[j] & (F_LIVE | F_LAST)) == (F_LIVE | F_LAST)) {
        const int r = s.r[j];
        a.rcount[r] = s.cnt[j];
        a.up_seq[r] = s.up[j];
        a.last_acc_r[r] = s.lacc[j];
      }
    }
  }
  if (tid == 0) {
    a.stop[0] = stop_j;
    a.stop[1] = stop_adj;
    a.stop[2] = v0;
  }
}

size_t g_smem_set = 0;  // the dynamic shared memory the kernel is cleared for

}  // namespace

// args: a host array of n_words 64-bit words, laid out as FleetArgs;
// launches one block on `stream` for chunk `chunk_idx` from lane `j_start`
// (0, and v0 -1, for a fresh chunk; a resumed one passes the lane and v0
// its last launch wrote to `stop`).
extern "C" int p2p_fleet_chunk(const void* args, int n_words, int chunk_idx, int j_start, int v0, void* stream) {
  if (args == nullptr || n_words != static_cast<int>(sizeof(FleetArgs) / 8)) return BAD_ARGS;
  FleetArgs a;
  memcpy(&a, args, sizeof(FleetArgs));
  if (a.chunk < 1 || a.dim < 1 || a.k_glob < 1 || a.k_max < 1 || a.gf_cap < 1 || a.hist_bins < 1 ||
      chunk_idx < 0 || chunk_idx >= a.n_chunks || j_start < 0 || j_start >= a.chunk || a.stop == nullptr ||
      (j_start > 0) != (v0 >= 0))
    return BAD_ARGS;
  const size_t smem = Layout(a).bytes();
  if (smem > 232448) return BAD_ARGS;
  if (smem > 48 * 1024 && smem > g_smem_set) {
    cudaError_t err = cudaFuncSetAttribute(fleet_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    g_smem_set = smem;
  }
  fleet_chunk_kernel<<<1, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a, chunk_idx, j_start, v0);
  return static_cast<int>(cudaGetLastError());
}
