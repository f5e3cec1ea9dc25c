// The megafleet chunk step for Hopper (sm_90a): a span of chunks in one
// launch of one thread block. Each chunk is pass A (the consensus task's
// local round of every lane), then the sequential admission of its events,
// the window folds and their writebacks (passes B, C and D).
//
// It replaces no Pallas kernel: in the JAX package the whole fleet is one
// lax.scan, and a chunk step is XLA code inside it
// (p2pfl_tpu/ops/fleet_kernels.py, _make_chunk_body: the admission scan at
// :787, the flush loop at :979, the writebacks at :1136). Written as
// PyTorch ops, one event costs some twenty scalar launches; a million
// clients make four million events. So the events are walked here, in
// order, by one block, and a launch walks `n_span` chunks.
//
// What it computes (ops/fleet_kernels.py: ChunkedFleet.pass_a, then
// fleet_chunk_plain, is the plain twin, line for line). Pass A, for the
// consensus task: each lane adopts against the pre-chunk mint history
// (base0 = the left-side searchsorted of its adoption time), starts from
// global G[base0] if that is newer than its row, trains once
// (x + lr·(t − x), three roundings as torch's sub, mul and add), writes
// its row and adopted version back and keeps its sent (possibly
// corrupted) payload in shared memory. A gradient-task fleet's round is
// PyTorch's: there pass A runs in PyTorch before a one-chunk launch, which
// reads its outputs; so does a sharded fleet's (ShardedFleet: pass A on
// each shard's block, the rows gathered), whose launch gets no client
// table and reads none. Then for each live event j in chunk order: adj = the
// chunk's mints older than its adoption time; a lane with adj > 0 adopted
// that in-chunk mint, so its row is retrained from global v0 + adj (a
// gradient-task launch stops before such a lane instead: it writes its
// state back and the lane to `stop`, the host retrains the lane, and the
// next launch resumes there). Then the admission: staleness τ, the bound,
// the rate gate, the insert into the regional window (hier) or the global
// window (flat), and at K the flush: sort the window by its two-word
// (origin, seq) key, fedavg (or the pad-aware median / trimmed mean),
// server merge. A regional flush offers its aggregate to the global window
// at the same position, through the (regional, up_seq) verdict grids.
//
// Layout of the work. The chain of events is sequential, but its integers
// and times never depend on params, and an event depends on the events
// before it only through its regional's counters (flat: the global
// window's) until a window flushes. So warp 0 decides 32 events at a
// time, one a lane: the events of one regional take turns (their
// counters handed on by shuffles), the others run side by side; the first
// event of the batch that flushes a window (or, when PyTorch ran pass A,
// that an in-chunk mint moved) ends it. The events before it commit (each
// lane its payload row, window slot, histogram count and counters), and
// the single-event path takes the flushing event with the whole warp,
// lane d owning coordinate d. A flush stages its window (weights, keys
// and, when there is room, its rows by cp.async) into a slot of a ring in
// shared memory and posts a command; warp 1 folds the posted windows in
// order (rank by key, key-order sums, server merge, the aggregate's row
// into the global window, the global fold of a mint) while warp 0 walks
// on; warp 0 waits on warp 1 only for a free slot, for a global row a
// retrained lane reads, and at the chunk's end. The chunk's records, its
// payloads, the weight table, the global window's weights and keys, the
// histograms, the mint history and (where they fit) the regionals'
// counters and running sample sums live in shared memory for the whole
// span, written back once at its end. All eight warps run the staging
// and pass A at each chunk's start (lanes in parallel); while warps 0 and
// 1 walk the chain, warps 2-7 prefetch into L2 the rows the next chunk's
// pass A reads.
//
// What bounds it: latency, not bytes or operations. The bytes (the
// records, the rows pass A moves, the windows a flush reads) would take
// well under a microsecond a chunk at 3.35 TB/s; the chain is one warp's
// dependent instructions: a batch's shared-memory round trips and
// shuffles, and each fold's K-term key-order sums (chip_smoke.py's
// latency bound counts them with the card's own latencies). Pass A's
// gather of random client rows runs at one SM's memory parallelism.
//
// fp32 as the twin: products and sums of the train step and the server
// merge are separate roundings (__fmul_rn/__fadd_rn, no contraction to
// fma) and equal torch's bits; a fedavg fold divides each weight by the
// total once, then sums the terms in key order; the fedavg and trimmed-mean
// sums run in key order here and in a library order in the twin (ulps).
// Integers (merges, versions, histograms, counters) and times do not
// depend on params and are exact.
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
constexpr size_t kSmemMax = 232448;  // 227 KB, a block's most on sm_90

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
  const int* bkind;
  const float* blam;
  const int* bnoise;
  // pass A's outputs [C] when PyTorch ran it (`staged`: a gradient task's)
  const long long* base0;
  const long long* rv0;
  const float* rows0;  // [C, dim + 1]: the pre-chunk rows, version in column dim
  float* payload;  // [C, dim]: staged by PyTorch, or the kernel's when shared memory is short
  // per-client tables [N + 1]
  const float* targets;
  const float* samples;
  const float* noise;
  // the carry (updated in place)
  float* w;  // [N + 1, dim + 1]; null in a staged launch (a sharded engine's rows lie in its shards)
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
  float* rraw;  // [R] scratch: the running sample sums when the counters stay in device memory
  int* stop;  // [3]: the lane a launch stopped at (chunk if none), its adj, v0
  long long* prof;  // [PROF_N] or null: clock64 cycles by section, added to (PROF_* below)
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
  long long chunk, n_chunks, dim, n_reg, k_glob, k_max, v_cap, stride, hist_bins, max_staleness, hier, fold, trim,
      byz, dup, gf_cap, staged, reg_layout;
  double local_lr, merge_keep, merge_lr, gap_reg, gap_glob;
};

// the int32 scalars of the carry (ops/fleet_kernels.py::SCALARS)
enum { S_VERSION, S_GCOUNT, S_MERGES, S_STALE_EDGE, S_RATE_EDGE, S_STALE_AGG, S_RATE_AGG, S_RMERGES,
       S_AGG_DROP, S_DUP_AGG, S_BYZ_AGG, S_COUNT };

enum { F_LIVE = 1, F_OK = 2 };
// what shared memory holds beyond the fixed part (the host decides)
enum { P_PAY = 1, P_REG = 2, P_MINT = 4, P_ROWS = 8 };
// the sections `prof` times (thread 0's clock64), and its counts
enum { PROF_STAGE, PROF_PASS_A, PROF_EVENTS, PROF_RFOLD, PROF_GFOLD, PROF_FOLDER, PROF_CHUNKS, PROF_RFOLDS,
       PROF_GFOLDS, PROF_N };
// the fold ring: kQ slots of staged windows and their commands, and its
// counters (posted, done, chunks closed, the newest final global row)
constexpr int kQ = 8;
enum { Q_HEAD, Q_TAIL, Q_CLOSE, Q_GDONE, Q_WORDS };
enum { CMD_RFOLD = 1, CMD_GFOLD = 2 };
struct FoldCmd {
  int kind, r, src_v, gslot, ak, nrow, ver, rows;  // rows: the slot holds the window's rows
  float alam;
  int pad[3];
};
// a spin on another warp's counter that outlasts any real wait traps
// instead of hanging the card
constexpr long long kSpinLimit = 1ll << 26;
// reg_layout: where the regionals' counters and the fold ring's window rows
// live (REG_DEVICE: in device memory, as for a fleet too large for shared
// memory; a fold then reads its rows there and the window waits for it)
enum { REG_AUTO = 0, REG_DEVICE = 1 };

// Shared memory: the fold ring first (kQ slots, each a window's rows when
// `place` has P_ROWS, its two-word keys and weights; the commands; the
// counters), then the per-lane records, the chunk's mint times, the
// weight table, the global window's weights and keys, the histograms, the
// folding warp's scratch; then, by `place`, the payloads, the regionals'
// counters and the mint history; one byte of flags a lane last.
struct Layout {
  int C, dim, gf, kg, kf, bins, sorted, R, vcap, place, rw, slot;
  __host__ __device__ Layout(const FleetArgs& a, int place_)
      : C(static_cast<int>(a.chunk)), dim(static_cast<int>(a.dim)), gf(static_cast<int>(a.gf_cap)),
        kg(static_cast<int>(a.k_glob)), kf(static_cast<int>(a.k_glob > a.k_max ? a.k_glob : a.k_max)),
        bins(static_cast<int>(a.hist_bins)), sorted(a.fold != 0 ? static_cast<int>(a.dim) * kf : 0),
        R(a.hier != 0 ? static_cast<int>(a.n_reg) : 0), vcap(static_cast<int>(a.v_cap)), place(place_),
        rw((place_ & P_ROWS) ? (kf * dim + 3) / 4 * 4 : 0), slot((rw + 3 * kf + 3) / 4 * 4) {}
  __host__ __device__ size_t words() const {
    size_t n = static_cast<size_t>(kQ) * slot + kQ * sizeof(FoldCmd) / 4 + Q_WORDS;
    n += 15ull * C + gf + 3ull * kg + 3ull * bins + 2ull * kf + sorted;
    if (place & P_PAY) n += static_cast<size_t>(C) * dim;
    if (place & P_REG) n += 5ull * R;
    if (place & P_MINT) n += vcap;
    return n;
  }
  __host__ __device__ size_t bytes() const { return 4 * words() + C; }
};

struct Smem {
  float* ring;  // kQ slots of L.slot words: rows (rw words), keys (2·kf), weights (kf)
  FoldCmd* cmd;
  int* q;
  float *tadopt, *tarr, *tradopt, *samp, *blam;
  int *base0, *prev0, *rv0, *r, *kr, *khi, *klo, *bkind, *bnoise, *idx;
  float *nm, *wtab, *gwt;
  int *gkh, *gkl, *hist_e, *hist_g;
  float* nw;
  int* perm;
  float* sorted;
  float* pay;
  int *rcnt, *rad, *rup;
  float *rlacc, *rraw;
  float* mint;
  unsigned char* flags;
};

__device__ __forceinline__ Smem carve(unsigned char* base, const Layout& L) {
  Smem s;
  s.ring = reinterpret_cast<float*>(base);
  s.cmd = reinterpret_cast<FoldCmd*>(s.ring + static_cast<size_t>(kQ) * L.slot);
  s.q = reinterpret_cast<int*>(s.cmd + kQ);
  float* f = reinterpret_cast<float*>(s.q + Q_WORDS);
  const int C = L.C;
  s.tadopt = f; s.tarr = f + C; s.tradopt = f + 2 * C; s.samp = f + 3 * C; s.blam = f + 4 * C;
  int* i = reinterpret_cast<int*>(f + 5 * C);
  s.base0 = i; s.prev0 = i + C; s.rv0 = i + 2 * C; s.r = i + 3 * C; s.kr = i + 4 * C; s.khi = i + 5 * C;
  s.klo = i + 6 * C; s.bkind = i + 7 * C; s.bnoise = i + 8 * C; s.idx = i + 9 * C;
  float* rest = reinterpret_cast<float*>(i + 10 * C);
  s.nm = rest; rest += L.gf;
  s.wtab = rest; rest += L.bins;
  s.gwt = rest; rest += L.kg;
  s.gkh = reinterpret_cast<int*>(rest); rest += L.kg;
  s.gkl = reinterpret_cast<int*>(rest); rest += L.kg;
  s.hist_e = reinterpret_cast<int*>(rest); rest += L.bins;
  s.hist_g = reinterpret_cast<int*>(rest); rest += L.bins;
  s.nw = rest; rest += L.kf;
  s.perm = reinterpret_cast<int*>(rest); rest += L.kf;
  s.sorted = rest; rest += L.sorted;
  s.pay = nullptr;
  if (L.place & P_PAY) { s.pay = rest; rest += static_cast<size_t>(L.C) * L.dim; }
  s.rcnt = s.rad = s.rup = nullptr;
  s.rlacc = s.rraw = nullptr;
  if (L.place & P_REG) {
    s.rcnt = reinterpret_cast<int*>(rest); rest += L.R;
    s.rad = reinterpret_cast<int*>(rest); rest += L.R;
    s.rup = reinterpret_cast<int*>(rest); rest += L.R;
    s.rlacc = rest; rest += L.R;
    s.rraw = rest; rest += L.R;
  }
  s.mint = nullptr;
  if (L.place & P_MINT) { s.mint = rest; rest += L.vcap; }
  s.flags = reinterpret_cast<unsigned char*>(rest);
  return s;
}

__device__ __forceinline__ int bin_of(int tau, int bins) { return min(max(tau, 0), bins - 1); }

// torch.searchsorted(mint, t) (left side) over the whole ascending history
// (+inf past the newest mint): the count of entries below t.
__device__ __forceinline__ int lower_bound(const float* mint, int n, float t) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (mint[mid] < t) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// The Byzantine transform of a sent value: 1 sign flip, 2 scale, 3 noise.
__device__ __forceinline__ float corrupt(int kind, float lam, const float* noise_row, int d, float x) {
  if (kind == 1) return -x;
  if (kind == 2) return __fmul_rn(lam, x);
  if (kind == 3 && noise_row != nullptr) return __fadd_rn(x, noise_row[d]);
  return x;
}

// A 4-byte copy from device into shared memory that completes later
// (cp.async.wait_all).
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned saddr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(saddr), "l"(src) : "memory");
}

// A window into ring slot q, by the warp that owns its rows: the weights
// and the (hi, lo) keys as one ordered word (hi signed above, lo shifted
// to [0, 2^32)) and, when rows is given, the K·dim rows by asynchronous
// copies (16 bytes each where aligned), waited for here.
__device__ __forceinline__ void stage_window(const Smem& s, const Layout& L, int q, const float* wts, const int* khi,
                                             const int* klo, const float* rows, int K, int lane) {
  const int dim = L.dim;
  float* slot = s.ring + static_cast<size_t>(q) * L.slot;
  long long* key = reinterpret_cast<long long*>(slot + L.rw);
  float* fw = slot + L.rw + 2 * L.kf;
  __syncwarp();  // the window's rows, weights and keys are written
  if (rows != nullptr) {
    if ((dim & 3) == 0 && (reinterpret_cast<uintptr_t>(rows) & 15) == 0) {
      for (int e = 4 * lane; e < K * dim; e += 128) {
        const unsigned saddr = static_cast<unsigned>(__cvta_generic_to_shared(slot + e));
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(saddr), "l"(rows + e) : "memory");
      }
    } else {
      for (int e = lane; e < K * dim; e += 32) cp_async4(slot + e, rows + e);
    }
  }
  for (int t = lane; t < K; t += 32) {
    fw[t] = wts[t];
    key[t] = static_cast<long long>(khi[t]) * 4294967296LL + (static_cast<long long>(klo[t]) + 2147483648LL);
  }
  if (rows != nullptr) asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncwarp();
}

// One window flush by the folding warp: out[d] = merge(prev[d],
// fold(window in slot q)[d]), lane d owning coordinate d (out may alias
// prev); the rows from the slot (from_slot), else from `rows` in device
// memory. The lanes rank the slots by key, stable (jnp.lexsort's
// order); fedavg divides each weight by the key-order total once, then
// sums a coordinate's terms in key order.
__device__ __forceinline__ void fold_window(const FleetArgs& a, const Smem& s, const Layout& L, int q,
                                            const float* rows, bool from_slot, int K, const float* prev, float* out,
                                            int lane) {
  const int dim = L.dim;
  float* slot = s.ring + static_cast<size_t>(q) * L.slot;
  const long long* key = reinterpret_cast<const long long*>(slot + L.rw);
  const float* fw = slot + L.rw + 2 * L.kf;
  const float* col = from_slot ? slot : rows;
  for (int t = lane; t < K; t += 32) {
    const long long kt = key[t];
    int rank = 0;
#pragma unroll 16
    for (int u = 0; u < K; ++u) {
      const long long ku = key[u];
      rank += (ku < kt) || (ku == kt && u < t);
    }
    s.perm[rank] = t;
    s.nw[rank] = fw[t];  // the weights in key order
  }
  __syncwarp();
  const float keep = static_cast<float>(a.merge_keep), lr = static_cast<float>(a.merge_lr);
  if (a.fold == 0) {
    float total = 0.f;
#pragma unroll 8
    for (int i = 0; i < K; ++i) total = __fadd_rn(total, s.nw[i]);
    __syncwarp();  // every lane has the total before the weights are divided
    for (int i = lane; i < K; i += 32) s.nw[i] = __fdiv_rn(s.nw[i], total);
    __syncwarp();
    for (int d = lane; d < dim; d += 32) {
      const float p = prev[d];
      float acc = 0.f;
#pragma unroll 8
      for (int i = 0; i < K; ++i) acc = __fadd_rn(acc, __fmul_rn(s.nw[i], col[s.perm[i] * dim + d]));
      out[d] = __fadd_rn(__fmul_rn(keep, p), __fmul_rn(lr, acc));
    }
  } else {
    // the rank rules over the live (weight > 0) slots: each live value's
    // rank in its coordinate (lane d sorts column d alone), then the
    // middle pair or the trimmed sum
    int n = 0;
    for (int i = 0; i < K; ++i) n += fw[i] > 0.f;
    for (int d = lane; d < dim; d += 32) {
      float* sc = s.sorted + static_cast<size_t>(d) * K;
      for (int i = 0; i < K; ++i) {
        if (!(fw[i] > 0.f)) continue;
        const float v = col[i * dim + d];
        int rank = 0;
        for (int u = 0; u < K; ++u) {
          if (!(fw[u] > 0.f)) continue;
          const float vu = col[u * dim + d];
          rank += (vu < v) || (vu == v && u < i);
        }
        sc[rank] = v;
      }
      float avg = 0.f;
      if (n >= 1 && a.fold == 2) {
        avg = __fmul_rn(0.5f, __fadd_rn(sc[(n - 1) / 2], sc[n / 2]));
      } else if (n >= 1) {
        const int t = min(static_cast<int>(a.trim), (n - 1) / 2);
        float acc = 0.f;
        for (int i = t; i < n - t; ++i) acc = __fadd_rn(acc, sc[i]);
        avg = __fdiv_rn(acc, static_cast<float>(max(n - 2 * t, 1)));
      }
      out[d] = __fadd_rn(__fmul_rn(keep, prev[d]), __fmul_rn(lr, avg));
    }
  }
  __syncwarp();
}

// Lane 0 waits until the ring counter q[k] (written by the other warp)
// satisfies `ready`, then the warp reads what that warp wrote before it.
template <typename Ready>
__device__ __forceinline__ int wait_for(const Smem& s, int k, Ready ready, int lane) {
  int v = 0;
  if (lane == 0) {
    long long spins = 0;
    while (!ready(v = *reinterpret_cast<volatile int*>(s.q + k))) {
      __nanosleep(32);
      if (++spins > kSpinLimit) __trap();
    }
    __threadfence_block();
  }
  v = __shfl_sync(0xffffffffu, v, 0);
  __syncwarp();
  return v;
}

// Lane 0 publishes q[k] = v after everything the warp wrote before.
__device__ __forceinline__ void publish(const Smem& s, int k, int v, int lane) {
  __syncwarp();
  if (lane == 0) {
    __threadfence_block();
    *reinterpret_cast<volatile int*>(s.q + k) = v;
  }
  __syncwarp();
}

// PLACE: the placement bits the shared-memory-resident state is compiled
// for (P_PAY, P_REG), so its loads and stores address shared memory.
template <int PLACE>
__global__ void __launch_bounds__(kThreads, 1)
    fleet_chunk_kernel(const __grid_constant__ FleetArgs a, int s0, int n_span, int j_start, int v0_in, int place) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L(a, place);
  const Smem s = carve(smem, L);
  const int tid = threadIdx.x, lane = tid & 31;
  const int C = L.C, dim = L.dim, kg = L.kg, kmax = static_cast<int>(a.k_max), bins = L.bins, R = L.R;
  const int stride = static_cast<int>(a.stride), vcap = L.vcap, row = dim + 1;
  const bool hier = a.hier != 0, byz = a.byz != 0, staged = a.staged != 0;
  // the regionals' counters, running sums, payloads and mint history: in
  // shared memory where they fit, else in device memory
  int* rcnt = (PLACE & P_REG) ? s.rcnt : a.rcount;
  int* rad = (PLACE & P_REG) ? s.rad : a.radopt;
  int* rup = (PLACE & P_REG) ? s.rup : a.up_seq;
  float* rlacc = (PLACE & P_REG) ? s.rlacc : a.last_acc_r;
  float* rraw = (PLACE & P_REG) ? s.rraw : a.rraw;
  float* pay = (PLACE & P_PAY) ? s.pay : a.payload;
  const float* mhist = (place & P_MINT) ? s.mint : a.mint;
  // section timing (thread 0; thread 32, the folding warp's busy time):
  // off unless a.prof is set
  const bool prof = a.prof != nullptr && tid == 0;
  const bool prof_folder = a.prof != nullptr && tid == 32;
  long long folder_cycles = 0;
  long long pt[PROF_N] = {};
  long long tmark = prof ? clock64() : 0;
  auto mark = [&](int k) {
    if (prof) {
      const long long now = clock64();
      pt[k] += now - tmark;
      tmark = now;
    }
  };

  // ---- the launch's staging: the global window's weights and keys, the
  // histograms, the weight table, the mint history, the regionals'
  // counters and their running sample sums (the slot-order sum of the
  // window's samples: slots fill in order and pads add +0)
  for (int t = tid; t < kg; t += kThreads) {
    s.gwt[t] = a.gwt[t];
    s.gkh[t] = a.gkey_hi[t];
    s.gkl[t] = a.gkey_lo[t];
  }
  for (int t = tid; t < bins; t += kThreads) {
    s.hist_e[t] = a.hist_edge[t];
    s.hist_g[t] = a.hist_glob[t];
    s.wtab[t] = a.wtab[t];
  }
  if (place & P_MINT)
    for (int v = tid; v < vcap; v += kThreads) s.mint[v] = a.mint[v];
  for (int q = tid; q < R; q += kThreads) {
    if (PLACE & P_REG) {
      s.rcnt[q] = a.rcount[q];
      s.rad[q] = a.radopt[q];
      s.rup[q] = a.up_seq[q];
      s.rlacc[q] = a.last_acc_r[q];
    }
    float raw = 0.f;
    for (int k = 0; k < kmax; ++k) raw = __fadd_rn(raw, a.rsamp[static_cast<size_t>(q) * kmax + k]);
    rraw[q] = raw;
  }
  if (tid == 0) {
    s.q[Q_HEAD] = s.q[Q_TAIL] = s.q[Q_CLOSE] = 0;
    s.q[Q_GDONE] = a.si[S_VERSION];  // the rows G[0..version] are final
  }
  int posted = 0;  // warp 0: folds posted; warp 1: folds done (the ring's tail)
  // the scalar state: warp 0's registers for the whole span
  int cnt[S_COUNT];
  for (int q = 0; q < S_COUNT; ++q) cnt[q] = a.si[q];
  int ver = cnt[S_VERSION], gcnt = cnt[S_GCOUNT];
  float lastm = a.sf[0], laccg = a.sf[1];
  int stop_j = C, stop_adj = 0, v0 = ver;
  const float lr_local = static_cast<float>(a.local_lr);
  const float gap_glob = static_cast<float>(a.gap_glob), gap_reg = static_cast<float>(a.gap_reg);
  const int max_st = static_cast<int>(a.max_staleness);

  for (int sc = s0; sc < s0 + n_span; ++sc) {
    const size_t base = static_cast<size_t>(sc) * C;
    const bool first = sc == s0;
    const int js = first ? j_start : 0;
    __syncthreads();  // the last chunk's rows, mints and staging have landed
    // ---- stage the chunk's records; pass A's adoption and start version
    for (int j = tid; j < C; j += kThreads) {
      const size_t e = base + j;
      s.flags[j] = (a.live[e] ? F_LIVE : 0) | (a.send_ok[e] ? F_OK : 0);
      const int client = static_cast<int>(a.client[e]);
      s.idx[j] = client;
      s.khi[j] = a.key_hi[e];
      s.klo[j] = a.key_lo[e];
      const float ta = a.t_adopt[e];
      s.tadopt[j] = ta;
      s.tarr[j] = a.t_arr[e];
      s.samp[j] = a.samples[client];
      s.bkind[j] = byz ? a.bkind[e] : 0;
      s.blam[j] = byz ? a.blam[e] : 1.f;
      s.bnoise[j] = (byz && a.bnoise != nullptr) ? a.bnoise[e] : 0;
      if (hier) {
        s.r[j] = a.r[e];
        s.kr[j] = a.k_r[e];
        s.tradopt[j] = a.t_radopt[e];
      }
      if (staged) {
        s.base0[j] = static_cast<int>(a.base0[j]);
        s.prev0[j] = static_cast<int>(a.rows0[static_cast<size_t>(j) * row + dim]);
        if (hier) s.rv0[j] = static_cast<int>(a.rv0[j]);
      } else {
        s.base0[j] = lower_bound(mhist, vcap, ta);
        s.prev0[j] = static_cast<int>(a.w[static_cast<size_t>(client) * row + dim]);
        if (hier) s.rv0[j] = lower_bound(mhist, vcap, s.tradopt[j]);
      }
    }
    __syncthreads();
    mark(PROF_STAGE);
    if (!staged) {
      // ---- pass A's rows: every lane's start row (G[base0] if newer than
      // its own) and one local round into the payloads, all read before
      // any row is written (pad lanes share the trash row N), then the
      // rows and versions written back and the payloads corrupted
#pragma unroll 8
      for (int it = tid; it < C * dim; it += kThreads) {
        const int j = it / dim, d = it - j * dim;
        const size_t client = static_cast<size_t>(s.idx[j]);
        const int b = s.base0[j];
        const float x = b > s.prev0[j] ? a.G[static_cast<size_t>(b) * dim + d] : a.w[client * row + d];
        const float t = a.targets[client * dim + d];
        pay[it] = __fadd_rn(x, __fmul_rn(lr_local, __fsub_rn(t, x)));
      }
      __syncthreads();
      for (int it = tid; it < C * dim; it += kThreads) {
        const int j = it / dim, d = it - j * dim;
        const float honest = pay[it];
        a.w[static_cast<size_t>(s.idx[j]) * row + d] = honest;
        const int k = s.bkind[j];
        if (k != 0) {
          const float* nrow = (k == 3 && a.noise != nullptr) ? a.noise + static_cast<size_t>(s.bnoise[j]) * dim
                                                            : nullptr;
          pay[it] = corrupt(k, s.blam[j], nrow, d, honest);
        }
      }
      for (int j = tid; j < C; j += kThreads)
        a.w[static_cast<size_t>(s.idx[j]) * row + dim] = static_cast<float>(max(s.base0[j], s.prev0[j]));
      __syncthreads();
    }
    mark(PROF_PASS_A);
    if (prof) pt[PROF_CHUNKS] += 1;
    if (tid >= 32 && tid < 64) {
      // ---- warp 1: the folds warp 0 posts, in order, until warp 0 closes
      // the chunk and the ring is empty
      const int chunk_no = sc - s0;
      for (;;) {
        int head = 0;
        if (lane == 0) {
          long long spins = 0;
          for (;;) {
            head = *reinterpret_cast<volatile int*>(s.q + Q_HEAD);
            if (head != posted) break;
            if (*reinterpret_cast<volatile int*>(s.q + Q_CLOSE) > chunk_no) {
              head = *reinterpret_cast<volatile int*>(s.q + Q_HEAD);  // posted before the close
              break;
            }
            __nanosleep(32);
            if (++spins > kSpinLimit) __trap();
          }
          __threadfence_block();
        }
        head = __shfl_sync(0xffffffffu, head, 0);
        __syncwarp();
        if (head == posted) break;
        const long long t0 = prof_folder ? clock64() : 0;
        const int q = posted % kQ;
        const FoldCmd c = s.cmd[q];
        if (c.kind == CMD_RFOLD) {
          float* rp = a.rparams + static_cast<size_t>(c.r) * dim;
          const float* cur = c.src_v >= 0 ? a.G + static_cast<size_t>(c.src_v) * dim : rp;
          fold_window(a, s, L, q, a.rbuf + static_cast<size_t>(c.r) * kmax * dim, c.rows != 0, kmax, cur, rp, lane);
          if (c.gslot >= 0) {
            // the regional's aggregate, corrupted if its regional is an
            // attacker, into the global window
            const float* nrow = c.nrow >= 0 ? a.agg_noise + static_cast<size_t>(c.nrow) * dim : nullptr;
            for (int d = lane; d < dim; d += 32)
              a.gbuf[static_cast<size_t>(c.gslot) * dim + d] = corrupt(c.ak, c.alam, nrow, d, rp[d]);
          }
        } else {
          fold_window(a, s, L, q, a.gbuf, c.rows != 0, kg, a.G + static_cast<size_t>(c.ver) * dim,
                      a.G + static_cast<size_t>(c.ver + 1) * dim, lane);
          publish(s, Q_GDONE, c.ver + 1, lane);
        }
        posted += 1;
        publish(s, Q_TAIL, posted, lane);
        if (prof_folder) folder_cycles += clock64() - t0;
      }
      continue;
    }
    if (tid >= 64) {
      // the other warps, while warp 0 walks the chain: the next chunk's
      // records and the rows its pass A reads, into L2 (a hint: the
      // values are read again after the barrier). A staged launch walks
      // one chunk and reads no client row (a sharded engine hands it none)
      if (!staged && sc + 1 < s0 + n_span) {
        const size_t nb = base + C;
        for (int j = tid - 64; j < C; j += kThreads - 64) {
          const size_t client = static_cast<size_t>(a.client[nb + j]);
          const float* wr = a.w + client * row;
          asm volatile("prefetch.global.L2 [%0];" ::"l"(wr));
          asm volatile("prefetch.global.L2 [%0];" ::"l"(wr + dim));
          asm volatile("prefetch.global.L2 [%0];" ::"l"(a.targets + client * dim));
          asm volatile("prefetch.global.L2 [%0];" ::"l"(a.targets + client * dim + dim - 1));
          asm volatile("prefetch.global.L2 [%0];" ::"l"(a.samples + client));
        }
      }
      continue;
    }

    // ---- warp 0: the chain of the chunk's events, 32 at a time. Each lane
    // takes one event of the batch and decides it from shared memory; the
    // events of one regional (of the global window, flat) run in turn, in
    // rounds that hand a regional's counters on through shuffles, the
    // others side by side. An event that flushes a window (or, when PyTorch
    // ran pass A, one an in-chunk mint moved) ends the batch: the events
    // before it are committed (each lane its own payload row, window slot
    // and counters), then the single-event path below takes it with the
    // whole warp (the fold, the aggregate's offer, a mint), lane d owning
    // coordinate d. A resumed launch (v0_in >= 0) re-reads the mints its
    // chunk has made.
    v0 = (first && v0_in >= 0) ? v0_in : ver;
    int nmn = ver - v0;
    for (int m = lane; m < min(nmn, L.gf); m += 32) s.nm[m] = a.mint[v0 + m];
    __syncwarp();
    const unsigned lt = (1u << lane) - 1u;  // the lanes below this one
    bool stopped = false;
    int j = js;
    while (j < C && !stopped) {
      const int nb = min(32, C - j);
      {
        const int je = j + lane;
        const bool inb = lane < nb;
        const unsigned char fl = inb ? s.flags[je] : 0;
        const bool live = (fl & F_LIVE) != 0;
        const int jr = inb ? je : j;  // a lane past the chunk reads a valid record
        const float ta = s.tadopt[jr], tarr = s.tarr[jr], samp = s.samp[jr];
        const float tr = hier ? s.tradopt[jr] : 0.f;
        const int r = hier ? s.r[jr] : 0, kr = hier ? s.kr[jr] : kg;
        const int nmc = min(nmn, L.gf);
        int adj = 0, radj = 0;
        for (int m = 0; m < nmc; ++m) {
          const float tm = s.nm[m];
          adj += tm < ta;
          radj += tm < tr;
        }
        const bool resumed_lane = first && v0_in >= 0 && je == js;
        const bool stopper = live && staged && adj > 0 && !resumed_lane;
        const bool retrain = live && adj > 0 && !resumed_lane;
        const int v_a = max(s.base0[jr] + adj, s.prev0[jr]);
        const int tau = hier ? max(s.rv0[jr] + radj - v_a, 0) : max(ver - v_a, 0);
        const bool ok = (fl & F_OK) != 0, fresh = tau <= max_st;
        const float gap = hier ? gap_reg : gap_glob;
        // the events of one window in turn: rank = earlier lanes of mine
        const unsigned grp = __match_any_sync(0xffffffffu, live ? (hier ? r : 0) : -1 - lane);
        const int rank = __popc(grp & lt);
        const int pred = (grp & lt) ? 31 - __clz(grp & lt) : lane;
        const int rounds = __reduce_max_sync(0xffffffffu, live ? rank : 0);
        int cnt_v = hier ? (live ? rcnt[r] : 0) : gcnt;
        float lacc_v = hier ? (live ? rlacc[r] : 0.f) : laccg;
        float raw_v = hier && live ? rraw[r] : 0.f;
        bool ins = false, flush = false, rate_ok = true;
        int slot = 0;
        for (int k = 0; k <= rounds; ++k) {
          const int pc = __shfl_sync(0xffffffffu, cnt_v, pred);
          const float pl = __shfl_sync(0xffffffffu, lacc_v, pred);
          const float pr = __shfl_sync(0xffffffffu, raw_v, pred);
          if (rank == k && live) {
            if (k > 0) {
              cnt_v = pc;
              lacc_v = pl;
              raw_v = pr;
            }
            rate_ok = !(gap > 0.f) || __fsub_rn(tarr, lacc_v) >= gap;
            ins = ok && fresh && rate_ok;
            slot = cnt_v;
            if (ins) {
              cnt_v += 1;
              lacc_v = tarr;
              raw_v = __fadd_rn(raw_v, samp);
            }
            // >=: a churn epoch can shrink k below a part-filled window
            flush = ins && cnt_v >= kr;
          }
        }
        const unsigned cuts = __ballot_sync(0xffffffffu, inb && (flush || stopper));
        const int cut = cuts ? __ffs(cuts) - 1 : nb;  // the lanes below it commit
        const bool commit = live && lane < cut;
        // a retrained lane reads global v0 + adj, which warp 1 may still be folding
        const int need = __reduce_max_sync(0xffffffffu, commit && retrain ? v0 + adj : -1);
        if (need >= 0) wait_for(s, Q_GDONE, [need](int g) { return g >= need; }, lane);
        cnt[S_STALE_EDGE] += __popc(__ballot_sync(0xffffffffu, commit && ok && !fresh));
        cnt[S_RATE_EDGE] += __popc(__ballot_sync(0xffffffffu, commit && ok && fresh && !rate_ok));
        if (commit && (retrain || ins)) {
          const int idx = s.idx[je], bk = s.bkind[je];
          float* dst = !ins ? nullptr
                            : (hier ? a.rbuf + (static_cast<size_t>(r) * kmax + slot) * dim
                                    : a.gbuf + static_cast<size_t>(slot) * dim);
          if (retrain) {
            const float* g = a.G + static_cast<size_t>(v0 + adj) * dim;
            const float* t = a.targets + static_cast<size_t>(idx) * dim;
            float* wrow = a.w + static_cast<size_t>(idx) * row;
            const float* noise_row = (bk == 3 && a.noise != nullptr)
                                         ? a.noise + static_cast<size_t>(s.bnoise[je]) * dim : nullptr;
            for (int d = 0; d < dim; ++d) {
              const float gd = g[d];
              const float honest = __fadd_rn(gd, __fmul_rn(lr_local, __fsub_rn(t[d], gd)));
              wrow[d] = honest;
              const float v = corrupt(bk, s.blam[je], noise_row, d, honest);
              if (dst != nullptr) dst[d] = v;
            }
            wrow[dim] = static_cast<float>(v0 + adj);
          } else {
            const float* p = pay + static_cast<size_t>(je) * dim;
            for (int d = 0; d < dim; ++d) dst[d] = p[d];
          }
        }
        if (commit && ins) {
          const int bin = bin_of(tau, bins);
          const float wgt = __fmul_rn(samp, s.wtab[bin]);
          if (hier) {
            const size_t q = static_cast<size_t>(r) * kmax + slot;
            a.rwt[q] = wgt;
            a.rsamp[q] = samp;
            a.rkey_hi[q] = s.khi[je];
            a.rkey_lo[q] = s.klo[je];
          } else {
            s.gwt[slot] = wgt;
            s.gkh[slot] = s.khi[je];
            s.gkl[slot] = s.klo[je];
          }
          atomicAdd(s.hist_e + bin, 1);
        }
        // each window's newest committed state, from its last committed lane
        const unsigned later = grp & ~lt & ~(1u << lane);
        const bool last = commit && (later == 0 || __ffs(later) - 1 >= cut);
        if (hier && last) {
          rcnt[r] = cnt_v;
          rlacc[r] = lacc_v;
          rraw[r] = raw_v;
        }
        const unsigned lasts = __ballot_sync(0xffffffffu, last);
        if (!hier && lasts) {
          const int src = 31 - __clz(lasts);
          gcnt = __shfl_sync(0xffffffffu, cnt_v, src);
          laccg = __shfl_sync(0xffffffffu, lacc_v, src);
        }
        __syncwarp();
        j += cut;
        if (cut == nb) continue;
      }
      // ---- the single-event path: event j, the whole warp
      do {
        const unsigned char fl = s.flags[j];
        if (!(fl & F_LIVE)) break;
        const float ta = s.tadopt[j], tarr = s.tarr[j], samp = s.samp[j];
        const int idx = s.idx[j], bk = s.bkind[j];
        const int nmc = min(nmn, L.gf);
        int adj = 0;
        for (int m = 0; m < nmc; ++m) adj += s.nm[m] < ta;
        // the lane a resumed launch starts at was retrained by the host
        const bool resumed_lane = first && v0_in >= 0 && j == js;
        if (staged && adj > 0 && !resumed_lane) {
          stop_j = j;
          stop_adj = adj;
          stopped = true;
          break;
        }
        const bool retrain = adj > 0 && !resumed_lane;
        const int v_a = max(s.base0[j] + adj, s.prev0[j]);
        const bool ok = (fl & F_OK) != 0;
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
          cnt_in = rcnt[r];
          up_in = rup[r];
          lacc_in = rlacc[r];
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
        if (retrain) wait_for(s, Q_GDONE, [&](int g) { return g >= v0 + adj; }, lane);
        // ---- the lane's payload (retrained from in-chunk mint adj, or pass
        // A's) into its window slot
        if (retrain || ins) {
          float* dst = !ins ? nullptr
                            : (hier ? a.rbuf + (static_cast<size_t>(r) * kmax + slot) * dim
                                    : a.gbuf + static_cast<size_t>(slot) * dim);
          const float* g = a.G + static_cast<size_t>(v0 + adj) * dim;
          const float* t = a.targets + static_cast<size_t>(idx) * dim;
          float* wrow = a.w + static_cast<size_t>(idx) * row;
          const float* noise_row = (bk == 3 && a.noise != nullptr) ? a.noise + static_cast<size_t>(s.bnoise[j]) * dim
                                                                   : nullptr;
          const float* p = pay + static_cast<size_t>(j) * dim;
          for (int d = lane; d < dim; d += 32) {
            float v;
            if (retrain) {
              const float gd = g[d];
              const float honest = __fadd_rn(gd, __fmul_rn(lr_local, __fsub_rn(t[d], gd)));
              wrow[d] = honest;
              v = corrupt(bk, s.blam[j], noise_row, d, honest);
            } else {
              v = p[d];
            }
            if (dst != nullptr) dst[d] = v;
          }
          if (retrain && lane == 0) wrow[dim] = static_cast<float>(v0 + adj);
        }
        bool g_offer = false;  // an offer into the global window at this event
        float t_evt = tarr, g_w = 0.f;
        int g_hi = 0, g_lo = 0, g_bin = 0;
        if (!hier) {
          if (ins) {
            g_offer = true;
            g_bin = bin_of(tau, bins);
            g_w = __fmul_rn(samp, s.wtab[g_bin]);
            g_hi = s.khi[j];
            g_lo = s.klo[j];
          }
        } else if (ins) {
          const int bin = bin_of(tau, bins);
          const size_t q = static_cast<size_t>(r) * kmax + slot;
          if (lane == 0) a.rwt[q] = __fmul_rn(samp, s.wtab[bin]);
          if (lane == 1) a.rsamp[q] = samp;
          if (lane == 2) a.rkey_hi[q] = s.khi[j];
          if (lane == 3) a.rkey_lo[q] = s.klo[j];
          if (lane == 0) s.hist_e[bin] += 1;  // read by lane 0 alone until the writeback
          const float raw = __fadd_rn(rraw[r], samp);
          int cnt_out = cnt_in + 1, up_new = up_in;
          // >=: a churn epoch can shrink k below a part-filled window
          if (cnt_out >= s.kr[j]) {
            mark(PROF_EVENTS);
            cnt_out = 0;
            up_new = up_in + 1;
            // the aggregate's verdicts first (device-memory loads that
            // overlap the fold), then the regional's params: the freshest
            // arrived global if newer than its last adoption, then the fold
            const int sidx = min(max(up_new - 1, 0), stride - 1);
            const size_t gq = static_cast<size_t>(r) * stride + sidx;
            const bool agg_ok = a.reg_send_ok[gq] != 0;
            const float t_agg = __fadd_rn(__fadd_rn(tarr, a.agg_delay[r]), a.reg_jit[gq]);
            const bool agg_byz = byz && a.akind[r] > 0;
            const bool agg_dup = a.dup && agg_ok && a.reg_dup[gq] != 0;
            const int ak = byz ? a.akind[r] : 0;
            const int nrow = ak == 3 ? a.agg_noise_idx[gq] : -1;
            const float alam = byz ? a.alam[r] : 1.f;
            const int radopt = rad[r];
            const size_t w0 = static_cast<size_t>(r) * kmax;
            // the window (its weights and keys, and its rows when the ring
            // has room) into a free ring slot, then reset for later inserts
            wait_for(s, Q_TAIL, [&](int done) { return posted - done < kQ; }, lane);
            const int qs = posted % kQ;
            const bool rows_in = (place & P_ROWS) != 0;
            stage_window(s, L, qs, a.rwt + w0, a.rkey_hi + w0, a.rkey_lo + w0, rows_in ? a.rbuf + w0 * dim : nullptr,
                         kmax, lane);
            for (int k = lane; k < kmax; k += 32) {
              a.rwt[w0 + k] = 0.f;
              a.rsamp[w0 + k] = 0.f;
              a.rkey_hi[w0 + k] = PAD_KEY;
              a.rkey_lo[w0 + k] = PAD_KEY;
            }
            rraw[r] = 0.f;
            rad[r] = max(radopt, rv);
            cnt[S_RMERGES] += 1;
            cnt[S_BYZ_AGG] += agg_byz;
            cnt[S_AGG_DROP] += !agg_ok;
            cnt[S_DUP_AGG] += agg_dup;
            const int tau_g = max(ver - rv, 0);
            const bool fresh_g = tau_g <= max_st;
            const bool rate_g_ok = !(gap_glob > 0.f) || __fsub_rn(t_agg, laccg) >= gap_glob;
            cnt[S_STALE_AGG] += agg_ok && !fresh_g;
            cnt[S_RATE_AGG] += agg_ok && fresh_g && !rate_g_ok;
            if (agg_ok && fresh_g && rate_g_ok) {
              g_offer = true;
              t_evt = t_agg;
              g_bin = bin_of(tau_g, bins);
              g_w = __fmul_rn(raw, s.wtab[g_bin]);
              g_hi = r;
              g_lo = up_new;
            }
            // warp 1 folds the regional's params (the freshest arrived
            // global if newer than its last adoption, else its own) and
            // offers the aggregate's row at the global slot
            if (lane == 0) {
              FoldCmd c = {};
              c.kind = CMD_RFOLD;
              c.r = r;
              c.src_v = rv > radopt ? rv : -1;
              c.gslot = g_offer ? gcnt : -1;
              c.ak = ak;
              c.nrow = nrow;
              c.rows = rows_in;
              c.alam = alam;
              s.cmd[qs] = c;
            }
            posted += 1;
            publish(s, Q_HEAD, posted, lane);
            // without a copy of its rows the window waits for its fold
            if (!rows_in) wait_for(s, Q_TAIL, [&](int done) { return done >= posted; }, lane);
            if (prof) pt[PROF_RFOLDS] += 1;
            mark(PROF_RFOLD);
          } else {
            rraw[r] = raw;
          }
          rcnt[r] = cnt_out;
          rup[r] = up_new;
          rlacc[r] = tarr;
        }
        if (!g_offer) break;
        // ---- the global window: insert (an aggregate's row comes from warp
        // 1), and at K the flush
        s.gwt[gcnt] = g_w;
        s.gkh[gcnt] = g_hi;
        s.gkl[gcnt] = g_lo;
        if (lane == 0) (hier ? s.hist_g : s.hist_e)[g_bin] += 1;
        laccg = t_evt;
        gcnt += 1;
        if (gcnt < kg) break;
        mark(PROF_EVENTS);
        gcnt = 0;
        {
          // warp 1 folds G[ver + 1]: the window's weights and keys into a
          // ring slot; flat, its rows too (warp 0 wrote them and inserts
          // again), hier, warp 1 reads the rows it wrote itself
          wait_for(s, Q_TAIL, [&](int done) { return posted - done < kQ; }, lane);
          const int qs = posted % kQ;
          const bool rows_in = !hier && (place & P_ROWS) != 0;
          stage_window(s, L, qs, s.gwt, s.gkh, s.gkl, rows_in ? a.gbuf : nullptr, kg, lane);
          if (lane == 0) {
            FoldCmd c = {};
            c.kind = CMD_GFOLD;
            c.ver = ver;
            c.rows = rows_in;
            s.cmd[qs] = c;
          }
          posted += 1;
          publish(s, Q_HEAD, posted, lane);
          if (!hier && !rows_in) wait_for(s, Q_TAIL, [&](int done) { return done >= posted; }, lane);
        }
        // mint times clamped monotone: the searchsorted axis stays ascending
        lastm = fmaxf(t_evt, lastm);
        if (lane == 0) a.mint[ver] = lastm;
        if (place & P_MINT) s.mint[ver] = lastm;
        s.nm[min(nmn, L.gf - 1)] = lastm;
        nmn += 1;
        ver += 1;
        cnt[S_MERGES] += 1;
        for (int t = lane; t < kg; t += 32) {
          s.gwt[t] = 0.f;
          s.gkh[t] = PAD_KEY;
          s.gkl[t] = PAD_KEY;
        }
        __syncwarp();  // the reset window before the next insert
        if (prof) pt[PROF_GFOLDS] += 1;
        mark(PROF_GFOLD);
      } while (false);
      __syncwarp();
      j += 1;
    }
    publish(s, Q_CLOSE, sc - s0 + 1, lane);  // warp 1 drains the ring and leaves
    mark(PROF_EVENTS);
  }

  // ---- write the span's state back (warp 0 holds the scalars)
  __syncthreads();
  if (tid == 0) {
    cnt[S_VERSION] = ver;
    cnt[S_GCOUNT] = gcnt;
    for (int q = 0; q < S_COUNT; ++q) a.si[q] = cnt[q];
    a.sf[0] = lastm;
    a.sf[1] = laccg;
    a.stop[0] = stop_j;
    a.stop[1] = stop_adj;
    a.stop[2] = v0;
    if (prof)
      for (int k = 0; k < PROF_N; ++k)
        if (k != PROF_FOLDER) a.prof[k] += pt[k];
  }
  if (prof_folder) {
    a.prof[PROF_FOLDER] += folder_cycles;
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
  if (PLACE & P_REG) {
    for (int q = tid; q < R; q += kThreads) {
      a.rcount[q] = s.rcnt[q];
      a.radopt[q] = s.rad[q];
      a.up_seq[q] = s.rup[q];
      a.last_acc_r[q] = s.rlacc[q];
    }
  }
}

// ---- the card's latencies, for the chunk step's latency bound ----
// One block of 256 threads; thread 0 times, with clock64, `steps`
// dependent steps each of: a pointer chase through shared memory, a
// __fadd_rn chain, a block barrier (every thread), a pointer chase
// through a small device-memory table (L2-resident) and through a large
// one (device memory). out[0..4]: cycles of each; out[5], out[6]: the
// globaltimer nanoseconds and clock64 cycles around the whole probe (the
// clock under this load); out[7]: a sink.
__global__ void __launch_bounds__(kThreads, 1)
    latency_probe_kernel(const int* l2_chase, const int* dram_chase, int dram_start, int steps, float seed,
                         long long* out) {
  __shared__ int chase[1024];
  const int tid = threadIdx.x;
  for (int i = tid; i < 1024; i += kThreads) chase[i] = (i * 389 + 1) & 1023;  // one cycle through all 1024
  __syncthreads();
  long long g0, g1;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g0));
  const long long c0 = clock64();
  long long sink = 0;
  if (tid == 0) {
    int p = 0;
    long long a = clock64();
    for (int k = 0; k < steps; ++k) p = chase[p];
    long long b = clock64();
    out[0] = b - a;
    sink += p;
    float x = seed;
    a = clock64();
    for (int k = 0; k < steps; ++k) x = __fadd_rn(x, seed);
    b = clock64();
    out[1] = b - a;
    sink += static_cast<long long>(x);
  }
  long long a = clock64();
  for (int k = 0; k < steps; ++k) __syncthreads();
  long long b = clock64();
  if (tid == 0) {
    out[2] = b - a;
    int p = 0;
    a = clock64();
    for (int k = 0; k < steps; ++k) p = l2_chase[p];
    b = clock64();
    out[3] = b - a;
    sink += p;
    p = dram_start;
    a = clock64();
    for (int k = 0; k < steps; ++k) p = dram_chase[p];
    b = clock64();
    out[4] = b - a;
    sink += p;
  }
  const long long c1 = clock64();
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g1));
  if (tid == 0) {
    out[5] = g1 - g0;
    out[6] = c1 - c0;
    out[7] = sink;
  }
}

// Where a launch keeps what fits (P_PAY | P_REG | P_MINT), or BAD_ARGS:
// the fixed part, then the consensus task's payloads, the regionals'
// counters (unless kept in device memory), the mint history.
int placement(const FleetArgs& a) {
  int place = 0;
  if (Layout(a, place).bytes() > kSmemMax) return BAD_ARGS;
  if (a.staged == 0 && Layout(a, place | P_PAY).bytes() <= kSmemMax) place |= P_PAY;
  if (a.hier != 0 && a.reg_layout != REG_DEVICE && Layout(a, place | P_REG).bytes() <= kSmemMax) place |= P_REG;
  if (Layout(a, place | P_MINT).bytes() <= kSmemMax) place |= P_MINT;
  if (a.reg_layout != REG_DEVICE && Layout(a, place | P_ROWS).bytes() <= kSmemMax) place |= P_ROWS;
  if (!(place & P_PAY) && a.payload == nullptr) return BAD_ARGS;
  if (a.hier != 0 && !(place & P_REG) && a.rraw == nullptr) return BAD_ARGS;
  return place;
}

template <int PLACE>
cudaError_t launch(const FleetArgs& a, int s0, int n_span, int j_start, int v0, int place, cudaStream_t stream) {
  const size_t smem = Layout(a, place).bytes();
  static size_t cleared = 0;  // the dynamic shared memory this instantiation is cleared for
  if (smem > 48 * 1024 && smem > cleared) {
    cudaError_t err = cudaFuncSetAttribute(fleet_chunk_kernel<PLACE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(kSmemMax));
    if (err != cudaSuccess) return err;
    cleared = kSmemMax;
  }
  fleet_chunk_kernel<PLACE><<<1, kThreads, smem, stream>>>(a, s0, n_span, j_start, v0, place);
  return cudaGetLastError();
}

bool unpack(const void* args, int n_words, FleetArgs* a) {
  if (args == nullptr || n_words != static_cast<int>(sizeof(FleetArgs) / 8)) return false;
  memcpy(a, args, sizeof(FleetArgs));
  // only a launch with pass A inside reads and writes the client rows
  return a->chunk >= 1 && a->dim >= 1 && a->k_glob >= 1 && a->k_max >= 1 && a->gf_cap >= 1 && a->hist_bins >= 1 &&
         a->v_cap >= 1 && a->stop != nullptr && (a->hier == 0 || a->n_reg >= 1) && a->reg_layout >= REG_AUTO &&
         a->reg_layout <= REG_DEVICE && (a->staged != 0 || (a->w != nullptr && a->targets != nullptr));
}

}  // namespace

// args: a host array of n_words 64-bit words, laid out as FleetArgs;
// launches one block on `stream` for chunks chunk_idx .. chunk_idx +
// n_span - 1 from lane `j_start` of the first (0, and v0 -1, for a fresh
// chunk; a gradient task's resumed chunk passes the lane and v0 its last
// launch wrote to `stop`, and a gradient task's launch walks one chunk).
extern "C" int p2p_fleet_chunk(const void* args, int n_words, int chunk_idx, int n_span, int j_start, int v0,
                               void* stream) {
  FleetArgs a;
  if (!unpack(args, n_words, &a) || chunk_idx < 0 || n_span < 1 ||
      chunk_idx + static_cast<long long>(n_span) > a.n_chunks || j_start < 0 || j_start >= a.chunk ||
      (j_start > 0) != (v0 >= 0) || ((a.staged != 0 || j_start > 0) && n_span != 1))
    return BAD_ARGS;
  const int place = placement(a);
  if (place < 0) return BAD_ARGS;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (place & (P_PAY | P_REG)) {
    case 0: return static_cast<int>(launch<0>(a, chunk_idx, n_span, j_start, v0, place, st));
    case P_PAY: return static_cast<int>(launch<P_PAY>(a, chunk_idx, n_span, j_start, v0, place, st));
    case P_REG: return static_cast<int>(launch<P_REG>(a, chunk_idx, n_span, j_start, v0, place, st));
    default: return static_cast<int>(launch<P_PAY | P_REG>(a, chunk_idx, n_span, j_start, v0, place, st));
  }
}

// What a launch of this argument table keeps in shared memory (P_PAY 1,
// P_REG 2, P_MINT 4, P_ROWS 8), or -1 if it would be refused.
extern "C" int p2p_fleet_chunk_place(const void* args, int n_words) {
  FleetArgs a;
  return unpack(args, n_words, &a) ? placement(a) : BAD_ARGS;
}

// The latency probe (one block): l2_chase and dram_chase each hold one
// cycle of indices, a table that fits L2 and one that does not (its chase
// starts at dram_start, a stretch of the cycle no earlier probe walked);
// out holds 8 int64 (latency_probe_kernel).
extern "C" int p2p_fleet_latency_probe(const int* l2_chase, const int* dram_chase, int dram_start, int steps,
                                       long long* out, void* stream) {
  if (l2_chase == nullptr || dram_chase == nullptr || out == nullptr || steps < 1 || dram_start < 0) return BAD_ARGS;
  latency_probe_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(l2_chase, dram_chase, dram_start,
                                                                             steps, 1e-3f, out);
  return static_cast<int>(cudaGetLastError());
}
