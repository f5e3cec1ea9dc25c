// The ICI weights plane's shard transfer for Hopper (sm_90a): one kernel
// launch copies every leaf of a parameter tree from the sending node's
// buffers into buffers owned by the receiving node, hand-written in CUDA
// C++.
//
// Port of the Pallas kernel in p2pfl_tpu/parallel/ici_plane.py:
//   p2p_ici_exchange <- _pallas_exchange (pltpu.make_async_remote_copy,
//                       launched per leaf inside the pair program of
//                       _exchange_program)
//
// What it computes: each destination buffer receives its source block,
// bit for bit, for any dtype (the copy is of bytes). The TPU kernel is a
// 2-cycle over the pair axis: both devices of the pair DMA their block
// into the partner's HBM, and the receiver keeps one side. Here only the
// kept side is written: the sender's block lands in the receiver's fresh
// buffers, and nothing is written back to the sender.
//
// Where the buffers are: on one card, both sides are that card's memory
// (two nodes owning disjoint slots of one card, the checking machine's
// layout). With two cards the destination pointers are the peer card's
// memory, valid on the launching card once peer access is enabled
// (p2p_enable_peer_access); the stores then cross NVLink. The wrapper
// orders the receiver's stream after the launch with an event, the role
// of the TPU kernel's recv semaphore.
//
// The table: up to kLarge entries (src, dst, bytes) travel in the launch's
// own parameter buffer (a __grid_constant__ struct in the card's constant
// bank), so one launch moves a whole tree and the wrapper makes no copy of
// its own. Each entry gets blocks in proportion to its bytes (at most
// kMaxBlocksPerEntry, beyond which a block loops); a block finds its entry
// by a binary search of first_block, uniform across the block and so a
// broadcast read of the constant cache.
//
// What bounds it: bytes. Every payload byte is read once and written once,
// so the least time is 2 x bytes / 3.35 TB/s on one card. The copy loop
// moves 16 bytes per thread per access (uint4 loads through the read-only
// path, four of them in flight before the uint4 stores) where source and
// destination share their alignment mod 16, with byte-wide head and tail;
// each block covers 16 KiB of its leaf in one pass; a leaf whose source and
// destination are misaligned to each other is copied byte by byte (slow,
// and never produced by the plane, whose buffers are whole allocations).
//
// The entry point returns cudaGetLastError() after the launch so the
// Python wrapper can raise on a refused launch; it allocates nothing in
// device memory and does not synchronise.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;                                   // uint4 copies a thread keeps in flight
constexpr unsigned long long kBytesPerBlock = 16ull * kUnroll * kThreads;  // 16 KiB: one pass
constexpr unsigned long long kMaxBlocksPerEntry = 8192;      // 128 MiB per pass
constexpr int kSmall = 64;     // 2 KiB of parameters: trees up to 64 leaves
#if CUDART_VERSION >= 12010
constexpr int kLarge = 1000;   // ~32 KB: the parameter limit since CUDA 12.1
#else
constexpr int kLarge = 120;    // ~4 KB: the parameter limit before CUDA 12.1
#endif
constexpr int BAD_ARGS = -1;

struct Entry {
  const unsigned char* src;
  unsigned char* dst;
  unsigned long long bytes;
  unsigned long long first_block;
};

template <int N>
struct Table {
  int n;
  Entry e[N];
};

template <int N>
__global__ void __launch_bounds__(kThreads) ici_exchange_kernel(const __grid_constant__ Table<N> t) {
  const unsigned long long b = blockIdx.x;
  int lo = 0, hi = t.n - 1;
  while (lo < hi) {  // the last entry whose first block is <= b
    const int mid = (lo + hi + 1) >> 1;
    if (t.e[mid].first_block <= b) lo = mid; else hi = mid - 1;
  }
  const unsigned char* __restrict__ src = t.e[lo].src;
  unsigned char* __restrict__ dst = t.e[lo].dst;
  const unsigned long long n = t.e[lo].bytes;
  const unsigned long long first = t.e[lo].first_block;
  const unsigned long long last = lo + 1 < t.n ? t.e[lo + 1].first_block : gridDim.x;
  const unsigned long long tid = (b - first) * kThreads + threadIdx.x;
  const unsigned long long stride = (last - first) * kThreads;

  const unsigned s_mis = static_cast<unsigned>(reinterpret_cast<uintptr_t>(src) & 15u);
  const unsigned d_mis = static_cast<unsigned>(reinterpret_cast<uintptr_t>(dst) & 15u);
  if (s_mis != d_mis) {
    for (unsigned long long i = tid; i < n; i += stride) dst[i] = src[i];
    return;
  }
  unsigned long long head = (16u - s_mis) & 15u;
  if (head > n) head = n;
  const unsigned long long n_vec = (n - head) >> 4;
  const uint4* __restrict__ s4 = reinterpret_cast<const uint4*>(src + head);
  uint4* __restrict__ d4 = reinterpret_cast<uint4*>(dst + head);
  // kUnroll independent 16-byte loads in flight per thread before its
  // stores; a warp's k-th accesses are 512 contiguous bytes
  for (unsigned long long i = tid; i < n_vec; i += kUnroll * stride) {
    uint4 r[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const unsigned long long j = i + k * stride;
      if (j < n_vec) r[k] = __ldg(s4 + j);
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const unsigned long long j = i + k * stride;
      if (j < n_vec) d4[j] = r[k];
    }
  }
  if (tid < head) dst[tid] = src[tid];
  for (unsigned long long i = head + (n_vec << 4) + tid; i < n; i += stride) dst[i] = src[i];
}

template <int N>
int launch(const unsigned long long* rows, int n_entries, cudaStream_t stream) {
  // the table is 32 KB at kLarge: on the heap, not the caller's stack;
  // the launch copies the parameters, so it is freed right after
  Table<N>* t = new Table<N>;
  t->n = n_entries;
  unsigned long long blocks = 0;
  for (int i = 0; i < n_entries; ++i) {
    const unsigned long long bytes = rows[3 * i + 2];
    t->e[i].src = reinterpret_cast<const unsigned char*>(rows[3 * i]);
    t->e[i].dst = reinterpret_cast<unsigned char*>(rows[3 * i + 1]);
    t->e[i].bytes = bytes;
    t->e[i].first_block = blocks;
    unsigned long long nb = (bytes + kBytesPerBlock - 1) / kBytesPerBlock;
    blocks += nb < kMaxBlocksPerEntry ? nb : kMaxBlocksPerEntry;
  }
  if (blocks == 0 || blocks > 0x7fffffffull) {
    delete t;
    return BAD_ARGS;
  }
  ici_exchange_kernel<N><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(*t);
  delete t;
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The most entries one launch takes (a longer tree takes several launches).
extern "C" int p2p_ici_max_entries() { return kLarge; }

// rows: a host array of n_entries x (src pointer, dst pointer, bytes) as
// unsigned 64-bit integers; every bytes > 0. Launches on `stream`.
extern "C" int p2p_ici_exchange(const void* rows, int n_entries, void* stream) {
  if (rows == nullptr || n_entries <= 0 || n_entries > kLarge) return BAD_ARGS;
  const unsigned long long* r = static_cast<const unsigned long long*>(rows);
  for (int i = 0; i < n_entries; ++i) {
    if (r[3 * i] == 0 || r[3 * i + 1] == 0 || r[3 * i + 2] == 0) return BAD_ARGS;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return n_entries <= kSmall ? launch<kSmall>(r, n_entries, s) : launch<kLarge>(r, n_entries, s);
}

// Lets `device` store into `peer`'s memory (two cards, one process). The
// calling thread's current device is restored. An already enabled pair
// is not an error.
extern "C" int p2p_enable_peer_access(int device, int peer) {
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaSetDevice(device);
  if (err == cudaSuccess) {
    err = cudaDeviceEnablePeerAccess(peer, 0);
    if (err == cudaErrorPeerAccessAlreadyEnabled) {
      cudaGetLastError();  // clear the error this call recorded
      err = cudaSuccess;
    }
  }
  cudaSetDevice(prev);
  return static_cast<int>(err);
}
