// Bit-packed GF(2) column kernels of the packed reduction, for Hopper (sm_90a).
//
// A block is (C, W) uint32 words: row c is one column of the coboundary
// matrix, key universe[i] lives at bit i (word i >> 5, bit i & 31), so the
// first set bit of a row is its low.  The tensors cross from PyTorch as
// int32 carrying the uint32 patterns; the kernels read them as uint32_t.
// NO_LOW = 2^31 - 1 marks an all-zero row.  Every kernel is exact.
//
// gf2_find_low      replaces src/repro/kernels/gf2.py::_find_low_kernel
// gf2_scatter_xor   replaces src/repro/kernels/gf2.py::_parallel_xor_kernel
//                   on the packed reduction's path (the addend block given
//                   as coordinates, XORed into the rows in place)
// gf2_parallel_xor  the same kernel's dense form, a ^ b of two blocks
// gf2_serial_reduce replaces src/repro/kernels/gf2.py::_serial_reduce_kernel
//
// What bounds them on an H100 at the packed engine's shapes (C <= 128 rows,
// W = 128 .. 2176 words, a few hundred KB a call): latency first, then
// bytes.  find_low and the XORs move a block once, microseconds at 3.35
// TB/s, below a launch, so their designs keep the dependent steps of a call
// few: find_low issues all of a row's loads before it tests any, and the
// scatter-XOR touches only the words that carry an addend bit, with no
// host-built dense addend block in front of it.  serial_reduce is a chain
// of dependent row XORs whose length the data sets: it holds the block on
// chip, finds every row's first low in one parallel pass, and pays one
// barrier for each XOR of the chain and none for a row that collides with
// nothing.
#include <atomic>
#include <climits>
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;

constexpr int kNoLow = 0x7fffffff;
constexpr unsigned kFull = 0xffffffffu;

// ---------------------------------------------------------------------------
// gf2_find_low: one thread block of T threads per row, the row's loads all
// in flight.  A pass covers T * K * 4 words: each thread issues its K
// 16-byte loads (VEC; or 4K coalesced word loads where the row is not
// 16-byte aligned) before it tests any of them, so a row pays one memory
// latency a pass, not one per 32 words as a warp walking the row does.  The
// launcher sizes T and K from W so that the path's rows (W <= 3,072 words)
// take one pass.  Each thread keeps the first non-zero word in its own
// words (they ascend in (k, j) order), the warp takes the minimum with
// __reduce_min_sync, and one shared-memory step reduces the warps.  A row
// wider than a pass loops, and stops at the first pass that finds a bit.
// The rows are a strided view: row c starts at cols + c * ld.
// ---------------------------------------------------------------------------
template <int T, int K, bool VEC>
__global__ void __launch_bounds__(T)
gf2_find_low_kernel(const uint32_t* __restrict__ cols,
                    int32_t* __restrict__ lows, int W, long long ld) {
  __shared__ int warp_min[T / 32];
  const uint32_t* r = cols + (size_t)blockIdx.x * (size_t)ld;
  const int tid = threadIdx.x;
  constexpr int kPass = T * K * 4;
  for (int base = 0; base < W; base += kPass) {
    uint32_t v[K][4];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (VEC) {
        const int w = base + (k * T + tid) * 4;
        if (w + 3 < W) {
          const uint4 q = *reinterpret_cast<const uint4*>(r + w);
          v[k][0] = q.x;
          v[k][1] = q.y;
          v[k][2] = q.z;
          v[k][3] = q.w;
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j) v[k][j] = w + j < W ? r[w + j] : 0u;
        }
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int w = base + (k * 4 + j) * T + tid;
          v[k][j] = w < W ? r[w] : 0u;
        }
      }
    }
    int best = kNoLow;
#pragma unroll
    for (int k = K - 1; k >= 0; --k) {
#pragma unroll
      for (int j = 3; j >= 0; --j) {
        const int w = VEC ? base + (k * T + tid) * 4 + j
                          : base + (k * 4 + j) * T + tid;
        if (v[k][j] != 0u) best = w * 32 + (__ffs((int)v[k][j]) - 1);
      }
    }
    int low = __reduce_min_sync(kFull, best);
    if (T > 32) {
      if ((tid & 31) == 0) warp_min[tid >> 5] = low;
      __syncthreads();
#pragma unroll
      for (int i = 0; i < T / 32; ++i) low = min(low, warp_min[i]);
      __syncthreads();              // warp_min is reused by the next pass
    }
    if (low != kNoLow) {            // uniform across the block
      if (tid == 0) lows[blockIdx.x] = low;
      return;
    }
  }
  if (tid == 0) lows[blockIdx.x] = kNoLow;
}

// ---------------------------------------------------------------------------
// gf2_scatter_xor: the parallel phase's GF(2) add in place.  The gathered
// addend block comes as one flat index a set bit, row * (W * 32) + rank;
// one thread a coordinate flips its bit with atomicXor.  XOR commutes, so
// the result is the same in whatever order the atomics land, and a repeated
// coordinate cancels as GF(2) addition does.  The work is the touched words
// (read and written once each) and the coordinates (read once): no dense
// addend block is built or read.  I is int32_t while C * W * 32 < 2^31,
// int64_t beyond.
// ---------------------------------------------------------------------------
constexpr int kScatterThreads = 256;

template <typename I>
__global__ void __launch_bounds__(kScatterThreads)
gf2_scatter_xor_kernel(uint32_t* rows, const I* __restrict__ flat,
                       long long n, I bits_per_row, long long ld) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const I f = flat[i];
    const I row = f / bits_per_row;
    const I pos = f - row * bits_per_row;
    atomicXor(rows + (size_t)row * (size_t)ld + (size_t)(pos >> 5),
              1u << (unsigned)(pos & 31));
  }
}

// ---------------------------------------------------------------------------
// gf2_parallel_xor: out = a ^ b elementwise over n words, grid-stride, with
// 16-byte vector accesses when all three pointers are 16-byte aligned.  The
// output is a separate buffer (the wrapper allocates it), not written in
// place.  The reference-shaped dense form: the packed reduction's path runs
// gf2_scatter_xor instead.
// ---------------------------------------------------------------------------
constexpr int kXorThreads = 256;

__global__ void __launch_bounds__(kXorThreads)
gf2_parallel_xor_kernel(const uint32_t* __restrict__ a,
                        const uint32_t* __restrict__ b,
                        uint32_t* __restrict__ out, size_t n, int vec) {
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  const size_t start = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  size_t tail = 0;
  if (vec) {
    const size_t n4 = n / 4;
    const uint4* a4 = reinterpret_cast<const uint4*>(a);
    const uint4* b4 = reinterpret_cast<const uint4*>(b);
    uint4* o4 = reinterpret_cast<uint4*>(out);
    for (size_t i = start; i < n4; i += stride) {
      const uint4 p = a4[i];
      const uint4 q = b4[i];
      o4[i] = make_uint4(p.x ^ q.x, p.y ^ q.y, p.z ^ q.z, p.w ^ q.w);
    }
    tail = n4 * 4;
  }
  for (size_t i = tail + start; i < n; i += stride) out[i] = a[i] ^ b[i];
}

// ---------------------------------------------------------------------------
// gf2_serial_reduce: the in-order serial phase of each (C, W) block of the
// batch.  For each row in order, while its low equals the low of an earlier
// row, the (one) earlier row with that low is XORed in.
//
// Routes, chosen by the wrapper (repro_torch/kernels/gf2.py serial_plan)
// from (C, W) and passed in as (k, S, threads):
//  * on chip, k >= 1: a cluster of k thread blocks a block of the batch.
//    Block rank r holds words [r*S, r*S + S) of every row in its shared
//    memory, loaded once (cp.async) and written back once.  k = 1 holds the
//    whole block (128 x 256 words is 128 KB) and a table low -> row;
//    k > 1 is a thread-block cluster whose ranks exchange through
//    distributed shared memory (128 x 2176 words, 1.1 MB, is five ranks of
//    436 words a row).
//  * global, k = 0: one thread block a block of the batch, the rows in the
//    output buffer, for blocks beyond sixteen ranks' shared memory.
//
// 1. Initial lows in one pass: a warp four rows at a time, their loads in
//    flight together; a rank's first bit covers its slice, and a cluster
//    takes the minimum of the k slice lows through distributed shared
//    memory.
// 2. The walk.  Its walkers hold the same lows and make the same choices,
//    so a decision needs no barrier.  Rows go 32 at a time, a lane a row: a
//    lane's row collides if a final row below the group has its low (final
//    lows are pairwise distinct, so there is at most one) or an earlier lane
//    has it (__match_any_sync once a group, then one ballot each time a
//    lane's low changes).  The rows before the first collision are final
//    at once; only a collision starts a reduction.  With k = 1 the final
//    row of a low is one load from the table, which the walk fills as rows
//    become final; otherwise a scan of the final lows.
// 3. A reduction is one pass from word low >> 5 (neither row has a bit
//    below it): each walker thread XORs the words it owns (w = t mod the
//    walkers' threads, so no other thread touches them and the rows need no
//    barrier) and keeps its first non-zero word; the warp takes the
//    minimum.  With the whole block in one thread block's shared memory
//    one warp walks, so that minimum is the new low: no barrier at all.  In
//    a cluster, and on the global route, every warp walks: lane r stores the
//    warp's minimum into rank r's scratch, one (cluster) barrier, and every
//    warp reads the minima.  The scratch is double-buffered: a reduction's
//    minima are read before any warp passes the next barrier, after which
//    the buffer is written again.
// Every rank writes its slice back; rank 0 writes the lows and the count.
// ---------------------------------------------------------------------------
constexpr int kSerialMaxThreads = 512;
constexpr size_t kSerialMaxSmem = 232448;  // a thread block's 227 KB

constexpr uint16_t kNoRow = 0xffff;        // the table's empty entry

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Bytes of shared memory ahead of the table and the block slice: the
// walk's lows (C padded to 32), the ranks' slice lows (clusters only) and
// the two buffers of warp minima (k * warps each), rounded up to 16 bytes.
// With k = 1 the table of W * 32 uint16 row indices follows, rounded up to
// 16 bytes.  kernels/gf2.py's _serial_header_bytes and _serial_table_bytes
// mirror them.
__host__ __device__ __forceinline__ size_t serial_header_bytes(int C, int k,
                                                               int warps) {
  const size_t cp = (size_t)((C + 31) & ~31);
  const size_t ints = cp * (k > 1 ? 2 : 1) + 2 * (size_t)k * warps;
  return (ints * sizeof(int) + 15) & ~(size_t)15;
}

__host__ __device__ __forceinline__ size_t serial_table_bytes(int W) {
  return ((size_t)W * 32 * sizeof(uint16_t) + 15) & ~(size_t)15;
}

// First set bits of the R rows c[0 .. R) of row0 (n words each, row stride
// ld) as bit indices of the whole row (word 0 is word s0), or kNoLow;
// uniform across the warp.  Each lane loads 8 words of every row a pass of
// 256 before testing any: with vec (rows 16-byte aligned, n a multiple of
// 4) words 4 lane .. 4 lane + 3 and 128 + 4 lane .. 128 + 4 lane + 3 as two
// 16-byte loads (a quarter-warp reads 128 contiguous bytes: no bank
// conflict), else words lane, lane + 32, ...  The passes stop once every
// row has a bit.
template <int R>
__device__ __forceinline__ void warp_first_bits(const uint32_t* row0,
                                                size_t ld, const int (&c)[R],
                                                int n, int s0, bool vec,
                                                int (&low)[R]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < R; ++r) low[r] = kNoLow;
  for (int base = 0; base < n; base += 256) {
    uint32_t v[R][8];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const uint32_t* row = row0 + (size_t)c[r] * ld;
      if (vec) {
        const int w = base + lane * 4;
        const uint4 z = make_uint4(0u, 0u, 0u, 0u);
        const uint4 a = w < n ? *reinterpret_cast<const uint4*>(row + w) : z;
        const uint4 b =
            w + 128 < n ? *reinterpret_cast<const uint4*>(row + w + 128) : z;
        v[r][0] = a.x; v[r][1] = a.y; v[r][2] = a.z; v[r][3] = a.w;
        v[r][4] = b.x; v[r][5] = b.y; v[r][6] = b.z; v[r][7] = b.w;
      } else {
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int w = base + u * 32 + lane;
          v[r][u] = w < n ? row[w] : 0u;
        }
      }
    }
    bool all = true;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      int best = kNoLow;
#pragma unroll
      for (int u = 7; u >= 0; --u)
        if (v[r][u] != 0u)
          best = (s0 + base +
                  (vec ? (u >> 2) * 128 + lane * 4 + (u & 3) : u * 32 + lane)) *
                     32 +
                 (__ffs((int)v[r][u]) - 1);
      best = __reduce_min_sync(kFull, best);
      if (low[r] == kNoLow) low[r] = best;
      all = all && low[r] != kNoLow;
    }
    if (all) return;
  }
}

// r[w] ^= o[w] over the words w < n that thread `me` owns (w = me mod
// stride, stride a power of two) from word `from` on, U pairs of loads in
// flight before any store; returns the thread's first set bit after the
// XOR as a bit index of the whole row, or kNoLow.
template <int U>
__device__ __forceinline__ int xor_first_bit(uint32_t* r, const uint32_t* o,
                                             int from, int n, int s0, int me,
                                             int stride) {
  int w = from > 0 ? from + ((me - from) & (stride - 1)) : me;
  int best = kNoLow;
  for (; w < n; w += U * stride) {
    uint32_t a[U], b[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int x = w + u * stride;
      a[u] = x < n ? r[x] : 0u;
      b[u] = x < n ? o[x] : 0u;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int x = w + u * stride;
      const uint32_t v = a[u] ^ b[u];
      if (x < n) r[x] = v;
      if (v != 0u && best == kNoLow)
        best = (s0 + x) * 32 + (__ffs((int)v) - 1);
    }
  }
  return best;
}

// Chunk by chunk between a slice in device memory and shared memory: chunk
// j of row c (`per` words: 4 where the rows are 16-byte aligned, else 1) of
// the C rows of n words sits at c * W + j * per there and c * S + j * per
// here; `fn(here, there)` moves one.  A thread's next chunk advances
// without a division.
template <typename F>
__device__ __forceinline__ void for_slice_chunks(int C, int n, int W, int S,
                                                 int per, F fn) {
  const int q = n / per;              // chunks a row
  if (q == 0) return;
  const int T = blockDim.x;
  const int dc = T / q, dj = T % q;
  int c = threadIdx.x / q, j = threadIdx.x % q;
  for (; c < C; c += dc, j += dj) {
    if (j >= q) {
      j -= q;
      ++c;
      if (c >= C) break;
    }
    fn((size_t)c * S + (size_t)j * per, (size_t)c * W + (size_t)j * per);
  }
}

template <bool CLUSTER>
__device__ __forceinline__ void serial_barrier() {
  if (CLUSTER)
    cg::this_cluster().sync();     // arrive.release, wait.acquire
  else
    __syncthreads();
}

template <bool CLUSTER, bool ONCHIP>
__global__ void __launch_bounds__(kSerialMaxThreads)
gf2_serial_reduce_kernel(const uint32_t* __restrict__ in,
                         uint32_t* __restrict__ out,
                         int32_t* __restrict__ lows_out,
                         int32_t* __restrict__ reds, int C, int W, int k,
                         int S, int vec) {
  // One warp walks a block held by one thread block; every warp otherwise.
  constexpr bool kSolo = ONCHIP && !CLUSTER;
  extern __shared__ __align__(16) unsigned char serial_smem[];
  const int T = blockDim.x, nw = T >> 5;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rank = CLUSTER ? (int)cg::this_cluster().block_rank() : 0;
  const size_t g = blockIdx.x / (unsigned)k;
  const int Cp = (C + 31) & ~31;
  int* lows = reinterpret_cast<int*>(serial_smem);      // the walk's lows
  int* part = lows + Cp;                                // this rank's (CLUSTER)
  int* mins = CLUSTER ? part + Cp : part;               // 2 x k x nw
  // kSolo: table[low] = the final row with that low, or kNoRow.
  const size_t head = serial_header_bytes(C, k, nw);
  uint16_t* table = reinterpret_cast<uint16_t*>(serial_smem + head);
  uint32_t* blk = reinterpret_cast<uint32_t*>(
      serial_smem + head + (kSolo ? serial_table_bytes(W) : 0));
  const size_t words = (size_t)C * W;
  const uint32_t* src = in + g * words;
  uint32_t* dst = out + g * words;
  const int s0 = ONCHIP ? rank * S : 0;       // the first word held here
  const int n = ONCHIP ? max(0, min(S, W - s0)) : W;   // words a row here
  const int ld = ONCHIP ? S : W;
  uint32_t* rows = ONCHIP ? blk : dst;

  // The rows (this rank's slice of them) into place.
  if (ONCHIP) {
    if (vec)
      for_slice_chunks(C, n, W, S, 4, [&](size_t s, size_t d) {
        cp_async16(blk + s, src + d + s0);
      });
    else
      for_slice_chunks(C, n, W, S, 1, [&](size_t s, size_t d) {
        cp_async4(blk + s, src + d + s0);
      });
    if (kSolo)
      for (int i = tid; i < W * 32; i += T) table[i] = kNoRow;
    cp_async_wait_all();
  } else {
    for (int c = 0; c < C; ++c)
      for (int w = tid; w < W; w += T)
        dst[(size_t)c * W + w] = src[(size_t)c * W + w];
  }
  __syncthreads();

  // 1. Every row's initial low, a warp four rows at a time.
  int* mine = CLUSTER ? part : lows;
  for (int c0 = warp; c0 < C; c0 += 4 * nw) {
    int c[4], l[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) c[r] = min(c0 + r * nw, C - 1);
    warp_first_bits<4>(rows, ld, c, n, s0, vec, l);
#pragma unroll
    for (int r = 0; r < 4; ++r)
      if (lane == 0 && c0 + r * nw < C) mine[c[r]] = l[r];
  }
  if (CLUSTER) {
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    for (int c = tid; c < C; c += T) {
      int l = kNoLow;
      for (int r = 0; r < k; ++r) l = min(l, cluster.map_shared_rank(part, r)[c]);
      lows[c] = l;
    }
  }
  __syncthreads();

  // 2. The walk.  Lane i of a group holds row base + i: its low L, and H,
  // the final row below the group whose low is L (-1 if none).
  int n_red = 0;
  if (!kSolo || warp == 0) {
    const int me = kSolo ? lane : tid, stride = kSolo ? 32 : T;
    const unsigned below = (1u << lane) - 1u;
    int par = 0;
    for (int base = 0; base < C; base += 32) {
      int L = base + lane < C ? lows[base + lane] : kNoLow;
      int H = -1;
      if (L != kNoLow) {
        if (kSolo) {
          const int t = table[L];
          H = t == kNoRow ? -1 : t;
        } else {
#pragma unroll 4
          for (int j = 0; j < base; j += 4) {
            const int4 v = *reinterpret_cast<const int4*>(lows + j);
            if (v.x == L) H = j;
            if (v.y == L) H = j + 1;
            if (v.z == L) H = j + 2;
            if (v.w == L) H = j + 3;
          }
        }
      }
      // same: the lanes whose low equals this lane's, kept up to date
      // below as lanes' lows change (one ballot, not a match, a change)
      unsigned same = __match_any_sync(kFull, L);
      int pos = 0;                      // lanes below pos are final
      for (;;) {
        const bool hit = lane >= pos && L != kNoLow &&
                         (H >= 0 || (same & below) != 0u);
        const unsigned hits = __ballot_sync(kFull, hit);
        if (hits == 0u) break;
        const int f = __ffs((int)hits) - 1;  // lanes pos .. f-1 are final
        const int R = base + f;
        int low = __shfl_sync(kFull, L, f);
        int j = __shfl_sync(
            kFull, H >= 0 ? H : base + __ffs((int)(same & below)) - 1, f);
        if (kSolo) {
          if (lane >= pos && lane < f && L != kNoLow) table[L] = base + lane;
          __syncwarp();
        }
        do {
          // 3. row R ^= row j from the low's word; R's next first bit.
          int best = xor_first_bit<8>(rows + (size_t)R * ld,
                                      rows + (size_t)j * ld, (low >> 5) - s0,
                                      n, s0, me, stride);
          best = __reduce_min_sync(kFull, best);
          if (kSolo) {
            low = best;
          } else {
            int* slot = mins + par * k * nw + rank * nw + warp;
            if (CLUSTER) {
              if (lane < k)
                *cg::this_cluster().map_shared_rank(slot, lane) = best;
            } else if (lane == 0) {
              *slot = best;
            }
            serial_barrier<CLUSTER>();
            int m = kNoLow;
            for (int x = lane; x < k * nw; x += 32)
              m = min(m, mins[par * k * nw + x]);
            low = __reduce_min_sync(kFull, m);
            par ^= 1;
          }
          ++n_red;
          // The next row to XOR in: the final row below R with the new low.
          j = -1;
          if (low != kNoLow) {
            if (kSolo) {
              const int t = table[low];
              j = t == kNoRow ? -1 : t;
            } else {
#pragma unroll 4
              for (int t = lane; t < base; t += 32)
                if (lows[t] == low) j = t;
              if (lane < f && L == low) j = base + lane;
              const unsigned got = __ballot_sync(kFull, j >= 0);
              j = got ? __shfl_sync(kFull, j, __ffs((int)got) - 1) : -1;
            }
          }
        } while (j >= 0);
        __syncwarp();                   // every lane has read the table
        if (lane == f) {
          L = low;
          H = -1;
          if (kSolo && low != kNoLow) table[low] = R;
        }
        if (kSolo) __syncwarp();
        const unsigned eq = __ballot_sync(kFull, L == low);
        same = L == low ? eq : same & ~(1u << f);
        pos = f + 1;
      }
      if (base + lane < C) {
        lows[base + lane] = L;          // every walker: equal values
        if (kSolo && lane >= pos && L != kNoLow) table[L] = base + lane;
      }
      __syncwarp();
    }
  }
  __syncthreads();

  // The rows (this rank's slice) back, once; the lows and the count.
  if (ONCHIP) {
    if (vec)
      for_slice_chunks(C, n, W, S, 4, [&](size_t s, size_t d) {
        *reinterpret_cast<uint4*>(dst + d + s0) =
            *reinterpret_cast<const uint4*>(blk + s);
      });
    else
      for_slice_chunks(C, n, W, S, 1, [&](size_t s, size_t d) {
        dst[d + s0] = blk[s];
      });
  }
  if (rank == 0) {
    for (int c = tid; c < C; c += T) lows_out[g * C + c] = lows[c];
    if (tid == 0) reds[g] = n_red;
  }
  // No rank may leave while another can still reach its shared memory.
  if (CLUSTER) cg::this_cluster().sync();
}

}  // namespace

template <int T, int K>
static void launch_find_low(const void* cols, void* lows, int C, int W,
                            long long ld, bool vec, cudaStream_t stream) {
  if (vec)
    gf2_find_low_kernel<T, K, true><<<C, T, 0, stream>>>(
        (const uint32_t*)cols, (int32_t*)lows, W, ld);
  else
    gf2_find_low_kernel<T, K, false><<<C, T, 0, stream>>>(
        (const uint32_t*)cols, (int32_t*)lows, W, ld);
}

// cols (C, W) with row stride ld words -> lows (C,).  Two block sizes, the
// two that the kernels phase of chip_smoke.py times: 32 threads for rows up
// to 128 words, 256 threads beyond with K = ceil(W / 1,024) loads a thread,
// at most 3 (one pass up to 3,072 words; wider rows loop).  Returns the
// cudaError_t of the launch.
extern "C" int gf2_find_low(const void* cols, void* lows, int C, int W,
                            long long ld, void* stream) {
  if (C <= 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  const bool vec = (((uintptr_t)cols) & 15u) == 0 && ld % 4 == 0;
  if (W <= 128)
    launch_find_low<32, 1>(cols, lows, C, W, ld, vec, s);
  else if (W <= 1024)
    launch_find_low<256, 1>(cols, lows, C, W, ld, vec, s);
  else if (W <= 2048)
    launch_find_low<256, 2>(cols, lows, C, W, ld, vec, s);
  else
    launch_find_low<256, 3>(cols, lows, C, W, ld, vec, s);
  return (int)cudaGetLastError();
}

// rows (C, W) with row stride ld words ^= the n flat bit indices (int64 when
// idx64, else int32) in place.  Returns the cudaError_t of the launch.
extern "C" int gf2_scatter_xor(void* rows, const void* flat, long long n,
                               int idx64, long long bits_per_row,
                               long long ld, void* stream) {
  if (n <= 0) return 0;
  long long grid = (n + kScatterThreads - 1) / kScatterThreads;
  if (grid > 132LL * 16) grid = 132LL * 16;
  const cudaStream_t s = (cudaStream_t)stream;
  if (idx64)
    gf2_scatter_xor_kernel<long long><<<(int)grid, kScatterThreads, 0, s>>>(
        (uint32_t*)rows, (const long long*)flat, n, bits_per_row, ld);
  else
    gf2_scatter_xor_kernel<int><<<(int)grid, kScatterThreads, 0, s>>>(
        (uint32_t*)rows, (const int*)flat, n, (int)bits_per_row, ld);
  return (int)cudaGetLastError();
}

// out = a ^ b over n words.  Returns the cudaError_t of the launch.
extern "C" int gf2_parallel_xor(const void* a, const void* b, void* out,
                                long long n, void* stream) {
  if (n <= 0) return 0;
  const int vec = ((((uintptr_t)a) | ((uintptr_t)b) | ((uintptr_t)out)) & 15u)
                  == 0;
  const long long items = vec ? (n + 3) / 4 : n;
  long long grid = (items + kXorThreads - 1) / kXorThreads;
  if (grid > 132LL * 16) grid = 132LL * 16;
  gf2_parallel_xor_kernel<<<(int)grid, kXorThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)out, (size_t)n, vec);
  return (int)cudaGetLastError();
}

// Dynamic shared memory above 48 KB, and clusters above the portable 8,
// must be allowed per kernel and device before a launch.  Each
// instantiation allows the most any plan takes (227 KB, 16 ranks) once a
// device, so a launch pays no attribute call.
template <bool CLUSTER, bool ONCHIP>
static cudaError_t serial_attributes() {
  static std::atomic<unsigned long long> done{0};  // a bit a device
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = device < 64 ? 1ull << device : 0ull;
  if (done.load(std::memory_order_relaxed) & bit) return cudaSuccess;
  auto* kernel = gf2_serial_reduce_kernel<CLUSTER, ONCHIP>;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kSerialMaxSmem);
  if (err == cudaSuccess && CLUSTER)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_relaxed);
  return err;
}

template <bool CLUSTER, bool ONCHIP>
static cudaError_t launch_serial(const void* in, void* out, void* lows,
                                 void* reds, int G, int C, int W, int k,
                                 int S, int threads, size_t smem, int vec,
                                 cudaStream_t stream) {
  auto* kernel = gf2_serial_reduce_kernel<CLUSTER, ONCHIP>;
  cudaError_t err = serial_attributes<CLUSTER, ONCHIP>();
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cfg.gridDim = dim3((unsigned)G * (unsigned)k);
  cfg.blockDim = dim3((unsigned)threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  if (CLUSTER) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = (unsigned)k;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
  err = cudaLaunchKernelEx(&cfg, kernel, (const uint32_t*)in, (uint32_t*)out,
                           (int32_t*)lows, (int32_t*)reds, C, W, k, S, vec);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// blocks (G, C, W) -> reduced (G, C, W), lows (G, C), n_reductions (G,).
// The route comes from kernels/gf2.py's serial_plan: k ranks of S words a
// row on chip (k = 1 a block's shared memory, 2 .. 16 a cluster), or k = 0
// the rows in global memory; `threads` a block.  A plan whose shared memory
// exceeds 227 KB, or whose ranks do not cover the row, is refused
// (cudaErrorInvalidValue).  Returns the cudaError_t of the launch.
extern "C" int gf2_serial_reduce(const void* in, void* out, void* lows,
                                 void* reds, int G, int C, int W, int k,
                                 int S, int threads, void* stream) {
  if (G <= 0 || C <= 0) return 0;
  const int ranks = k > 0 ? k : 1;
  if (k < 0 || k > 16 || threads < 32 || threads > kSerialMaxThreads ||
      (threads & (threads - 1)) != 0 ||
      (k > 0 && (S < 0 || (long long)k * S < W)))
    return (int)cudaErrorInvalidValue;
  const size_t smem = serial_header_bytes(C, ranks, threads / 32) +
                      (k == 1 ? serial_table_bytes(W) : 0) +
                      (k > 0 ? (size_t)C * S * sizeof(uint32_t) : 0);
  if (smem > kSerialMaxSmem) return (int)cudaErrorInvalidValue;
  const int vec = W % 4 == 0 && S % 4 == 0 &&
                  ((((uintptr_t)in) | ((uintptr_t)out)) & 15u) == 0;
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (k == 0)
    err = launch_serial<false, false>(in, out, lows, reds, G, C, W, 1, 0,
                                      threads, smem, 0, s);
  else if (k == 1)
    err = launch_serial<false, true>(in, out, lows, reds, G, C, W, 1, S,
                                     threads, smem, vec, s);
  else
    err = launch_serial<true, true>(in, out, lows, reds, G, C, W, k, S,
                                    threads, smem, vec, s);
  return (int)err;
}
