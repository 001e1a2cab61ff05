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
// of dependent row XORs whose length the data sets.
#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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
// gf2_serial_reduce: one thread block per (C, W) block of the batch.  The
// block is copied to the output and reduced there, in global memory and L2
// (128 x 2176 words is 1.1 MB, beyond the 227 KB of shared memory); the C
// lows and the reduction scratch live in shared memory.  Rows are walked in
// order; while row c's low equals the low of an earlier row, the first such
// row is XORed in (all threads across W), then the low is found again.
// The scan covers the whole width, so V-words at the tail of a row ride the
// same XORs.  After an XOR at low L, neither row has a set bit before word
// L >> 5, so both the XOR and the next low scan start there.
// ---------------------------------------------------------------------------
constexpr int kSerialThreads = 512;

__device__ int block_min(int v, int* scratch) {
  for (int off = 16; off > 0; off >>= 1)
    v = min(v, __shfl_xor_sync(kFull, v, off));
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
  __syncthreads();
  int r = scratch[0];
  for (int w = 1; w < (int)(blockDim.x >> 5); ++w) r = min(r, scratch[w]);
  __syncthreads();                    // scratch is reused by the next call
  return r;
}

// First set bit of a row at or after word `start`; kNoLow if none.  Each
// thread's first non-zero word in its stride is its own minimum.
__device__ int row_low(const uint32_t* row, int start, int W, int* scratch) {
  int best = kNoLow;
  for (int w = start + threadIdx.x; w < W; w += blockDim.x) {
    const uint32_t v = row[w];
    if (v != 0u) {
      best = w * 32 + (__ffs((int)v) - 1);
      break;
    }
  }
  return block_min(best, scratch);
}

__global__ void __launch_bounds__(kSerialThreads)
gf2_serial_reduce_kernel(const uint32_t* __restrict__ in, uint32_t* out,
                         int32_t* __restrict__ lows_out,
                         int32_t* __restrict__ reds, int C, int W) {
  extern __shared__ int smem[];
  int* lows = smem;                   // C entries
  int* scratch = smem + C;            // one slot per warp
  const size_t g = blockIdx.x;
  const size_t words = (size_t)C * W;
  const uint32_t* src = in + g * words;
  uint32_t* blk = out + g * words;
  for (size_t i = threadIdx.x; i < words; i += blockDim.x) blk[i] = src[i];
  for (int i = threadIdx.x; i < C; i += blockDim.x) lows[i] = kNoLow;
  __syncthreads();

  int n_red = 0;
  for (int c = 0; c < C; ++c) {
    uint32_t* row = blk + (size_t)c * W;
    int low = row_low(row, 0, W, scratch);
    while (low != kNoLow) {
      int j = kNoLow;                 // first earlier row with this low
      for (int t = threadIdx.x; t < c; t += blockDim.x) {
        if (lows[t] == low) {
          j = t;
          break;
        }
      }
      j = block_min(j, scratch);
      if (j == kNoLow) break;         // uniform: every thread holds the min
      const uint32_t* other = blk + (size_t)j * W;
      const int w0 = low >> 5;
      for (int w = w0 + threadIdx.x; w < W; w += blockDim.x) row[w] ^= other[w];
      __syncthreads();
      ++n_red;
      low = row_low(row, w0, W, scratch);
    }
    if (threadIdx.x == 0) lows[c] = low;
    __syncthreads();
  }
  for (int i = threadIdx.x; i < C; i += blockDim.x) lows_out[g * C + i] = lows[i];
  if (threadIdx.x == 0) reds[g] = n_red;
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

// blocks (G, C, W) -> reduced (G, C, W), lows (G, C), n_reductions (G,).
// Returns the cudaError_t of the launch.
extern "C" int gf2_serial_reduce(const void* in, void* out, void* lows,
                                 void* reds, int G, int C, int W,
                                 void* stream) {
  if (G <= 0) return 0;
  const size_t smem = ((size_t)C + kSerialThreads / 32) * sizeof(int);
  gf2_serial_reduce_kernel<<<G, kSerialThreads, smem, (cudaStream_t)stream>>>(
      (const uint32_t*)in, (uint32_t*)out, (int32_t*)lows, (int32_t*)reds, C,
      W);
  return (int)cudaGetLastError();
}
