// Bit-packed GF(2) column kernels of the packed reduction, for Hopper (sm_90a).
//
// A block is (C, W) uint32 words: row c is one column of the coboundary
// matrix, key universe[i] lives at bit i (word i >> 5, bit i & 31), so the
// first set bit of a row is its low.  The tensors cross from PyTorch as
// int32 carrying the uint32 patterns; the kernels read them as uint32_t.
// NO_LOW = 2^31 - 1 marks an all-zero row.  All three kernels are exact.
//
// gf2_find_low      replaces src/repro/kernels/gf2.py::_find_low_kernel
// gf2_parallel_xor  replaces src/repro/kernels/gf2.py::_parallel_xor_kernel
// gf2_serial_reduce replaces src/repro/kernels/gf2.py::_serial_reduce_kernel
//
// What bounds them on an H100 at the packed engine's shapes (C <= 128 rows,
// W = 128 .. 2176 words, a few hundred KB a call): launch and round-trip
// latency first, then bytes.  find_low and parallel_xor move a block once
// (read, or read two and write one), microseconds at 3.35 TB/s, below a
// launch; serial_reduce is a chain of dependent row XORs whose length the
// data sets.  The designs keep every byte moved once per pass and leave
// the fixed cost to the caller's batching (device-resident blocks are a
// later change).
#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kNoLow = 0x7fffffff;
constexpr unsigned kFull = 0xffffffffu;

// ---------------------------------------------------------------------------
// gf2_find_low: one warp per row.  The warp strides over the row 32 words at
// a time; __ballot_sync marks the non-zero words, the first of them is
// broadcast with __shfl_sync, and __ffs gives its lowest set bit.  The scan
// stops at the first non-zero chunk, so a row costs the words up to its low.
// ---------------------------------------------------------------------------
constexpr int kFindLowThreads = 256;

__global__ void __launch_bounds__(kFindLowThreads)
gf2_find_low_kernel(const uint32_t* __restrict__ cols,
                    int32_t* __restrict__ lows, int C, int W) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= C) return;               // uniform across the warp
  const uint32_t* r = cols + (size_t)row * W;
  int low = kNoLow;
  for (int base = 0; base < W; base += 32) {
    const int w = base + lane;
    const uint32_t v = w < W ? r[w] : 0u;
    const unsigned nz = __ballot_sync(kFull, v != 0u);
    if (nz != 0u) {
      const int src = __ffs((int)nz) - 1;
      const uint32_t first = __shfl_sync(kFull, v, src);
      low = (base + src) * 32 + (__ffs((int)first) - 1);
      break;
    }
  }
  if (lane == 0) lows[row] = low;
}

// ---------------------------------------------------------------------------
// gf2_parallel_xor: out = a ^ b elementwise over n words, grid-stride, with
// 16-byte vector accesses when all three pointers are 16-byte aligned.  The
// output is a separate buffer (the wrapper allocates it), not written in
// place.
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

// cols (C, W) -> lows (C,).  Returns the cudaError_t of the launch.
extern "C" int gf2_find_low(const void* cols, void* lows, int C, int W,
                            void* stream) {
  if (C <= 0) return 0;
  const int rows_per_block = kFindLowThreads / 32;
  const int grid = (C + rows_per_block - 1) / rows_per_block;
  gf2_find_low_kernel<<<grid, kFindLowThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)cols, (int32_t*)lows, C, W);
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
