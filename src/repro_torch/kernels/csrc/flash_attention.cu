// Forward flash attention (online softmax) in float32 arithmetic, for Hopper
// (sm_90a): the float32 route of the port's flash_attention.
//
// Replaces: src/repro/kernels/flash_attention.py::_flash_kernel, the Pallas
// TPU kernel behind flash_attention, for float32 inputs (bfloat16 inputs go
// to the tensor-core kernel in flash_attention_sm90.cu).  Same function,
// for q, k, v (BH, S, d) float32, contiguous, GQA already expanded:
//   o[b, i] = sum_j softmax_j(q_i . k_j / sqrt(d)) v_j
// where key j is masked for query i (score -1e30) when causal and j > i, or
// when window > 0 and i - j >= window, or when j >= S.  Sums and the
// running max / sum / accumulator are float32.  expf, not __expf.
//
// What bounds it on an H100: operations.  At BH = 128, S = 2048, d = 128
// causal it does about 137 GFLOP against 268 MB moved.  The float32
// contract forbids TF32, and on Hopper wgmma on float32 is TF32, so the
// products stay float32 FMAs on the CUDA cores (67 TFLOP/s at best, a
// bound of 2.05 ms there).  A register-blocked SIMT design is the next step
// for this route.
//
// Design: one thread block per (bh, 64-query tile), 256 threads as 16 x 16.
// The query tile (scaled by sm_scale) and each 64-row K and V tile are
// staged in shared memory as float32 (zeros past S and past d).  Thread
// (ty, tx) owns query rows 4ty..4ty+3: it computes their scores against keys
// tx + 16jj (jj < 4) in registers, keeps their running max and sum in
// registers (replicated over the 16 threads of a row group, reduced with
// shuffles inside the half-warp), writes its probabilities to a shared P
// tile, and accumulates output columns tx + 16m.  With causal masking the
// KV tiles wholly above the diagonal are skipped, with a window those
// wholly before it; a ragged last tile is masked in the kernel, so no
// padding copy is made.  d is rounded up to the template width D in
// {32, 64, 128, 256}; at D = 256 the tiles take 214 KB of shared memory,
// above the 48 KB default, so the launcher raises the attribute first.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;             // queries per block
constexpr int kBK = 64;             // keys per KV tile
constexpr int kSide = 16;           // threads per block side
constexpr int kRows = kBQ / kSide;  // query rows per thread (4)
constexpr int kKeys = kBK / kSide;  // keys per thread per tile (4)
constexpr int kPStride = kBK + 4;   // P rows: the two row groups of a warp
                                    // land 16 banks apart
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (size_t)(kBQ * (D + 1) + kBK * (D + 1) + kBK * D + kBQ * kPStride);
}

// Rows [row0, row0 + 64) of a (S, d) slice into a (64, ld) float tile, zero
// past S and past d.  Consecutive threads take consecutive columns.
template <int D, typename T>
__device__ __forceinline__ void load_tile(float* dst, int ld,
                                          const T* __restrict__ src, int row0,
                                          int S, int d, float scale) {
  for (int i = threadIdx.y * kSide + threadIdx.x; i < kBK * D;
       i += kSide * kSide) {
    const int r = i / D;
    const int c = i - r * D;
    const int g = row0 + r;
    dst[r * ld + c] =
        (g < S && c < d) ? to_f32(src[(size_t)g * d + c]) * scale : 0.0f;
  }
}

template <int D, typename T>
__global__ void __launch_bounds__(kSide * kSide)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int S,
                       int d, int causal, int window, float sm_scale) {
  constexpr int kCols = D / kSide;  // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;                      // (64, D + 1), scaled
  float* ks = qs + kBQ * (D + 1);        // (64, D + 1)
  float* vs = ks + kBK * (D + 1);        // (64, D)
  float* ps = vs + kBK * D;              // (64, kPStride)

  // Heavier (later) causal query tiles are scheduled first.
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int q0 = qt * kBQ;
  const size_t base = (size_t)blockIdx.y * S * d;
  const int ty = threadIdx.y;
  const int tx = threadIdx.x;

  load_tile<D>(qs, D + 1, q + base, q0, S, d, sm_scale);

  float m[kRows], l[kRows], acc[kRows][kCols];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.0f;
  }

  // KV tiles that hold any key a query of this tile may see.
  int kv_end = S;
  if (causal) kv_end = min(S, q0 + kBQ);
  int kv_begin = 0;
  if (window > 0) kv_begin = max(0, q0 - window + 1);
  kv_begin = (kv_begin / kBK) * kBK;

  for (int k0 = kv_begin; k0 < kv_end; k0 += kBK) {
    __syncthreads();  // the previous tile's P.V is done with ks, vs, ps
    load_tile<D>(ks, D + 1, k + base, k0, S, d, 1.0f);
    load_tile<D>(vs, D, v + base, k0, S, d, 1.0f);
    __syncthreads();

    float s[kRows][kKeys];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kKeys; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int c = 0; c < D; ++c) {
      float a[kRows], b[kKeys];
#pragma unroll
      for (int i = 0; i < kRows; ++i) a[i] = qs[(ty * kRows + i) * (D + 1) + c];
#pragma unroll
      for (int j = 0; j < kKeys; ++j) b[j] = ks[(tx + kSide * j) * (D + 1) + c];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kKeys; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qi = q0 + ty * kRows + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        const int kj = k0 + tx + kSide * j;
        const bool masked = (causal && kj > qi) ||
                            (window > 0 && qi - kj >= window) || kj >= S;
        if (masked) s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      // max over the 16 threads (one half-warp) that share these rows
#pragma unroll
      for (int off = kSide / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        ps[(ty * kRows + i) * kPStride + tx + kSide * j] = p;
      }
#pragma unroll
      for (int off = kSide / 2; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();  // P complete

#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float p[kRows], w[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) p[i] = ps[(ty * kRows + i) * kPStride + j];
#pragma unroll
      for (int c = 0; c < kCols; ++c) w[c] = vs[j * D + tx + kSide * c];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[i][c] = fmaf(p[i], w[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qi = q0 + ty * kRows + i;
    if (qi >= S) break;
    const float inv = 1.0f / fmaxf(l[i], 1e-30f);
    T* dst = o + base + (size_t)qi * d;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = tx + kSide * c;
      if (col < d) store(dst + col, acc[i][c] * inv);
    }
  }
}

template <int D, typename T>
int launch(const void* q, const void* k, const void* v, void* o, int BH,
           int S, int d, int causal, int window, float sm_scale,
           cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<D>();
  // Above 48 KB a launch is refused unless the kernel's limit is raised.
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<D, T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + kBQ - 1) / kBQ, BH);
  const dim3 block(kSide, kSide);
  flash_attention_kernel<D, T><<<grid, block, bytes, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, S, d, causal, window,
      sm_scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int BH,
             int S, int d, int causal, int window, float sm_scale,
             cudaStream_t stream) {
  if (d <= 32)
    return launch<32, T>(q, k, v, o, BH, S, d, causal, window, sm_scale,
                         stream);
  if (d <= 64)
    return launch<64, T>(q, k, v, o, BH, S, d, causal, window, sm_scale,
                         stream);
  if (d <= 128)
    return launch<128, T>(q, k, v, o, BH, S, d, causal, window, sm_scale,
                          stream);
  return launch<256, T>(q, k, v, o, BH, S, d, causal, window, sm_scale,
                        stream);
}

}  // namespace

// q, k, v, o: (BH, S, d) float32 device pointers, contiguous.  The wrapper
// checks shapes, dtypes and 0 < d <= 256, d % 8 == 0.  window <= 0 means no
// window.  Returns the cudaError_t of the launch.
extern "C" int flash_attention_f32(const void* q, const void* k,
                                   const void* v, void* o, int BH, int S,
                                   int d, int causal, int window,
                                   float sm_scale, void* stream) {
  if (BH <= 0 || S <= 0) return 0;
  if (d <= 0 || d > 256 || BH > 65535) return (int)cudaErrorInvalidValue;
  return dispatch<float>(q, k, v, o, BH, S, d, causal, window, sm_scale,
                         (cudaStream_t)stream);
}
