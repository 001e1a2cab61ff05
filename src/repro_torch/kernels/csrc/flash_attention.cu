// Forward flash attention (online softmax) in float32 arithmetic, for Hopper
// (sm_90a): the float32 route of the port's flash_attention.
//
// Replaces: src/repro/kernels/flash_attention.py::_flash_kernel, the Pallas
// TPU kernel behind flash_attention, for float32 inputs (bfloat16 inputs go
// to the tensor-core kernel in flash_attention_sm90.cu).  Same function,
// for q, k, v (BH, S, d) float32, contiguous, GQA already expanded:
//   o[b, i] = sum_j softmax_j((q_i / sqrt(d)) . k_j) v_j
// where key j is masked for query i (score -1e30) when causal and j > i, or
// when window > 0 and i - j >= window, or when j >= S.  Q is scaled by
// 1/sqrt(d) in float32 before the product; the running max, sum and
// accumulator are float32; the output is acc / max(l, 1e-30).  expf, not
// __expf; no fast-math.
//
// What bounds it on an H100: operations.  At BH = 128, S = 2048, d = 128
// causal it does 137.5 GFLOP against 537 MB moved.  The float32 contract
// forbids TF32 (3xTF32 included), and on Hopper every tensor-core product
// of float32 is TF32, so both products are IEEE float32 FFMAs on the CUDA
// cores: 67 TFLOP/s at best, a bound of 2.05 ms there.
//
// Design: a register-blocked SIMT kernel, built like a tuned SGEMM and
// applied to both products.  One block of 256 threads per (bh, query tile)
// (one block an SM); tiles by width D (Tiles<D>): 128 queries and 64 keys
// per KV tile for D <= 128, 64 queries and 32 keys at D = 256 (shared
// memory).
//   - Threads form 16 row groups of 16, two to a warp.  Thread (rg, lane)
//     owns query rows rg + 16 i (i < BQ / 16), the BK / 16 consecutive keys
//     from lane * BK / 16 of S, and D / 16 output columns of O, in vectors
//     of up to 4 from 4 * lane, 64 apart.  At D = 128 that is an 8 x 4 block
//     of S and an 8 x 8 block of O in registers, so each 128-bit shared load
//     feeds 10.7 FFMAs in S = Q.K^T and 16 in O += P.V.
//   - A 128-bit shared load costs the distinct 16-byte words that each
//     quarter-warp asks for, 8 a cycle, so every quarter-warp spans both
//     row groups of its warp and 4 lanes: it asks for 2 rows of Q or P
//     and 4 of K or V at once.
//   - Q (scaled in place once), the K and V tiles and P live in shared
//     memory, read as float4 (float2 at D = 32 for V, at BK = 32 for P's
//     stores).  Q, K and P swap their 16-byte chunks within each row by an
//     XOR of the row (K: of its key group), so the rows that one
//     quarter-warp reads at once fall in distinct banks without padding; V
//     needs none.
//   - K and V tiles arrive through cp.async (16 bytes, .cg, zero-filled past
//     S and past d by the source size) into a ring of two stages: tile t + 1
//     is in flight while tile t's products run.  No per-element divide and
//     no register staging.
//   - Row max and sum are reduced with shuffles over the 16 lanes that share
//     a row.  Two barriers a tile: one before the tile's scores (its copies
//     landed, the previous tile's P.V is done with the stage and P), one
//     before P.V (P complete).
//   - KV tiles wholly above the diagonal or wholly before the window are
//     never loaded; later causal query tiles are scheduled first.  The
//     masks run only on tiles that straddle a mask edge or the ragged end
//     of S, and no padding copy is made.
// d is rounded up to the template width D in {32, 64, 128, 256} with zero
// columns.  Shared memory: 224 KB at D = 128, 200 KB at D = 256, so the
// launcher raises the dynamic-shared-memory attribute.  PERF.md holds the
// kernel's times on the card beside this bound.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLanes = 16;          // threads of a row group
constexpr int kGroups = kThreads / kLanes;  // row groups
constexpr float kNegInf = -1e30f;

// Queries per block (BQ) and keys per KV tile (BK) by template width.
template <int D> struct Tiles;
template <> struct Tiles<32> { static constexpr int BQ = 128, BK = 64; };
template <> struct Tiles<64> { static constexpr int BQ = 128, BK = 64; };
template <> struct Tiles<128> { static constexpr int BQ = 128, BK = 64; };
template <> struct Tiles<256> { static constexpr int BQ = 64, BK = 32; };

template <int D>
constexpr size_t smem_bytes() {
  constexpr int BQ = Tiles<D>::BQ, BK = Tiles<D>::BK;
  // Q, two stages of K and of V, P
  return sizeof(float) * (size_t)(BQ * D + 4 * BK * D + BQ * BK);
}

template <int N> struct Vec;
template <> struct Vec<2> { using type = float2; };
template <> struct Vec<4> { using type = float4; };

__device__ __forceinline__ float get(const float2& v, int e) {
  return e == 0 ? v.x : v.y;
}
__device__ __forceinline__ float get(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  // src-size 0 writes 16 zero bytes and reads nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Offset (floats) of 16-byte chunk cc of row r in a swizzled (rows, width)
// tile: the chunk index is XORed with (r / group) & 7.
template <int W, int GROUP>
__device__ __forceinline__ int swz(int r, int cc) {
  return r * W + 4 * (cc ^ ((r / GROUP) & 7));
}

// Rows [row0, row0 + ROWS) of a (S, d) slice into a (ROWS, D) shared tile,
// chunk-swizzled by row group GROUP (0: not swizzled), zeros past S and d.
// Consecutive threads take consecutive 16-byte chunks of a row.
template <int D, int ROWS, int GROUP>
__device__ __forceinline__ void load_tile(float* dst,
                                          const float* __restrict__ src,
                                          int row0, int S, int d) {
  constexpr int kChunks = D / 4;
  static_assert(ROWS * kChunks % kThreads == 0, "tile / threads");
#pragma unroll
  for (int n = 0; n < ROWS * kChunks / kThreads; ++n) {
    const int idx = threadIdx.x + n * kThreads;
    const int r = idx / kChunks;
    const int cc = idx % kChunks;
    const int g = row0 + r;
    const bool valid = g < S && 4 * cc < d;
    int off = r * D + 4 * cc;
    if constexpr (GROUP > 0) off = swz<D, GROUP>(r, cc);
    cp_async16(dst + off, valid ? src + (size_t)g * d + 4 * cc : src, valid);
  }
}

// Scales the chunks of the (ROWS, D) tile that this thread copied with
// load_tile<D, ROWS, 1> (its own cp.async writes, complete after the wait).
template <int D, int ROWS>
__device__ __forceinline__ void scale_own_chunks(float* tile, float scale) {
  constexpr int kChunks = D / 4;
#pragma unroll
  for (int n = 0; n < ROWS * kChunks / kThreads; ++n) {
    const int idx = threadIdx.x + n * kThreads;
    float4* p = reinterpret_cast<float4*>(
        tile + swz<D, 1>(idx / kChunks, idx % kChunks));
    float4 x = *p;
    x.x *= scale;
    x.y *= scale;
    x.z *= scale;
    x.w *= scale;
    *p = x;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_f32_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v, float* __restrict__ o,
                           int S, int d, int causal, int window,
                           float sm_scale) {
  constexpr int BQ = Tiles<D>::BQ, BK = Tiles<D>::BK;
  constexpr int R = BQ / kGroups;              // query rows per thread
  constexpr int KPT = BK / kLanes;             // keys per thread in S
  constexpr int C = D / kLanes;                // output columns per thread
  constexpr int VW = C < 4 ? C : 4;            // V / O vector width
  constexpr int NCH = C / VW;                  // V / O vectors per thread
  using VecV = typename Vec<VW>::type;
  using VecP = typename Vec<KPT>::type;
  static_assert(D / 4 >= 8 && BK / 4 >= 8, "swizzle needs 8 chunks a row");
  static_assert(KPT == 2 || KPT == 4, "P stores are float2 or float4");

  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                            // (BQ, D), swizzled by row
  float* ks = qs + BQ * D;                     // 2 x (BK, D), by row / KPT
  float* vs = ks + 2 * BK * D;                 // 2 x (BK, D)
  float* ps = vs + 2 * BK * D;                 // (BQ, BK), swizzled by row

  // Heavier (later) causal query tiles are scheduled first.
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const size_t base = (size_t)blockIdx.y * S * d;
  const float* qb = q + base;
  const float* kb = k + base;
  const float* vb = v + base;
  // Two row groups a warp; each quarter-warp spans both and 4 lanes.
  const int wl = threadIdx.x % 32;
  const int rg = 2 * (threadIdx.x / 32) + (wl & 1);  // row group
  const int lane = 4 * (wl / 8) + (wl / 2) % 4;      // key group in S,
                                                     // columns in O
  const int fq = rg & 7;                       // swizzle of rows rg + 16 i
  const int fk = lane & 7;                     // of keys KPT * lane + jj

  // KV tiles that hold any key a query of this tile may see.
  const int kv_end = causal ? min(S, q0 + BQ) : S;
  int kv_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  kv_begin = (kv_begin / BK) * BK;
  const int n_tiles = (kv_end - kv_begin + BK - 1) / BK;

  load_tile<D, BQ, 1>(qs, qb, q0, S, d);
  load_tile<D, BK, KPT>(ks, kb, kv_begin, S, d);
  load_tile<D, BK, 0>(vs, vb, kv_begin, S, d);
  cp_async_commit();

  float m[R], l[R], acc[R][C];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < C; ++c) acc[i][c] = 0.0f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = kv_begin + t * BK;
    cp_async_wait_all();
    if (t == 0) scale_own_chunks<D, BQ>(qs, sm_scale);
    // Tile t landed for every thread, and P.V of tile t - 1 is done with
    // the other stage and with P.
    __syncthreads();
    if (t + 1 < n_tiles) {
      const int nxt = (t + 1) & 1;
      load_tile<D, BK, KPT>(ks + nxt * BK * D, kb, k0 + BK, S, d);
      load_tile<D, BK, 0>(vs + nxt * BK * D, vb, k0 + BK, S, d);
      cp_async_commit();
    }
    const float* kt = ks + (t & 1) * BK * D;
    const float* vt = vs + (t & 1) * BK * D;

    // S = (Q / sqrt(d)) . K^T, an R x KPT block a thread.  The products walk
    // each chunk's four depths outermost, so consecutive FFMAs update
    // different sums (each sum still adds its depths in order).
    float s[R][KPT];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < KPT; ++j) s[i][j] = 0.0f;
#pragma unroll 2
    for (int cc = 0; cc < D / 4; ++cc) {
      const int pq = 4 * (cc ^ fq);
      const int pk = 4 * (cc ^ fk);
      float4 kv[KPT], qv[R];
#pragma unroll
      for (int j = 0; j < KPT; ++j)
        kv[j] = *reinterpret_cast<const float4*>(kt + (KPT * lane + j) * D +
                                                 pk);
#pragma unroll
      for (int i = 0; i < R; ++i)
        qv[i] =
            *reinterpret_cast<const float4*>(qs + (rg + kGroups * i) * D + pq);
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
          for (int j = 0; j < KPT; ++j)
            s[i][j] = fmaf(get(qv[i], e), get(kv[j], e), s[i][j]);
    }

    // Masks only where the tile straddles an edge: the diagonal, the
    // window's far end, or the end of S.
    const bool edge = (causal && k0 + BK - 1 > q0) ||
                      (window > 0 && q0 + BQ - 1 - k0 >= window) ||
                      k0 + BK > S;
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int qi = q0 + rg + kGroups * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        if (edge) {
          const int kj = k0 + KPT * lane + j;
          if ((causal && kj > qi) || (window > 0 && qi - kj >= window) ||
              kj >= S)
            s[i][j] = kNegInf;
        }
        mx = fmaxf(mx, s[i][j]);
      }
      // over the 16 threads that share these rows (lane bits 1 to 4)
#pragma unroll
      for (int off = 2; off < 32; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float p[KPT];
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        p[j] = expf(s[i][j] - m_new);
        sum += p[j];
      }
#pragma unroll
      for (int off = 2; off < 32; off <<= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < C; ++c) acc[i][c] *= alpha;
      const int row = rg + kGroups * i;
      const int key = KPT * lane;
      VecP pv;
      if constexpr (KPT == 4) {
        pv = make_float4(p[0], p[1], p[2], p[3]);
      } else {
        pv = make_float2(p[0], p[1]);
      }
      *reinterpret_cast<VecP*>(ps + swz<BK, 1>(row, key / 4) + key % 4) = pv;
    }
    __syncthreads();  // P complete

    // O += P . V, an R x C block a thread.
#pragma unroll 2
    for (int jc = 0; jc < BK / 4; ++jc) {
      const int pp = 4 * (jc ^ fq);
      float4 pr[R];
#pragma unroll
      for (int i = 0; i < R; ++i)
        pr[i] = *reinterpret_cast<const float4*>(ps + (rg + kGroups * i) * BK +
                                                 pp);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float* vrow = vt + (4 * jc + e) * D + VW * lane;
        float w[C];
#pragma unroll
        for (int u = 0; u < NCH; ++u) {
          const VecV x =
              *reinterpret_cast<const VecV*>(vrow + kLanes * VW * u);
#pragma unroll
          for (int c = 0; c < VW; ++c) w[u * VW + c] = get(x, c);
        }
#pragma unroll
        for (int i = 0; i < R; ++i) {
          const float pe = get(pr[i], e);
#pragma unroll
          for (int c = 0; c < C; ++c) acc[i][c] = fmaf(pe, w[c], acc[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int qi = q0 + rg + kGroups * i;
    if (qi >= S) break;
    const float denom = fmaxf(l[i], 1e-30f);
    float* dst = o + base + (size_t)qi * d + VW * lane;
#pragma unroll
    for (int u = 0; u < NCH; ++u) {
      if (VW * lane + kLanes * VW * u >= d) continue;
      VecV x;
      if constexpr (VW == 4) {
        x = make_float4(acc[i][u * 4] / denom, acc[i][u * 4 + 1] / denom,
                        acc[i][u * 4 + 2] / denom, acc[i][u * 4 + 3] / denom);
      } else {
        x = make_float2(acc[i][u * 2] / denom, acc[i][u * 2 + 1] / denom);
      }
      *reinterpret_cast<VecV*>(dst + kLanes * VW * u) = x;
    }
  }
}

template <int D>
int launch(const float* q, const float* k, const float* v, float* o, int BH,
           int S, int d, int causal, int window, float sm_scale,
           cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<D>();
  static_assert(bytes <= 232448, "above the 227 KB a block may use");
  // Above 48 KB a launch is refused unless the kernel's limit is raised.
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_f32_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + Tiles<D>::BQ - 1) / Tiles<D>::BQ, BH);
  flash_attention_f32_kernel<D><<<grid, kThreads, bytes, stream>>>(
      q, k, v, o, S, d, causal, window, sm_scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, o: (BH, S, d) float32 device pointers, contiguous and 16-byte
// aligned (cp.async and the vector stores).  The wrapper checks shapes,
// dtypes, alignment and 0 < d <= 256, d % 8 == 0.  window <= 0 means no
// window.  Returns the cudaError_t of the launch.
extern "C" int flash_attention_f32(const void* q, const void* k,
                                   const void* v, void* o, int BH, int S,
                                   int d, int causal, int window,
                                   float sm_scale, void* stream) {
  if (BH <= 0 || S <= 0) return 0;
  if (d <= 0 || d > 256 || d % 8 != 0 || BH > 65535)
    return (int)cudaErrorInvalidValue;
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  float* of = static_cast<float*>(o);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d <= 32)
    return launch<32>(qf, kf, vf, of, BH, S, d, causal, window, sm_scale, st);
  if (d <= 64)
    return launch<64>(qf, kf, vf, of, BH, S, d, causal, window, sm_scale, st);
  if (d <= 128)
    return launch<128>(qf, kf, vf, of, BH, S, d, causal, window, sm_scale,
                       st);
  return launch<256>(qf, kf, vf, of, BH, S, d, causal, window, sm_scale, st);
}
