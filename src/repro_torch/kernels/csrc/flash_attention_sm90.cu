// Forward flash attention in bfloat16 on Hopper tensor cores (sm_90a):
// wgmma on TMA-fed tiles, one producer and two consumer warpgroups.
//
// Replaces: src/repro/kernels/flash_attention.py::_flash_kernel (behind
// flash_attention, pallas_call at :93) for bfloat16 inputs.  Same function,
// for q, k, v (BH, S, d) bfloat16, contiguous, 16-byte aligned, GQA already
// expanded:
//   o[b, i] = sum_j softmax_j(q_i . k_j / sqrt(d)) v_j
// where key j is masked for query i (score -1e30) when causal and j > i, or
// when window > 0 and i - j >= window, or when j >= S.  Scores, the running
// max and sum and the output accumulator are float32; the probabilities
// are rounded to bfloat16 for the P.V product (as the reference model's
// _sdpa does), and the output is rounded once (round to nearest).  The
// float32 route keeps its SIMT kernel (flash_attention.cu).
//
// What bounds it on an H100: operations.  The serving prefill calls it at
// BH = 128, S = 2048, d = 128 causal: 137.5 GFLOP against 268 MB moved, some
// 500 flops a byte, above the card's balance point for the bf16 tensor
// cores (989 TFLOP/s, about 295 flops a byte), so the bound is 0.139 ms of
// tensor-core work.  Both products therefore run as wgmma, and the loads
// stay off the threads that issue them.
//
// Design (FlashAttention-3's layout and its intra-warpgroup pipelining,
// without its ping-pong schedule between warpgroups).  One block of 384
// threads per (bh, 128-query tile), on a grid (S/128, BH): the query tiles
// of one head are neighbours, so the blocks in flight share their heads' K
// and V in L2 (with the heads on the fast axis they span every head and
// stream K and V from device memory at a third of the speed); within a
// head the later, heavier causal tiles go first.
// - Warpgroup 0 is the producer.  It gives up registers (setmaxnreg.dec)
//   and one of its threads issues TMA loads: the Q tile once, then K and V
//   tiles of BK rows (128 at D <= 128, 64 at D = 256) through a ring of
//   2 to 4 stages (as many as fit) with full and empty mbarriers.
// - Warpgroups 1 and 2 are consumers (setmaxnreg.inc), each owning 64
//   query rows.  S = Q.K^T is wgmma m64nBKk16 with Q and K both from shared
//   memory, K-major.  The scale 1/sqrt(d), with log2(e) folded in for
//   exp2f, is applied in float32 after the product.  Masks and the online
//   softmax run in registers in the accumulator layout, a row's max and sum
//   reduced over the four threads that share it.  P is rounded to bfloat16
//   in registers and is the A operand of O += P.V (wgmma m64nDk16, A from
//   registers): the accumulator fragment of each 16-column slice of S is
//   the A fragment of that k16 step.  V is the B operand from shared
//   memory, MN-major (the transpose bit).
// - Each consumer issues Q.K^T of tile t before P.V of tile t - 1, and runs
//   the softmax of tile t while the tensor cores do that P.V.
// - KV tiles wholly above the diagonal or wholly before the window are
//   never loaded; only tiles that cross the diagonal, the window's start or
//   S test the masks.
//
// Tensor maps are 3-D, (d, S, BH), with 128-byte swizzle and 64-column
// boxes, encoded on the host at each call (cuTensorMapEncodeTiled through
// cudaGetDriverEntryPoint, so no -lcuda).  Rows past S and columns past d
// arrive as zeros, never as the next head's rows, so any d <= 256 that is a
// multiple of 8 runs at the template width D in {64, 128, 256} and a ragged
// S needs no padding copy; the epilogue stores only rows < S and columns
// < d.  Shared memory holds Q (128 x D) and the K/V ring (BK x D a tile) in
// 1024-byte aligned 128-byte-swizzle atoms: 144 KB at D = 64 (4 stages),
// 225 KB at D = 128 (3), 193 KB at D = 256 (2).  The wgmma descriptors
// match the swizzle: K-major tiles with SBO = 1024 bytes (8 rows of 128
// bytes), stepping 32 bytes per k16 inside a 64-column box; V MN-major
// with LBO = one box (BK x 128 bytes) and SBO = 1024 bytes (8 keys).
#include <cuda.h>  // CUtensorMap and its enums; no driver library is linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 128;      // queries per block, 64 per consumer warpgroup
constexpr int kThreads = 384;
constexpr int kConsumerWarps = 8;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Cfg {
  static constexpr int BK = D == 256 ? 64 : 128;    // keys per KV tile
  static constexpr int kBoxes = D / 64;             // 64-column TMA boxes
  static constexpr int kQBytes = kBQ * D * 2;
  static constexpr int kKVBytes = BK * D * 2;       // one K or V stage
  // K/V ring depth: as many stages as fit beside Q in 227 KB
  static constexpr int kStages = D == 64 ? 4 : D == 128 ? 3 : 2;
  static constexpr int kKOff = kQBytes;
  static constexpr int kVOff = kKOff + kStages * kKVBytes;
  static constexpr int kBarOff = kVOff + kStages * kKVBytes;
  // barriers (1 + 4 kStages of 8 bytes), then slack to align the base to
  // 1024 bytes
  static constexpr int kSmem = kBarOff + 256 + 1024;
  static_assert(kSmem <= 232448, "shared memory above the block's limit");
};

// -- PTX wrappers -----------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ bool mbar_try(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  while (!mbar_try(bar, parity)) {
  }
}

// One 3-D box of a tensor map into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// wgmma shared-memory descriptor for the 128-byte swizzle: the low word
// holds the start address and the leading byte offset (LBO), both in units
// of 16 bytes (bits 0-13 and 16-29); the high word the stride byte offset
// (SBO, 1024 bytes: eight 128-byte rows) and the layout type (1, bits
// 62-63).  Shared addresses stay below 2^18, so a byte offset o is added to
// the low word as o >> 4 without a carry out of the address field.
constexpr uint32_t kDescHi = (1024u >> 4) | (1u << 30);

__device__ __forceinline__ uint32_t desc_lo(uint32_t addr, uint32_t lbo) {
  return ((addr & 0x3FFFF) >> 4) | ((lbo >> 4) << 16);
}
__device__ __forceinline__ uint64_t desc(uint32_t lo) {
  return ((uint64_t)kDescHi << 32) | lo;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N committed groups of this warpgroup are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from touching registers that an in-flight wgmma owns:
// reads of an accumulator are ordered after the wait, and the A fragment
// stays live (and unmoved) until it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// D (64 x N, float32) += A (64 x 16) . B (16 x N), bfloat16 operands.
// wgmma_ss: A and B from shared memory, both K-major; scale_d = 0 zeroes D.
// wgmma_rs: A from registers, B from shared memory MN-major.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[128],
                                         const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);  // .x = lo, low half
  return *reinterpret_cast<uint32_t*>(&h);
}

// What a consumer thread needs to mask its scores: its two rows (row0 and
// row0 + 8) and the first of its column pairs, in the accumulator layout.
struct Rows {
  int row0, col2, S, causal, window;
};

// Scale, mask and exponentiate one KV tile's scores (sc, this thread's
// share: sc[4i + e] is row row0 + 8 (e >> 1), key k0 + 8i + col2 + (e & 1))
// in place, in the exp2 domain (scale = log2(e) / sqrt(d)).  Updates the
// running max m and this thread's share l of each row's sum, and returns
// in alpha the factor that rescales the earlier accumulator.  Only `edge`
// tiles (crossing the diagonal, the window's start or S) test the masks.
template <int N>
__device__ __forceinline__ void softmax_tile(float (&sc)[N], float (&m)[2],
                                             float (&l)[2], float (&alpha)[2],
                                             float scale, bool edge, int k0,
                                             const Rows& r) {
  float mx[2] = {kNegInf, kNegInf};
  if (edge) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int qi = r.row0 + ((i >> 1) & 1) * 8;
      const int kj = k0 + 8 * (i >> 2) + r.col2 + (i & 1);
      float x = sc[i] * scale;
      if ((r.causal && kj > qi) || (r.window > 0 && qi - kj >= r.window) ||
          kj >= r.S)
        x = kNegInf;
      sc[i] = x;
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x);
    }
  } else {
    // the max of the raw scores, scaled after (scale > 0 keeps the order)
#pragma unroll
    for (int i = 0; i < N; ++i)
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
    mx[0] *= scale;
    mx[1] *= scale;
  }
  // edge tiles hold scaled scores, the others raw ones: one FFMA and one
  // exp2 an element either way
  const float mul = edge ? 1.0f : scale;
  float rs[2] = {0.0f, 0.0f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    mx[h] = fmaxf(mx[h], m[h]);
    alpha[h] = exp2f(m[h] - mx[h]);
    m[h] = mx[h];
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int h = (i >> 1) & 1;
    const float p = exp2f(fmaf(sc[i], mul, -m[h]));
    sc[i] = p;
    rs[h] += p;
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + rs[h];
}

// P (this thread's share of a 64 x N tile, float32, accumulator layout) as
// the register A fragments of the k16 steps of P.V: the accumulator
// fragment of columns 16j..16j+15 is the A fragment of step j.
template <int N>
__device__ __forceinline__ void pack_p(const float (&sc)[N],
                                       uint32_t (&pa)[N / 8][4]) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int h = 0; h < 4; ++h)
      pa[j][h] = pack_bf16(sc[8 * j + 2 * h], sc[8 * j + 2 * h + 1]);
}

// -- the kernel -------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_kernel_sm90(const __grid_constant__ CUtensorMap tm_q,
                            const __grid_constant__ CUtensorMap tm_k,
                            const __grid_constant__ CUtensorMap tm_v,
                            __nv_bfloat16* __restrict__ o, int S, int d,
                            int causal, int window, float sm_scale) {
  using C = Cfg<D>;
  constexpr int BK = C::BK;
  constexpr int kStages = C::kStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sq = base;
  const uint32_t sk = base + C::kKOff;
  const uint32_t sv = base + C::kVOff;
  const uint32_t q_full = base + C::kBarOff;
  // barrier of stage s: k_full, v_full, k_empty, v_empty
  auto bar = [&](int kind, int s) {
    return q_full + 8u * (1 + kind * kStages + s);
  };

  // The query tiles of one head are neighbours in the grid, so the blocks
  // in flight share their heads' K and V in L2; within a head the later,
  // heavier causal tiles go first.
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int bh = blockIdx.y;
  // KV tiles that hold any key a query of this block may see.
  const int kv_end = causal ? min(S, q0 + kBQ) : S;
  const int kv_begin = (window > 0 ? max(0, q0 - window + 1) : 0) / BK * BK;
  const int n_tiles = (kv_end - kv_begin + BK - 1) / BK;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar(0, s), 1);
      mbar_init(bar(1, s), 1);
      mbar_init(bar(2, s), kConsumerWarps);
      mbar_init(bar(3, s), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, C::kQBytes);
#pragma unroll
      for (int b = 0; b < C::kBoxes; ++b)
        tma_load(sq + b * (kBQ * 128), &tm_q, q_full, 64 * b, q0, bh);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        const uint32_t parity = ((t / kStages) & 1) ^ 1;
        const int k0 = kv_begin + t * BK;
        mbar_wait(bar(2, s), parity);
        mbar_expect_tx(bar(0, s), C::kKVBytes);
#pragma unroll
        for (int b = 0; b < C::kBoxes; ++b)
          tma_load(sk + s * C::kKVBytes + b * (BK * 128), &tm_k, bar(0, s),
                   64 * b, k0, bh);
        mbar_wait(bar(3, s), parity);
        mbar_expect_tx(bar(1, s), C::kKVBytes);
#pragma unroll
        for (int b = 0; b < C::kBoxes; ++b)
          tma_load(sv + s * C::kKVBytes + b * (BK * 128), &tm_v, bar(1, s),
                   64 * b, k0, bh);
      }
    }
  } else {
    // ---- consumers: warpgroup cw owns query rows q0 + 64 cw .. + 63 ----
    // Software-pipelined as FlashAttention-3: Q.K^T of tile t is issued
    // before P.V of tile t - 1, and the softmax of tile t runs while the
    // tensor cores do that P.V.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int cw = wg - 1;
    const int tid = threadIdx.x % 128;
    const int lane = tid % 32;
    const int qw0 = q0 + cw * 64;
    const Rows rows{qw0 + (tid / 32) * 16 + lane / 4, 2 * (lane % 4), S,
                    causal, window};
    const float scale = sm_scale * kLog2e;
    // Does tile k0 need the masks for this warpgroup's rows?
    auto edge = [&](int k0) {
      return k0 + BK > S || (causal && k0 + BK - 1 > qw0) ||
             (window > 0 && qw0 + 63 - k0 >= window);
    };

    float acc[D / 2];
    float sc[BK / 2];
    uint32_t pa[BK / 16][4];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) sc[i] = 0.0f;
    float m[2] = {kNegInf, kNegInf};
    float l[2] = {0.0f, 0.0f};  // this thread's share of each row's sum
    float alpha[2];

    // descriptor low words: Q and K K-major (LBO unused, 16), V MN-major
    // (LBO = one 64-column box of BK rows)
    const uint32_t q_lo = desc_lo(sq + cw * 64 * 128, 16);
    const uint32_t k_lo = desc_lo(sk, 16);
    const uint32_t v_lo = desc_lo(sv, BK * 128);
    // S = Q . K^T of the tile in stage s: k16 steps of 32 bytes inside a
    // 64-column box, then the next box
    auto issue_qk = [&](int s) {
      const uint32_t k_desc = k_lo + s * (C::kKVBytes >> 4);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss(sc, desc(q_lo + (kk / 4) * (kBQ * 128 >> 4) + (kk % 4) * 2),
                 desc(k_desc + (kk / 4) * (BK * 128 >> 4) + (kk % 4) * 2),
                 kk > 0);
      wgmma_commit();
    };
    // O += P . V of the tile in stage s: k16 steps of 16 keys (2048 bytes)
    auto issue_pv = [&](int s) {
      const uint32_t v_desc = v_lo + s * (C::kKVBytes >> 4);
#pragma unroll
      for (int j = 0; j < BK / 16; ++j)
        wgmma_rs(acc, pa[j], desc(v_desc + j * (16 * 128 >> 4)));
      wgmma_commit();
    };

    mbar_wait(q_full, 0);
    // tile 0: its scores and P; O is still zero
    mbar_wait(bar(0, 0), 0);
    wgmma_fence();
    issue_qk(0);
    wgmma_wait<0>();
    fence_regs(sc);
    if (lane == 0) mbar_arrive(bar(2, 0));
    softmax_tile(sc, m, l, alpha, scale, edge(kv_begin), kv_begin, rows);
    pack_p(sc, pa);

    for (int t = 1; t < n_tiles; ++t) {
      const int s = t % kStages, sp = (t - 1) % kStages;
      const int k0 = kv_begin + t * BK;
      mbar_wait(bar(0, s), (t / kStages) & 1);
      wgmma_fence();
      issue_qk(s);   // S(t), the older group
      mbar_wait(bar(1, sp), ((t - 1) / kStages) & 1);
      issue_pv(sp);  // O += P(t-1) . V(t-1)
      wgmma_wait<1>();
      fence_regs(sc);
      if (lane == 0) mbar_arrive(bar(2, s));
      softmax_tile(sc, m, l, alpha, scale, edge(k0), k0, rows);
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(pa);
      if (lane == 0) mbar_arrive(bar(3, sp));
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
      pack_p(sc, pa);
    }
    // the last tile's P.V
    const int sl = (n_tiles - 1) % kStages;
    mbar_wait(bar(1, sl), ((n_tiles - 1) / kStages) & 1);
    wgmma_fence();
    issue_pv(sl);
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(pa);

    // epilogue: the row sums over the four threads of a row, one rounding
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      inv[r] = 1.0f / fmaxf(l[r], 1e-30f);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qi = rows.row0 + 8 * r;
      if (qi >= S) continue;
      __nv_bfloat16* dst = o + ((size_t)bh * S + qi) * d;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const int col = 8 * j + rows.col2;
        if (col < d)
          *reinterpret_cast<__nv_bfloat162*>(dst + col) =
              __floats2bfloat162_rn(acc[4 * j + 2 * r] * inv[r],
                                    acc[4 * j + 2 * r + 1] * inv[r]);
      }
    }
  }
}

// -- host -------------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, looked up once through the runtime.
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
#if CUDART_VERSION >= 12050
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      return nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault) != cudaSuccess)
      return nullptr;
#endif
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A (BH, S, d) bfloat16 tensor as a 3-D map (d, S, BH): boxes of 64 columns
// by `rows` rows of one head, 128-byte swizzle, zeros outside the tensor.
bool make_map(EncodeTiled enc, CUtensorMap* map, const void* ptr, int BH,
              int S, int d, int rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)S, (cuuint64_t)BH};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2, (cuuint64_t)S * d * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
             dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int BH,
           int S, int d, int causal, int window, float sm_scale,
           cudaStream_t stream) {
  using C = Cfg<D>;
  EncodeTiled enc = encoder();
  if (enc == nullptr) return (int)cudaErrorSymbolNotFound;
  CUtensorMap mq, mk, mv;
  if (!make_map(enc, &mq, q, BH, S, d, kBQ) ||
      !make_map(enc, &mk, k, BH, S, d, C::BK) ||
      !make_map(enc, &mv, v, BH, S, d, C::BK))
    return (int)cudaErrorInvalidValue;
  // Above 48 KB a launch is refused unless the kernel's limit is raised.
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel_sm90<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + kBQ - 1) / kBQ, BH);
  flash_attention_kernel_sm90<D><<<grid, kThreads, C::kSmem, stream>>>(
      mq, mk, mv, (__nv_bfloat16*)o, S, d, causal, window, sm_scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, o: (BH, S, d) bfloat16 device pointers, contiguous and 16-byte
// aligned (TMA's rule).  The wrapper checks shapes, dtypes, alignment and
// 0 < d <= 256, d % 8 == 0.  window <= 0 means no window.  Returns the
// cudaError_t of the launch (cudaErrorInvalidValue where a tensor map cannot
// be encoded, cudaErrorMisalignedAddress for a pointer off 16 bytes).
extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, void* o, int BH, int S,
                                    int d, int causal, int window,
                                    float sm_scale, void* stream) {
  if (BH <= 0 || S <= 0) return 0;
  if (d <= 0 || d > 256 || d % 8 != 0 || BH > 65535)
    return (int)cudaErrorInvalidValue;
  if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)o) & 15)
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t st = (cudaStream_t)stream;
  if (d <= 64)
    return launch<64>(q, k, v, o, BH, S, d, causal, window, sm_scale, st);
  if (d <= 128)
    return launch<128>(q, k, v, o, BH, S, d, causal, window, sm_scale, st);
  return launch<256>(q, k, v, o, BH, S, d, causal, window, sm_scale, st);
}
