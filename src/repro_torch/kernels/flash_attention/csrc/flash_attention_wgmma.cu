// GQA flash-attention forward for Hopper (sm_90a) on the tensor cores:
// bfloat16 q, k, v at head dims 64, 128 and 256.
//
// Replaces the Pallas TPU kernel fwd_call of
// repro/kernels/flash_attention/kernel.py (_fwd_kernel) for those inputs;
// flash_attention.cu beside it keeps float32 and the other head dims on the
// CUDA cores (kernel.py's flash_fwd picks one of the two by (dtype, D)).
// The function is the same: for q (B, H, Sq, D) and k, v (B, Hkv, Skv, D),
// query head h reads KV head h / (H / Hkv), and
//   out[b, h, i] = sum_j softmax_j(scale * q_i . k_j) v_j
// over the keys j that query i sees: all of them, or with `causal` those
// with i >= j (no offset, the reference kernel's mask).  Constants as the
// reference: masked scores -1e30, the running max starts at -1e30, the
// output is acc / max(l, 1e-30) rounded to bfloat16.
//
// Bound: operations.  Each (query, key) pair that is not masked costs a
// D-long dot product and a D-long weighted add, 4 D operations, at the
// card's 989 TFLOP/s bf16 tensor-core rate (0.0695 ms for qwen3-0.6b's 16
// heads of 128 at S 4,096 causal); q, k, v and out move in two orders of
// magnitude less time at 3.35 TB/s.
//
// Design:
//   * Tensor cores through wgmma, bf16 operands, float32 accumulators.
//     S = Q K^T with Q and K tiles in shared memory, both K-major (a K tile
//     as it lies, [key][d], is the transposed B operand).  O += P V with P
//     from registers (the S accumulator's fragment is the A fragment of the
//     next product) and V from shared memory, MN-major through the
//     transpose bit.  Online softmax in float32 registers: row max and sum
//     over the four threads of a row by quad shuffles, l summed from the
//     unrounded float32 P, exp2 of log2(e)-scaled scores.
//   * P is split: P_hi = bf16(P), P_lo = bf16(P - P_hi), and P V runs on
//     both.  P rounded once to bf16 puts about a tenth of the outputs past
//     one bf16 ulp of the exact result (the outputs are sums that cancel);
//     the split keeps them within it.  It costs 1.5x the least operations.
//     S needs no split: a bf16 x bf16 product is exact in float32.
//   * Warp specialisation: two consumer warpgroups of 64 query rows each
//     and one producer warpgroup, whose one thread keeps TMA loads of K and
//     V tiles (128 keys, 64 at D 256 where the output accumulator takes
//     128 registers; 128-byte swizzle, zero fill past the sequence) in
//     flight through a ring of two stages under mbarriers (full: K and V
//     apart, so S starts before V lands; empty: one arrival per consumer
//     warp).  setmaxnreg moves registers from the producer (24) to the
//     consumers (240).  The tensor maps take q, k and v's real strides
//     (any batch, head and row stride that TMA can address: multiples of 16
//     bytes, the last dimension contiguous); cuTensorMapEncodeTiled is
//     reached through cudaGetDriverEntryPoint, so the library links no
//     libcuda, and the maps travel as __grid_constant__ parameters.
//   * One K/V tile per GQA group: a block owns one (batch, KV head, query
//     tile) and computes the group's query heads (up to 16; a larger group
//     is split over blocks) from the K and V tiles it loads once.  Its 128
//     rows are the heads' query rows, head by head, NQ = 128 / heads
//     rounded down to a multiple of 8 query positions each, so that every
//     head's Q box, loaded once by TMA, starts on a swizzle atom
//     (qwen3-0.6b: 2 heads x 64 queries).
//   * Causal tile skip: the KV loop ends at the tile holding the block's
//     last query; only tiles that cross the diagonal or the sequence's end
//     are masked element by element.  Query tiles run longest first.
//   * Shared memory at D 128: Q 32 KB, two stages of K and V 128 KB (D 64:
//     16 + 64 KB; D 256: 64 + 128 KB).
//
// Left for later: pingpong scheduling of the two consumer warpgroups (one's
// softmax under the other's products), overlap of the softmax with the next
// tile's Q K^T inside a warpgroup, clusters sharing a K/V load by TMA
// multicast, a TMA store of the output, and fp8.
//
// Plain C interface, loaded with ctypes; the launch reports
// cudaGetLastError().

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kRows = 128;          // query rows per block
constexpr int kStages = 2;          // K/V ring
constexpr int kConsumers = 2;       // warpgroups of 64 rows
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kMaxHeads = 16;       // query heads per block
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFull = 0xffffffffu;

template <int D>
struct Geo {
  // keys per tile: 64 at D 256, where the output accumulator takes half
  // of a consumer thread's registers
  static constexpr int BKV = D > 128 ? 64 : 128;
  static constexpr int CB = D / 64;               // 128-byte column blocks
  static constexpr int Q_CB = kRows * 128;        // bytes of one Q column block
  static constexpr int KV_CB = BKV * 128;         // of one K or V column block
  static constexpr int Q_BYTES = CB * Q_CB;
  static constexpr int KV_BYTES = CB * KV_CB;
  static constexpr int BARS = Q_BYTES + 2 * kStages * KV_BYTES;
  static constexpr int SMEM = BARS + 8 * (1 + 3 * kStages) + 1024;
  static_assert(D == 64 || D == 128 || D == 256, "head dim 64, 128, 256");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
               :: "r"(bar) : "memory");
}

// Wait for the completion of the barrier's phase of this parity.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// One TMA box into shared memory; `order` packs, two bits each, which of
// the map's dimensions 1..3 holds the row, the head and the batch.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int order, int d,
                                         int row, int head, int batch) {
  const int pr = order & 3, ph = (order >> 2) & 3;
  const int c1 = pr == 0 ? row : ph == 0 ? head : batch;
  const int c2 = pr == 1 ? row : ph == 1 ? head : batch;
  const int c3 = pr == 2 ? row : ph == 2 ? head : batch;
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(d),
         "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// Shared-memory matrix descriptor, 128-byte swizzle; offsets in bytes.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return uint64_t((addr & 0x3FFFF) >> 4) |
         (uint64_t((lbo >> 4) & 0x3FFF) << 16) |
         (uint64_t((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// Keep the compiler from moving accesses of a wgmma operand across the
// asynchronous window.
__device__ __forceinline__ void pin(float& r) {
  asm volatile("" : "+f"(r) :: "memory");
}
__device__ __forceinline__ void pin(uint32_t& r) {
  asm volatile("" : "+r"(r) :: "memory");
}

// D[64 x 64] (+)= A[64 x 16] B[16 x 64], A and B K-major in shared memory;
// D is overwritten where `accumulate` is 0.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 128] (+)= A[64 x 16] B[16 x 128], A and B K-major in shared memory;
// D is overwritten where `accumulate` is 0.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
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
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 64] += A[64 x 16] B[16 x 64], A in registers, B MN-major in
// shared memory (the transpose bit set).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
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

// D[64 x 128] += A[64 x 16] B[16 x 128], A in registers, B MN-major in
// shared memory (the transpose bit set).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
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

// D[64 x 256] += A[64 x 16] B[16 x 256], A in registers, B MN-major in
// shared memory (the transpose bit set).
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
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

// Two floats as bf16x2 (x in the low half) and, in `lo`, what rounding
// left behind, also as bf16x2.
__device__ __forceinline__ uint32_t split_bf16x2(float x, float y,
                                                 uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x - hf.x, y - hf.y);
  uint32_t hb, lb;
  memcpy(&hb, &h, 4);
  memcpy(&lb, &l, 4);
  lo = lb;
  return hb;
}

template <int N>
__device__ __forceinline__ void wgmma_qk(float (&s)[N / 2], uint64_t da,
                                         uint64_t db, int accumulate) {
  if constexpr (N == 64) wgmma_ss_n64(s, da, db, accumulate);
  else wgmma_ss_n128(s, da, db, accumulate);
}

template <int D>
__device__ __forceinline__ void wgmma_pv(float (&o)[D / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (D == 64) wgmma_rs_n64(o, a, db);
  else if constexpr (D == 128) wgmma_rs_n128(o, a, db);
  else wgmma_rs_n256(o, a, db);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv,
                __nv_bfloat16* __restrict__ out, int H, int G, int HB, int NQ,
                int Sq, int Skv, int causal, float scale_log2, int qord,
                int kord, int vord) {
  using C = Geo<D>;
  constexpr int BKV = C::BKV;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t qs = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t ks = qs + C::Q_BYTES;                // K stage s: + s KV_BYTES
  const uint32_t vs = ks + kStages * C::KV_BYTES;
  const uint32_t qbar = qs + C::BARS;                 // then full K, full V,
  const uint32_t kbar = qbar + 8;                     // empty, kStages each
  const uint32_t vbar = kbar + 8 * kStages;
  const uint32_t ebar = vbar + 8 * kStages;

  const int n_hc = (G + HB - 1) / HB;                 // head chunks a group
  const int kvh = blockIdx.y / n_hc, hc = blockIdx.y % n_hc;
  const int b = blockIdx.z;
  const int h0 = kvh * G + hc * HB;                   // the block's first head
  const int hb = min(HB, G - hc * HB);                // and its head count
  const int q0 = (gridDim.x - 1 - blockIdx.x) * NQ;   // longest first
  const int rows = min(NQ, Sq - q0);
  // Causal: the block's last query q0 + rows - 1 sees keys up to itself.
  const int kv_end = causal ? min(Skv, q0 + rows) : Skv;
  const int n_tiles = (kv_end + BKV - 1) / BKV;

  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(kbar + 8 * s, 1);
      mbar_init(vbar + 8 * s, 1);
      mbar_init(ebar + 8 * s, kConsumers * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 128 * kConsumers) {
    // ---- producer warpgroup: one thread issues every load ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 128 * kConsumers) {
      mbar_expect_tx(qbar, hb * C::CB * NQ * 128);
      for (int g = 0; g < hb; ++g)
        for (int c = 0; c < C::CB; ++c)
          tma_load(qs + c * C::Q_CB + g * NQ * 128, &tq, qbar, qord, c * 64,
                   q0, h0 + g, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        if (t >= kStages) mbar_wait(ebar + 8 * s, ((t / kStages) - 1) & 1);
        mbar_expect_tx(kbar + 8 * s, C::KV_BYTES);
        for (int c = 0; c < C::CB; ++c)
          tma_load(ks + s * C::KV_BYTES + c * C::KV_CB, &tk, kbar + 8 * s,
                   kord, c * 64, t * BKV, kvh, b);
        mbar_expect_tx(vbar + 8 * s, C::KV_BYTES);
        for (int c = 0; c < C::CB; ++c)
          tma_load(vs + s * C::KV_BYTES + c * C::KV_CB, &tv, vbar + 8 * s,
                   vord, c * 64, t * BKV, kvh, b);
      }
    }
  } else {
    // ---- consumer warpgroups: 64 rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int wg = threadIdx.x / 128;
    const int lane = threadIdx.x % 32;
    const int c2 = (lane % 4) * 2;                    // fragment column pair
    // the thread's two rows of the block: row a and row a + 8
    const int ra = wg * 64 + ((threadIdx.x / 32) % 4) * 16 + lane / 4;
    const int ga = ra / NQ, gb = (ra + 8) / NQ;       // head within the block
    const int qa = q0 + ra % NQ, qb = q0 + (ra + 8) % NQ;   // query position

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m_a = kNegInf, m_b = kNegInf, l_a = 0.f, l_b = 0.f;
    const uint32_t qa_smem = qs + wg * 64 * 128;      // this warpgroup's Q rows

    mbar_wait(qbar, 0);
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % kStages;
      const uint32_t par = (t / kStages) & 1;
      const int j0 = t * BKV;

      // S = Q K^T
      float sacc[BKV / 2];
      mbar_wait(kbar + 8 * s, par);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;   // 16 columns of a block
        wgmma_qk<BKV>(
            sacc,
            smem_desc(qa_smem + (kk / 4) * C::Q_CB + off, 16, 1024),
            smem_desc(ks + s * C::KV_BYTES + (kk / 4) * C::KV_CB + off, 16,
                      1024),
            kk > 0);
      }
      wg_commit();
      wg_wait_all();
#pragma unroll
      for (int i = 0; i < BKV / 2; ++i) pin(sacc[i]);

      // online softmax, log2 domain; element 4j + e of the fragment is row
      // (e < 2 ? a : b), column j0 + 8 j + c2 + (e & 1)
      const bool edge = j0 + BKV > Skv || (causal && j0 + BKV - 1 > q0);
      float mx_a = kNegInf, mx_b = kNegInf;
#pragma unroll
      for (int j = 0; j < BKV / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = sacc[4 * j + e] * scale_log2;
          if (edge) {
            const int col = j0 + 8 * j + c2 + (e & 1);
            if (col >= Skv || (causal && col > (e < 2 ? qa : qb)))
              x = kNegInf;
          }
          sacc[4 * j + e] = x;
        }
        mx_a = fmaxf(mx_a, fmaxf(sacc[4 * j], sacc[4 * j + 1]));
        mx_b = fmaxf(mx_b, fmaxf(sacc[4 * j + 2], sacc[4 * j + 3]));
      }
      mx_a = fmaxf(mx_a, __shfl_xor_sync(kFull, mx_a, 1));
      mx_a = fmaxf(mx_a, __shfl_xor_sync(kFull, mx_a, 2));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(kFull, mx_b, 1));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(kFull, mx_b, 2));
      const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
      const float al_a = exp2f(m_a - mn_a), al_b = exp2f(m_b - mn_b);
      m_a = mn_a;
      m_b = mn_b;
      float ps_a = 0.f, ps_b = 0.f;
#pragma unroll
      for (int j = 0; j < BKV / 8; ++j) {
        sacc[4 * j] = exp2f(sacc[4 * j] - mn_a);
        sacc[4 * j + 1] = exp2f(sacc[4 * j + 1] - mn_a);
        sacc[4 * j + 2] = exp2f(sacc[4 * j + 2] - mn_b);
        sacc[4 * j + 3] = exp2f(sacc[4 * j + 3] - mn_b);
        ps_a += sacc[4 * j] + sacc[4 * j + 1];
        ps_b += sacc[4 * j + 2] + sacc[4 * j + 3];
      }
      l_a = l_a * al_a + ps_a;        // this thread's columns; summed over
      l_b = l_b * al_b + ps_b;        // the row's quad at the end
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o[4 * j] *= al_a;
        o[4 * j + 1] *= al_a;
        o[4 * j + 2] *= al_b;
        o[4 * j + 3] *= al_b;
      }
      // P as the A fragments of 16-key steps: registers (a, cols 0-7),
      // (b, cols 0-7), (a, cols 8-15), (b, cols 8-15) of the step
      uint32_t phi[BKV / 16][4], plo[BKV / 16][4];
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          phi[kk][r] = split_bf16x2(sacc[8 * kk + 2 * r],
                                    sacc[8 * kk + 2 * r + 1], plo[kk][r]);

      // O += P_hi V + P_lo V
      mbar_wait(vbar + 8 * s, par);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) pin(o[i]);
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          pin(phi[kk][r]);
          pin(plo[kk][r]);
        }
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk)
        wgmma_pv<D>(o, phi[kk],
                    smem_desc(vs + s * C::KV_BYTES + kk * 16 * 128, C::KV_CB,
                              1024));
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk)
        wgmma_pv<D>(o, plo[kk],
                    smem_desc(vs + s * C::KV_BYTES + kk * 16 * 128, C::KV_CB,
                              1024));
      wg_commit();
      wg_wait_all();
#pragma unroll
      for (int i = 0; i < D / 2; ++i) pin(o[i]);
      __syncwarp();
      if (lane == 0) mbar_arrive(ebar + 8 * s);
    }

    l_a += __shfl_xor_sync(kFull, l_a, 1);
    l_a += __shfl_xor_sync(kFull, l_a, 2);
    l_b += __shfl_xor_sync(kFull, l_b, 1);
    l_b += __shfl_xor_sync(kFull, l_b, 2);
    const float den_a = fmaxf(l_a, 1e-30f), den_b = fmaxf(l_b, 1e-30f);
    if (ga < hb && qa < Sq) {
      __nv_bfloat16* p =
          out + ((int64_t(b) * H + h0 + ga) * Sq + qa) * D + c2;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(p + 8 * j) =
            __floats2bfloat162_rn(o[4 * j] / den_a, o[4 * j + 1] / den_a);
    }
    if (gb < hb && qb < Sq) {
      __nv_bfloat16* p =
          out + ((int64_t(b) * H + h0 + gb) * Sq + qb) * D + c2;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(p + 8 * j) =
            __floats2bfloat162_rn(o[4 * j + 2] / den_b,
                                  o[4 * j + 3] / den_b);
    }
  }
}

// ---- host side -------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// Error codes past the runtime's: no cuTensorMapEncodeTiled, or an operand
// TMA cannot address; kEncodeFailed + the CUresult of a refused encoding.
constexpr int kNoEncoder = 10000, kBadOperand = 10001, kEncodeFailed = 20000;

// The tensor map of a (B, heads, rows, D) bf16 operand with element strides
// st[0..2] (batch, head, row), boxes of 64 columns x box_rows rows.  Its
// dimensions 1..3 hold rows, heads and batch in the order of their strides
// (a dimension of size 1 last); `order` says where each went.
int make_map(CUtensorMap* map, const void* ptr, int batch, int heads,
             int rows, int D, const long long* st, int box_rows,
             int* order) {
  struct Dim { unsigned long long size, stride; int role; };
  Dim d[3] = {{(unsigned long long)rows, (unsigned long long)st[2], 0},
              {(unsigned long long)heads, (unsigned long long)st[1], 1},
              {(unsigned long long)batch, (unsigned long long)st[0], 2}};
  unsigned long long span = D;
  for (auto& x : d)
    if (x.size > 1 && x.size * x.stride > span) span = x.size * x.stride;
  for (auto& x : d) {
    if (x.size == 1) x.stride = span;
    if (x.stride == 0 || (x.stride * 2) % 16 != 0 ||
        x.stride * 2 >= (1ull << 40))
      return kBadOperand;
  }
  if (reinterpret_cast<uintptr_t>(ptr) % 16 != 0) return kBadOperand;
  for (int i = 1; i < 3; ++i)            // by stride, stable
    for (int j = i; j > 0 && d[j].stride < d[j - 1].stride; --j) {
      const Dim t = d[j]; d[j] = d[j - 1]; d[j - 1] = t;
    }
  cuuint64_t gdim[4] = {(cuuint64_t)D, d[0].size, d[1].size, d[2].size};
  cuuint64_t gstride[3] = {d[0].stride * 2, d[1].stride * 2,
                           d[2].stride * 2};
  cuuint32_t box[4] = {64, 1, 1, 1};
  cuuint32_t estride[4] = {1, 1, 1, 1};
  int pos[3];
  for (int i = 0; i < 3; ++i) pos[d[i].role] = i;
  box[1 + pos[0]] = (cuuint32_t)box_rows;
  *order = pos[0] | (pos[1] << 2) | (pos[2] << 4);
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return kNoEncoder;
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(ptr), gdim, gstride, box, estride,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeFailed + int(r);
}

template <int D>
int launch(int B, int H, int Hkv, int Sq, int Skv, int causal, float scale,
           const void* q, const void* k, const void* v, void* out,
           const long long* st, cudaStream_t stream) {
  using C = Geo<D>;
  const int G = H / Hkv;
  const int HB = G < kMaxHeads ? G : kMaxHeads;
  const int NQ = (kRows / HB) / 8 * 8;
  CUtensorMap tq, tk, tv;
  int qord, kord, vord, err;
  if ((err = make_map(&tq, q, B, H, Sq, D, st, NQ, &qord)) != 0) return err;
  if ((err = make_map(&tk, k, B, Hkv, Skv, D, st + 3, C::BKV, &kord)) != 0)
    return err;
  if ((err = make_map(&tv, v, B, Hkv, Skv, D, st + 6, C::BKV, &vord)) != 0)
    return err;
  auto kern = flash_fwd_wgmma<D>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (e != cudaSuccess) return int(e);
  const dim3 grid((Sq + NQ - 1) / NQ, Hkv * ((G + HB - 1) / HB), B);
  kern<<<grid, kThreads, C::SMEM, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(out), H, G, HB, NQ, Sq, Skv,
      causal, scale * kLog2e, qord, kord, vord);
  return int(cudaGetLastError());
}

}  // namespace

// bfloat16 q (B, H, Sq, D), k and v (B, Hkv, Skv, D), D 64, 128 or 256; out
// contiguous (B, H, Sq, D).  strides: the batch, head and row strides of q,
// k and v in elements (9 values), each a multiple of 8 where its dimension
// is longer than 1.  Returns a CUDA error code, or kBadOperand (10001),
// kNoEncoder (10000) or 20000 + the CUresult of a refused tensor map.
extern "C" int flash_fwd_wgmma_launch(int B, int H, int Hkv, int Sq, int Skv,
                                      int D, int causal, float scale,
                                      const void* q, const void* k,
                                      const void* v, void* out,
                                      const long long* strides,
                                      void* stream) {
  if (B <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 || Sq <= 0 || Skv <= 0)
    return int(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return launch<64>(B, H, Hkv, Sq, Skv, causal, scale, q, k, v, out,
                      strides, s);
  if (D == 128)
    return launch<128>(B, H, Hkv, Sq, Skv, causal, scale, q, k, v, out,
                       strides, s);
  if (D == 256)
    return launch<256>(B, H, Hkv, Sq, Skv, causal, scale, q, k, v, out,
                       strides, s);
  return int(cudaErrorInvalidValue);
}
