// SpMM y = A @ X (A in CSR, X dense row-major (n, k)) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel spmm_call of
// repro/kernels/spmm/kernel.py (_spmm_kernel): for each row i,
//   y[i, :] = sum_j a_ij * X[col_j, :]
// accumulated in float32 over the row's nonzeros in order, from 0, and
// stored cast to X's dtype (float32, bfloat16 or float16; round to
// nearest even).  Adds one kernel that replaces none, classify_kernel
// (below).
//
// Bound: memory.  The least traffic reads the row pointer, the column ids
// and values once, X once and writes Y once; 2 k operations per nonzero
// are far below the FP32 rate.  What the card actually moves is one X row
// per nonzero (the gathers: 466 MB at k = 64 float32 on the symmetrized
// G500 s16 graph, 1.07 GB on ER s18), out of L2 where X fits in it.  A
// skewed row is the other limit: its float32 sums are one chain of
// dependent adds per column, about 4 cycles a nonzero, and the row-order
// rounding contract forbids splitting it: its time is the floor of the
// launch, which longest-first order and a whole block a row shorten.
//
// Design on this card:
//   * Rows by live length, on the device, with no host sync.
//     classify_kernel (one thread a row; it replaces no TPU kernel: the TPU
//     grid walks equal-nnz row bins in order on one core and needs no row
//     lists) takes each row's live length min(indptr[i+1], min(nnz, cap)) -
//     indptr[i], clamped at 0, and appends the row to one of kClasses lists
//     by ceil(log2(length)): classes 0-3 hold rows of at most 32, 64, 128
//     and 256 (kLongRow) nonzeros, empty rows in class 0, and take a warp a
//     row; classes 4-9 hold (256, 512], ..., (4,096, 8,192] and longer
//     rows, and take a block a row.  Class c >= 1 has room for cap / (32 *
//     2^(c-1) + 1) rows, all that a row pointer that never decreases can
//     give it; a row past its list's room (only a decreasing row pointer
//     makes one) goes to class 0.  The caller keeps the lists (memoized on
//     the CSR) and passes them to every product.
//   * One persistent launch a call (after an 8-byte memset of its two pop
//     counters), as many blocks as the card holds at once (three of 256
//     threads an SM), at most one a 32-row chunk.  Each block first pops
//     block rows with an atomic counter, longest class first
//     (longest-processing-time order: the 9,629-nonzero row of the G500
//     graph starts at once); then each of its warps pops warp rows,
//     longest class first, 1, 2, 4 or 32 rows at a pop (classes 3 to 0).
//   * A block row: kProducerWarps producer warps and kConsumerWarps
//     consumer warps around a ring of kStages stages of kStageBytes in
//     dynamic shared memory (64 KB a block).  Stage j holds up to 32 of the
//     row's slots (kStageBytes / pitch at wide k) and is filled by producer
//     warp (block stage count) % kProducerWarps: one warp starting a stage's
//     copies took longer on the card than the consumers take to add it, so
//     four take turns.  A producer fetches its stages' column
//     ids and values kIdStages stages ahead by cp.async into its own id
//     ring (a load into registers stalled it a memory latency a stage),
//     writes each stage's values, and brings the stage's X rows (this
//     pass's columns of them) in:
//       - with cp.async.bulk (1-D TMA), one copy a row, completion on the
//         stage's mbarrier through expect_tx, where X and its rows are
//         16-byte aligned;
//       - else through registers (bf16 and f16 at k = 100, any dtype at
//         k = 1, an X not 16-byte aligned): 2-byte loads, eight a lane in
//         flight, then shared stores, reported by the lanes' arrivals.
//         Wider loads (the widest of 8, 4, 2 bytes the row allows) took
//         registers from the whole kernel: it spilled, and the bulk-copy
//         launch on the symmetrized G500 s16 graph went from 0.14 to 0.27
//         ms on an H100.
//     The host picks the path from k, the dtype and X's address before
//     the launch.  Each consumer lane owns
//     kCols (2) adjacent columns of a 256-column strip (one 8- or 4-byte
//     shared load a slot feeds two independent sums) and adds the stage's
//     slots in order; wider k walks the row once per strip, so shared
//     memory stays the same for any k.
//     Every stage has a full and an empty mbarrier, waited on with an
//     explicit phase parity from the block's running stage count (see
//     consume for why a parity is never ambiguous); consumer warps with no
//     column in a strip skip it, and the first consumer warp arrives for
//     them.
//   * A warp row: one warp, lanes over k, VW contiguous columns a lane (a
//     4-, 8- or 16-byte load of X, as wide as k, X's alignment and 32 VW >=
//     k allow); k past 32 VW takes further passes.  A warp walks its rows
//     as one stream of 32-slot batches (rows and passes in order) and loads
//     the next batch's column ids and values before the current batch's
//     adds; the rows' bounds are loaded once, 32 rows at a time.  kUnroll
//     X gathers are in flight at once (8 rows of 8 bytes a lane at k = 64:
//     more spilled them under the 85-register cap of three blocks an SM).
//   * Each product is __fmul_rn and each add __fadd_rn, in the row's
//     order: no FMA, no tensor cores, no TF32.  The plain version (ref.py)
//     does the same operations in the same order, so the two agree
//     bitwise.  Slots at or past min(nnz, cap) count as 0; column ids are
//     clipped to [0, n), as the reference's gather clips them.
//   * The block barrier between block rows is the non-aligned
//     barrier.sync, as in spgemm_hash.cu: it follows loops whose trip count
//     depends on the row.
//
// Plain C interface, loaded with ctypes; every launch reports
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kClasses = 10;
constexpr int kWarpClasses = 4;  // classes 0-3: a warp a row
constexpr int kShortRow = 32;    // class 0: at most one 32-slot batch
constexpr int kLongRow = kShortRow << (kWarpClasses - 1);  // 256
constexpr int kProducerWarps = 4;  // stage j filled by warp j % 4
constexpr int kConsumerWarps = 4;
constexpr int kWarps = kProducerWarps + kConsumerWarps;
constexpr int kThreads = 32 * kWarps;
constexpr int kCols = 2;  // adjacent columns a consumer lane owns
constexpr int kStrip = kCols * 32 * kConsumerWarps;  // columns a pass
constexpr int kStages = 8;  // >= kProducerWarps (see consume)
constexpr int kStageBytes = 8192;
constexpr int kIdStages = 8;  // a producer's own stages of ids fetched ahead
// rows a warp pops at once from warp class c: 32 of at most 32 slots,
// then 4, 2 and 1 as rows lengthen
__host__ __device__ constexpr int class_chunk(int c) {
  return c == 0 ? 32 : 8 >> c;
}
constexpr int kChunk = class_chunk(0);
constexpr int kMinBlocks = 3;
// dynamic shared memory: the ring, values and column ids a stage, the
// producer's id ring (column ids and values kIdStages stages ahead), then
// the full and empty barriers
constexpr int kRingBytes = kStages * kStageBytes;
constexpr int kSmemBytes = kRingBytes + 2 * kStages * 32 * 4 +
                           kProducerWarps * 2 * kIdStages * 32 * 4 +
                           2 * kStages * 8;

// Room of class c's list (rows); class 0 holds every row.
__host__ __device__ inline int class_room(int c, int m, int cap) {
  if (c == 0) return m;
  const long long lo = static_cast<long long>(kShortRow) << (c - 1);
  const long long r = cap / (lo + 1);
  return r < m ? static_cast<int>(r) : m;
}

__host__ __device__ inline long long class_offset(int c, int m, int cap) {
  long long off = 0;
  for (int j = 0; j < c; ++j) off += class_room(j, m, cap);
  return off;
}

__device__ __forceinline__ int row_class(int len) {
  const int bits = 32 - __clz(max(len, 1) - 1);  // ceil(log2(len))
  return min(max(bits - 5, 0), kClasses - 1);
}

__device__ __forceinline__ void block_sync() {
  asm volatile("barrier.sync 0;" ::: "memory");
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(bytes) : "memory");
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

__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes),
         "r"(bar)
      : "memory");
}

// Ampere-style asynchronous 4-byte copies (the producers' column ids and
// values), grouped by commit and waited on by group.
__device__ __forceinline__ void async_copy4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;"
               :: "r"(dst), "l"(reinterpret_cast<uint64_t>(src))
               : "memory");
}
__device__ __forceinline__ void async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void async_wait() {
  asm volatile("cp.async.wait_group %0;" :: "n"(N) : "memory");
}

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ float load_f(const __half* p) {
  return __half2float(*p);
}

__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void store_f(__half* p, float v) {
  *p = __float2half_rn(v);
}

// 16-bit halves of a 32-bit word to float, and back.
__device__ __forceinline__ float half_to_f(unsigned short h, __nv_bfloat16*) {
  return __uint_as_float(static_cast<unsigned>(h) << 16);
}
__device__ __forceinline__ float half_to_f(unsigned short h, __half*) {
  return __half2float(__ushort_as_half(h));
}
__device__ __forceinline__ unsigned short f_to_half(float v,
                                                    __nv_bfloat16*) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}
__device__ __forceinline__ unsigned short f_to_half(float v, __half*) {
  return __half_as_ushort(__float2half_rn(v));
}

// VW contiguous elements of T as floats, in one load of VW * sizeof(T)
// bytes (2, 4, 8 or 16; p aligned to it), and the store back.
template <int NW>
__device__ __forceinline__ void load_words(const void* p, unsigned (&w)[NW]) {
  if constexpr (NW == 1) {
    w[0] = *static_cast<const unsigned*>(p);
  } else if constexpr (NW == 2) {
    const uint2 v = *static_cast<const uint2*>(p);
    w[0] = v.x; w[1] = v.y;
  } else {
    const uint4 v = *static_cast<const uint4*>(p);
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
  }
}

template <int NW>
__device__ __forceinline__ void store_words(void* p, const unsigned (&w)[NW]) {
  if constexpr (NW == 1) {
    *static_cast<unsigned*>(p) = w[0];
  } else if constexpr (NW == 2) {
    *static_cast<uint2*>(p) = make_uint2(w[0], w[1]);
  } else {
    *static_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

template <typename T, int VW>
__device__ __forceinline__ void load_vec(const T* p, float (&out)[VW]) {
  if constexpr (sizeof(T) == 4) {
    unsigned w[VW];
    load_words<VW>(p, w);
#pragma unroll
    for (int e = 0; e < VW; ++e) out[e] = __uint_as_float(w[e]);
  } else if constexpr (VW == 1) {
    out[0] = load_f(p);
  } else {
    unsigned w[VW / 2];
    load_words<VW / 2>(p, w);
#pragma unroll
    for (int e = 0; e < VW / 2; ++e) {
      out[2 * e] = half_to_f(static_cast<unsigned short>(w[e] & 0xffffu),
                             static_cast<T*>(nullptr));
      out[2 * e + 1] = half_to_f(static_cast<unsigned short>(w[e] >> 16),
                                 static_cast<T*>(nullptr));
    }
  }
}

template <typename T, int VW>
__device__ __forceinline__ void store_vec(T* p, const float (&v)[VW]) {
  if constexpr (sizeof(T) == 4) {
    unsigned w[VW];
#pragma unroll
    for (int e = 0; e < VW; ++e) w[e] = __float_as_uint(v[e]);
    store_words<VW>(p, w);
  } else if constexpr (VW == 1) {
    store_f(p, v[0]);
  } else {
    unsigned w[VW / 2];
#pragma unroll
    for (int e = 0; e < VW / 2; ++e)
      w[e] = static_cast<unsigned>(f_to_half(v[2 * e],
                                             static_cast<T*>(nullptr))) |
             (static_cast<unsigned>(f_to_half(v[2 * e + 1],
                                              static_cast<T*>(nullptr)))
              << 16);
    store_words<VW / 2>(p, w);
  }
}

// The producer's copies of a stage's X rows where bulk copies cannot take
// them: 2-byte loads into registers, eight a lane in flight, then shared
// stores; lanes over the upr units of each row q < cnt, from X row
// cols[q] at byte offset off, into the stage's rows of pitch bytes.
__device__ __forceinline__ void register_rows(
    unsigned char* stage, int pitch, const int* cols, int cnt,
    const unsigned char* x, size_t row_stride, size_t off, int upr,
    int lane) {
  using V = unsigned short;
  for (int q = 0; q < cnt; ++q) {
    const unsigned char* src = x + cols[q] * row_stride + off;
    unsigned char* dst = stage + q * pitch;
    for (int v0 = lane; v0 < upr; v0 += 8 * 32) {
      V t[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if (v0 + 32 * i < upr)
          t[i] = *reinterpret_cast<const V*>(src + (v0 + 32 * i) * 2);
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if (v0 + 32 * i < upr)
          *reinterpret_cast<V*>(dst + (v0 + 32 * i) * 2) = t[i];
    }
  }
}

// Row lists by live length (see the header): one thread a row.  counts
// holds kClasses zeroed counts, lists class_offset(kClasses, m, cap) ids.
__global__ void classify_kernel(int m, int cap, const int* __restrict__ nnz,
                                const int* __restrict__ indptr,
                                int* __restrict__ counts,
                                int* __restrict__ lists) {
  __shared__ int s_n[kClasses];
  __shared__ int s_base[kClasses];
  if (threadIdx.x < kClasses) s_n[threadIdx.x] = 0;
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  int cls = -1, pos = 0;
  if (i < m) {
    const int live = min(*nnz, cap);
    const int len = max(min(indptr[i + 1], live) - indptr[i], 0);
    cls = row_class(len);
    pos = atomicAdd(&s_n[cls], 1);
  }
  __syncthreads();
  if (threadIdx.x < kClasses && s_n[threadIdx.x])
    s_base[threadIdx.x] = atomicAdd(counts + threadIdx.x, s_n[threadIdx.x]);
  __syncthreads();
  if (cls < 0) return;
  int at = s_base[cls] + pos;
  if (cls > 0 && at >= class_room(cls, m, cap)) {
    cls = 0;  // past its list's room: the warps take it
    at = atomicAdd(counts, 1);
  }
  lists[class_offset(cls, m, cap) + at] = i;
}

// Long row number t of this call, longest class first; -1 past the last.
__device__ int long_row(int t, int m, int cap, const int* counts,
                        const int* lists) {
  for (int c = kClasses - 1; c >= kWarpClasses; --c) {
    const int nc = min(counts[c], class_room(c, m, cap));
    if (t < nc) return lists[class_offset(c, m, cap) + t];
    t -= nc;
  }
  return -1;
}

// Producer warp pw's share of one pass over a long row: slots [p0, p1),
// columns [c0, c0 + w), the pass's stages j whose block-wide count it + j
// is pw modulo kProducerWarps (so a warp's turns stay kProducerWarps
// stages apart across passes too).  it: the block's stage count before the
// pass.  Lane q < S holds slot q of each
// stage; the column ids and values of this warp's stages come kIdStages of
// them ahead by cp.async into its id ring (idc, idv), so no load of them
// stands between the warp and its next copies.
template <typename T>
__device__ __forceinline__ void produce(
    int p0, int p1, int c0, int w, int k, int n, int bulk, int rows_a_stage,
    int pitch, uint32_t it, int pw, unsigned char* ring, float* vals,
    int* colsm, int* idc, float* idv, uint64_t* full, uint64_t* empty,
    const int* __restrict__ indices, const float* __restrict__ data,
    const T* __restrict__ x, int lane) {
  const int S = rows_a_stage;
  const int n_stages = (p1 - p0 + S - 1) / S;
  const int row_bytes = w * static_cast<int>(sizeof(T));
  // this warp's t-th stage of the pass is j = j0 + t * kProducerWarps
  const int j0 = (pw - static_cast<int>(it % kProducerWarps) +
                  kProducerWarps) % kProducerWarps;
  const auto fetch = [&](int t) {
    const int j = j0 + t * kProducerWarps;
    const int q = p0 + j * S + lane;
    if (j < n_stages && lane < S && q < p1) {
      const int slot = (t % kIdStages) * 32 + lane;
      async_copy4(smem_u32(idc + slot), indices + q);
      async_copy4(smem_u32(idv + slot), data + q);
    }
    async_commit();
  };
  for (int t = 0; t < kIdStages; ++t) fetch(t);
  for (int t = 0, j = j0; j < n_stages; ++t, j += kProducerWarps) {
    const uint32_t s_it = it + j;
    const int s = s_it % kStages;
    const int cnt = min(S, p1 - (p0 + j * S));
    async_wait<kIdStages - 1>();  // this lane's ids of stage j
    const int slot = (t % kIdStages) * 32 + lane;
    const int col = min(max(idc[slot], 0), n - 1);
    const float val = idv[slot];
    mbar_wait(smem_u32(empty + s), ((s_it / kStages) & 1) ^ 1);
    if (lane < cnt) {
      vals[s * 32 + lane] = val;
      colsm[s * 32 + lane] = col;
    }
    __syncwarp();
    const uint32_t bar = smem_u32(full + s);
    unsigned char* stage = ring + s * kStageBytes;
    if (bulk) {
      if (lane == 0) mbar_arrive_tx(bar, cnt * row_bytes);
      __syncwarp();
      if (lane < cnt)
        bulk_copy(smem_u32(stage + lane * pitch),
                  x + static_cast<size_t>(col) * k + c0, row_bytes, bar);
      if (lane != 0) mbar_arrive(bar, 1);
    } else {
      const unsigned char* xb = reinterpret_cast<const unsigned char*>(x);
      const size_t stride = static_cast<size_t>(k) * sizeof(T);
      const size_t off = static_cast<size_t>(c0) * sizeof(T);
      register_rows(stage, pitch, colsm + s * 32, cnt, xb, stride, off,
                    row_bytes / 2, lane);
      mbar_arrive(bar, 1);
    }
    fetch(t + kIdStages);  // into the slot this lane just read
  }
  async_wait<0>();
}

// A consumer warp's share of one pass: columns c0 + kCols (cw * 32 +
// lane) + [0, kCols), one 8- or 4-byte shared load a slot feeding kCols
// independent sums, the stage's rows in slot order.  ncw consumer warps
// hold columns this pass; warp 0 arrives on the empty barriers for the
// others.  A parity wait tells apart only two phases of a barrier, so no
// wait may be on a stage whose earlier use may still be pending: within a
// row the passes' active consumer warps only shrink (the last strip is the
// narrowest), rows are separated by a block barrier, and a producer waits
// for stage j's slot only after its own stage j - kProducerWarps, whose
// slot was released after stage j - kProducerWarps - kStages was
// consumed, so with kProducerWarps <= kStages the slot's use j - 2 kStages
// is done too.
template <typename T>
__device__ __forceinline__ void consume(
    int len, int c0, int w, int cw, int ncw, int rows_a_stage, int pitch,
    uint32_t it, const unsigned char* ring, const float* vals,
    uint64_t* full, uint64_t* empty, T* yrow, int lane) {
  const int S = rows_a_stage;
  const int n_stages = (len + S - 1) / S;
  const int col = (cw * 32 + lane) * kCols;
  const bool on = col < w;
  const uint32_t arrivals = cw == 0 ? 1 + kConsumerWarps - ncw : 1;
  float acc[kCols];
#pragma unroll
  for (int e = 0; e < kCols; ++e) acc[e] = 0.0f;
  for (int j = 0; j < n_stages; ++j) {
    const uint32_t s_it = it + j;
    const int s = s_it % kStages;
    mbar_wait(smem_u32(full + s), (s_it / kStages) & 1);
    const int cnt = min(S, len - j * S);
    const unsigned char* xs = ring + s * kStageBytes + col * sizeof(T);
    const float* vs = vals + s * 32;
    if (on) {
      // a stage holds at most 32 slots: all their loads start before the
      // adds that wait on them (a shallower unroll left each group's load
      // latency on the consumer's path)
#pragma unroll 32
      for (int q = 0; q < cnt; ++q) {
        float xv[kCols];
        load_vec<T, kCols>(reinterpret_cast<const T*>(xs + q * pitch), xv);
        const float a = vs[q];
#pragma unroll
        for (int e = 0; e < kCols; ++e)
          acc[e] = __fadd_rn(acc[e], __fmul_rn(a, xv[e]));
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(smem_u32(empty + s), arrivals);
  }
#pragma unroll
  for (int e = 0; e < kCols; ++e)
    if (col + e < w) store_f(yrow + c0 + col + e, acc[e]);
}

template <typename T, int VW>
__global__ void __launch_bounds__(kThreads, kMinBlocks) spmm_kernel(
    int m, int n, int k, int cap, int bulk, const int* __restrict__ nnz,
    const int* __restrict__ indptr, const int* __restrict__ indices,
    const float* __restrict__ data, const T* __restrict__ x,
    T* __restrict__ y, const int* __restrict__ counts,
    const int* __restrict__ lists, int* pops) {
  constexpr int kUnroll = VW == 1 ? 8 : 16 / VW;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* ring = smem;
  float* vals = reinterpret_cast<float*>(smem + kRingBytes);
  int* colsm = reinterpret_cast<int*>(vals + kStages * 32);
  // producer warp w's id ring: idc/idv + w * kIdStages * 32
  int* idc = colsm + kStages * 32;
  float* idv = reinterpret_cast<float*>(idc + kProducerWarps * kIdStages * 32);
  uint64_t* full = reinterpret_cast<uint64_t*>(idv + kProducerWarps *
                                               kIdStages * 32);
  uint64_t* empty = full + kStages;
  __shared__ int s_row[2];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int live = min(*nnz, cap);

  // ---- long rows: the whole block a row, longest class first ----------
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      // the producer's lanes arrive once a stage
      mbar_init(smem_u32(full + s), 32);
      mbar_init(smem_u32(empty + s), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  const int pitch =
      (min(k, kStrip) * static_cast<int>(sizeof(T)) + 15) / 16 * 16;
  const int rows_a_stage = min(32, kStageBytes / pitch);
  uint32_t it = 0;
  for (int turn = 0;; ++turn) {
    if (threadIdx.x == 0)
      s_row[turn & 1] = long_row(atomicAdd(pops, 1), m, cap, counts, lists);
    block_sync();
    const int row = s_row[turn & 1];
    if (row < 0) break;
    const int p0 = indptr[row];
    const int p1 = min(indptr[row + 1], live);
    const int n_stages = (p1 - p0 + rows_a_stage - 1) / rows_a_stage;
    for (int c0 = 0; c0 < k; c0 += kStrip) {
      const int w = min(kStrip, k - c0);
      const int cw = warp - kProducerWarps;
      if (cw < 0)
        produce<T>(p0, p1, c0, w, k, n, bulk, rows_a_stage, pitch, it, warp,
                   ring, vals, colsm, idc + warp * kIdStages * 32,
                   idv + warp * kIdStages * 32, full, empty, indices, data,
                   x, lane);
      else if (cw * 32 * kCols < w)
        consume<T>(p1 - p0, c0, w, cw, (w + 32 * kCols - 1) / (32 * kCols),
                   rows_a_stage, pitch, it, ring, vals, full, empty,
                   y + static_cast<size_t>(row) * k, lane);
      it += n_stages;
    }
  }

  // ---- warp rows: one warp a row, longest class first -----------------
  for (;;) {
    int item = 0;
    if (lane == 0) item = atomicAdd(pops + 1, 1);
    item = __shfl_sync(kFull, item, 0);
    // item -> class_chunk(c) rows of class c's list from `first`
    long long first = -1;
    int n_rows = 0;
    for (int c = kWarpClasses - 1; c >= 0 && first < 0; --c) {
      const int nc = min(counts[c], class_room(c, m, cap));
      const int per = class_chunk(c);
      const int items = (nc + per - 1) / per;
      if (item < items) {
        first = class_offset(c, m, cap) + static_cast<long long>(item) * per;
        n_rows = min(per, nc - item * per);
      }
      item -= items;
    }
    if (first < 0) break;
    // lane r holds row r of the item and its live slots [b0, b1)
    int my_row = 0, my_b0 = 0, my_b1 = 0;
    if (lane < n_rows) {
      my_row = lists[first + lane];
      my_b0 = indptr[my_row];
      my_b1 = max(min(indptr[my_row + 1], live), my_b0);
    }
    // one stream of 32-slot batches: (row r, pass c0, first slot b)
    int r = 0, c0 = 0;
    int row = __shfl_sync(kFull, my_row, 0);
    int b = __shfl_sync(kFull, my_b0, 0);
    int b1 = __shfl_sync(kFull, my_b1, 0);
    int cur_col = 0;
    float cur_val = 0.0f;
    if (b + lane < b1) {
      cur_col = min(max(indices[b + lane], 0), n - 1);
      cur_val = data[b + lane];
    }
    float acc[VW];
#pragma unroll
    for (int e = 0; e < VW; ++e) acc[e] = 0.0f;
    for (;;) {
      // where the next batch starts
      int nr = r, nc0 = c0, nb = b + 32;
      if (nb >= b1) {
        nc0 = c0 + 32 * VW;
        if (nc0 >= k) {
          nc0 = 0;
          nr = r + 1;
        }
      }
      const int nrow = __shfl_sync(kFull, my_row, nr & 31);
      const int nb0 = __shfl_sync(kFull, my_b0, nr & 31);
      const int nb1 = __shfl_sync(kFull, my_b1, nr & 31);
      if (nr != r || nc0 != c0) nb = nb0;
      int nxt_col = 0;
      float nxt_val = 0.0f;
      if (nr < n_rows && nb + lane < nb1) {
        nxt_col = min(max(indices[nb + lane], 0), n - 1);
        nxt_val = data[nb + lane];
      }
      // this batch's gathers and adds
      const int cnt = max(min(32, b1 - b), 0);
      const int cl = c0 + lane * VW;
      const bool on = cl < k;
      for (int q0 = 0; q0 < cnt; q0 += kUnroll) {
        float xv[kUnroll][VW];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int q = q0 + u;
          const int col = __shfl_sync(kFull, cur_col, q & 31);
          if (q < cnt && on) {
            load_vec<T, VW>(x + static_cast<size_t>(col) * k + cl, xv[u]);
          } else {
#pragma unroll
            for (int e = 0; e < VW; ++e) xv[u][e] = 0.0f;
          }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const float av = __shfl_sync(kFull, cur_val, (q0 + u) & 31);
          if (q0 + u < cnt) {
#pragma unroll
            for (int e = 0; e < VW; ++e)
              acc[e] = __fadd_rn(acc[e], __fmul_rn(av, xv[u][e]));
          }
        }
      }
      if (nr != r || nc0 != c0) {  // the row's pass is done
        if (on) store_vec<T, VW>(y + static_cast<size_t>(row) * k + cl, acc);
#pragma unroll
        for (int e = 0; e < VW; ++e) acc[e] = 0.0f;
      }
      if (nr >= n_rows) break;
      r = nr;
      c0 = nc0;
      b = nb;
      b1 = nb1;
      row = nrow;
      cur_col = nxt_col;
      cur_val = nxt_val;
    }
  }
}

// The instantiation for (dtype, vw) and its index; nullptr for a pair not
// built.
const void* pick(int dtype, int vw, int* index) {
  const void* fns[] = {
      reinterpret_cast<const void*>(spmm_kernel<float, 1>),
      reinterpret_cast<const void*>(spmm_kernel<float, 2>),
      reinterpret_cast<const void*>(spmm_kernel<float, 4>),
      reinterpret_cast<const void*>(spmm_kernel<__nv_bfloat16, 1>),
      reinterpret_cast<const void*>(spmm_kernel<__nv_bfloat16, 2>),
      reinterpret_cast<const void*>(spmm_kernel<__nv_bfloat16, 4>),
      reinterpret_cast<const void*>(spmm_kernel<__nv_bfloat16, 8>),
      reinterpret_cast<const void*>(spmm_kernel<__half, 1>),
      reinterpret_cast<const void*>(spmm_kernel<__half, 2>),
      reinterpret_cast<const void*>(spmm_kernel<__half, 4>),
      reinterpret_cast<const void*>(spmm_kernel<__half, 8>)};
  const int lg = vw == 1 ? 0 : vw == 2 ? 1 : vw == 4 ? 2 : vw == 8 ? 3 : 9;
  const int i = dtype == 0 ? (lg <= 2 ? lg : -1)
              : dtype == 1 || dtype == 2 ? (lg <= 3 ? 3 + 4 * (dtype - 1) + lg
                                                    : -1)
              : -1;
  if (i < 0) return nullptr;
  *index = i;
  return fns[i];
}

constexpr int kKernels = 11;
constexpr int kMaxDevices = 16;

// Blocks a multiprocessor holds of kernel `index`, and the
// multiprocessors, on the current device (queried once a device).
int resident(const void* fn, int index, int* per_sm, int* sms) {
  static int cached[kMaxDevices][kKernels + 1];
  int dev = 0;
  int err = static_cast<int>(cudaGetDevice(&dev));
  if (err) return err;
  int* c = dev < kMaxDevices ? cached[dev] : nullptr;
  if (c != nullptr && c[index] > 0 && c[kKernels] > 0) {
    *per_sm = c[index];
    *sms = c[kKernels];
    return 0;
  }
  err = static_cast<int>(cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes));
  if (err) return err;
  err = static_cast<int>(
      cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev));
  if (err) return err;
  err = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, fn, kThreads, kSmemBytes));
  if (err) return err;
  if (*per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  if (c != nullptr) {
    c[index] = *per_sm;
    c[kKernels] = *sms;
  }
  return 0;
}

}  // namespace

// The row lists (classify_kernel): counts holds kClasses zeroed counts,
// lists list_length ids, every class's room (class_offset(kClasses, m,
// cap); the caller's sum of ref.class_rooms, checked here).
extern "C" int spmm_classify(int m, int cap, long long list_length,
                             const int* nnz, const int* indptr, int* counts,
                             int* lists, void* stream) {
  if (list_length != class_offset(kClasses, m, cap))
    return static_cast<int>(cudaErrorInvalidValue);
  if (m <= 0) return 0;
  constexpr int kBlock = 256;
  classify_kernel<<<(m + kBlock - 1) / kBlock, kBlock, 0,
                    static_cast<cudaStream_t>(stream)>>>(m, cap, nnz, indptr,
                                                         counts, lists);
  return static_cast<int>(cudaGetLastError());
}

// The launch shape of the (dtype, vw) kernel on the current device: out =
// {threads a block, dynamic shared memory bytes, resident blocks an SM,
// SMs, short rows a warp pops at once, long-row threshold, ring stages,
// bytes a stage}.
extern "C" int spmm_shape(int dtype, int vw, int* out) {
  int index = 0;
  const void* fn = pick(dtype, vw, &index);
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  int per_sm = 0, sms = 0;
  const int err = resident(fn, index, &per_sm, &sms);
  if (err) return err;
  out[0] = kThreads;
  out[1] = kSmemBytes;
  out[2] = per_sm;
  out[3] = sms;
  out[4] = kChunk;
  out[5] = kLongRow;
  out[6] = kStages;
  out[7] = kStageBytes;
  return 0;
}

// y (m, k) = A (m, n; CSR with cap slots, nnz live on the device) @ x
// (n, k).  dtype: 0 float32, 1 bfloat16, 2 float16 (x and y alike); data
// is float32.  vw: X elements a lane loads at once on short rows (k a
// multiple of it, x aligned to vw elements).  bulk: 1 for bulk copies of
// long rows' X rows (x and k * sizeof(T) 16-byte aligned), 0 for the
// register path.  counts and lists: classify_kernel's for this indptr, nnz
// and cap (lists list_length long, checked); pops: two counters, zeroed
// here on the stream before the launch.  m, n, k >= 1.  One launch: the
// grid is the card's resident blocks, at most one a chunk of short rows.
extern "C" int spmm_launch(int dtype, int vw, int bulk, int m, int n, int k,
                           int cap, long long list_length, const int* nnz,
                           const int* indptr, const int* indices,
                           const float* data, const void* x, void* y,
                           const int* counts, const int* lists, int* pops,
                           void* stream) {
  int index = 0;
  const void* fn = pick(dtype, vw, &index);
  if (fn == nullptr || m < 1 || n < 1 || k < 1 ||
      list_length != class_offset(kClasses, m, cap) ||
      (bulk != 0 && bulk != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  int per_sm = 0, sms = 0;
  int err = resident(fn, index, &per_sm, &sms);
  if (err) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = static_cast<int>(cudaMemsetAsync(pops, 0, 2 * sizeof(int), s));
  if (err) return err;
  const int chunks = (m + kChunk - 1) / kChunk;
  const int grid = max(1, min(per_sm * sms, chunks));
  void* args[] = {&m, &n, &k, &cap, &bulk, &nnz, &indptr, &indices, &data,
                  &x, &y, &counts, &lists, &pops};
  err = static_cast<int>(cudaLaunchKernel(fn, dim3(grid), dim3(kThreads),
                                          args, kSmemBytes, s));
  if (err) return err;
  return static_cast<int>(cudaGetLastError());
}
