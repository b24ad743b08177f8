// Block-row hash SpGEMM over BCSR for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels numeric_call of
// repro/kernels/spgemm_bcsr/kernel.py (_numeric_kernel, _block_row_loop,
// and the _probe_scalar / _probe_vector probes it borrows from the hash
// kernel) and batched_numeric_call (_batched_numeric_kernel: numeric_call
// over the grid (members, bins) of a fleet of block-value members, which
// the reference reaches through its custom_vmap rule).
//
// What it computes, per block row i of a bin whose table holds tsz slots
// (tsz a power of two, the plan's min(bin_tsize[b], table_size)):
//   for each A block j of block row i and each B block t of block row
//   a_bcol[j], in that order, find the slot of block column b_bcol[t] in a
//   table keyed by block column -- hashed as (uint32(col) * 0x9E3779B9) &
//   (tsz - 1) with linear probing, or over tsz / 8 chunks of 8 slots when
//   vector -- and add the tile product A_blk[j] (bm x bk) @ B_blk[t]
//   (bk x bn) into the slot's (bm x bn) float32 accumulator; then flush
//   the occupied slots in table order to out_bcol / out_blk at
//   indptr_c[i] + cnt.  Block columns come out unsorted (C8).
//
// Design on this card:
//   * The TPU grid walks 8 equal-flop bins in order on one core.  Here a
//     launch covers one bin and one thread block owns one block row at a
//     time, so the rows of a bin run concurrently across the 132 SMs.
//   * One thread per output lane (r, c) of the tile up to 1,024 lanes.
//     A larger tile (kMulti) gives each of the 1,024 threads the lanes
//     tid, tid + 1024, ... below bm * bn, so any tile size runs; the
//     one-lane variant keeps its A row pointer out of the pair loop.
//   * Thread 0 probes the row's keys alone, in the reference's (j, t)
//     order, and records each pair's slot (and whether the pair opened
//     it) in shared memory, a chunk of B blocks at a time; the other
//     threads stage the chunk's block columns first.  Serial inserts in
//     the reference's order give the TPU kernel's table layout, so the
//     flushed block-column order is the reference's, and need no atomics.
//   * Every lane then folds the chunk's pairs into its own accumulator
//     element in the same order: sum_k __fmul_rn(a[r][k], b[k][c]) with
//     __fadd_rn over k in order, then __fadd_rn into the accumulator.
//     CUDA-core FP32 only: no FMA, no mma, no TF32.  Sums are
//     deterministic and equal the plain version's on the CPU.
//   * The pair that opens a slot adds into 0 instead of a reset tile, so
//     only the keys are reset per row, not tsz tiles.
//   * Tables of up to the wrapper's shared-memory budget (keys + tiles)
//     live in dynamic shared memory; larger ones in a per-block table in
//     global memory (workspace from the caller), each block looping over
//     many rows.
//   * The output is zeroed by the caller before launch: blocks run in no
//     order, so nothing like the TPU kernel's "zero at bin 0" is possible.
//   * The flush counts occupied slots with __ballot_sync/__popc and a
//     block-wide prefix; a count that disagrees with indptr_c, or a probe
//     that finds the table full, adds one to errors[0] and nothing is
//     written outside the row's range.
//   * Batched (a fleet under torch.func.vmap): one launch per bin index,
//     blockIdx.y the member, the x blocks striding over that member's
//     block rows of the bin.  Every array, the schedule included, takes a
//     member stride, 0 for an array all members share, so a shared
//     operand (B's tiles, the plan's integer arrays) is read in place and
//     never copied per member.  Each member probes its own table size;
//     dynamic shared memory is sized for the largest table of the launch
//     that fits, and members with larger tables use a global workspace
//     with a table per member and x block (the TPU grid runs in order and
//     shares one bank; here blocks run at once).  The row body is the
//     single-product kernel's code.
//
// Bound: memory.  The least traffic reads A's and B's blocks once, writes
// C's blocks once, plus the index arrays; the 2 * bm * bk * bn operations
// per block pair are far below the FP32 rate on 8x8 tiles.
//
// Plain C interface, loaded with ctypes; every launch reports
// cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kEmpty = -1;
constexpr unsigned kHashConst = 0x9E3779B9u;  // == -1640531527 mod 2^32
constexpr int kChunk = 8;
constexpr int kPairs = 256;      // B blocks staged per round
constexpr int kMaxThreads = 1024;

__device__ __forceinline__ unsigned hash_of(int col, unsigned mask) {
  return (static_cast<unsigned>(col) * kHashConst) & mask;
}

// Linear probing (Fig. 8a) by one thread.  Returns the slot that holds
// col (claiming the first EMPTY one on the way), or -1 when every slot
// holds another key.
__device__ __forceinline__ int probe_scalar(int* keys, int tsz, int col,
                                            int* opened) {
  const unsigned mask = static_cast<unsigned>(tsz) - 1u;
  unsigned h = hash_of(col, mask);
  *opened = 0;
  for (int step = 0; step < tsz; ++step) {
    const int k = keys[h];
    if (k == col) return static_cast<int>(h);
    if (k == kEmpty) {
      keys[h] = col;
      *opened = 1;
      return static_cast<int>(h);
    }
    h = (h + 1u) & mask;
  }
  return -1;
}

// Chunked probing (Fig. 8b) by one thread: the hash names a chunk of
// kChunk slots; the first lane holding col wins, else the first EMPTY
// lane, else the next chunk.
__device__ __forceinline__ int probe_vector(int* keys, int tsz, int col,
                                            int* opened) {
  const int n_chunks = tsz / kChunk;
  const unsigned cmask = static_cast<unsigned>(n_chunks) - 1u;
  unsigned c = hash_of(col, cmask);
  *opened = 0;
  for (int step = 0; step < n_chunks; ++step) {
    const int base = static_cast<int>(c) * kChunk;
    int empty = -1;
    for (int l = 0; l < kChunk; ++l) {
      const int k = keys[base + l];
      if (k == col) return base + l;
      if (k == kEmpty && empty < 0) empty = l;
    }
    if (empty >= 0) {
      keys[base + empty] = col;
      *opened = 1;
      return base + empty;
    }
    c = (c + 1u) & cmask;
  }
  return -1;
}

// Folds a chunk's n pairs into lane l's accumulators, in pair order:
// sum_k __fmul_rn(a_row[k], b_lane[k * bn]) with __fadd_rn over k, then
// __fadd_rn into the pair's slot (into 0 for the pair that opened it).
__device__ __forceinline__ void fold_lane(int l, const float* a_row,
                                          const float* b_lane, int n, int bk,
                                          int bn, int tile, const int* s_slot,
                                          const int* s_open, float* acc) {
  for (int q = 0; q < n; ++q) {
    const int slot = s_slot[q];
    if (slot < 0) continue;
    const float* b_col = b_lane + static_cast<size_t>(q) * bk * bn;
    float sum = __fmul_rn(a_row[0], b_col[0]);
    for (int kk = 1; kk < bk; ++kk)
      sum = __fadd_rn(sum, __fmul_rn(a_row[kk], b_col[kk * bn]));
    float* dst = acc + static_cast<size_t>(slot) * tile + l;
    *dst = __fadd_rn(s_open[q] ? 0.0f : *dst, sum);
  }
}

// Block row `row` of one product: probe its block pairs into the table
// (keys, acc), fold their tile products, flush the occupied slots to
// out_bcol / out_blk at indptr_c[row].  Every thread of the block calls it,
// with its output lane (r, c) of the tile, (0, 0) past the tile.  The
// callers compute the lane once, outside their row loops: computed per row
// in here, it made the single-product kernel slower on the card.
template <bool kVector, bool kMulti>
__device__ __forceinline__ void bcsr_row(
    int row, int tsz, int bcap_c, int bm, int bk, int bn, int r, int c,
    const int* __restrict__ indptr_a, const int* __restrict__ a_bcol,
    const float* __restrict__ a_blk, const int* __restrict__ indptr_b,
    const int* __restrict__ b_bcol, const float* __restrict__ b_blk,
    const int* __restrict__ indptr_c, int* __restrict__ out_bcol,
    float* __restrict__ out_blk, int* __restrict__ errors, int* keys,
    float* acc) {
  __shared__ int s_col[kPairs];
  __shared__ int s_slot[kPairs];
  __shared__ int s_open[kPairs];
  __shared__ int s_flush[kMaxThreads];
  __shared__ int s_warp[32];

  const int tile = bm * bn;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const bool active = tid < tile;

  // Fig. 7: the table is reinitialised for each row, not reallocated;
  // the tiles need no reset (the opening pair adds into 0)
  for (int s = tid; s < tsz; s += blockDim.x) keys[s] = kEmpty;
  __syncthreads();

  const int a1 = indptr_a[row + 1];
  for (int j = indptr_a[row]; j < a1; ++j) {
    const int k = a_bcol[j];
    const int t1 = indptr_b[k + 1];
    const float* a_row = a_blk + (static_cast<size_t>(j) * bm + r) * bk;
    for (int t0 = indptr_b[k]; t0 < t1; t0 += kPairs) {
      const int n = min(kPairs, t1 - t0);
      for (int q = tid; q < n; q += blockDim.x) s_col[q] = b_bcol[t0 + q];
      __syncthreads();
      if (tid == 0) {
        for (int q = 0; q < n; ++q) {
          int opened;
          const int slot = kVector ? probe_vector(keys, tsz, s_col[q], &opened)
                                   : probe_scalar(keys, tsz, s_col[q], &opened);
          if (slot < 0) atomicAdd(errors, 1);
          s_slot[q] = slot;
          s_open[q] = opened;
        }
      }
      __syncthreads();
      const float* b_chunk = b_blk + static_cast<size_t>(t0) * bk * bn;
      if constexpr (kMulti) {
        for (int l = tid; l < tile; l += blockDim.x)
          fold_lane(l, a_blk + (static_cast<size_t>(j) * bm + l / bn) * bk,
                    b_chunk + l % bn, n, bk, bn, tile, s_slot, s_open, acc);
      } else if (active) {
        fold_lane(tid, a_row, b_chunk + c, n, bk, bn, tile, s_slot, s_open,
                  acc);
      }
      __syncthreads();
    }
  }

  // flush in table order: unsorted block columns (C8)
  const int base = indptr_c[row];
  const int want = indptr_c[row + 1] - base;
  int running = 0;
  for (int s0 = 0; s0 < tsz; s0 += blockDim.x) {
    const int s = s0 + tid;
    const int key = s < tsz ? keys[s] : kEmpty;
    const bool occupied = key != kEmpty;
    const unsigned ballot = __ballot_sync(0xffffffffu, occupied);
    if (lane == 0) s_warp[warp] = __popc(ballot);
    __syncthreads();
    int before = 0;
    int total = 0;
    for (int w = 0; w < nwarps; ++w) {
      if (w < warp) before += s_warp[w];
      total += s_warp[w];
    }
    if (occupied) {
      const int e = before + __popc(ballot & ((1u << lane) - 1u));
      s_flush[e] = s;
      const int pos = running + e;
      if (pos < want && base + pos < bcap_c) out_bcol[base + pos] = key;
    }
    __syncthreads();
    for (int e = 0; e < total; ++e) {
      const int pos = running + e;
      if (pos >= want || base + pos >= bcap_c) break;
      for (int l = tid; l < tile; l += blockDim.x)
        out_blk[static_cast<size_t>(base + pos) * tile + l] =
            acc[static_cast<size_t>(s_flush[e]) * tile + l];
    }
    running += total;
    __syncthreads();
  }
  if (tid == 0 && running != want) atomicAdd(errors, 1);
  __syncthreads();
}

template <bool kVector, bool kMulti>
__global__ void bcsr_rows_kernel(
    int row_begin, int row_end, int tsz, int bcap_c, int bm, int bk, int bn,
    const int* __restrict__ indptr_a, const int* __restrict__ a_bcol,
    const float* __restrict__ a_blk, const int* __restrict__ indptr_b,
    const int* __restrict__ b_bcol, const float* __restrict__ b_blk,
    const int* __restrict__ indptr_c, int* __restrict__ out_bcol,
    float* __restrict__ out_blk, int* __restrict__ errors, int* ws_keys,
    float* ws_acc) {
  extern __shared__ int smem[];
  const int tile = bm * bn;
  int* keys;
  float* acc;
  if (ws_keys != nullptr) {
    keys = ws_keys + static_cast<size_t>(blockIdx.x) * tsz;
    acc = ws_acc + static_cast<size_t>(blockIdx.x) * tsz * tile;
  } else {
    keys = smem;
    acc = reinterpret_cast<float*>(smem + tsz);
  }
  const int r = threadIdx.x < tile ? threadIdx.x / bn : 0;
  const int c = threadIdx.x < tile ? threadIdx.x % bn : 0;
  for (int row = row_begin + blockIdx.x; row < row_end; row += gridDim.x)
    bcsr_row<kVector, kMulti>(row, tsz, bcap_c, bm, bk, bn, r, c, indptr_a,
                              a_bcol, a_blk, indptr_b, b_bcol, b_blk,
                              indptr_c, out_bcol, out_blk, errors, keys, acc);
}

// The batched grid, for one bin index `bin`: blockIdx.y is the fleet
// member e, and the x blocks stride over e's block rows
// [offsets[e][bin], offsets[e][bin + 1]).  Member e's arrays start at
// base + e * stride; stride 0 shares one array among all members.  Its
// table holds min(bin_tsize[e][bin], table_size) slots: in dynamic shared
// memory when that fits smem_slots, else in the block's slice of the
// global workspace (ws_tsz slots per member and x block).  A schedule the
// launch cannot hold (rows past n_rows, a table that is not a power of two
// or fits neither place) adds one to errors and runs nothing.
template <bool kVector, bool kMulti>
__global__ void bcsr_rows_batched_kernel(
    int bin, int n_rows, int table_size, int smem_slots, int ws_tsz,
    int bcap_c, int bm, int bk, int bn, const int* __restrict__ offsets,
    long long s_off, const int* __restrict__ bin_tsize, long long s_bt,
    const int* indptr_a, long long s_ia, const int* a_bcol, long long s_ac,
    const float* a_blk, long long s_ab, const int* indptr_b, long long s_ib,
    const int* b_bcol, long long s_bc, const float* b_blk, long long s_bb,
    const int* indptr_c, long long s_ic, int* out_bcol, float* out_blk,
    int* errors, int* ws_keys, float* ws_acc) {
  extern __shared__ int smem[];
  const long long e = blockIdx.y;
  const int r0 = offsets[e * s_off + bin];
  const int r1 = offsets[e * s_off + bin + 1];
  if (r0 >= r1) return;
  const int tsz = min(bin_tsize[e * s_bt + bin], table_size);
  const bool in_smem = tsz <= smem_slots;
  if (r0 < 0 || r1 > n_rows || tsz < 1 || (tsz & (tsz - 1)) ||
      (kVector && tsz < kChunk) || (!in_smem && tsz > ws_tsz)) {
    if (threadIdx.x == 0 && blockIdx.x == 0) atomicAdd(errors, 1);
    return;
  }
  const long long tile = static_cast<long long>(bm) * bn;
  int* keys;
  float* acc;
  if (in_smem) {
    keys = smem;
    acc = reinterpret_cast<float*>(smem + tsz);
  } else {
    const size_t slot =
        (static_cast<size_t>(e) * gridDim.x + blockIdx.x) * ws_tsz;
    keys = ws_keys + slot;
    acc = ws_acc + slot * tile;
  }
  const int r = threadIdx.x < tile ? threadIdx.x / bn : 0;
  const int c = threadIdx.x < tile ? threadIdx.x % bn : 0;
  for (int row = r0 + blockIdx.x; row < r1; row += gridDim.x)
    bcsr_row<kVector, kMulti>(
        row, tsz, bcap_c, bm, bk, bn, r, c, indptr_a + e * s_ia,
        a_bcol + e * s_ac, a_blk + e * s_ab, indptr_b + e * s_ib,
        b_bcol + e * s_bc, b_blk + e * s_bb, indptr_c + e * s_ic,
        out_bcol + e * bcap_c, out_blk + e * bcap_c * tile, errors, keys,
        acc);
}

template <bool kVector, bool kMulti>
int launch(int row_begin, int row_end, int tsz, int bcap_c, int bm, int bk,
           int bn, int grid, int block, int smem_bytes, const int* indptr_a,
           const int* a_bcol, const float* a_blk, const int* indptr_b,
           const int* b_bcol, const float* b_blk, const int* indptr_c,
           int* out_bcol, float* out_blk, int* errors, int* ws_keys,
           float* ws_acc, cudaStream_t stream) {
  auto kernel = bcsr_rows_kernel<kVector, kMulti>;
  if (smem_bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<grid, block, smem_bytes, stream>>>(
      row_begin, row_end, tsz, bcap_c, bm, bk, bn, indptr_a, a_bcol, a_blk,
      indptr_b, b_bcol, b_blk, indptr_c, out_bcol, out_blk, errors, ws_keys,
      ws_acc);
  return static_cast<int>(cudaGetLastError());
}

template <bool kVector, bool kMulti>
int launch_batched(int bin, int n_rows, int table_size, int smem_slots,
                   int ws_tsz, int bcap_c, int bm, int bk, int bn, int grid_x,
                   int n_members, int block, int smem_bytes,
                   const int* offsets, long long s_off, const int* bin_tsize,
                   long long s_bt, const int* indptr_a, long long s_ia,
                   const int* a_bcol, long long s_ac, const float* a_blk,
                   long long s_ab, const int* indptr_b, long long s_ib,
                   const int* b_bcol, long long s_bc, const float* b_blk,
                   long long s_bb, const int* indptr_c, long long s_ic,
                   int* out_bcol, float* out_blk, int* errors, int* ws_keys,
                   float* ws_acc, cudaStream_t stream) {
  auto kernel = bcsr_rows_batched_kernel<kVector, kMulti>;
  if (smem_bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<dim3(grid_x, n_members), block, smem_bytes, stream>>>(
      bin, n_rows, table_size, smem_slots, ws_tsz, bcap_c, bm, bk, bn,
      offsets, s_off, bin_tsize, s_bt, indptr_a, s_ia, a_bcol, s_ac, a_blk,
      s_ab, indptr_b, s_ib, b_bcol, s_bc, b_blk, s_bb, indptr_c, s_ic,
      out_bcol, out_blk, errors, ws_keys, ws_acc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One launch over block rows [row_begin, row_end) of one bin; writes
// nothing at or past bcap_c.  block (threads) is a multiple of 32, at
// most 1024; each thread owns every block-th lane of the bm * bn tile.
// ws_keys/ws_acc null: the table lives in shared memory (smem_bytes =
// tsz * (4 + 4 * bm * bn)); else a table of tsz slots per thread block in
// global memory.
extern "C" int spgemm_bcsr_launch(
    int vector, int row_begin, int row_end, int tsz, int bcap_c, int bm,
    int bk, int bn, int grid, int block, int smem_bytes, const int* indptr_a,
    const int* a_bcol, const float* a_blk, const int* indptr_b,
    const int* b_bcol, const float* b_blk, const int* indptr_c,
    int* out_bcol, float* out_blk, int* errors, int* ws_keys, float* ws_acc,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto fn = launch<false, false>;
  if (bm * bn > block)
    fn = vector ? launch<true, true> : launch<false, true>;
  else if (vector)
    fn = launch<true, false>;
  return fn(row_begin, row_end, tsz, bcap_c, bm, bk, bn, grid, block,
            smem_bytes, indptr_a, a_bcol, a_blk, indptr_b, b_bcol, b_blk,
            indptr_c, out_bcol, out_blk, errors, ws_keys, ws_acc, s);
}

// The batched numeric phase for bin index `bin` of every fleet member: a
// grid of (grid_x, n_members) blocks of `block` threads.  Each array takes
// a member stride in elements (0: shared by all members): offsets rows of
// n_bins + 1, bin_tsize rows of n_bins, the operands as for
// spgemm_bcsr_launch.  out_bcol/out_blk are (n_members, bcap_c[, bm, bn]),
// zeroed by the caller.  smem_bytes = smem_slots * (4 + 4 * bm * bn);
// ws_keys/ws_acc hold grid_x * n_members * ws_tsz slots (null when ws_tsz
// is 0).
extern "C" int spgemm_bcsr_batched_launch(
    int vector, int bin, int n_rows, int table_size, int smem_slots,
    int ws_tsz, int bcap_c, int bm, int bk, int bn, int grid_x,
    int n_members, int block, int smem_bytes, const int* offsets,
    long long s_off, const int* bin_tsize, long long s_bt,
    const int* indptr_a, long long s_ia, const int* a_bcol, long long s_ac,
    const float* a_blk, long long s_ab, const int* indptr_b, long long s_ib,
    const int* b_bcol, long long s_bc, const float* b_blk, long long s_bb,
    const int* indptr_c, long long s_ic, int* out_bcol, float* out_blk,
    int* errors, int* ws_keys, float* ws_acc, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto fn = launch_batched<false, false>;
  if (bm * bn > block)
    fn = vector ? launch_batched<true, true> : launch_batched<false, true>;
  else if (vector)
    fn = launch_batched<true, false>;
  return fn(bin, n_rows, table_size, smem_slots, ws_tsz, bcap_c, bm, bk, bn,
            grid_x, n_members, block, smem_bytes, offsets, s_off, bin_tsize,
            s_bt, indptr_a, s_ia, a_bcol, s_ac, a_blk, s_ab, indptr_b, s_ib,
            b_bcol, s_bc, b_blk, s_bb, indptr_c, s_ic, out_bcol, out_blk,
            errors, ws_keys, ws_acc, s);
}
