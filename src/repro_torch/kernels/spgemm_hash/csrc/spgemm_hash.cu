// Hash-accumulator SpGEMM kernels for Hopper (sm_90a): paper Figs. 7 and 8.
//
// Replaces the Pallas TPU kernels of repro/kernels/spgemm_hash/kernel.py:
//   numeric_call  (_numeric_kernel, _row_loop(numeric=True), _probe_scalar)
//   symbolic_call (_symbolic_kernel)
//   _probe_vector (the hash_vector mode of both)
//   batched_symbolic_call (_batched_symbolic_kernel) and
//     batched_numeric_call (_batched_numeric_kernel): symbolic_call and
//     numeric_call over the grid (members, bins) of a fleet of products
//
// What each computes, per output row i of a bin whose table holds tsz slots
// (tsz a power of two, the plan's min(bin_tsize[b], table_size)):
//   insert every column k of B's rows selected by A's row i into a table
//   keyed by column, hashed as (uint32(col) * 0x9E3779B9) & (tsz - 1)
//   (the TPU kernel's int32 product by -1640531527: same bits), probing
//   linearly; symbolic writes the number of distinct columns, numeric adds
//   a_ij * b_jk into the slot and flushes the occupied slots, unsorted, to
//   out[indptr_c[i] + cnt].
//
// Design on this card:
//   * The TPU grid walks 8 equal-flop bins in order on one core.  Here one
//     thread block owns one row at a time, and a launch covers one bin, so
//     every row of a bin runs concurrently across the 132 SMs.
//   * Inside the block, warp w takes A entries a0+w, a0+w+nwarps, ...; its
//     lanes take that B row's entries.  Inserts race, so keys go in with
//     atomicCAS and values with atomicAdd: the column order of a row is
//     free (the contract is "some order") and float sums may round in
//     another order, within 1 ulp per product (exact on dyadic values).
//     Products are rounded before the add (__fmul_rn): no FMA, no TF32.
//   * Tables of up to 16,384 slots (128 KB of key + value) live in dynamic
//     shared memory; larger bins use a per-block table in global memory
//     (workspace allocated by the caller), and the launch loops each block
//     over many rows.
//   * The output is zeroed by the caller before launch: blocks run in no
//     order, so nothing like the TPU kernel's "zero at bin 0" is possible.
//   * The flush counts each row's occupied slots with __ballot_sync/__popc
//     and a block-wide prefix.  A count that disagrees with indptr_c, or a
//     probe that runs past a full table, adds one to errors[0] and writes
//     nothing outside the row.
//   * Vector mode (Fig. 8b): groups of 8 lanes probe a chunk of 8 slots
//     together; __ballot_sync + __ffs give the first lane holding the key,
//     else the first EMPTY lane (claimed with atomicCAS), else the next
//     chunk -- the TPU kernel's CHUNK = 8, so any plan table (>= 8 slots)
//     is valid.
//   * Batched (a fleet of products that share static capacities), both
//     phases: one launch per bin index, blockIdx.y the member, one x block
//     per row of the member with the most rows in the bin while the tables
//     fit in shared memory (blocks that walk many work items ran the PB
//     batched kernels 2x slower).  Every array argument, the schedule
//     included, takes a member stride, 0 for one all members share, so a
//     shared B or a plan's shared bins are read in place and never copied
//     per member.  Each member probes its own table size, as the TPU
//     kernel does; dynamic shared memory is sized for the largest table of
//     the launch that fits, and members with larger tables use the global
//     workspace.  The row body (hash_row) is the same code as the
//     single-product kernel's.
//
// Bound: memory.  Each product reads one B index and value and does one
// probe and one atomic in the table; the output is written once.  The
// least time is the bytes of A, B's touched entries and C over HBM rate.
//
// Plain C interface, loaded with ctypes; every launch reports
// cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kEmpty = -1;
constexpr unsigned kHashConst = 0x9E3779B9u;  // == -1640531527 mod 2^32
constexpr int kChunk = 8;

__device__ __forceinline__ unsigned hash_of(int col, unsigned mask) {
  return (static_cast<unsigned>(col) * kHashConst) & mask;
}

// Linear probing (Fig. 8a).  Returns the slot that holds col (claiming an
// EMPTY one if needed), or -1 when every slot holds another key.
__device__ __forceinline__ int insert_scalar(int* keys, int tsz, int col,
                                             int* inserted) {
  const unsigned mask = static_cast<unsigned>(tsz) - 1u;
  volatile int* vkeys = keys;
  unsigned h = hash_of(col, mask);
  *inserted = 0;
  for (int step = 0; step < tsz; ++step) {
    const int k = vkeys[h];
    if (k == col) return static_cast<int>(h);
    if (k == kEmpty) {
      const int old = atomicCAS(keys + h, kEmpty, col);
      if (old == kEmpty) {
        *inserted = 1;
        return static_cast<int>(h);
      }
      if (old == col) return static_cast<int>(h);
    }
    h = (h + 1u) & mask;
  }
  return -1;
}

// Chunked probing (Fig. 8b) by the 8 lanes of gmask, all holding col.
// Every lane returns the same slot; *inserted is 1 on one lane when the
// group claimed a new slot.
__device__ __forceinline__ int insert_vector(int* keys, int tsz, int col,
                                             unsigned gmask, int lane8,
                                             int* inserted) {
  const unsigned cmask = static_cast<unsigned>(tsz / kChunk) - 1u;
  const int base_lane = __ffs(gmask) - 1;
  volatile int* vkeys = keys;
  unsigned c = hash_of(col, cmask);
  *inserted = 0;
  // each step moves to the next chunk or follows a slot that another key
  // just took, so tsz / kChunk + tsz steps visit everything
  const int max_steps = tsz / kChunk + tsz + 1;
  for (int step = 0; step < max_steps; ++step) {
    const int k = vkeys[c * kChunk + lane8];
    const unsigned hit = (__ballot_sync(gmask, k == col) >> base_lane) & 0xffu;
    if (hit) return static_cast<int>(c * kChunk) + __ffs(hit) - 1;
    const unsigned empty =
        (__ballot_sync(gmask, k == kEmpty) >> base_lane) & 0xffu;
    if (!empty) {
      c = (c + 1u) & cmask;
      continue;
    }
    const int first = __ffs(empty) - 1;
    const int slot = static_cast<int>(c * kChunk) + first;
    int old = 0;
    if (lane8 == first) old = atomicCAS(keys + slot, kEmpty, col);
    old = __shfl_sync(gmask, old, base_lane + first);
    if (old == kEmpty) {
      *inserted = (lane8 == first);
      return slot;
    }
    if (old == col) return slot;
    // another key took the slot: read the same chunk again
  }
  return -1;
}

// One output row, by every thread of the block: fill the row's table of
// tsz slots (reset first: Fig. 7 reinitialises the table per row, it does
// not reallocate it), then write its count (symbolic) or flush it to
// out[indptr_c[row] ...] (numeric).  s_count and s_warp are the block's
// shared scratch.
template <bool kNumeric, bool kVector>
__device__ __forceinline__ void hash_row(
    int row, int tsz, int cap_c, int* keys, float* vals,
    const int* __restrict__ indptr_a, const int* __restrict__ a_idx,
    const float* __restrict__ a_val, const int* __restrict__ indptr_b,
    const int* __restrict__ b_idx, const float* __restrict__ b_val,
    const int* __restrict__ indptr_c, int* __restrict__ out_cols,
    float* __restrict__ out_vals, int* __restrict__ row_nnz,
    int* __restrict__ errors, int* s_count, int* s_warp) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;

  for (int s = tid; s < tsz; s += blockDim.x) {
    keys[s] = kEmpty;
    if (kNumeric) vals[s] = 0.0f;
  }
  if (tid == 0) *s_count = 0;
  __syncthreads();

  int mine = 0;
  const int a1 = indptr_a[row + 1];
  for (int j = indptr_a[row] + warp; j < a1; j += nwarps) {
    const int k = a_idx[j];
    const float av = kNumeric ? a_val[j] : 0.0f;
    const int b1 = indptr_b[k + 1];
    if (kVector) {
      const int lane8 = lane & 7;
      const int grp = lane >> 3;
      const unsigned gmask = 0xffu << (grp * 8);
      for (int t = indptr_b[k] + grp; t < b1; t += 4) {
        int ins;
        const int slot = insert_vector(keys, tsz, b_idx[t], gmask, lane8,
                                       &ins);
        if (slot < 0) {
          if (lane8 == 0) atomicAdd(errors, 1);
          continue;
        }
        mine += ins;
        if (kNumeric && lane8 == 0)
          atomicAdd(vals + slot, __fmul_rn(av, b_val[t]));
      }
    } else {
      for (int t = indptr_b[k] + lane; t < b1; t += 32) {
        int ins;
        const int slot = insert_scalar(keys, tsz, b_idx[t], &ins);
        if (slot < 0) {
          atomicAdd(errors, 1);
          continue;
        }
        mine += ins;
        if (kNumeric) atomicAdd(vals + slot, __fmul_rn(av, b_val[t]));
      }
    }
  }
  if (mine) atomicAdd(s_count, mine);
  __syncthreads();
  const int count = *s_count;

  if (!kNumeric) {
    if (tid == 0) row_nnz[row] = count;
  } else {
    // flush in table order: unsorted columns (C8)
    const int base = indptr_c[row];
    const int want = indptr_c[row + 1] - base;
    // the table was filled by atomics: read it past any stale L1 line
    volatile const int* vkeys = keys;
    volatile const float* vvals = vals;
    int running = 0;
    for (int s0 = 0; s0 < tsz; s0 += blockDim.x) {
      const int s = s0 + tid;
      const int key = s < tsz ? vkeys[s] : kEmpty;
      const bool occupied = key != kEmpty;
      const unsigned ballot = __ballot_sync(0xffffffffu, occupied);
      if (lane == 0) s_warp[warp] = __popc(ballot);
      __syncthreads();
      int before = running;
      int total = 0;
      for (int w = 0; w < nwarps; ++w) {
        if (w < warp) before += s_warp[w];
        total += s_warp[w];
      }
      if (occupied) {
        const int pos = before + __popc(ballot & ((1u << lane) - 1u));
        if (pos < want && base + pos < cap_c) {
          out_cols[base + pos] = key;
          out_vals[base + pos] = vvals[s];
        }
      }
      running += total;
      __syncthreads();
    }
    if (tid == 0 && (running != want || count != want)) atomicAdd(errors, 1);
  }
  __syncthreads();
}

template <bool kNumeric, bool kVector>
__global__ void hash_rows_kernel(
    int row_begin, int row_end, int tsz, int cap_c,
    const int* __restrict__ indptr_a, const int* __restrict__ a_idx,
    const float* __restrict__ a_val, const int* __restrict__ indptr_b,
    const int* __restrict__ b_idx, const float* __restrict__ b_val,
    const int* __restrict__ indptr_c, int* __restrict__ out_cols,
    float* __restrict__ out_vals, int* __restrict__ row_nnz,
    int* __restrict__ errors, int* ws_keys, float* ws_vals) {
  extern __shared__ int smem[];
  __shared__ int s_count;
  __shared__ int s_warp[32];
  int* keys;
  float* vals = nullptr;
  if (ws_keys != nullptr) {
    keys = ws_keys + static_cast<size_t>(blockIdx.x) * tsz;
    if (kNumeric) vals = ws_vals + static_cast<size_t>(blockIdx.x) * tsz;
  } else {
    keys = smem;
    if (kNumeric) vals = reinterpret_cast<float*>(smem + tsz);
  }
  for (int row = row_begin + blockIdx.x; row < row_end; row += gridDim.x)
    hash_row<kNumeric, kVector>(row, tsz, cap_c, keys, vals, indptr_a, a_idx,
                                a_val, indptr_b, b_idx, b_val, indptr_c,
                                out_cols, out_vals, row_nnz, errors, &s_count,
                                s_warp);
}

// The batched grid of one phase (kNumeric: numeric, else symbolic) for
// one bin index `bin`: blockIdx.y is the fleet member e, and the x blocks
// stride over e's rows [offsets[e][bin], offsets[e][bin + 1]).  Member e's
// arrays start at base + e * stride; stride 0 shares one array among all
// members (a plan's schedule is shared by every member of a value fleet).
// Its table holds min(bin_tsize[e][bin], table_size) slots: in dynamic
// shared memory when that fits smem_slots, else in the block's slice of
// the global workspace (ws_tsz slots per member and x block).  The
// symbolic phase writes row_nnz[e * n_rows + row], the numeric phase
// out_cols/out_vals[e * cap_c + ...].  A schedule the launch cannot hold
// (rows past n_rows, a table that is not a power of two or fits neither
// place) adds one to errors and runs nothing.
template <bool kNumeric, bool kVector>
__global__ void hash_rows_batched_kernel(
    int bin, int n_rows, int table_size, int smem_slots, int ws_tsz,
    int cap_c, const int* __restrict__ offsets, long long s_off,
    const int* __restrict__ bin_tsize, long long s_bt, const int* indptr_a,
    long long s_ia, const int* a_idx, long long s_ai, const float* a_val,
    long long s_av, const int* indptr_b, long long s_ib, const int* b_idx,
    long long s_bi, const float* b_val, long long s_bv, const int* indptr_c,
    long long s_ic, int* out_cols, float* out_vals, int* row_nnz,
    int* errors, int* ws_keys, float* ws_vals) {
  extern __shared__ int smem[];
  __shared__ int s_count;
  __shared__ int s_warp[32];
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
  int* keys;
  float* vals = nullptr;
  if (in_smem) {
    keys = smem;
    if (kNumeric) vals = reinterpret_cast<float*>(smem + tsz);
  } else {
    const size_t slot =
        (static_cast<size_t>(e) * gridDim.x + blockIdx.x) * ws_tsz;
    keys = ws_keys + slot;
    if (kNumeric) vals = ws_vals + slot;
  }
  const int* ic = kNumeric ? indptr_c + e * s_ic : nullptr;
  int* oc = kNumeric ? out_cols + e * cap_c : nullptr;
  float* ov = kNumeric ? out_vals + e * cap_c : nullptr;
  int* rn = kNumeric ? nullptr : row_nnz + e * n_rows;
  for (int row = r0 + blockIdx.x; row < r1; row += gridDim.x)
    hash_row<kNumeric, kVector>(
        row, tsz, cap_c, keys, vals, indptr_a + e * s_ia, a_idx + e * s_ai,
        a_val + e * s_av, indptr_b + e * s_ib, b_idx + e * s_bi,
        b_val + e * s_bv, ic, oc, ov, rn, errors, &s_count, s_warp);
}

template <bool kNumeric, bool kVector>
int launch(int row_begin, int row_end, int tsz, int cap_c, int grid,
           int block, int smem_bytes, const int* indptr_a, const int* a_idx,
           const float* a_val, const int* indptr_b, const int* b_idx,
           const float* b_val, const int* indptr_c, int* out_cols,
           float* out_vals, int* row_nnz, int* errors, int* ws_keys,
           float* ws_vals, cudaStream_t stream) {
  auto kernel = hash_rows_kernel<kNumeric, kVector>;
  if (smem_bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<grid, block, smem_bytes, stream>>>(
      row_begin, row_end, tsz, cap_c, indptr_a, a_idx, a_val, indptr_b, b_idx,
      b_val, indptr_c, out_cols, out_vals, row_nnz, errors, ws_keys, ws_vals);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One launch over rows [row_begin, row_end) of one bin.  numeric = 0 runs
// the symbolic phase (writes row_nnz; cap_c/indptr_c/out_* unused), 1 the
// numeric phase, which writes nothing at or past cap_c.  ws_keys/ws_vals
// null: tables in shared memory (smem_bytes = tsz * 4 or 8); else a table
// of tsz slots per block in global memory.
extern "C" int spgemm_hash_launch(
    int numeric, int vector, int row_begin, int row_end, int tsz, int cap_c,
    int grid, int block, int smem_bytes, const int* indptr_a, const int* a_idx,
    const float* a_val, const int* indptr_b, const int* b_idx,
    const float* b_val, const int* indptr_c, int* out_cols, float* out_vals,
    int* row_nnz, int* errors, int* ws_keys, float* ws_vals, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (numeric) {
    if (vector)
      return launch<true, true>(row_begin, row_end, tsz, cap_c, grid, block,
                                smem_bytes, indptr_a, a_idx, a_val, indptr_b,
                                b_idx, b_val, indptr_c, out_cols, out_vals,
                                row_nnz, errors, ws_keys, ws_vals, s);
    return launch<true, false>(row_begin, row_end, tsz, cap_c, grid, block,
                               smem_bytes, indptr_a, a_idx, a_val, indptr_b,
                               b_idx, b_val, indptr_c, out_cols, out_vals,
                               row_nnz, errors, ws_keys, ws_vals, s);
  }
  if (vector)
    return launch<false, true>(row_begin, row_end, tsz, cap_c, grid, block,
                               smem_bytes, indptr_a, a_idx, a_val, indptr_b,
                               b_idx, b_val, indptr_c, out_cols, out_vals,
                               row_nnz, errors, ws_keys, ws_vals, s);
  return launch<false, false>(row_begin, row_end, tsz, cap_c, grid, block,
                              smem_bytes, indptr_a, a_idx, a_val, indptr_b,
                              b_idx, b_val, indptr_c, out_cols, out_vals,
                              row_nnz, errors, ws_keys, ws_vals, s);
}

// One phase (numeric = 0: symbolic, 1: numeric) for bin index `bin` of
// every fleet member: a grid of (grid_x, n_members) blocks.  offsets rows
// hold n_bins + 1 entries and bin_tsize rows n_bins; every array argument
// is followed by its member stride in elements (0: shared by all members;
// an operand's column ids and values each have their own).  Symbolic
// writes row_nnz (n_members, n_rows) (indptr_c/out_* unused); numeric
// writes out_cols/out_vals (n_members, cap_c), zeroed by the caller
// (row_nnz unused).  smem_bytes = smem_slots * 4 (symbolic) or 8
// (numeric); ws_keys (and, numeric, ws_vals) hold grid_x * n_members *
// ws_tsz slots (null when ws_tsz is 0).
extern "C" int spgemm_hash_batched_launch(
    int numeric, int vector, int bin, int n_rows, int table_size,
    int smem_slots, int ws_tsz, int cap_c, int grid_x, int n_members,
    int block, int smem_bytes, const int* offsets, long long s_off,
    const int* bin_tsize, long long s_bt, const int* indptr_a, long long s_ia,
    const int* a_idx, long long s_ai, const float* a_val, long long s_av,
    const int* indptr_b, long long s_ib, const int* b_idx, long long s_bi,
    const float* b_val, long long s_bv, const int* indptr_c, long long s_ic,
    int* out_cols, float* out_vals, int* row_nnz, int* errors, int* ws_keys,
    float* ws_vals, void* stream) {
  auto kernel = numeric ? (vector ? &hash_rows_batched_kernel<true, true>
                                  : &hash_rows_batched_kernel<true, false>)
                        : (vector ? &hash_rows_batched_kernel<false, true>
                                  : &hash_rows_batched_kernel<false, false>);
  if (smem_bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<dim3(grid_x, n_members), block, smem_bytes,
           static_cast<cudaStream_t>(stream)>>>(
      bin, n_rows, table_size, smem_slots, ws_tsz, cap_c, offsets, s_off,
      bin_tsize, s_bt, indptr_a, s_ia, a_idx, s_ai, a_val, s_av, indptr_b,
      s_ib, b_idx, s_bi, b_val, s_bv, indptr_c, s_ic, out_cols, out_vals,
      row_nnz, errors, ws_keys, ws_vals);
  return static_cast<int>(cudaGetLastError());
}
