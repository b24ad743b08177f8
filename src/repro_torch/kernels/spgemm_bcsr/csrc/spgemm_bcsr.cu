// Block-row hash SpGEMM over BCSR for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels numeric_call of
// repro/kernels/spgemm_bcsr/kernel.py (_numeric_kernel, _block_row_loop,
// and the _probe_scalar / _probe_vector probes it borrows from the hash
// kernel) and batched_numeric_call (_batched_numeric_kernel: numeric_call
// over the grid (members, bins) of a fleet of block-value members, which
// the reference reaches through its custom_vmap rule), and adds two
// kernels that replace none, classify_kernel and place_kernel (below).
//
// What it computes, per block row i: for each A block j of block row i and
// each B block t of block row a_bcol[j], in that order, the tile product
// A_blk[j] (bm x bk) @ B_blk[t] (bk x bn) is added into the output block
// of column b_bcol[t], found in a table keyed by block column -- hashed as
// (uint32(col) * 0x9E3779B9) & (tsz - 1) with linear probing, or over tsz
// / 8 chunks of 8 slots when vector.  Row i's blocks go to out_bcol /
// out_blk at indptr_c[i], block columns unsorted (C8).
//
// Design on this card:
//   * A table per row, sized from its own output count need_i =
//     indptr_c[i + 1] - indptr_c[i]: tsz_i = min(cap_i, lowest power of
//     two >= max(2 * need_i, 8)) key slots, cap_i the row's bin table
//     min(bin_tsize[b], table_size) (as the hash kernel's rows: a plan
//     sized at load factor 1 stays exactly full).  Beside the keys, a map
//     from slot to tile, and need_i accumulator tiles handed out in
//     insertion order: the table's bytes are 8 * tsz_i + 4 * bm * bn *
//     need_i, not tsz_i tiles.
//   * Inside a row, one A block j at a time (a "stage"; a B row longer
//     than a stage holds is cut into several).  Within one j the B row's
//     block columns are distinct, so no two pairs of a stage meet in one
//     slot, and with the stages multiplied in order every output tile is
//     summed in j order, with no float atomics.
//   * Staged rows (their table in shared memory) run three warp roles as
//     a pipeline over the row's stages, through a full, a probed and an
//     empty mbarrier per stage buffer (3 or 4 buffers in what the table
//     leaves of the block's shared memory):
//       - the stager warp walks the row -- the (start, end) of the next
//         kWindow A blocks' B rows staged in shared memory, so a stage
//         costs no dependent load -- and, once a buffer is empty, copies
//         A's tile j, the stage's B block columns and B tiles into it:
//         bulk copies (cp.async.bulk, completing the full barrier's
//         bytes) where 16-byte aligned, the lanes' 4-byte cp.async
//         otherwise;
//       - the prober warp probes each full stage, one lane per key (32
//         keys a round), claiming slots with atomicCAS; the pairs that
//         open a slot take their tiles by a warp prefix sum of the opening
//         flags in pair order, so the insertion order -- the flush order
//         -- is the order of first appearance in the (j, t) expansion, the
//         same on every call and in both probe modes.  It replaces each
//         block column by the pair's code (its tile, and whether it
//         opened it);
//       - the multiplier warps multiply each probed stage, one output lane
//         (r, c) of one pair a thread at a time: sum_k __fmul_rn(a[r][k],
//         b[k][c]) with __fadd_rn over k in order, added with __fadd_rn
//         into the tile (into 0 by the pair that opened it), then meet at
//         a barrier of their own (the next stage may add into the same
//         tiles) and free the buffer.  CUDA-core FP32 only: no FMA, no
//         mma, no TF32.  Each tile is the plain version's sum, bitwise.
//     The prober and the stager run ahead of the multipliers by up to the
//     buffers.  At the row's end its tiles are flushed to
//     out_blk[indptr_c[i] ...] in one coalesced copy.
//   * Direct rows (a table past every class, or any tile too large to
//     stage): keys and map in a per-block workspace in device memory,
//     tiles accumulated in place in out_blk[indptr_c[i] ...], A and B read
//     from device memory (L2).
//   * The single-product kernel runs rows by class, not by plan bin.
//     classify_kernel (one thread a row) writes each row's table and its
//     class -- by the row's bytes, a block's shared memory of 30 / 54 /
//     111 / 225 KB (7 / 4 / 2 / 1 blocks an SM), or direct -- and, within
//     the class, by its A-block count in powers of two (the row's critical
//     path: one stage per A block); place_kernel lays every class's rows
//     out longest first.  No host synchronisation.  Then one persistent
//     launch per class that can hold rows, the largest class first, each
//     block popping rows with an atomic: the longest rows start first.
//     The class launches after the first are programmatic dependent
//     launches: every block lets the next class start at once, and block
//     0 of each class waits for the class before it to finish before it
//     exits, so the last class's end is every class's end.
//   * Errors: a row whose table cannot hold its output (need_i > cap_i, a
//     table that is not a power of two, or below the chunk in vector
//     mode), a probe that finds the table full, an insert past need_i
//     (tested before the tile or out_bcol is written), a final count that
//     differs from need_i, and a row that indptr_c leaves empty but that
//     has pairs each add one to errors[0]; nothing is written outside the
//     row's range of the output.
//   * The output is zeroed by the caller before launch: blocks run in no
//     order, so nothing like the TPU kernel's "zero at bin 0" is possible.
//   * Batched (a fleet under torch.func.vmap): one launch per bin index,
//     blockIdx.y the member, the x blocks striding over that member's
//     block rows of the bin.  Every array, the schedule included, takes a
//     member stride, 0 for an array all members share.  Each row runs the
//     same row body: staged when its table and one tile of stage fit the
//     launch's shared memory, else direct in its (member, x block) slice
//     of the workspace.
//   * Every block barrier of the row body is the non-aligned barrier.sync:
//     lanes leave the probe loops at different times.
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
//: row classes: four shared-memory budgets, then direct
constexpr int kClasses = 5;
constexpr int kDirectClass = kClasses - 1;
//: A-block count classes within a row class: [2^L, 2^(L + 1)), the last
//: open
constexpr int kLenBuckets = 16;
constexpr int kKeys = kClasses * kLenBuckets;
//: B tiles a stage of a staged row is sized for at least: kStageMin, or
//: as many as kStageFloats lanes hold for large tiles, or the row's output
//: count when smaller (no B row is longer than the row's output)
constexpr int kStageMin = 8;
constexpr int kStageFloats = 2048;
//: stage buffers of a staged row: kBuffers, or 3 for tiles past
//: kStageFloats lanes (A's and B's tile together)
constexpr int kBuffers = 4;
//: A blocks whose B row bounds are staged at a time
constexpr int kWindow = 64;
//: pairs of a direct row's stage
constexpr int kDirectPairs = 1024;
constexpr int kMaxThreads = 576;
//: a batched block: a prober warp, a stager warp and 256 multiplier
//: threads
constexpr int kBatchedThreads = 320;

// Dynamic shared memory of class c's blocks, and their threads.
__host__ __device__ constexpr int class_smem(int c) {
  return c == 0 ? 30 * 1024 : c == 1 ? 54 * 1024 : c == 2 ? 111 * 1024
       : c == 3 ? 225 * 1024 : 4 * kDirectPairs;
}
// A staged class's block is a prober warp, a stager warp and 128 / 256 /
// 256 / 512 multiplier threads.
__host__ __device__ constexpr int class_threads(int c) {
  return c == 0 ? 192 : c == 3 ? 576 : c == kDirectClass ? 256 : 320;
}
// Blocks an SM that class c's shared memory allows (the register cap).
__host__ __device__ constexpr int class_blocks_per_sm(int c) {
  return c == 0 ? 7 : c == 1 ? 4 : c == 2 ? 2 : c == 3 ? 1 : 4;
}

__host__ __device__ constexpr long long r16(long long x) {
  return (x + 15) & ~15LL;
}
// A staged row's table: keys and slot-to-tile map (tsz each), need tiles.
__host__ __device__ constexpr long long table_bytes(int tsz, int need,
                                                    int tile) {
  return r16(8LL * tsz + 4LL * tile * need);
}
// One stage buffer of n B tiles: A's tile, the block columns (with room
// for their 16-byte aligned cover), the tiles.
__host__ __device__ constexpr long long half_bytes(long long n, int bm, int bk,
                                                   int bn) {
  return r16(4LL * bm * bk) + r16(4 * n) + 16 + r16(4LL * bk * bn * n);
}
__host__ __device__ constexpr int stage_buffers(int bm, int bk, int bn) {
  return bm * bk + bk * bn > kStageFloats ? 3 : kBuffers;
}
// The B tiles a staged row's stage buffers are sized for.
__host__ __device__ constexpr int stage_min(int need, int bk, int bn) {
  const int by_lanes = kStageFloats / (bk * bn) > 1
                           ? kStageFloats / (bk * bn) : 1;
  const int s = by_lanes < kStageMin ? by_lanes : kStageMin;
  return need < s ? need : s;
}
// Shared memory a staged row asks for: its table and its stage buffers.
__host__ __device__ constexpr long long row_bytes(int tsz, int need, int bm,
                                                  int bk, int bn) {
  return table_bytes(tsz, need, bm * bn) +
         stage_buffers(bm, bk, bn) *
             half_bytes(stage_min(need, bk, bn), bm, bk, bn);
}
__host__ __device__ constexpr int class_of_bytes(long long bytes) {
  int c = 0;
  while (c < kDirectClass && bytes > class_smem(c)) ++c;
  return c;
}
__device__ __forceinline__ int len_bucket(int na) {
  const int l = 31 - __clz(na);
  return l < kLenBuckets ? l : kLenBuckets - 1;
}

// A row's table: min(cap, lowest power of two >= max(2 * need, CHUNK)), 0
// for a row with no output.
__host__ __device__ inline int row_table(int cap, int need) {
  if (need <= 0 || cap <= 0) return 0;
  if (need >= cap) return cap;
  int p = kChunk;
  while (p < 2 * need) p <<= 1;
  return p < cap ? p : cap;
}

__device__ __forceinline__ bool bad_cap(int cap, bool vector) {
  return cap < 1 || (cap & (cap - 1)) || (vector && cap < kChunk);
}

// B tiles a stage buffer holds when `rest` bytes follow the table: the
// most n with nbuf buffers of half_bytes(n) in rest (0 if none fits).
__device__ __forceinline__ int stage_tiles(long long rest, int nbuf, int bm,
                                           int bk, int bn) {
  const long long per = 4 + 4LL * bk * bn;
  long long n = (rest / nbuf - r16(4LL * bm * bk) - 48) / per;
  if (n < 0) n = 0;
  while (n > 0 && nbuf * half_bytes(n, bm, bk, bn) > rest) --n;
  while (nbuf * half_bytes(n + 1, bm, bk, bn) <= rest) ++n;
  return static_cast<int>(n);
}

__device__ __forceinline__ unsigned hash_of(int col, unsigned mask) {
  return (static_cast<unsigned>(col) * kHashConst) & mask;
}

// Tables are filled by atomics: read them past any stale cached line.
__device__ __forceinline__ int load_int(const int* p) {
  return *reinterpret_cast<const volatile int*>(p);
}
__device__ __forceinline__ float load_float(const float* p) {
  return *reinterpret_cast<const volatile float*>(p);
}
// Four slots of a chunk in one 16-byte load.
__device__ __forceinline__ void load_quad(const int* p, int k[4]) {
  asm volatile("ld.volatile.v4.s32 {%0, %1, %2, %3}, [%4];"
               : "=r"(k[0]), "=r"(k[1]), "=r"(k[2]), "=r"(k[3])
               : "l"(p) : "memory");
}

// The block barrier that counts every thread: after the data-dependent
// probe loops the lanes of a warp reach it apart, and the aligned form
// __syncthreads() compiles to lets a warp's late lanes fall one barrier
// behind the rest of the block.
__device__ __forceinline__ void block_sync() {
  asm volatile("barrier.sync 0;" ::: "memory");
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void async_copy4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;"
               :: "r"(smem_u32(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void mbar_init(unsigned long long* bar,
                                          int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive_tx(unsigned long long* bar,
                                               unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
               :: "r"(smem_u32(bar)) : "memory");
}
// Hold the barrier's phase until this thread's earlier cp.async copies
// have landed (one more pending arrival, made when they land).
__device__ __forceinline__ void async_arrive(unsigned long long* bar) {
  asm volatile("cp.async.mbarrier.arrive.shared::cta.b64 [%0];"
               :: "r"(smem_u32(bar)) : "memory");
}
// Wait for the completion of the barrier's phase of this parity.
__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  } while (!done);
}
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}
// Order this thread's earlier shared-memory accesses before the bulk
// copies it issues next (the async proxy).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// The multiplier warps' own barrier (id 1; barrier 0 is the block's).
__device__ __forceinline__ void multipliers_sync(int threads) {
  asm volatile("barrier.sync 1, %0;" :: "r"(threads) : "memory");
}

// Linear probing (Fig. 8a).  Returns the slot that holds col (claiming an
// EMPTY one if needed), or -1 when every slot holds another key.  Each
// step is one atomicCAS, whose old value says EMPTY (claimed), col (found)
// or another key (next slot).
__device__ __forceinline__ int insert_scalar(int* keys, int tsz, int col,
                                             int* opened) {
  const unsigned mask = static_cast<unsigned>(tsz) - 1u;
  unsigned h = hash_of(col, mask);
  for (int step = 0; step < tsz; ++step) {
    const int old = atomicCAS(keys + h, kEmpty, col);
    if (old == kEmpty) {
      *opened = 1;
      return static_cast<int>(h);
    }
    if (old == col) return static_cast<int>(h);
    h = (h + 1u) & mask;
  }
  return -1;
}

// Chunked probing (Fig. 8b) by one lane: slots only ever go from EMPTY to
// a key, and a key is claimed in the first EMPTY slot of the first chunk
// that has one, so a chunk with an EMPTY slot and no col ends the search;
// a chunk fills from its first slot, so its first half decides whenever
// it holds col or an EMPTY slot.
__device__ __forceinline__ int insert_vector(int* keys, int tsz, int col,
                                             int* opened) {
  const unsigned cmask = static_cast<unsigned>(tsz / kChunk) - 1u;
  unsigned c = hash_of(col, cmask);
  // each step moves to the next chunk or follows a slot that another key
  // just took, so tsz / kChunk + tsz steps visit everything
  const int max_steps = tsz / kChunk + tsz + 1;
  for (int step = 0; step < max_steps; ++step) {
    const int first = static_cast<int>(c) * kChunk;
    int* p = keys + first;
    int hit = -1, empty = -1;
#pragma unroll
    for (int half = 0; half < kChunk; half += 4) {
      int k[4];
      load_quad(p + half, k);
#pragma unroll
      for (int i = 3; i >= 0; --i) {
        if (k[i] == col) hit = half + i;
        if (k[i] == kEmpty) empty = half + i;
      }
      if (hit >= 0 || empty >= 0) break;
    }
    if (hit >= 0) return first + hit;
    if (empty < 0) {
      c = (c + 1u) & cmask;
      continue;
    }
    const int old = atomicCAS(p + empty, kEmpty, col);
    if (old == kEmpty) {
      *opened = 1;
      return first + empty;
    }
    if (old == col) return first + empty;
    // another key took the slot: read the same chunk again
  }
  return -1;
}

// One product's arrays (a fleet member's, in the batched kernel).
struct Ops {
  const int* indptr_a;
  const int* a_bcol;
  const float* a_blk;
  const int* indptr_b;
  const int* b_bcol;
  const float* b_blk;
  const int* indptr_c;
  int* out_bcol;
  float* out_blk;
  int bcap_c;
  int b_bcol_len;  // b_bcol's length (the bulk copies read no further)
};

// Tile shape, whether A's and B's tiles allow 16-byte copies, and the
// output lanes of thread t of the nt that multiply.  With `fixed` (the
// tile divides nt) a thread keeps one lane (r, c) of pairs q0, q0 +
// qstep, ...; otherwise it walks the stage's (pair, lane) items nt apart.
struct Shape {
  int bm, bk, bn, tile;
  bool a16, b16;
  bool fixed;
  int t, nt;
  int l, r, c, q0, qstep;
  // 8x8x8 tiles, 16 threads a pair: row r8 and columns c8 .. c8 + 3 of
  // pairs q8, q8 + q8step, ...
  bool tile8;
  int r8, c8, q8, q8step;
};

__device__ __forceinline__ Shape make_shape(int bm, int bk, int bn, int a16,
                                            int b16, int t, int nt) {
  Shape s;
  s.bm = bm;
  s.bk = bk;
  s.bn = bn;
  s.tile = bm * bn;
  s.a16 = a16 && (bm * bk) % 4 == 0;
  s.b16 = b16 && (bk * bn) % 4 == 0;
  s.t = t;
  s.nt = nt;
  s.fixed = s.tile <= nt && nt % s.tile == 0;
  s.l = s.fixed ? t % s.tile : 0;
  s.r = s.l / bn;
  s.c = s.l % bn;
  s.q0 = s.fixed ? t / s.tile : 0;
  s.qstep = s.fixed ? nt / s.tile : 1;
  s.tile8 = bm == 8 && bk == 8 && bn == 8 && nt % 16 == 0;
  s.r8 = (t & 15) >> 1;
  s.c8 = (t & 1) * 4;
  s.q8 = t >> 4;
  s.q8step = nt >> 4;
  return s;
}

// A row's id, table, output range and A blocks (row -1: none).
struct RowMeta {
  int row, tsz, base, need, a0, na;
};

// Per-block scratch of the row body.
struct Scratch {
  // per stage buffer: its copies landed, its pairs probed, it is free
  unsigned long long full[kBuffers];
  unsigned long long probed[kBuffers];
  unsigned long long empty[kBuffers];
  int stage_off[kBuffers];        // the block columns' offset in a buffer
  int wtot[2][kMaxThreads / 32];  // the opening scan's per-warp counts
  // (start, end) of B rows of kWindow A blocks: the walker's window and
  // the next row's first, staged ahead (for row win_row)
  int win[2][2 * kWindow];
  int win_row;
  RowMeta meta[2];                // the row and the next (class kernels)
  int stage_n[kBuffers];          // B tiles of the stage in each buffer
  int cursor;                     // tiles a staged row opened
  int flag;
};

// The stages of a row: A blocks in order, each B row cut into stages of
// at most cap_n tiles, empty B rows skipped.  Every thread of the block
// (kWarp: of one warp) walks it in step; the window reloads are block
// (warp) barriers.
struct Walker {
  int a0, na;  // the row's A blocks
  int* win;    // its window
  int w0;      // first A block of the loaded window (relative)
  int jj;      // current A block (relative)
  int t, te;   // its next B tile and end
};

// The (start, end) of the B rows of A blocks a0 + start ... (at most
// kWindow, below na) into win, by thread t of nt.
__device__ __forceinline__ void fill_window(int* win, int a0, int na,
                                            int start, int t, int nt,
                                            const Ops& o) {
  for (int q = t; q < kWindow && start + q < na; q += nt) {
    const int k = o.a_bcol[a0 + start + q];
    win[2 * q] = o.indptr_b[k];
    win[2 * q + 1] = o.indptr_b[k + 1];
  }
}

template <bool kWarp>
__device__ __forceinline__ void load_window(Walker& w, int start,
                                            const Ops& o) {
  // every thread is done with the previous window
  if (kWarp) __syncwarp(); else block_sync();
  fill_window(w.win, w.a0, w.na, start, kWarp ? threadIdx.x & 31
                                              : threadIdx.x,
              kWarp ? 32 : blockDim.x, o);
  w.w0 = start;
  if (kWarp) __syncwarp(); else block_sync();
}

// A walker over A blocks a0 ... a0 + na - 1 with the window win; `ready`:
// the window already holds the first kWindow A blocks' B rows.
template <bool kWarp>
__device__ __forceinline__ void walker_init(Walker& w, int a0, int na,
                                            int* win, bool ready,
                                            const Ops& o) {
  w.a0 = a0;
  w.na = na;
  w.win = win;
  w.jj = -1;
  w.t = w.te = 0;
  w.w0 = 0;
  if (!ready) load_window<kWarp>(w, 0, o);
}

template <bool kWarp>
__device__ __forceinline__ bool next_stage(Walker& w, int cap_n, int* j,
                                           int* t0, int* n,
                                           const Ops& o) {
  while (w.t >= w.te) {
    if (++w.jj >= w.na) return false;
    if (w.jj >= w.w0 + kWindow) load_window<kWarp>(w, w.jj, o);
    w.t = w.win[2 * (w.jj - w.w0)];
    w.te = w.win[2 * (w.jj - w.w0) + 1];
  }
  *j = w.a0 + w.jj;
  *t0 = w.t;
  *n = min(cap_n, w.te - w.t);
  w.t += *n;
  return true;
}

// Probe a stage's n block columns (cols[q], or b_bcol[t0 + q] when cols
// is null) and give each pair its code in codes[q]: 2 * tile + 1 for the
// pair that opened the tile, 2 * tile for one that found it, -1 for one
// that adds nothing (an error).  Opening pairs take tiles cursor, cursor
// + 1, ... in pair order (a block scan); cursor advances by the openings.
template <bool kVector>
__device__ __forceinline__ void probe_stage(
    int n, const int* cols, const int* gcols, int* codes, int* keys,
    int* map, int tsz, int need, int base, int& cursor, const Ops& o,
    Scratch* sh, int* errors) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int q0 = 0, rnd = 0; q0 < n; q0 += blockDim.x, rnd ^= 1) {
    const int q = q0 + tid;
    int col = 0, slot = -1, opened = 0;
    if (q < n) {
      col = cols != nullptr ? cols[q] : gcols[q];
      slot = kVector ? insert_vector(keys, tsz, col, &opened)
                     : insert_scalar(keys, tsz, col, &opened);
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, opened);
    if (lane == 0) sh->wtot[rnd][warp] = __popc(ballot);
    block_sync();
    int before = 0, total = 0;
    for (int w = 0; w < nwarps; ++w) {
      const int v = sh->wtot[rnd][w];
      total += v;
      if (w < warp) before += v;
    }
    if (q < n) {
      int code = -1;
      if (slot < 0) {
        atomicAdd(errors, 1);
      } else if (opened) {
        const int pos = cursor + before + __popc(ballot & ((1u << lane) - 1u));
        if (pos < need) {
          map[slot] = pos;
          if (base + pos < o.bcap_c) o.out_bcol[base + pos] = col;
          code = 2 * pos + 1;
        } else {
          map[slot] = -1;
          atomicAdd(errors, 1);
        }
      } else {
        const int p = load_int(map + slot);
        code = p >= 0 ? 2 * p : -1;
      }
      codes[q] = code;
    }
    cursor += total;
  }
}

// The prober warp of a staged row: probe the stage's n block columns
// codes[q] and replace each with its code, as probe_stage does, 32 pairs
// a round with a warp scan of the openings; lane 0 leaves the cursor in
// *cursor_out.
template <bool kVector>
__device__ __forceinline__ void probe_warp(int n, int* codes, int* keys,
                                           int* map, int tsz, int need,
                                           int base, int& cursor,
                                           int* cursor_out, const Ops& o,
                                           int* errors) {
  const int lane = threadIdx.x & 31;
  for (int q0 = 0; q0 < n; q0 += 32) {
    const int q = q0 + lane;
    int col = 0, slot = -1, opened = 0;
    if (q < n) {
      col = codes[q];
      slot = kVector ? insert_vector(keys, tsz, col, &opened)
                     : insert_scalar(keys, tsz, col, &opened);
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, opened);
    if (q < n) {
      int code = -1;
      if (slot < 0) {
        atomicAdd(errors, 1);
      } else if (opened) {
        const int pos = cursor + __popc(ballot & ((1u << lane) - 1u));
        if (pos < need) {
          map[slot] = pos;
          if (base + pos < o.bcap_c) o.out_bcol[base + pos] = col;
          code = 2 * pos + 1;
        } else {
          map[slot] = -1;
          atomicAdd(errors, 1);
        }
      } else {
        const int p = load_int(map + slot);
        code = p >= 0 ? 2 * p : -1;
      }
      codes[q] = code;
    }
    cursor += __popc(ballot);
  }
  if (lane == 0) *cursor_out = cursor;
}

// One output lane of one pair: sum_k a_row[k] * b_col[k * bn], one
// rounding per product and per add, k in order.
__device__ __forceinline__ float lane_product(const float* a_row,
                                              const float* b_col, int bk,
                                              int bn) {
  float sum = __fmul_rn(a_row[0], b_col[0]);
#pragma unroll 8
  for (int kk = 1; kk < bk; ++kk)
    sum = __fadd_rn(sum, __fmul_rn(a_row[kk], b_col[kk * bn]));
  return sum;
}

// Add one lane's product into its tile (code as probe_stage gives it;
// none for a negative code): into 0 for the pair that opened the tile.
template <bool kDirect>
__device__ __forceinline__ void add_lane(float* tiles, int code,
                                         const Shape& s, float sum) {
  if (code < 0) return;
  float* dst = tiles + static_cast<size_t>(code >> 1) * s.tile + s.l;
  const float old = (code & 1) ? 0.0f : (kDirect ? load_float(dst) : *dst);
  *dst = __fadd_rn(old, sum);
}

// 8x8x8 tiles in shared memory, 16-byte aligned (tiles too): each thread
// sums four lanes of a pair's tile from A's row in registers and B's rows
// read four columns at a time, and adds them into the tile at once.
__device__ __forceinline__ void multiply_stage8(int n, const int* codes,
                                                const float* a,
                                                const float* b,
                                                float* tiles,
                                                const Shape& s) {
  const float4 a0 = *reinterpret_cast<const float4*>(a + s.r8 * 8);
  const float4 a1 = *reinterpret_cast<const float4*>(a + s.r8 * 8 + 4);
  const float ar[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
  for (int q = s.q8; q < n; q += s.q8step) {
    const int code = codes[q];
    if (code < 0) continue;
    const float* bq = b + q * 64 + s.c8;
    float4 bv = *reinterpret_cast<const float4*>(bq);
    float4 sum = make_float4(__fmul_rn(ar[0], bv.x), __fmul_rn(ar[0], bv.y),
                             __fmul_rn(ar[0], bv.z), __fmul_rn(ar[0], bv.w));
#pragma unroll
    for (int kk = 1; kk < 8; ++kk) {
      bv = *reinterpret_cast<const float4*>(bq + kk * 8);
      sum.x = __fadd_rn(sum.x, __fmul_rn(ar[kk], bv.x));
      sum.y = __fadd_rn(sum.y, __fmul_rn(ar[kk], bv.y));
      sum.z = __fadd_rn(sum.z, __fmul_rn(ar[kk], bv.z));
      sum.w = __fadd_rn(sum.w, __fmul_rn(ar[kk], bv.w));
    }
    float4* dst = reinterpret_cast<float4*>(tiles + (code >> 1) * 64 +
                                            s.r8 * 8 + s.c8);
    if (code & 1) {
      *dst = make_float4(__fadd_rn(0.0f, sum.x), __fadd_rn(0.0f, sum.y),
                         __fadd_rn(0.0f, sum.z), __fadd_rn(0.0f, sum.w));
    } else {
      const float4 old = *dst;
      *dst = make_float4(__fadd_rn(old.x, sum.x), __fadd_rn(old.y, sum.y),
                         __fadd_rn(old.z, sum.z), __fadd_rn(old.w, sum.w));
    }
  }
}

// Add the stage's n tile products into their tiles (tiles + code / 2 *
// tile): a is A's tile, b the stage's first B tile.  kDirect: the tiles
// are in device memory (read past L1).
template <bool kDirect>
__device__ __forceinline__ void multiply_stage(int n, const int* codes,
                                               const float* a,
                                               const float* b, float* tiles,
                                               const Shape& s) {
  const int bkbn = s.bk * s.bn;
  if (s.fixed) {
    const float* a_row = a + s.r * s.bk;
    for (int q = s.q0; q < n; q += s.qstep) {
      const int code = codes[q];
      if (code < 0) continue;
      add_lane<kDirect>(
          tiles, code, s,
          lane_product(a_row, b + static_cast<size_t>(q) * bkbn + s.c, s.bk,
                       s.bn));
    }
    return;
  }
  const int items = n * s.tile;
  for (int it = s.t; it < items; it += s.nt) {
    const int q = it / s.tile;
    const int code = codes[q];
    if (code < 0) continue;
    const int l = it - q * s.tile;
    const int r = l / s.bn;
    const int c = l - r * s.bn;
    const float sum = lane_product(
        a + r * s.bk, b + static_cast<size_t>(q) * bkbn + c, s.bk, s.bn);
    float* dst = tiles + static_cast<size_t>(code >> 1) * s.tile + l;
    const float old = (code & 1) ? 0.0f : (kDirect ? load_float(dst) : *dst);
    *dst = __fadd_rn(old, sum);
  }
}

// Copy stage (j, t0, n) into buffer `buf`, by the stager warp: A's tile
// j at sa, the block columns in the cols region (from sh->stage_off[buf]
// ints on) and the B tiles at sb.  16-byte aligned tiles and the block
// columns' 16-byte aligned cover (when b_bcol holds it) go by bulk copies
// from lane 0, the rest by the lanes' 4-byte cp.async; the buffer's full
// barrier completes when all have landed.
__device__ __forceinline__ void issue_stage(float* sa, int* scols, float* sb,
                                            int buf, int j, int t0, int n,
                                            const Ops& o, const Shape& s,
                                            Scratch* sh) {
  const int lane = threadIdx.x & 31;
  unsigned long long* bar = sh->full + buf;
  const int na = s.bm * s.bk;
  const int nb = n * s.bk * s.bn;
  const float* ga = o.a_blk + static_cast<size_t>(j) * na;
  const float* gb = o.b_blk + static_cast<size_t>(t0) * s.bk * s.bn;
  const int c0 = t0 & ~3;
  const int cn = ((t0 & 3) + n + 3) & ~3;
  const bool c16 = (reinterpret_cast<size_t>(o.b_bcol) & 15) == 0 &&
                   c0 + cn <= o.b_bcol_len;
  if (!(s.a16 && s.b16 && c16)) {
    if (!s.a16)
      for (int i = lane; i < na; i += 32) async_copy4(sa + i, ga + i);
    if (!s.b16)
      for (int i = lane; i < nb; i += 32) async_copy4(sb + i, gb + i);
    if (!c16)
      for (int i = lane; i < n; i += 32)
        async_copy4(scols + i, o.b_bcol + t0 + i);
    async_arrive(bar);
    __syncwarp();  // every lane's pending arrival before lane 0's
  }
  if (lane == 0) {
    sh->stage_off[buf] = c16 ? t0 & 3 : 0;
    sh->stage_n[buf] = n;
    const unsigned tx = (s.a16 ? 4u * na : 0u) + (s.b16 ? 4u * nb : 0u) +
                        (c16 ? 4u * cn : 0u);
    fence_proxy_async();
    mbar_arrive_tx(bar, tx);
    if (s.a16) bulk_copy(sa, ga, 4u * na, bar);
    if (s.b16) bulk_copy(sb, gb, 4u * nb, bar);
    if (c16) bulk_copy(scols, o.b_bcol + c0, 4u * cn, bar);
  }
}

// Row `row` with its table in shared memory (smem, smem_bytes of it):
// keys and map (tsz each), then need tiles, then nbuf stage buffers.  Three
// roles run a pipeline over the row's stages through each buffer's
// barriers: warp 1 (the stager) walks the row and copies stage k into
// buffer k % nbuf once the multipliers have freed it (empty); warp 0 (the
// prober) probes each stage once its copies land (full); the other warps
// (the multipliers, s: their lanes) multiply each stage once it is probed
// (probed), with a barrier of their own after each stage (a tile's sums
// in stage order), then free the buffer.  A stage of no tiles ends the
// row.  Every thread of the block calls it.
// Where the class kernels' rows come from: the class's list (its rows
// list[start ...], n of them, popped through *pop) and their tables.
struct RowSource {
  int* pop;
  const int* list;
  int start, n;
  const int* row_tsz;
};

// Pop the next row of src and read its RowMeta (lane 0 of a warp).
__device__ __forceinline__ RowMeta pop_row(const RowSource& src,
                                           const Ops& o) {
  RowMeta m{-1, 0, 0, 0, 0, 0};
  const int idx = atomicAdd(src.pop, 1);
  if (idx < src.n) {
    m.row = src.list[src.start + idx];
    m.tsz = src.row_tsz[m.row];
    m.base = o.indptr_c[m.row];
    m.need = o.indptr_c[m.row + 1] - m.base;
    m.a0 = o.indptr_a[m.row];
    m.na = o.indptr_a[m.row + 1] - m.a0;
  }
  return m;
}

template <bool kVector>
__device__ void row_staged(const RowMeta& m, int smem_bytes, char* smem,
                           const Ops& o, const Shape& s, Scratch* sh,
                           int* errors, const RowSource* src,
                           RowMeta* next, int& win_cur) {
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int tsz = m.tsz;
  const int base = m.base;
  const int need = m.need;
  int* keys = reinterpret_cast<int*>(smem);
  int* map = keys + tsz;
  float* tiles = reinterpret_cast<float*>(map + tsz);
  const int nbuf = stage_buffers(s.bm, s.bk, s.bn);
  const long long tb = table_bytes(tsz, need, s.tile);
  const int cap_n = stage_tiles(smem_bytes - tb, nbuf, s.bm, s.bk, s.bn);
  char* stage = smem + tb;
  const long long hb = half_bytes(cap_n, s.bm, s.bk, s.bn);
  const long long cols_at = r16(4LL * s.bm * s.bk);
  const long long tiles_at = cols_at + r16(4LL * cap_n) + 16;
  // 8x8x8 tiles four lanes a thread, where the tiles are 16-byte aligned
  const bool tile8 = s.tile8 && (tsz & 1) == 0;

  for (int k = tid; k < tsz; k += blockDim.x) keys[k] = kEmpty;
  if (tid == 0) {
    sh->cursor = 0;
    // every phase of the last row's barriers completed: start them again
    for (int b = 0; b < nbuf; ++b) {
      mbar_init(sh->full + b, 1);
      mbar_init(sh->probed + b, 1);
      mbar_init(sh->empty + b, 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  block_sync();  // the table is clear, the barriers ready
  unsigned phase = 0;  // this role's next parity on each buffer's barrier
  if (warp == 1) {
    // the first window may have been staged by the last row's stager
    const bool ready = sh->win_row == m.row;
    if (ready) win_cur ^= 1;
    Walker w;
    walker_init<true>(w, m.a0, m.na, sh->win[win_cur], ready, o);
    for (int k = 0, b = 0;; ++k) {
      if (k >= nbuf) {
        mbar_wait(sh->empty + b, (phase >> b) & 1u);
        phase ^= 1u << b;
      }
      int j, t0, n;
      if (!next_stage<true>(w, cap_n, &j, &t0, &n, o)) {
        if (lane == 0) {
          sh->stage_n[b] = 0;
          mbar_arrive(sh->full + b);
        }
        break;
      }
      char* p = stage + b * hb;
      issue_stage(reinterpret_cast<float*>(p),
                  reinterpret_cast<int*>(p + cols_at),
                  reinterpret_cast<float*>(p + tiles_at), b, j, t0, n, o, s,
                  sh);
      b = b + 1 == nbuf ? 0 : b + 1;
    }
    if (src != nullptr) {
      // the stager is done early: pop the next row, read its meta and
      // stage its first window while this row is probed and multiplied
      RowMeta nm;
      if (lane == 0) {
        nm = pop_row(*src, o);
        *next = nm;
        sh->win_row = nm.row;
      }
      nm.row = __shfl_sync(0xffffffffu, nm.row, 0);
      nm.a0 = __shfl_sync(0xffffffffu, nm.a0, 0);
      nm.na = __shfl_sync(0xffffffffu, nm.na, 0);
      if (nm.row >= 0)
        fill_window(sh->win[win_cur ^ 1], nm.a0, nm.na, 0, lane, 32, o);
    }
  } else if (warp == 0) {
    int cursor = 0;
    for (int b = 0;; b = b + 1 == nbuf ? 0 : b + 1) {
      mbar_wait(sh->full + b, (phase >> b) & 1u);
      phase ^= 1u << b;
      const int n = sh->stage_n[b];
      if (n > 0)
        probe_warp<kVector>(
            n,
            reinterpret_cast<int*>(stage + b * hb + cols_at) +
                sh->stage_off[b],
            keys, map, tsz, need, base, cursor, &sh->cursor, o, errors);
      __syncwarp();  // every lane's codes written
      if (lane == 0) mbar_arrive(sh->probed + b);
      if (n == 0) break;
    }
  } else {
    for (int b = 0;; b = b + 1 == nbuf ? 0 : b + 1) {
      mbar_wait(sh->probed + b, (phase >> b) & 1u);
      phase ^= 1u << b;
      const int n = sh->stage_n[b];
      if (n == 0) break;
      const char* cur = stage + b * hb;
      const int* codes =
          reinterpret_cast<const int*>(cur + cols_at) + sh->stage_off[b];
      if (tile8)
        multiply_stage8(n, codes, reinterpret_cast<const float*>(cur),
                        reinterpret_cast<const float*>(cur + tiles_at),
                        tiles, s);
      else
        multiply_stage<false>(
            n, codes, reinterpret_cast<const float*>(cur),
            reinterpret_cast<const float*>(cur + tiles_at), tiles, s);
      multipliers_sync(blockDim.x - 64);
      if (tid == 64) mbar_arrive(sh->empty + b);
    }
  }
  block_sync();  // every tile summed
  const int opened = sh->cursor;

  // flush the tiles, in insertion order, to the row's range
  int cnt = min(opened, need);
  if (base + cnt > o.bcap_c) cnt = max(0, o.bcap_c - base);
  float* dst = o.out_blk + static_cast<size_t>(base) * s.tile;
  const int nf = cnt * s.tile;
  if ((s.tile & 3) == 0 && (tsz & 1) == 0) {
    const float4* src4 = reinterpret_cast<const float4*>(tiles);
    float4* dst4 = reinterpret_cast<float4*>(dst);
    for (int i = tid; i < nf / 4; i += blockDim.x) dst4[i] = src4[i];
  } else {
    for (int i = tid; i < nf; i += blockDim.x) dst[i] = tiles[i];
  }
  if (tid == 0 && opened != need) atomicAdd(errors, 1);
  block_sync();  // the next row may reuse the table and sh->cursor
}

// Row `row` with keys and map in device memory (ws, 2 * tsz ints) and its
// tiles accumulated in place in out_blk; codes holds kDirectPairs ints of
// shared memory.
template <bool kVector>
__device__ void row_direct(int row, int tsz, int* ws, int* codes,
                           const Ops& o, const Shape& s, Scratch* sh,
                           int* errors) {
  const int tid = threadIdx.x;
  const int base = o.indptr_c[row];
  const int need = o.indptr_c[row + 1] - base;
  int* keys = ws;
  int* map = ws + tsz;
  float* tiles = o.out_blk + static_cast<size_t>(base) * s.tile;
  for (int k = tid; k < tsz; k += blockDim.x) keys[k] = kEmpty;
  Walker w;
  walker_init<false>(w, o.indptr_a[row], o.indptr_a[row + 1] -
                     o.indptr_a[row], sh->win[0], false, o);
  int cursor = 0;
  int j, t0, n;
  while (next_stage<false>(w, kDirectPairs, &j, &t0, &n, o)) {
    probe_stage<kVector>(n, nullptr, o.b_bcol + t0, codes, keys, map, tsz,
                         need, base, cursor, o, sh, errors);
    block_sync();  // every code written
    // pairs past bcap_c add nothing
    for (int q = tid; q < n; q += blockDim.x) {
      const int code = codes[q];
      if (code >= 0 && base + (code >> 1) >= o.bcap_c) codes[q] = -1;
    }
    block_sync();
    multiply_stage<true>(n, codes,
                         o.a_blk + static_cast<size_t>(j) * s.bm * s.bk,
                         o.b_blk + static_cast<size_t>(t0) * s.bk * s.bn,
                         tiles, s);
    block_sync();  // this stage's tiles written; codes free
  }
  if (tid == 0 && cursor != need) atomicAdd(errors, 1);
  block_sync();
}

// Row classes (see the header), one thread a row.  Row i of the bin b that
// holds it gets tsz_i (row_tsz[i]) and the key (class, A-block bucket) in
// row_key[i] with its rank among that key's rows in row_rank[i]; counts
// gains one per row.  Rows without output get key -1; errors gains one
// per row whose table cannot hold its output and per row that indptr_c
// leaves empty but that has pairs.
__global__ void classify_kernel(
    int m, int n_bins, int table_size, int vector, int bm, int bk, int bn,
    const int* __restrict__ offsets, const int* __restrict__ bin_tsize,
    const int* __restrict__ indptr_a, const int* __restrict__ a_bcol,
    const int* __restrict__ indptr_b, const int* __restrict__ indptr_c,
    int* __restrict__ counts, int* __restrict__ row_tsz,
    int* __restrict__ row_key, int* __restrict__ row_rank,
    int* __restrict__ errors) {
  __shared__ int s_n[kKeys];
  __shared__ int s_base[kKeys];
  for (int k = threadIdx.x; k < kKeys; k += blockDim.x) s_n[k] = 0;
  block_sync();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  int key = -1, rank = 0;
  if (i < m) {
    // the bin of row i: the last b with offsets[b] <= i
    int lo = 0, hi = n_bins - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (offsets[mid] <= i) lo = mid; else hi = mid - 1;
    }
    const bool in_bin = offsets[lo] <= i && i < offsets[lo + 1];
    const int cap = in_bin ? min(bin_tsize[lo], table_size) : 0;
    const int need = indptr_c[i + 1] - indptr_c[i];
    const int a0 = indptr_a[i], na = indptr_a[i + 1] - a0;
    bool bad = need < 0;
    int tsz = 0;
    if (need > 0) {
      bad = !in_bin || bad_cap(cap, vector) || need > cap || na <= 0;
      if (!bad) {
        tsz = row_table(cap, need);
        const int c = class_of_bytes(row_bytes(tsz, need, bm, bk, bn));
        key = c * kLenBuckets + len_bucket(na);
        rank = atomicAdd(&s_n[key], 1);
      }
    } else if (need == 0) {
      for (int j = a0; j < a0 + na && !bad; ++j) {
        const int k = a_bcol[j];
        bad = indptr_b[k + 1] > indptr_b[k];
      }
    }
    row_tsz[i] = tsz;
    if (bad) atomicAdd(errors, 1);
  }
  block_sync();
  for (int k = threadIdx.x; k < kKeys; k += blockDim.x)
    if (s_n[k]) s_base[k] = atomicAdd(counts + k, s_n[k]);
  block_sync();
  if (i < m) {
    row_key[i] = key;
    if (key >= 0) row_rank[i] = s_base[key] + rank;
  }
}

// Lay every class's rows out in list, classes in order, within a class the
// longest A-block bucket first (one thread a row).
__global__ void place_kernel(int m, const int* __restrict__ counts,
                             const int* __restrict__ row_key,
                             const int* __restrict__ row_rank,
                             int* __restrict__ list) {
  __shared__ int s_off[kKeys];
  if (threadIdx.x == 0) {
    int run = 0;
    for (int c = 0; c < kClasses; ++c)
      for (int l = kLenBuckets - 1; l >= 0; --l) {
        s_off[c * kLenBuckets + l] = run;
        run += counts[c * kLenBuckets + l];
      }
  }
  block_sync();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < m) {
    const int key = row_key[i];
    if (key >= 0) list[s_off[key] + row_rank[i]] = i;
  }
}

// The rows of class kClass: a persistent grid whose blocks pop rows from
// the class's part of list (counted in counts) through pops[kClass] until
// it runs dry.  Staged classes keep each row's table in shared memory;
// the direct class keeps keys and map in the block's ws_tsz * 2 ints of
// ws_keys.
template <bool kVector, int kClass>
__global__ void __launch_bounds__(class_threads(kClass),
                                  class_blocks_per_sm(kClass))
    bcsr_class_kernel(
    int ws_tsz, const int* __restrict__ counts, int* pops,
    const int* __restrict__ list, const int* __restrict__ row_tsz, Ops o,
    int bm, int bk, int bn, int a16, int b16, int* errors, int* ws_keys) {
  extern __shared__ __align__(16) char smem[];
  __shared__ Scratch sh;
  // the next class may start on whatever this one leaves free
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
  int start = 0, n = 0;
  for (int k = 0; k < kKeys; ++k) {
    const int c = k / kLenBuckets;
    if (c < kClass) start += counts[k];
    if (c == kClass) n += counts[k];
  }
  // staged rows: warps 2 on multiply; direct rows: every thread does
  const Shape s = kClass == kDirectClass
                      ? make_shape(bm, bk, bn, a16, b16, threadIdx.x,
                                   blockDim.x)
                      : make_shape(bm, bk, bn, a16, b16,
                                   static_cast<int>(threadIdx.x) - 64,
                                   blockDim.x - 64);
  const RowSource src{pops + kClass, list, start, n, row_tsz};
  if (threadIdx.x == 0) {
    sh.meta[0] = pop_row(src, o);
    sh.win_row = -1;
  }
  block_sync();
  int win_cur = 0;  // the stager's window (warp 1)
  for (int p = 0;; p ^= 1) {
    const RowMeta m = sh.meta[p];
    if (m.row < 0) break;
    if (kClass == kDirectClass) {
      if (threadIdx.x == 0)  // read after this row's barriers
        sh.meta[p ^ 1] = pop_row(src, o);
      row_direct<kVector>(
          m.row, m.tsz,
          ws_keys + static_cast<size_t>(blockIdx.x) * 2 * ws_tsz,
          reinterpret_cast<int*>(smem), o, s, &sh, errors);
    } else {
      // the stager pops the next row, after this row's barriers
      row_staged<kVector>(m, class_smem(kClass), smem, o, s, &sh, errors,
                          &src, &sh.meta[p ^ 1], win_cur);
    }
  }
  // this class ends after the one before it (a no-op after a plain launch)
  if (blockIdx.x == 0) asm volatile("griddepcontrol.wait;" ::: "memory");
}

// The batched grid, for one bin index `bin`: blockIdx.y is the fleet
// member e, and the x blocks stride over e's block rows
// [offsets[e][bin], offsets[e][bin + 1]).  Member e's arrays start at
// base + e * stride; stride 0 shares one array among all members.  Each
// row's table is sized from the member's cap min(bin_tsize[e][bin],
// table_size) and its own output; it is staged in shared memory
// (smem_bytes) when its table and one tile of stage fit, else direct in
// the block's slice of the workspace (2 * ws_tsz ints per member and x
// block; a row whose table passes ws_tsz there is an error).  A schedule
// the launch cannot hold (rows past n_rows, a cap that is not a power of
// two) adds one to errors and runs nothing.
template <bool kVector>
__global__ void __launch_bounds__(kBatchedThreads) bcsr_rows_batched_kernel(
    int bin, int n_rows, int table_size, int smem_bytes, int ws_tsz,
    int bcap_c, int bm, int bk, int bn, int a16, int b16, int b_bcol_len,
    const int* __restrict__ offsets, long long s_off,
    const int* __restrict__ bin_tsize, long long s_bt, const int* indptr_a,
    long long s_ia, const int* a_bcol, long long s_ac, const float* a_blk,
    long long s_ab, const int* indptr_b, long long s_ib, const int* b_bcol,
    long long s_bc, const float* b_blk, long long s_bb, const int* indptr_c,
    long long s_ic, int* out_bcol, float* out_blk, int* errors,
    int* ws_keys) {
  extern __shared__ __align__(16) char smem[];
  __shared__ Scratch sh;
  const long long e = blockIdx.y;
  const int r0 = offsets[e * s_off + bin];
  const int r1 = offsets[e * s_off + bin + 1];
  if (r0 >= r1) return;
  const int cap = min(bin_tsize[e * s_bt + bin], table_size);
  if (r0 < 0 || r1 > n_rows || bad_cap(cap, kVector)) {
    if (threadIdx.x == 0 && blockIdx.x == 0) atomicAdd(errors, 1);
    return;
  }
  const long long tile = static_cast<long long>(bm) * bn;
  Ops o{indptr_a + e * s_ia, a_bcol + e * s_ac, a_blk + e * s_ab,
        indptr_b + e * s_ib, b_bcol + e * s_bc, b_blk + e * s_bb,
        indptr_c + e * s_ic, out_bcol + e * bcap_c,
        out_blk + e * bcap_c * tile, bcap_c, b_bcol_len};
  const Shape s = make_shape(bm, bk, bn, a16, b16,
                             static_cast<int>(threadIdx.x) - 64,
                             blockDim.x - 64);
  const Shape sd = make_shape(bm, bk, bn, a16, b16, threadIdx.x, blockDim.x);
  if (threadIdx.x == 0) sh.win_row = -1;
  int win_cur = 0;  // the stager's window (warp 1)
  int* ws = ws_keys == nullptr
                ? nullptr
                : ws_keys + (static_cast<size_t>(e) * gridDim.x + blockIdx.x) *
                                2 * ws_tsz;
  for (int row = r0 + blockIdx.x; row < r1; row += gridDim.x) {
    const int need = o.indptr_c[row + 1] - o.indptr_c[row];
    if (need <= 0) {
      // a row without output must have no pairs
      if (threadIdx.x == 0) sh.flag = need < 0;
      block_sync();
      const int a0 = o.indptr_a[row], a1 = o.indptr_a[row + 1];
      for (int j = a0 + threadIdx.x; j < a1; j += blockDim.x) {
        const int k = o.a_bcol[j];
        if (o.indptr_b[k + 1] > o.indptr_b[k]) sh.flag = 1;
      }
      block_sync();
      if (threadIdx.x == 0 && sh.flag) atomicAdd(errors, 1);
      block_sync();
      continue;
    }
    if (need > cap) {
      if (threadIdx.x == 0) atomicAdd(errors, 1);
      continue;
    }
    const int tsz = row_table(cap, need);
    if (table_bytes(tsz, need, static_cast<int>(tile)) +
            stage_buffers(bm, bk, bn) * half_bytes(1, bm, bk, bn) <=
        smem_bytes) {
      const int a0 = o.indptr_a[row];
      const RowMeta m{row, tsz, o.indptr_c[row], need, a0,
                      o.indptr_a[row + 1] - a0};
      row_staged<kVector>(m, smem_bytes, smem, o, s, &sh, errors, nullptr,
                          nullptr, win_cur);
    } else if (ws != nullptr && tsz <= ws_tsz &&
               smem_bytes >= 4 * kDirectPairs) {
      row_direct<kVector>(row, tsz, ws, reinterpret_cast<int*>(smem), o, sd,
                          &sh, errors);
    } else if (threadIdx.x == 0) {
      atomicAdd(errors, 1);
    }
  }
}

using ClassKernel = void (*)(int, const int*, int*, const int*, const int*,
                             Ops, int, int, int, int, int, int*, int*);

template <bool kVector>
ClassKernel class_kernel_of(int c) {
  switch (c) {
    case 0: return bcsr_class_kernel<kVector, 0>;
    case 1: return bcsr_class_kernel<kVector, 1>;
    case 2: return bcsr_class_kernel<kVector, 2>;
    case 3: return bcsr_class_kernel<kVector, 3>;
    default: return bcsr_class_kernel<kVector, 4>;
  }
}

ClassKernel class_kernel(int vector, int c) {
  return vector ? class_kernel_of<true>(c) : class_kernel_of<false>(c);
}

int set_smem(const void* kernel, int smem_bytes) {
  if (smem_bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes));
}

}  // namespace

// The row classes of one product: classify_kernel, then place_kernel.
// counts holds kClasses * kLenBuckets zeroed counts (then the class
// kernels' kClasses pop counters, untouched here); row_tsz, row_key,
// row_rank and list hold m ints each.
extern "C" int spgemm_bcsr_classify(
    int m, int n_bins, int table_size, int vector, int bm, int bk, int bn,
    const int* offsets, const int* bin_tsize, const int* indptr_a,
    const int* a_bcol, const int* indptr_b, const int* indptr_c, int* counts,
    int* row_tsz, int* row_key, int* row_rank, int* list, int* errors,
    void* stream) {
  if (m <= 0) return 0;
  if (n_bins < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  constexpr int kThreads = 256;
  const int grid = (m + kThreads - 1) / kThreads;
  classify_kernel<<<grid, kThreads, 0, s>>>(
      m, n_bins, table_size, vector, bm, bk, bn, offsets, bin_tsize,
      indptr_a, a_bcol, indptr_b, indptr_c, counts, row_tsz, row_key,
      row_rank, errors);
  const int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  place_kernel<<<grid, kThreads, 0, s>>>(m, counts, row_key, row_rank, list);
  return static_cast<int>(cudaGetLastError());
}

// The launch shape of class c's kernel on the current device: out =
// {threads a block, dynamic shared memory bytes a block, resident blocks
// (the persistent grid), registers a thread}.
extern "C" int spgemm_bcsr_class_shape(int vector, int c, int* out) {
  if (c < 0 || c >= kClasses) return static_cast<int>(cudaErrorInvalidValue);
  const void* fn = reinterpret_cast<const void*>(class_kernel(vector, c));
  const int threads = class_threads(c), smem = class_smem(c);
  int err = set_smem(fn, smem);
  if (err) return err;
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  err = static_cast<int>(
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev));
  if (err) return err;
  err = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, fn, threads, smem));
  if (err) return err;
  cudaFuncAttributes attr;
  err = static_cast<int>(cudaFuncGetAttributes(&attr, fn));
  if (err) return err;
  out[0] = threads;
  out[1] = smem;
  out[2] = per_sm * sms;
  out[3] = attr.numRegs;
  return 0;
}

namespace {

int launch_one(int vector, int c, int pdl, int bcap_c, int b_bcol_len,
               int bm, int bk, int bn, int a16, int b16, int grid,
               int ws_tsz,
               const int* counts, int* pops, const int* list,
               const int* row_tsz, const int* indptr_a, const int* a_bcol,
               const float* a_blk, const int* indptr_b, const int* b_bcol,
               const float* b_blk, const int* indptr_c, int* out_bcol,
               float* out_blk, int* errors, int* ws_keys,
               cudaStream_t stream) {
  if (c < 0 || c >= kClasses || grid < 1 ||
      (c == kDirectClass && ws_keys == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const ClassKernel kernel = class_kernel(vector, c);
  const int smem = class_smem(c);
  const int err = set_smem(reinterpret_cast<const void*>(kernel), smem);
  if (err) return err;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(class_threads(c));
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = pdl ? 1 : 0;
  const Ops o{indptr_a, a_bcol, a_blk, indptr_b,  b_bcol,
              b_blk,    indptr_c, out_bcol, out_blk, bcap_c,
              b_bcol_len};
  cudaLaunchKernelEx(&cfg, kernel, ws_tsz, counts, pops, list, row_tsz, o,
                     bm, bk, bn, a16, b16, errors, ws_keys);
  return static_cast<int>(cudaGetLastError());
}

// Resident blocks of each staged class on each device and probe mode,
// found once.
constexpr int kDevices = 16;
int g_resident[kDevices][2][kClasses] = {};

int resident_blocks(int vector, int c, int* out) {
  int dev = 0;
  int err = static_cast<int>(cudaGetDevice(&dev));
  if (err) return err;
  int* slot = dev < kDevices ? &g_resident[dev][vector ? 1 : 0][c] : nullptr;
  if (slot != nullptr && *slot > 0) {
    *out = *slot;
    return 0;
  }
  int shape[4];
  err = spgemm_bcsr_class_shape(vector, c, shape);
  if (err) return err;
  if (shape[2] < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  if (slot != nullptr) *slot = shape[2];
  *out = shape[2];
  return 0;
}

}  // namespace

// One class's launch: grid blocks popping the rows that counts and list
// give class c (pops: the kClasses pop counters, zeroed by the caller).
// pdl: launch as a programmatic dependent of the kernel before it in the
// stream (another class launch).  ws_keys holds grid * 2 * ws_tsz ints for
// the direct class, null otherwise.  a16/b16: A's/B's tiles may be copied
// 16 bytes at a time (16-byte aligned bases).
extern "C" int spgemm_bcsr_class_launch(
    int vector, int c, int pdl, int bcap_c, int b_bcol_len, int bm, int bk,
    int bn, int a16, int b16, int grid, int ws_tsz, const int* counts,
    int* pops,
    const int* list, const int* row_tsz, const int* indptr_a,
    const int* a_bcol, const float* a_blk, const int* indptr_b,
    const int* b_bcol, const float* b_blk, const int* indptr_c,
    int* out_bcol, float* out_blk, int* errors, int* ws_keys, void* stream) {
  return launch_one(vector, c, pdl, bcap_c, b_bcol_len, bm, bk, bn, a16,
                    b16, grid, ws_tsz, counts, pops, list, row_tsz, indptr_a,
                    a_bcol,
                    a_blk, indptr_b, b_bcol, b_blk, indptr_c, out_bcol,
                    out_blk, errors, ws_keys,
                    static_cast<cudaStream_t>(stream));
}

// The whole single-product numeric phase: the classifying kernels, then
// classes cls_hi down to cls_lo, each a persistent grid of its resident
// blocks (the direct class: ws_blocks blocks over ws_keys, ws_blocks * 2 *
// table_size ints), the classes after the first as programmatic dependent
// launches.  counts: kClasses * (kLenBuckets + 1) zeroed ints;
// work: 4 * m ints.
extern "C" int spgemm_bcsr_numeric(
    int vector, int m, int n_bins, int table_size, int bcap_c,
    int b_bcol_len, int bm, int bk, int bn, int a16, int b16, int cls_hi,
    int cls_lo,
    int ws_blocks, const int* offsets, const int* bin_tsize,
    const int* indptr_a, const int* a_bcol, const float* a_blk,
    const int* indptr_b, const int* b_bcol, const float* b_blk,
    const int* indptr_c, int* counts, int* work, int* out_bcol,
    float* out_blk, int* errors, int* ws_keys, void* stream) {
  if (m <= 0) return 0;
  if (cls_hi >= kClasses || cls_lo < 0 || cls_lo > cls_hi)
    return static_cast<int>(cudaErrorInvalidValue);
  int err = spgemm_bcsr_classify(m, n_bins, table_size, vector, bm, bk, bn,
                                 offsets, bin_tsize, indptr_a, a_bcol,
                                 indptr_b, indptr_c, counts, work,
                                 work + m, work + 2 * m, work + 3 * m,
                                 errors, stream);
  if (err) return err;
  for (int c = cls_hi; c >= cls_lo; --c) {
    int grid = ws_blocks;
    if (c != kDirectClass) {
      err = resident_blocks(vector, c, &grid);
      if (err) return err;
    }
    const int ws_tsz = c == kDirectClass ? table_size : 0;
    err = launch_one(vector, c, c != cls_hi, bcap_c, b_bcol_len, bm,
                     bk, bn, a16, b16, grid, ws_tsz, counts, counts + kKeys,
                     work + 3 * m, work, indptr_a, a_bcol,
                     a_blk, indptr_b, b_bcol, b_blk, indptr_c, out_bcol,
                     out_blk, errors, ws_keys,
                     static_cast<cudaStream_t>(stream));
    if (err) return err;
  }
  return 0;
}

// The batched numeric phase for bin index `bin` of every fleet member: a
// grid of (grid_x, n_members) blocks of kBatchedThreads threads.
// Each array takes a member stride in elements (0: shared by all
// members): offsets rows of n_bins + 1, bin_tsize rows of n_bins, the
// operands as for spgemm_bcsr_class_launch.  out_bcol/out_blk are
// (n_members, bcap_c[, bm, bn]), zeroed by the caller.  smem_bytes: each
// block's dynamic shared memory (staged rows); ws_keys holds grid_x *
// n_members * 2 * ws_tsz ints (null when ws_tsz is 0) for direct rows.
extern "C" int spgemm_bcsr_batched_launch(
    int vector, int bin, int n_rows, int table_size, int smem_bytes,
    int ws_tsz, int bcap_c, int bm, int bk, int bn, int a16, int b16,
    int b_bcol_len, int grid_x, int n_members, const int* offsets,
    long long s_off, const int* bin_tsize, long long s_bt,
    const int* indptr_a, long long s_ia, const int* a_bcol, long long s_ac,
    const float* a_blk, long long s_ab, const int* indptr_b, long long s_ib,
    const int* b_bcol, long long s_bc, const float* b_blk, long long s_bb,
    const int* indptr_c, long long s_ic, int* out_bcol, float* out_blk,
    int* errors, int* ws_keys, void* stream) {
  auto kernel = vector ? bcsr_rows_batched_kernel<true>
                       : bcsr_rows_batched_kernel<false>;
  const int err = set_smem(reinterpret_cast<const void*>(kernel), smem_bytes);
  if (err) return err;
  kernel<<<dim3(grid_x, n_members), kBatchedThreads, smem_bytes,
           static_cast<cudaStream_t>(stream)>>>(
      bin, n_rows, table_size, smem_bytes, ws_tsz, bcap_c, bm, bk, bn, a16,
      b16, b_bcol_len, offsets, s_off, bin_tsize, s_bt, indptr_a, s_ia,
      a_bcol, s_ac, a_blk, s_ab, indptr_b, s_ib, b_bcol, s_bc, b_blk, s_bb,
      indptr_c, s_ic, out_bcol, out_blk, errors, ws_keys);
  return static_cast<int>(cudaGetLastError());
}
