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
//   * Every call runs by class, not by plan bin, over work items: a block
//     row of one member, or -- where the fleet shares every index array
//     (the schedule, indptr_a, a_bcol, indptr_b, b_bcol, indptr_c: a value
//     fleet on one plan) -- a block row of a group of members, which
//     stages the B block columns and probes once, and multiplies every
//     member's tiles into that member's tiles.  The single product is the
//     fleet of one member.  classify_kernel (one thread a unit: a row of
//     every member when the index arrays are shared, else a (member, row)
//     pair) writes each unit's table, its group and its items' key: the
//     class by the item's bytes (its group's tiles counted) -- a block's
//     shared memory of 30 / 54 / 111 / 225 KB (7 / 4 / 2 / 1 blocks an
//     SM), or direct -- and, within the class, its A-block count in
//     powers of two (the row's critical path: one stage per A block);
//     place_kernel lays every class's items out longest first.  No host
//     synchronisation.  Then one persistent launch per class that can hold
//     items, the largest class first, each block popping items with an
//     atomic: the longest rows start first.  The class launches after the
//     first are programmatic dependent launches: every block lets the next
//     class start at once, and block 0 of each class waits for the class
//     before it to finish before it exits, so the last class's end is
//     every class's end.
//   * A group's size (group_of) is read from the fleet's members, whether
//     A's and B's tiles are per member, and the row's bytes: the most
//     members, up to kMaxGroup, whose item still fits kGroupBytes of
//     shared memory, evened out over the groups the row needs; a row that
//     runs direct takes one member an item.  An item of members e0 ... e0
//     + gn - 1 keeps gn * need tiles in its table, member after member,
//     and each stage buffer gn of A's tiles (one when A is shared) and gn
//     runs of B's tiles (one when B is shared).
//   * Errors: a row whose table cannot hold its output (need_i > cap_i, a
//     table that is not a power of two, or below the chunk in vector
//     mode), a probe that finds the table full, an insert past need_i
//     (tested before the tile or out_bcol is written), a final count that
//     differs from need_i, and a row that indptr_c leaves empty but that
//     has pairs each add one to errors[0] for each of its members; so does
//     each member whose bins run past its rows (it runs no row), and a
//     fleet of 2^31 or more (member, row) pairs adds one and runs nothing.
//     Nothing is written outside the row's range of the output.
//   * The output is zeroed by the caller before launch: blocks run in no
//     order, so nothing like the TPU kernel's "zero at bin 0" is possible.
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
//: members an item of a fleet with shared index arrays takes at most, and
//: the shared memory its group may fill (group_of)
constexpr int kMaxGroup = 4;
constexpr long long kGroupBytes = 225 * 1024;
static_assert(kGroupBytes <= 225 * 1024, "a group's item must stay staged");

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
// One stage buffer of n B tiles: ga of A's tiles, the block columns (with
// room for their 16-byte aligned cover), gb runs of the n tiles.
__host__ __device__ constexpr long long half_bytes(long long n, int bm, int bk,
                                                   int bn, int ga = 1,
                                                   int gb = 1) {
  return r16(4LL * bm * bk * ga) + r16(4 * n) + 16 +
         r16(4LL * bk * bn * n * gb);
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
// Shared memory a staged item asks for: its table (the tiles of its g
// members) and its stage buffers (ga of A's tiles, gb runs of B's).
__host__ __device__ constexpr long long row_bytes(int tsz, int need, int bm,
                                                  int bk, int bn, int g = 1,
                                                  int ga = 1, int gb = 1) {
  return table_bytes(tsz, need * g, bm * bn) +
         stage_buffers(bm, bk, bn) *
             half_bytes(stage_min(need, bk, bn), bm, bk, bn, ga, gb);
}
__host__ __device__ constexpr int class_of_bytes(long long bytes) {
  int c = 0;
  while (c < kDirectClass && bytes > class_smem(c)) ++c;
  return c;
}
// Members an item of a row takes, of a fleet of n members that shares its
// index arrays (a_each / b_each: A's / B's tiles are per member): the most
// g <= kMaxGroup whose item fits kGroupBytes, evened out over the
// ceil(n / g) items the row then needs; 1 when even one member's row does
// not fit (it runs direct).
__host__ __device__ inline int group_of(int n, int tsz, int need, int bm,
                                        int bk, int bn, bool a_each,
                                        bool b_each) {
  int cap = 1;
  for (int g = n < kMaxGroup ? n : kMaxGroup; g > 1; --g)
    if (row_bytes(tsz, need, bm, bk, bn, g, a_each ? g : 1,
                  b_each ? g : 1) <= kGroupBytes) {
      cap = g;
      break;
    }
  const int items = (n + cap - 1) / cap;
  return (n + items - 1) / items;
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
// most n with nbuf buffers of half_bytes(n, ..., ga, gb) in rest (0 if
// none fits).
__device__ __forceinline__ int stage_tiles(long long rest, int nbuf, int bm,
                                           int bk, int bn, int ga, int gb) {
  const long long per = 4 + 4LL * bk * bn * gb;
  long long n = (rest / nbuf - r16(4LL * bm * bk * ga) - 48) / per;
  if (n < 0) n = 0;
  while (n > 0 && nbuf * half_bytes(n, bm, bk, bn, ga, gb) > rest) --n;
  while (nbuf * half_bytes(n + 1, bm, bk, bn, ga, gb) <= rest) ++n;
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

}  // namespace

// The fleet: each array's base and member stride in elements (0: one
// array every member shares), the outputs (n, bcap_c[, bm, bn]), the
// sizes, and whether every index array is shared (an item is then a row
// of a group of members).  The single product is the fleet of n = 1.  (Out
// of the anonymous namespace: the C interface takes it.)
struct Fleet {
  const int* offsets;
  long long s_off;
  const int* bin_tsize;
  long long s_bt;
  const int* indptr_a;
  long long s_ia;
  const int* a_bcol;
  long long s_ac;
  const float* a_blk;
  long long s_ab;
  const int* indptr_b;
  long long s_ib;
  const int* b_bcol;
  long long s_bc;
  const float* b_blk;
  long long s_bb;
  const int* indptr_c;
  long long s_ic;
  int* out_bcol;
  float* out_blk;
  int n, m, n_bins, table_size, bcap_c;
  int b_bcol_len;  // b_bcol's length (the bulk copies read no further)
  int bm, bk, bn;
  int a16, b16;    // every member's A / B tiles go 16 bytes at a time
  int grouped;
};

namespace {

// One item's arrays: its first member's, and its members' tiles and
// outputs at the member strides s_ab, s_bb (A's, B's tiles; 0 when
// shared) and bcap_c (out_bcol; out_blk bcap_c tiles).  A fleet's row
// body reads them from shared memory (Scratch::ops), so that none is held
// in a register across the row; the single product's are the launch's
// parameters.
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
  int b_bcol_len;
  long long s_ab, s_bb;
};

__device__ __forceinline__ Ops ops_of(const Fleet& f, int e0) {
  const long long e = e0;
  return Ops{f.indptr_a + e * f.s_ia, f.a_bcol + e * f.s_ac,
             f.a_blk + e * f.s_ab,    f.indptr_b + e * f.s_ib,
             f.b_bcol + e * f.s_bc,   f.b_blk + e * f.s_bb,
             f.indptr_c + e * f.s_ic, f.out_bcol + e * f.bcap_c,
             f.out_blk + e * f.bcap_c * f.bm * f.bn,
             f.bcap_c,                f.b_bcol_len,
             f.s_ab,                  f.s_bb};
}

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

// An item's id, row, table, output range, A blocks and members e0 ...
// e0 + gn - 1 (row -1: none).
struct RowMeta {
  int item, row, tsz, base, need, a0, na, e0, gn;
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
  // the next item's first, staged ahead (for item win_item)
  int win[2][2 * kWindow];
  int win_item;
  RowMeta meta[2];                // the item and the next
  Ops ops;                        // the item's arrays
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

// The prober warp of a staged item: probe the stage's n block columns
// codes[q] and replace each with its code, as probe_stage does, 32 pairs
// a round with a warp scan of the openings, writing an opened tile's block
// column for each of the item's members and counting an error once for
// each; lane 0 leaves the cursor in *cursor_out.
template <bool kVector>
__device__ __forceinline__ void probe_warp(int n, int* codes, int* keys,
                                           int* map, int tsz, int need,
                                           int base, int& cursor,
                                           int* cursor_out, const Ops& o,
                                           int gn, int* errors) {
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
        atomicAdd(errors, gn);
      } else if (opened) {
        const int pos = cursor + __popc(ballot & ((1u << lane) - 1u));
        if (pos < need) {
          map[slot] = pos;
          if (base + pos < o.bcap_c)
            for (int g = 0; g < gn; ++g)
              o.out_bcol[static_cast<size_t>(g) * o.bcap_c + base + pos] =
                  col;
          code = 2 * pos + 1;
        } else {
          map[slot] = -1;
          atomicAdd(errors, gn);
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

// multiply_stage8 for an item of gn members: the stage's n pairs of each
// member (A's tile at a + g * astride, B's run at b + g * bstride, 0 for
// a tile every member shares), each into the member's tiles (tiles + g *
// tstride), one (member, pair) per 16 threads at a time.
__device__ __forceinline__ void multiply_members8(int n, int gn,
                                                  const int* codes,
                                                  const float* a,
                                                  int astride, const float* b,
                                                  int bstride, float* tiles,
                                                  int tstride,
                                                  const Shape& s) {
  const int total = n * gn;
  for (int v = s.q8; v < total; v += s.q8step) {
    const int g = v / n;
    const int q = v - g * n;
    const int code = codes[q];
    if (code < 0) continue;
    const float* ag = a + g * astride + s.r8 * 8;
    const float4 a0 = *reinterpret_cast<const float4*>(ag);
    const float4 a1 = *reinterpret_cast<const float4*>(ag + 4);
    const float ar[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float* bq = b + g * bstride + q * 64 + s.c8;
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
    float4* dst = reinterpret_cast<float4*>(
        tiles + g * tstride + (code >> 1) * 64 + s.r8 * 8 + s.c8);
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

// multiply_stage<false> for an item of gn members (strides as for
// multiply_members8): (member, pair) items for fixed lanes, else
// (member, pair, lane) items nt apart.
__device__ __forceinline__ void multiply_members(int n, int gn,
                                                 const int* codes,
                                                 const float* a, int astride,
                                                 const float* b, int bstride,
                                                 float* tiles, int tstride,
                                                 const Shape& s) {
  const int bkbn = s.bk * s.bn;
  if (s.fixed) {
    const int total = n * gn;
    for (int v = s.q0; v < total; v += s.qstep) {
      const int g = v / n;
      const int q = v - g * n;
      const int code = codes[q];
      if (code < 0) continue;
      add_lane<false>(
          tiles + g * tstride, code, s,
          lane_product(a + g * astride + s.r * s.bk,
                       b + g * bstride + static_cast<size_t>(q) * bkbn + s.c,
                       s.bk, s.bn));
    }
    return;
  }
  const int per = n * s.tile;
  const int items = per * gn;
  for (int it = s.t; it < items; it += s.nt) {
    const int g = it / per;
    const int rest = it - g * per;
    const int q = rest / s.tile;
    const int code = codes[q];
    if (code < 0) continue;
    const int l = rest - q * s.tile;
    const int r = l / s.bn;
    const int c = l - r * s.bn;
    const float sum = lane_product(
        a + g * astride + r * s.bk,
        b + g * bstride + static_cast<size_t>(q) * bkbn + c, s.bk, s.bn);
    float* dst = tiles + g * tstride +
                 static_cast<size_t>(code >> 1) * s.tile + l;
    const float old = (code & 1) ? 0.0f : *dst;
    *dst = __fadd_rn(old, sum);
  }
}

// Copy stage (j, t0, n) into buffer `buf`, by the stager warp: A's tile
// j at sa (ga of them, a tile apart: one per member, or one for all), the
// block columns in the cols region (from sh->stage_off[buf] ints on) and
// the B tiles at sb (gb runs, bstride floats apart).  16-byte aligned
// tiles and the block columns' 16-byte aligned cover (when b_bcol holds
// it) go by bulk copies from lane 0, the rest by the lanes' 4-byte
// cp.async; the buffer's full barrier completes when all have landed.
__device__ __forceinline__ void issue_stage(float* sa, int* scols, float* sb,
                                            int bstride, int ga, int gb,
                                            int buf, int j, int t0, int n,
                                            const Ops& o, const Shape& s,
                                            Scratch* sh) {
  const int lane = threadIdx.x & 31;
  unsigned long long* bar = sh->full + buf;
  const int na = s.bm * s.bk;
  const int nb = n * s.bk * s.bn;
  const float* src_a = o.a_blk + static_cast<size_t>(j) * na;
  const float* src_b = o.b_blk + static_cast<size_t>(t0) * s.bk * s.bn;
  const int c0 = t0 & ~3;
  const int cn = ((t0 & 3) + n + 3) & ~3;
  const bool c16 = (reinterpret_cast<size_t>(o.b_bcol) & 15) == 0 &&
                   c0 + cn <= o.b_bcol_len;
  if (!(s.a16 && s.b16 && c16)) {
    if (!s.a16)
      for (int g = 0; g < ga; ++g)
        for (int i = lane; i < na; i += 32)
          async_copy4(sa + g * na + i, src_a + g * o.s_ab + i);
    if (!s.b16)
      for (int g = 0; g < gb; ++g)
        for (int i = lane; i < nb; i += 32)
          async_copy4(sb + g * bstride + i, src_b + g * o.s_bb + i);
    if (!c16)
      for (int i = lane; i < n; i += 32)
        async_copy4(scols + i, o.b_bcol + t0 + i);
    async_arrive(bar);
    __syncwarp();  // every lane's pending arrival before lane 0's
  }
  if (lane == 0) {
    sh->stage_off[buf] = c16 ? t0 & 3 : 0;
    sh->stage_n[buf] = n;
    const unsigned tx = (s.a16 ? 4u * na * ga : 0u) +
                        (s.b16 ? 4u * nb * gb : 0u) + (c16 ? 4u * cn : 0u);
    fence_proxy_async();
    mbar_arrive_tx(bar, tx);
    if (s.a16)
      for (int g = 0; g < ga; ++g)
        bulk_copy(sa + g * na, src_a + g * o.s_ab, 4u * na, bar);
    if (s.b16)
      for (int g = 0; g < gb; ++g)
        bulk_copy(sb + g * bstride, src_b + g * o.s_bb, 4u * nb, bar);
    if (c16) bulk_copy(scols, o.b_bcol + c0, 4u * cn, bar);
  }
}

// Where the class kernels' items come from: the class's list (its items
// list[start ...], n of them, popped through *pop), the units' tables and
// groups.
struct RowSource {
  int* pop;
  const int* list;
  int start, n;
  const int* unit_tsz;
  const int* unit_group;
};

// Pop the next item of src and read its RowMeta (lane 0 of a warp).  Item
// p = x * m + i is row i of member x, or of the group x of the row's
// members when the fleet shares its index arrays (unit i, else unit p);
// without kFleet (the single product) row p of member 0.
template <bool kFleet>
__device__ __forceinline__ RowMeta pop_item(const RowSource& src,
                                            const Fleet& f) {
  RowMeta m{-1, -1, 0, 0, 0, 0, 0, 0, 0};
  const int idx = atomicAdd(src.pop, 1);
  if (idx < src.n) {
    const int p = src.list[src.start + idx];
    const int x = kFleet ? p / f.m : 0;
    m.item = p;
    m.row = p - x * f.m;
    const int unit = kFleet && f.grouped ? m.row : p;
    m.tsz = src.unit_tsz[unit];
    m.e0 = x;
    m.gn = 1;
    if (kFleet && f.grouped) {
      const int g = src.unit_group[unit];
      m.e0 = x * g;
      m.gn = min(g, f.n - m.e0);
    }
    const long long e = m.e0;
    const int* ic = f.indptr_c + e * f.s_ic;
    const int* ia = f.indptr_a + e * f.s_ia;
    m.base = ic[m.row];
    m.need = ic[m.row + 1] - m.base;
    m.a0 = ia[m.row];
    m.na = ia[m.row + 1] - m.a0;
  }
  return m;
}

// Item m with its table in shared memory (smem, smem_bytes of it): keys
// and map (tsz each), then the tiles of its gn members (need each, member
// after member), then nbuf stage buffers; o: its arrays (kFleet: sh->ops,
// which thread 0 fills here; else the single product's).  Three roles run a pipeline over
// the row's stages through each buffer's barriers: warp 1 (the stager)
// walks the row and copies stage k into buffer k % nbuf once the
// multipliers have freed it (empty); warp 0 (the prober) probes each stage
// once its copies land (full); the other warps (the multipliers, s: their
// lanes) multiply each stage for every member once it is probed (probed),
// with a barrier of their own after each stage (a tile's sums in stage
// order), then free the buffer.  A stage of no tiles ends the row.  The
// stager then pops the next item (into *next) and stages its first
// window.  Every thread of the block calls it.
template <bool kVector, bool kFleet>
__device__ __forceinline__ void row_staged(const RowMeta& m, int smem_bytes,
                                           char* smem, const Ops& o,
                                           const Fleet& f, const Shape& s,
                                           Scratch* sh, int* errors,
                                           const RowSource& src,
                                           RowMeta* next, int& win_cur) {
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int tsz = m.tsz;
  const int base = m.base;
  const int need = m.need;
  const int gn = kFleet ? m.gn : 1;
  int* keys = reinterpret_cast<int*>(smem);
  int* map = keys + tsz;
  float* tiles = reinterpret_cast<float*>(map + tsz);
  const int nbuf = stage_buffers(s.bm, s.bk, s.bn);
  // A's and B's tiles in a stage buffer: one per member, or one for all
  const int ga = kFleet && f.s_ab ? gn : 1;
  const int gb = kFleet && f.s_bb ? gn : 1;
  // shared-memory offsets fit an int: 32-bit values hold fewer registers
  const int tb = static_cast<int>(table_bytes(tsz, need * gn, s.tile));
  const int cap_n =
      stage_tiles(smem_bytes - tb, nbuf, s.bm, s.bk, s.bn, ga, gb);
  char* stage = smem + tb;
  const int hb = static_cast<int>(half_bytes(cap_n, s.bm, s.bk, s.bn, ga,
                                             gb));
  const int cols_at = static_cast<int>(r16(4LL * s.bm * s.bk * ga));
  const int tiles_at = cols_at + static_cast<int>(r16(4LL * cap_n)) + 16;
  const int bstride = gb > 1 ? cap_n * s.bk * s.bn : 0;
  // 8x8x8 tiles four lanes a thread, where the tiles are 16-byte aligned
  const bool tile8 = s.tile8 && (tsz & 1) == 0;

  for (int k = tid; k < tsz; k += blockDim.x) keys[k] = kEmpty;
  if (tid == 0) {
    if (kFleet) sh->ops = ops_of(f, m.e0);
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
    // the first window may have been staged by the last item's stager
    const bool ready = sh->win_item == m.item;
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
                  reinterpret_cast<float*>(p + tiles_at), bstride, ga, gb, b,
                  j, t0, n, o, s, sh);
      b = b + 1 == nbuf ? 0 : b + 1;
    }
    // the stager is done early: pop the next item, read its meta and
    // stage its first window while this row is probed and multiplied
    RowMeta nm;
    if (lane == 0) {
      nm = pop_item<kFleet>(src, f);
      *next = nm;
      sh->win_item = nm.item;
    }
    nm.row = __shfl_sync(0xffffffffu, nm.row, 0);
    nm.a0 = __shfl_sync(0xffffffffu, nm.a0, 0);
    nm.na = __shfl_sync(0xffffffffu, nm.na, 0);
    if (kFleet) nm.e0 = __shfl_sync(0xffffffffu, nm.e0, 0);
    if (nm.row >= 0)
      fill_window(sh->win[win_cur ^ 1], nm.a0, nm.na, 0, lane, 32,
                  ops_of(f, kFleet ? nm.e0 : 0));
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
            keys, map, tsz, need, base, cursor, &sh->cursor, o, gn, errors);
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
      const float* a = reinterpret_cast<const float*>(cur);
      const float* bt = reinterpret_cast<const float*>(cur + tiles_at);
      if (kFleet && gn > 1) {
        const int astride = ga > 1 ? s.bm * s.bk : 0;
        if (tile8)
          multiply_members8(n, gn, codes, a, astride, bt, bstride, tiles,
                            need * s.tile, s);
        else
          multiply_members(n, gn, codes, a, astride, bt, bstride, tiles,
                           need * s.tile, s);
      } else if (tile8) {
        multiply_stage8(n, codes, a, bt, tiles, s);
      } else {
        multiply_stage<false>(n, codes, a, bt, tiles, s);
      }
      multipliers_sync(blockDim.x - 64);
      if (tid == 64) mbar_arrive(sh->empty + b);
    }
  }
  block_sync();  // every tile summed
  const int opened = sh->cursor;

  // flush each member's tiles, in insertion order, to the row's range
  int cnt = min(opened, need);
  if (base + cnt > o.bcap_c) cnt = max(0, o.bcap_c - base);
  const int nf = cnt * s.tile;
  for (int g = 0; g < gn; ++g) {
    float* dst = o.out_blk +
                 (static_cast<size_t>(g) * o.bcap_c + base) * s.tile;
    const float* from = tiles + static_cast<size_t>(g) * need * s.tile;
    if ((s.tile & 3) == 0 && (tsz & 1) == 0) {
      const float4* src4 = reinterpret_cast<const float4*>(from);
      float4* dst4 = reinterpret_cast<float4*>(dst);
      for (int i = tid; i < nf / 4; i += blockDim.x) dst4[i] = src4[i];
    } else {
      for (int i = tid; i < nf; i += blockDim.x) dst[i] = from[i];
    }
  }
  if (tid == 0 && opened != need) atomicAdd(errors, gn);
  block_sync();  // the next row may reuse the table and sh->cursor
}

// Item m (one member) with keys and map in device memory (ws, 2 * tsz
// ints) and its tiles accumulated in place in out_blk; codes holds
// kDirectPairs ints of shared memory; o as for row_staged.
template <bool kVector, bool kFleet>
__device__ void row_direct(const RowMeta& m, int* ws, int* codes,
                           const Ops& o, const Fleet& f, const Shape& s,
                           Scratch* sh, int* errors) {
  const int tid = threadIdx.x;
  const int row = m.row;
  const int tsz = m.tsz;
  if (kFleet) {
    if (tid == 0) sh->ops = ops_of(f, m.e0);
    block_sync();
  }
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

// The work items (see the header), one thread a unit u: row u of every
// member when the fleet shares its index arrays, else row i of member e,
// u = e * m + i.  Unit u gets its table tsz_i (unit_tsz[u]), its group
// (unit_group[u]), the key (class, A-block bucket) of its items in
// unit_key[u] (-1: none) and the rank of its first item among that key's
// items in unit_rank[u]; counts gains one per item.  errors gains one per
// member of a unit whose table cannot hold its output or that indptr_c
// leaves empty but that has pairs, and one per member whose bins run past
// its rows (none of its units has items).
__global__ void classify_kernel(
    Fleet f, int vector, int* __restrict__ counts, int* __restrict__ unit_tsz,
    int* __restrict__ unit_key, int* __restrict__ unit_rank,
    int* __restrict__ unit_group, int* __restrict__ errors) {
  __shared__ int s_n[kKeys];
  __shared__ int s_base[kKeys];
  for (int k = threadIdx.x; k < kKeys; k += blockDim.x) s_n[k] = 0;
  block_sync();
  const long long units =
      f.grouped ? f.m : static_cast<long long>(f.n) * f.m;
  const long long u =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  int key = -1, rank = 0;
  if (u < units) {
    const long long e = f.grouped ? 0 : u / f.m;
    const int i = static_cast<int>(u - e * f.m);
    // the members this unit's errors stand for
    const int members = f.grouped ? f.n : 1;
    const int* offsets = f.offsets + e * f.s_off;
    const int* bin_tsize = f.bin_tsize + e * f.s_bt;
    const int* indptr_a = f.indptr_a + e * f.s_ia;
    const int* a_bcol = f.a_bcol + e * f.s_ac;
    const int* indptr_b = f.indptr_b + e * f.s_ib;
    const int* indptr_c = f.indptr_c + e * f.s_ic;
    int tsz = 0, group = 1;
    bool bad = false;
    if (offsets[0] < 0 || offsets[f.n_bins] > f.m) {
      bad = i == 0;  // the member's bins run past its rows: counted once
    } else {
      // the bin of row i: the last b with offsets[b] <= i
      int lo = 0, hi = f.n_bins - 1;
      while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (offsets[mid] <= i) lo = mid; else hi = mid - 1;
      }
      const bool in_bin = offsets[lo] <= i && i < offsets[lo + 1];
      const int cap = in_bin ? min(bin_tsize[lo], f.table_size) : 0;
      const int need = indptr_c[i + 1] - indptr_c[i];
      const int a0 = indptr_a[i], na = indptr_a[i + 1] - a0;
      bad = need < 0;
      if (need > 0) {
        bad = !in_bin || bad_cap(cap, vector) || need > cap || na <= 0;
        if (!bad) {
          tsz = row_table(cap, need);
          if (f.grouped)
            group = group_of(f.n, tsz, need, f.bm, f.bk, f.bn, f.s_ab != 0,
                             f.s_bb != 0);
          const int g = min(group, f.n);
          const int c = class_of_bytes(row_bytes(
              tsz, need, f.bm, f.bk, f.bn, g, f.s_ab ? g : 1,
              f.s_bb ? g : 1));
          key = c * kLenBuckets + len_bucket(na);
          rank = atomicAdd(&s_n[key], f.grouped ? (f.n + g - 1) / g : 1);
        }
      } else if (need == 0) {
        for (int j = a0; j < a0 + na && !bad; ++j) {
          const int k = a_bcol[j];
          bad = indptr_b[k + 1] > indptr_b[k];
        }
      }
    }
    unit_tsz[u] = tsz;
    unit_group[u] = group;
    if (bad) atomicAdd(errors, members);
  }
  block_sync();
  for (int k = threadIdx.x; k < kKeys; k += blockDim.x)
    if (s_n[k]) s_base[k] = atomicAdd(counts + k, s_n[k]);
  block_sync();
  if (u < units) {
    unit_key[u] = key;
    if (key >= 0) unit_rank[u] = s_base[key] + rank;
  }
}

// Lay every class's items out in list, classes in order, within a class
// the longest A-block bucket first (one thread a unit; a shared row's
// groups side by side).
__global__ void place_kernel(Fleet f, const int* __restrict__ counts,
                             const int* __restrict__ unit_key,
                             const int* __restrict__ unit_rank,
                             const int* __restrict__ unit_group,
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
  const long long units =
      f.grouped ? f.m : static_cast<long long>(f.n) * f.m;
  const long long u =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (u >= units) return;
  const int key = unit_key[u];
  if (key < 0) return;
  int* at = list + s_off[key] + unit_rank[u];
  if (!f.grouped) {
    *at = static_cast<int>(u);
    return;
  }
  const int g = unit_group[u];
  for (int x = 0; x * g < f.n; ++x) at[x] = x * f.m + static_cast<int>(u);
}

// A fleet too large for the item lists: one error, no item.
__global__ void too_many_items_kernel(int* errors) { atomicAdd(errors, 1); }

// The items of class kClass: a persistent grid whose blocks pop items from
// the class's part of list (counted in counts) through pops[kClass] until
// it runs dry.  Staged classes keep each item's table in shared memory;
// the direct class keeps keys and map in the block's ws_tsz * 2 ints of
// ws_keys (its items are of one member each).
template <bool kVector, int kClass, bool kFleet>
__global__ void __launch_bounds__(class_threads(kClass),
                                  class_blocks_per_sm(kClass))
    bcsr_class_kernel(Fleet f, int ws_tsz, const int* __restrict__ counts,
                      int* pops, const int* __restrict__ list,
                      const int* __restrict__ unit_tsz,
                      const int* __restrict__ unit_group, int* errors,
                      int* ws_keys) {
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
                      ? make_shape(f.bm, f.bk, f.bn, f.a16, f.b16,
                                   threadIdx.x, blockDim.x)
                      : make_shape(f.bm, f.bk, f.bn, f.a16, f.b16,
                                   static_cast<int>(threadIdx.x) - 64,
                                   blockDim.x - 64);
  const RowSource src{pops + kClass, list, start, n, unit_tsz, unit_group};
  // the item's arrays: a fleet's in shared memory, the single product's
  // the launch's
  const Ops single = ops_of(f, 0);
  const Ops& o = kFleet ? sh.ops : single;
  if (threadIdx.x == 0) {
    sh.meta[0] = pop_item<kFleet>(src, f);
    sh.win_item = -1;
  }
  block_sync();
  int win_cur = 0;  // the stager's window (warp 1)
  for (int p = 0;; p ^= 1) {
    const RowMeta m = sh.meta[p];
    if (m.row < 0) break;
    if (kClass == kDirectClass) {
      if (threadIdx.x == 0)  // read after this row's barriers
        sh.meta[p ^ 1] = pop_item<kFleet>(src, f);
      row_direct<kVector, kFleet>(
          m, ws_keys + static_cast<size_t>(blockIdx.x) * 2 * ws_tsz,
          reinterpret_cast<int*>(smem), o, f, s, &sh, errors);
    } else {
      // the stager pops the next item, after this row's barriers
      row_staged<kVector, kFleet>(m, class_smem(kClass), smem, o, f, s, &sh,
                                  errors, src, &sh.meta[p ^ 1], win_cur);
    }
  }
  // this class ends after the one before it (a no-op after a plain launch)
  if (blockIdx.x == 0) asm volatile("griddepcontrol.wait;" ::: "memory");
}

using ClassKernel = void (*)(Fleet, int, const int*, int*, const int*,
                             const int*, const int*, int*, int*);

template <bool kVector, bool kFleet>
ClassKernel class_kernel_of(int c) {
  switch (c) {
    case 0: return bcsr_class_kernel<kVector, 0, kFleet>;
    case 1: return bcsr_class_kernel<kVector, 1, kFleet>;
    case 2: return bcsr_class_kernel<kVector, 2, kFleet>;
    case 3: return bcsr_class_kernel<kVector, 3, kFleet>;
    default: return bcsr_class_kernel<kVector, 4, kFleet>;
  }
}

// Class c's kernel, built for the fleet of one member (the single
// product: member 0's arrays are the launch's, one member an item) and
// for fleets (each item's arrays in shared memory, groups of members).
ClassKernel class_kernel(int vector, int c, bool fleet = false) {
  if (fleet)
    return vector ? class_kernel_of<true, true>(c)
                  : class_kernel_of<false, true>(c);
  return vector ? class_kernel_of<true, false>(c)
                : class_kernel_of<false, false>(c);
}

int set_smem(const void* kernel, int smem_bytes) {
  if (smem_bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes));
}

// The units the classifying kernel takes and the (member, row) pairs the
// item lists hold at most.
long long fleet_units(const Fleet& f) {
  return f.grouped ? f.m : static_cast<long long>(f.n) * f.m;
}

}  // namespace

// The work items of a fleet: classify_kernel, then place_kernel.  counts
// holds kClasses * kLenBuckets zeroed counts (then the class kernels'
// kClasses pop counters, untouched here); work holds, for the U units
// (m when f->grouped, else n * m), unit_tsz, unit_key, unit_rank and
// unit_group, U ints each, then the item list, n * m ints.  A fleet of
// 2^31 or more (member, row) pairs adds one to errors and lists nothing.
extern "C" int spgemm_bcsr_classify(int vector, const Fleet* f, int* counts,
                                    int* work, int* errors, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (static_cast<long long>(f->n) * f->m > 0x7fffffffLL) {
    too_many_items_kernel<<<1, 1, 0, s>>>(errors);
    return static_cast<int>(cudaGetLastError());
  }
  const long long units = fleet_units(*f);
  if (units <= 0) return 0;
  if (f->n_bins < 1) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int kThreads = 256;
  const int grid = static_cast<int>((units + kThreads - 1) / kThreads);
  int* unit_tsz = work;
  int* unit_key = work + units;
  int* unit_rank = work + 2 * units;
  int* unit_group = work + 3 * units;
  classify_kernel<<<grid, kThreads, 0, s>>>(*f, vector, counts, unit_tsz,
                                           unit_key, unit_rank, unit_group,
                                           errors);
  const int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  place_kernel<<<grid, kThreads, 0, s>>>(*f, counts, unit_key, unit_rank,
                                        unit_group, work + 4 * units);
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

int launch_one(int vector, int c, int pdl, int grid, int ws_tsz,
               const Fleet& f, int* counts, int* work, int* errors,
               int* ws_keys, cudaStream_t stream) {
  if (c < 0 || c >= kClasses || grid < 1 ||
      (c == kDirectClass && ws_keys == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long units = fleet_units(f);
  if (units <= 0 || static_cast<long long>(f.n) * f.m > 0x7fffffffLL)
    return 0;
  const ClassKernel kernel = class_kernel(vector, c, f.n > 1);
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
  // the kernel's list, unit_tsz and unit_group (spgemm_bcsr_classify)
  cudaLaunchKernelEx(&cfg, kernel, f, ws_tsz, counts, counts + kKeys,
                     work + 4 * units, work, work + 3 * units, errors,
                     ws_keys);
  return static_cast<int>(cudaGetLastError());
}

// A class launch's grid: the direct class's ws_blocks, else the class's
// resident blocks, but no more than the fleet's (member, row) pairs.
int class_grid(int vector, int c, const Fleet& f, int ws_blocks, int* grid) {
  if (c == kDirectClass) {
    *grid = ws_blocks;
    return 0;
  }
  const int err = resident_blocks(vector, c, grid);
  const long long pairs = static_cast<long long>(f.n) * f.m;
  if (pairs >= 1 && pairs < *grid) *grid = static_cast<int>(pairs);
  return err;
}

}  // namespace

// One class's launch: blocks popping the items that counts and work (as
// spgemm_bcsr_classify left them) give class c; the class's pop counter
// (counts[kKeys + c]) must be zero.  pdl: launch as a programmatic
// dependent of the kernel before it in the stream (another class launch).
// ws_keys holds ws_blocks * 2 * ws_tsz ints for the direct class (its
// grid: ws_blocks), null otherwise.
extern "C" int spgemm_bcsr_class_launch(int vector, int c, int pdl,
                                        int ws_blocks, int ws_tsz,
                                        const Fleet* f, int* counts,
                                        int* work, int* errors, int* ws_keys,
                                        void* stream) {
  int grid = 0;
  const int err = class_grid(vector, c, *f, ws_blocks, &grid);
  if (err) return err;
  return launch_one(vector, c, pdl, grid, ws_tsz, *f, counts, work, errors,
                    ws_keys, static_cast<cudaStream_t>(stream));
}

// A whole numeric phase, every member: the classifying kernels, then
// classes cls_hi down to cls_lo, each a persistent grid (the direct class:
// ws_blocks blocks over ws_keys, ws_blocks * 2 * table_size ints), the
// classes after the first as programmatic dependent launches.  counts:
// kClasses * (kLenBuckets + 1) zeroed ints; work as for
// spgemm_bcsr_classify.
extern "C" int spgemm_bcsr_numeric(int vector, const Fleet* f, int cls_hi,
                                   int cls_lo, int ws_blocks, int* counts,
                                   int* work, int* errors, int* ws_keys,
                                   void* stream) {
  if (cls_hi >= kClasses || cls_lo < 0 || cls_lo > cls_hi)
    return static_cast<int>(cudaErrorInvalidValue);
  int err = spgemm_bcsr_classify(vector, f, counts, work, errors, stream);
  if (err) return err;
  for (int c = cls_hi; c >= cls_lo; --c) {
    int grid = 0;
    err = class_grid(vector, c, *f, ws_blocks, &grid);
    if (err) return err;
    err = launch_one(vector, c, c != cls_hi, grid,
                     c == kDirectClass ? f->table_size : 0, *f, counts, work,
                     errors, ws_keys, static_cast<cudaStream_t>(stream));
    if (err) return err;
  }
  return 0;
}
