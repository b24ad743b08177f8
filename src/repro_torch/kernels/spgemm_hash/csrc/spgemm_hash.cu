// Hash-accumulator SpGEMM kernels for Hopper (sm_90a): paper Figs. 7 and 8.
//
// Replaces the Pallas TPU kernels of repro/kernels/spgemm_hash/kernel.py:
//   numeric_call  (_numeric_kernel, _row_loop(numeric=True), _probe_scalar)
//   symbolic_call (_symbolic_kernel)
//   _probe_vector (the hash_vector mode of both)
//   batched_symbolic_call (_batched_symbolic_kernel) and
//     batched_numeric_call (_batched_numeric_kernel): symbolic_call and
//     numeric_call over the grid (members, bins) of a fleet of products
// and adds two kernels that replace none: classify_kernel with its
// place_kernel (below), and bitmap_class_kernel, the symbolic phase's
// rows past one block's table.
//
// What each computes, per output row i:
//   insert every column k of B's rows selected by A's row i into a table
//   keyed by column, hashed as (uint32(col) * 0x9E3779B9) & (tsz - 1)
//   (the TPU kernel's int32 product by -1640531527: same bits), probing
//   linearly; symbolic writes the number of distinct columns, numeric adds
//   a_ij * b_jk into the slot and flushes the occupied slots, unsorted, to
//   out[indptr_c[i] + cnt].
//
// Bound: memory.  Each product reads one B index and value and does one
// probe and one atomic in the table; the output is written once.  The
// least time is the bytes of A, B's touched entries and C over HBM rate.
// A table that lives in device memory adds its own bytes: clearing and
// flushing a table of tsz slots moves 16 * tsz bytes, so the design keeps
// tables small and on chip.
//
// Design on this card:
//   * A table per row.  The TPU kernel gives every row of a bin the bin's
//     table (min(bin_tsize[b], table_size) slots, the cap).  Here row i
//     probes tsz_i = min(cap, lowest_p2(max(2 * need_i, CHUNK))) slots,
//     need_i its output count (numeric, from indptr_c) or its product
//     count (symbolic: the sum of its B rows' lengths): at most half
//     full, and never larger than the plan's table, so a plan sized at
//     load factor 1 stays exactly full and one past fill still errors.  A
//     row with no output clears, probes and flushes nothing.  Clearing
//     and flushing touch tsz_i slots, not the cap.
//   * A fleet is n members, each array at base + e * stride (stride 0: one
//     array that every member shares, as a value fleet shares its plan's
//     schedule); the single product is the fleet of one member.  Both
//     phases, of a fleet or of one product, run rows by table class, not
//     by plan bin.  classify_kernel (one thread a
//     (member, row) pair; replaces no TPU kernel: the TPU grid walks bins
//     in order and needs no row lists) writes each pair's tsz_i and its
//     rank among its class's pairs, counting each class; place_kernel, in
//     the same call, lays the pairs out in one list of n * m entries,
//     class after class, so grouping costs the execute no host
//     synchronisation.  An entry is e * m + i (int32; the host checks n * m
//     < 2^31).  A long A row's product count is summed by its whole warp,
//     and stops at the cap (any count past half the cap gives the cap).
//     Then one persistent launch per class that can hold rows (the host
//     knows the largest bin table of the fleet): as many blocks (or
//     clusters) as the card holds at once, each popping entries from its
//     class's part of the list with an atomic counter (the next entry is
//     popped while the current row runs), every member's rows in one
//     launch; the single product (one member) takes its arrays as they
//     are, with no member arithmetic in the row loop.  Classes:
//       0-2  tables of <= 1,024 / 4,096 / 16,384 slots in one block's
//            shared memory (numeric 8 / 32 / 128 KB of key + value,
//            symbolic half: keys only; 128 / 256 / 1,024 threads, the
//            symbolic class 0 64: its short rows wait on a chain of
//            dependent loads, and twice the blocks an SM hide more of
//            it);
//       3-5  32,768 / 65,536 / 131,072 slots in a thread-block cluster of
//            2 / 4 / 8 blocks of 1,024 threads: one contiguous slice of
//            16,384 slots (a multiple of CHUNK: a chunk never straddles two
//            blocks) in each block's shared memory, reached by the others
//            through distributed shared memory (map_shared_rank).  Keys go
//            in with atomicCAS and values with atomicAdd on the owning
//            block's slice.  After a cluster barrier the numeric phase
//            flushes each block's slice at the sum of the lower ranks'
//            counts and the symbolic phase writes the sum of the ranks'
//            inserts, both read across the cluster; every block leaves the
//            kernel through one more cluster barrier, so none exits while
//            another may still read its shared memory;
//       6    larger tables: a per-block workspace in device memory (grid
//            GLOBAL_BLOCKS, the fleet's largest table a block), each row
//            using its own tsz_i slots of it;
//       7    symbolic only, when the host gives B's width (Fleet::n_cols)
//            and its bitmap fits one block (kBitmapMaxWords): every row
//            whose tsz_i passes Fleet::bitmap_above (4,096 slots, or the
//            bitmap's words where those are more), in place of the larger
//            table classes.  The symbolic phase stores no value, so a bit
//            per column of B says all a key does: one block of 1,024
//            threads a row clears n_cols / 8 bytes of shared memory (8 KB
//            at 65,536 columns, where the row's keys would take 32 KB or
//            more, across a cluster past 64 KB), sets one bit a product with
//            atomicOr, read first so that a hub column is read and not
//            contended, and writes the bitmap's popcount.  No probe, no
//            remote atomic, no table of 2 * flop slots to clear.  A count
//            past tsz_i (the table the row would have filled) adds one to
//            errors, as that table's full probe would have.
//   * Inside a team (a block, or a cluster's blocks) a row's products are
//     spread evenly over every thread, one key a thread: A's row is staged
//     blockDim entries at a time in shared memory (each entry's B row start
//     and the scan of the B rows' lengths), and a thread finds the entry of
//     its product q by a binary search of the scan.  (One warp per A entry,
//     lanes over its B row, left a row waiting on its longest B row: G500's
//     hubs hold thousands of entries.)  Each thread loads its next
//     product's B index and values while it probes the current one.
//     Inserts race, so the column order of
//     a row is free (the contract is "some order") and float sums may round
//     in another order, within 1 ulp per product (exact on dyadic values).
//     Products are rounded before the add (__fmul_rn): no FMA, no TF32.
//   * Chunked probing (Fig. 8b, vector mode), one lane per key: the lane
//     reads the 8-slot chunk hash(col) & (tsz / 8 - 1) as 16-byte loads
//     (the second half only when the first holds neither the key nor an
//     EMPTY slot), takes the first slot holding the key, else claims the
//     first EMPTY slot with atomicCAS (a lost CAS re-reads the same chunk),
//     else moves to the next chunk -- the TPU kernel's one vector compare
//     of a chunk, in registers.  Tables stay >= CHUNK slots and 16-byte
//     aligned.
//   * Every barrier of the row body is the non-aligned barrier.sync (and
//     barrier.cluster.arrive/wait): lanes leave the probe loops at
//     different times, and with the aligned forms that __syncthreads() and
//     cluster.sync() compile to, about one call in thirty of the G500 s16
//     vector product left one block's late lanes a barrier behind for the
//     rest of its rows.
//   * The flush takes positions a warp at a time (__ballot_sync, one
//     shared atomic on the row's cursor): no block-wide sync per 32 slots.
//     A count that disagrees with indptr_c, or a probe that runs past a
//     full table, adds one to errors[0] and writes nothing outside the row;
//     so does a row that indptr_c leaves empty but that has products.
//   * The output is zeroed by the caller before launch: blocks run in no
//     order, so nothing like the TPU kernel's "zero at bin 0" is possible.
//
// Plain C interface, loaded with ctypes; every launch reports
// cudaGetLastError().

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace cg = cooperative_groups;

// The arrays of a fleet of n products (kernel.py's _Fleet lays out the
// same fields): member e's array starts at base + e * stride (elements;
// stride 0 shares one array among all members).  Numeric writes member
// e's output at out_* + e * cap_c, symbolic its counts at row_nnz + e * m.
// The single product is the fleet of one member.  n_cols is B's width,
// which every member shares; bitmap_above (symbolic only, else 0) the
// table above which a row goes to the bitmap class, 0 for none.  Outside
// the anonymous namespace: the C interface takes it.
struct Fleet {
  const int* offsets;   long long s_off;  // n_bins + 1 a member
  const int* bin_tsize; long long s_bt;   // n_bins a member
  const int* indptr_a;  long long s_ia;
  const int* a_idx;     long long s_ai;
  const float* a_val;   long long s_av;
  const int* indptr_b;  long long s_ib;
  const int* b_idx;     long long s_bi;
  const float* b_val;   long long s_bv;
  const int* indptr_c;  long long s_ic;   // numeric only
  int* out_cols;                          // numeric only
  float* out_vals;                        // numeric only
  int* row_nnz;                           // symbolic only
  long long cap_c;
  int n, m, n_bins, table_size, n_cols, bitmap_above;
};

namespace {

constexpr int kEmpty = -1;
constexpr unsigned kHashConst = 0x9E3779B9u;  // == -1640531527 mod 2^32
constexpr int kChunk = 8;
//: one block's largest table: 16,384 slots, 128 KB of key + value
constexpr int kSliceSlots = 16384;
constexpr int kClasses = 8;
constexpr int kGlobalClass = 6;
constexpr int kBitmapClass = 7;
//: the widest B whose bitmap one block holds: 200 KB, 1,638,400 columns
constexpr int kBitmapMaxWords = 51200;

// Largest table of class c (slots), its blocks (a cluster past one) and
// threads a block (by phase: numeric or symbolic).
__host__ __device__ constexpr int class_slots(int c) {
  return c == 0 ? 1024 : c == 1 ? 4096 : c == 2 ? 16384 : c == 3 ? 32768
       : c == 4 ? 65536 : c == 5 ? 131072 : 0x7fffffff;
}
__host__ __device__ constexpr int class_blocks(int c) {
  return c == 3 ? 2 : c == 4 ? 4 : c == 5 ? 8 : 1;
}
__host__ __device__ constexpr int class_threads(int numeric, int c) {
  return c == 0 ? (numeric ? 128 : 64) : c == 1 ? 256
       : c == kGlobalClass ? 512 : 1024;
}
// Table slots in a class's block's shared memory: its table, or its slice.
__host__ __device__ constexpr int class_smem_slots(int c) {
  return c >= kGlobalClass ? 0 : c < 3 ? class_slots(c) : kSliceSlots;
}
// Words of the bitmap class's bitmap (a multiple of four: 16 bytes).
__host__ __device__ constexpr int bitmap_words(int n_cols) {
  return ((n_cols + 31) / 32 + 3) & ~3;
}

// A row's class from its table (bitmap_above: Fleet's, 0 for none).
__device__ __forceinline__ int row_class(int tsz, int bitmap_above) {
  if (bitmap_above > 0 && tsz > bitmap_above) return kBitmapClass;
  int c = 0;
  while (c < kGlobalClass && tsz > class_slots(c)) ++c;
  return c;
}

// A row's table: min(cap, lowest power of two >= max(2 * need, CHUNK)),
// 0 for a row with nothing to insert.
__device__ __forceinline__ int row_table(int cap, long long need) {
  if (need <= 0 || cap <= 0) return 0;
  if (need >= cap) return cap;
  int p = kChunk;
  while (p < 2 * need) p <<= 1;
  return p < cap ? p : cap;
}

__device__ __forceinline__ unsigned hash_of(int col, unsigned mask) {
  return (static_cast<unsigned>(col) * kHashConst) & mask;
}

// Tables are filled by atomics: read them past any stale cached line.
__device__ __forceinline__ int load_key(const int* p) {
  return *reinterpret_cast<const volatile int*>(p);
}
__device__ __forceinline__ float load_val(const float* p) {
  return *reinterpret_cast<const volatile float*>(p);
}
// Four slots of a chunk in one 16-byte load.
__device__ __forceinline__ void load_quad(const int* p, int k[4]) {
  asm volatile("ld.volatile.v4.s32 {%0, %1, %2, %3}, [%4];"
               : "=r"(k[0]), "=r"(k[1]), "=r"(k[2]), "=r"(k[3])
               : "l"(p) : "memory");
}

// Per-block scratch of the row body, two of each by row parity: row k
// uses [k & 1] and resets [(k + 1) & 1] after its first team sync, when no
// block of the team can still read the previous row's.
struct Scratch {
  int count[2];     // keys this block inserted
  int cursor[2];    // flush positions this block took
  int occupied[2];  // occupied slots of this block's slice (cluster)
  int item[2];      // the next list entry (rank 0's is read)
  int warp_sum[32];  // the chunk scan's per-warp totals
};

// A staged chunk of A's row, one entry a thread, in dynamic shared memory
// after the table (kStageBytes a thread): each entry's inclusive end in
// the chunk's products (the scan of its B row lengths), its B row start
// less its first product (so product q of the entry reads B at bofs + q)
// and its A value.
constexpr int kStageBytes = 12;
struct Stage {
  int* end;
  int* bofs;
  float* av;
};

__device__ __forceinline__ Stage stage_at(int* p) {
  return {p, p + blockDim.x, reinterpret_cast<float*>(p + 2 * blockDim.x)};
}

__device__ __forceinline__ void scratch_reset(Scratch* sh, int p) {
  sh->count[p] = 0;
  sh->cursor[p] = 0;
  sh->occupied[p] = 0;
}

// Block and cluster barriers that count every thread: after the
// data-dependent probe loops the lanes of a warp reach them apart, and the
// aligned forms __syncthreads() and cluster.sync() compile to (every lane
// of a warp at the same instruction, at once) let a warp's late lanes fall
// one barrier behind the rest of the block.
__device__ __forceinline__ void block_sync() {
  asm volatile("barrier.sync 0;" ::: "memory");
}
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\n\t"
               "barrier.cluster.wait.acquire;" ::: "memory");
}

// A table that one block owns: its shared memory, or its slice of a
// workspace in device memory.
struct BlockTable {
  static constexpr int kBlocks = 1;
  int* keys;
  float* vals;
  __device__ int rank() const { return 0; }
  __device__ void sync() const { block_sync(); }
  __device__ void size(int) {}
  __device__ int own_slots(int tsz) const { return tsz; }
  __device__ int* key(int s) const { return keys + s; }
  __device__ float* val(int s) const { return vals + s; }
  __device__ Scratch* scratch_of(Scratch* sh, int) const { return sh; }
};

// A table of tsz slots cut into kBlocksT slices of tsz / kBlocksT, slice r
// in the shared memory of the cluster's block r.
template <int kBlocksT>
struct ClusterTable {
  static constexpr int kBlocks = kBlocksT;
  int* keys;    // this block's slice
  float* vals;
  int my_rank;
  int shift;    // log2 of the slice
  __device__ int rank() const { return my_rank; }
  __device__ void sync() const { cluster_sync(); }
  __device__ void size(int tsz) { shift = __ffs(tsz / kBlocks) - 1; }
  __device__ int own_slots(int tsz) const { return tsz / kBlocks; }
  template <class T>
  __device__ T* at(T* base, int s) const {
    const int owner = s >> shift;
    T* p = base + (s & ((1 << shift) - 1));
    return owner == my_rank ? p : cg::this_cluster().map_shared_rank(p, owner);
  }
  __device__ int* key(int s) const { return at(keys, s); }
  __device__ float* val(int s) const { return at(vals, s); }
  __device__ Scratch* scratch_of(Scratch* sh, int r) const {
    return cg::this_cluster().map_shared_rank(sh, r);
  }
};

// Linear probing (Fig. 8a).  Returns the slot that holds col (claiming an
// EMPTY one if needed), or -1 when every slot holds another key.  Each
// step is one atomicCAS, whose old value says all a read would: EMPTY
// (claimed), col (found) or another key (next slot): one round trip a
// step, where a read and then a CAS take two for a new key.
template <class Tab>
__device__ __forceinline__ int insert_scalar(const Tab& tab, int tsz, int col,
                                             int* inserted) {
  const unsigned mask = static_cast<unsigned>(tsz) - 1u;
  unsigned h = hash_of(col, mask);
  *inserted = 0;
  for (int step = 0; step < tsz; ++step) {
    const int old = atomicCAS(tab.key(static_cast<int>(h)), kEmpty, col);
    if (old == kEmpty) {
      *inserted = 1;
      return static_cast<int>(h);
    }
    if (old == col) return static_cast<int>(h);
    h = (h + 1u) & mask;
  }
  return -1;
}

// Chunked probing (Fig. 8b) by one lane: slots only ever go from EMPTY to
// a key, and a key is claimed in the first EMPTY slot of the first chunk
// that has one, so a chunk with an EMPTY slot and no col ends the search.
// By the same order a chunk fills from its first slot, so its first half
// decides whenever it holds col or an EMPTY slot; the second half is read
// only when the first is full of other keys.
template <class Tab>
__device__ __forceinline__ int insert_vector(const Tab& tab, int tsz, int col,
                                             int* inserted) {
  const unsigned cmask = static_cast<unsigned>(tsz / kChunk) - 1u;
  unsigned c = hash_of(col, cmask);
  *inserted = 0;
  // each step moves to the next chunk or follows a slot that another key
  // just took, so tsz / kChunk + tsz steps visit everything
  const int max_steps = tsz / kChunk + tsz + 1;
  for (int step = 0; step < max_steps; ++step) {
    const int first = static_cast<int>(c) * kChunk;
    int* p = tab.key(first);
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
      *inserted = 1;
      return first + empty;
    }
    if (old == col) return first + empty;
    // another key took the slot: read the same chunk again
  }
  return -1;
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The staged entry holding product q: the first at or after e whose end
// passes q (n_ent entries staged).
__device__ __forceinline__ int find_entry(const int* end, int e, int n_ent,
                                          int q) {
  int hi = n_ent - 1;
  while (e < hi) {
    const int mid = (e + hi) >> 1;
    if (end[mid] > q) hi = mid; else e = mid + 1;
  }
  return e;
}

// Stage A's entries [c0, c0 + blockDim) of a row ending at a1, every
// thread of the block calling; returns the chunk's products.  Three block
// syncs: the last makes the stage visible.
template <bool kNumeric>
__device__ __forceinline__ int stage_chunk(
    const Stage& st, int c0, int a1, const int* __restrict__ a_idx,
    const float* __restrict__ a_val, const int* __restrict__ indptr_b,
    Scratch* sh) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int j = c0 + tid;
  int len = 0, bst = 0;
  float av = 0.0f;
  if (j < a1) {
    const int k = a_idx[j];
    bst = indptr_b[k];
    len = indptr_b[k + 1] - bst;
    if (kNumeric) av = a_val[j];
  }
  int x = len;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) sh->warp_sum[warp] = x;
  block_sync();
  if (warp == 0) {
    int y = lane < nwarps ? sh->warp_sum[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int z = __shfl_up_sync(0xffffffffu, y, o);
      if (lane >= o) y += z;
    }
    if (lane < nwarps) sh->warp_sum[lane] = y;
  }
  block_sync();
  if (warp > 0) x += sh->warp_sum[warp - 1];
  const int total = sh->warp_sum[nwarps - 1];
  st.end[tid] = x;
  st.bofs[tid] = bst - (x - len);
  if (kNumeric) st.av[tid] = av;
  block_sync();
  return total;
}

// One output row by a team (one block, or the blocks of a cluster), every
// thread calling: clear this block's part of the row's table of tsz slots
// (classify_kernel's tsz_i, > 0), fill it, then write the count
// (symbolic) or flush it to out[indptr_c[row] ...] (numeric).  The table
// is left as it is: the next row clears what it uses.  A's row is taken
// blockDim entries at a time and its products spread evenly over the
// team's threads (a thread finds its product's entry by a binary search
// of the staged ends), so no warp walks a long B row alone.  p is the
// row's parity (Scratch); thread 0 calls publish() once after the first
// team sync (the class kernels pop their next row there).
template <bool kNumeric, bool kVector, class Tab, class Publish>
__device__ __forceinline__ void hash_row(
    Tab& tab, int row, int tsz, int p, int cap_c,
    const int* __restrict__ indptr_a, const int* __restrict__ a_idx,
    const float* __restrict__ a_val, const int* __restrict__ indptr_b,
    const int* __restrict__ b_idx, const float* __restrict__ b_val,
    const int* __restrict__ indptr_c, int* __restrict__ out_cols,
    float* __restrict__ out_vals, int* __restrict__ row_nnz,
    int* __restrict__ errors, Scratch* sh, const Stage& st,
    const Publish& publish) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int a0 = indptr_a[row];
  const int a1 = indptr_a[row + 1];

  int total = stage_chunk<kNumeric>(st, a0, a1, a_idx, a_val, indptr_b, sh);
  int base = 0, want = 0;
  if (kNumeric) {
    base = indptr_c[row];
    want = indptr_c[row + 1] - base;
  }

  tab.size(tsz);
  const int own = tab.own_slots(tsz);
  for (int s = tid; s < own; s += blockDim.x) {
    tab.keys[s] = kEmpty;
    if (kNumeric) tab.vals[s] = 0.0f;
  }
  tab.sync();  // A: every part clear
  if (tid == 0) {
    scratch_reset(sh, p ^ 1);
    publish();
  }

  int mine = 0;
  const int team_threads = Tab::kBlocks * blockDim.x;
  for (int c0 = a0;;) {
    const int n_ent = min(static_cast<int>(blockDim.x), a1 - c0);
    int e = 0;
    // software-pipelined: the next product's operands load while this
    // one probes
    int q = tab.rank() * blockDim.x + tid;
    int col = 0, t = 0;
    float av = 0.0f, bv = 0.0f;
    if (q < total) {
      e = find_entry(st.end, e, n_ent, q);
      t = st.bofs[e] + q;
      col = b_idx[t];
      if (kNumeric) {
        av = st.av[e];
        bv = b_val[t];
      }
    }
    while (q < total) {
      const int qn = q + team_threads;
      int col_n = 0;
      float av_n = 0.0f, bv_n = 0.0f;
      if (qn < total) {
        e = find_entry(st.end, e, n_ent, qn);
        const int tn = st.bofs[e] + qn;
        col_n = b_idx[tn];
        if (kNumeric) {
          av_n = st.av[e];
          bv_n = b_val[tn];
        }
      }
      int ins;
      const int slot = kVector ? insert_vector(tab, tsz, col, &ins)
                               : insert_scalar(tab, tsz, col, &ins);
      if (slot < 0) {
        atomicAdd(errors, 1);
      } else {
        mine += ins;
        if (kNumeric) atomicAdd(tab.val(slot), __fmul_rn(av, bv));
      }
      q = qn;
      col = col_n;
      av = av_n;
      bv = bv_n;
    }
    c0 += blockDim.x;
    if (c0 >= a1) break;
    block_sync();  // the stage is read
    total = stage_chunk<kNumeric>(st, c0, a1, a_idx, a_val, indptr_b, sh);
  }
  if (mine) atomicAdd(&sh->count[p], mine);
  tab.sync();  // B: every insert done

  if (!kNumeric) {
    // the ranks' inserts, read after B; no block resets count[p] before
    // the next row's barrier A, which rank 0 reaches after this read
    if (Tab::kBlocks == 1) {
      if (tid == 0) row_nnz[row] = sh->count[p];
    } else if (tab.rank() == 0 && tid < 32) {
      const int n = warp_sum(
          lane < Tab::kBlocks ? tab.scratch_of(sh, lane)->count[p] : 0);
      if (lane == 0) row_nnz[row] = n;
    }
    return;
  }

  // flush this block's part in table order: unsorted columns (C8)
  int before = 0;  // entries of the lower ranks' slices
  if (Tab::kBlocks > 1) {
    int n = 0;
    for (int s0 = 0; s0 < own; s0 += blockDim.x) {
      const int s = s0 + tid;
      const bool occ = s < own && load_key(tab.keys + s) != kEmpty;
      n += __popc(__ballot_sync(0xffffffffu, occ));
    }
    if (lane == 0 && n) atomicAdd(&sh->occupied[p], n);
    tab.sync();  // C: every slice counted
    int occ_r = 0, ins_r = 0;
    if (lane < Tab::kBlocks) {
      const Scratch* o = tab.scratch_of(sh, lane);
      occ_r = o->occupied[p];
      ins_r = o->count[p];
    }
    before = warp_sum(lane < tab.rank() ? occ_r : 0);
    const int occupied = warp_sum(occ_r);
    const int inserted = warp_sum(ins_r);
    if (tid == 0 && tab.rank() == 0 &&
        (occupied != want || inserted != want))
      atomicAdd(errors, 1);
  }
  for (int s0 = 0; s0 < own; s0 += blockDim.x) {
    const int s = s0 + tid;
    const int key = s < own ? load_key(tab.keys + s) : kEmpty;
    const bool occ = key != kEmpty;
    const unsigned ballot = __ballot_sync(0xffffffffu, occ);
    if (ballot) {
      int w = 0;
      if (lane == 0) w = atomicAdd(&sh->cursor[p], __popc(ballot));
      w = __shfl_sync(0xffffffffu, w, 0);
      if (occ) {
        const int pos = before + w + __popc(ballot & ((1u << lane) - 1u));
        if (pos < want && base + pos < cap_c) {
          out_cols[base + pos] = key;
          out_vals[base + pos] = load_val(tab.vals + s);
        }
      }
    }
  }
  block_sync();  // D: this block's flush done
  if (Tab::kBlocks == 1 && tid == 0 &&
      (sh->cursor[p] != want || sh->count[p] != want))
    atomicAdd(errors, 1);
}

// counts (kCountInts ints, zeroed by the caller): [0, 8) each class's
// listed pairs, [8, 16) the class kernels' pop counters.
constexpr int kPops = kClasses;
constexpr int kCountInts = 2 * kClasses;
static_assert(kCountInts == 16, "kernel.py's COUNT_INTS");
constexpr int kClassifyThreads = 256;
// a longer A row's product count is summed by its whole warp
constexpr int kOwnEntries = 32;

// The plan's table of member e's row i: min(bin_tsize[b], table_size) of
// the bin b that holds it; -1 for a row outside every bin, which the TPU
// grid never visits either.
__device__ __forceinline__ int bin_cap(const Fleet& f, long long e, int i) {
  const int* off = f.offsets + e * f.s_off;
  int lo = 0, hi = f.n_bins - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (off[mid] <= i) lo = mid; else hi = mid - 1;
  }
  if (off[lo] > i || i >= off[lo + 1]) return -1;
  return min(f.bin_tsize[e * f.s_bt + lo], f.table_size);
}

// The products of A's entries [a0, a1), summed until they reach cap.
__device__ __forceinline__ long long flop_upto(const int* __restrict__ a_idx,
                                               const int* __restrict__ ib,
                                               int a0, int a1, int cap) {
  long long f = 0;
  for (int j = a0; j < a1 && f < cap; j += 4) {
    int k[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) k[u] = j + u < a1 ? a_idx[j + u] : -1;
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (k[u] >= 0) f += ib[k[u] + 1] - ib[k[u]];
  }
  return f;
}

// The symbolic need of each lane's pair (cap < 0: none): its product
// count, summed until it reaches the cap (any count past half the cap
// gives the cap's table).  A lane sums an A row of up to kOwnEntries
// entries itself; the warp sums each longer row together, 32 entries a
// step (a G500 hub row holds thousands).  Every lane of the warp calls.
__device__ long long symbolic_need(const Fleet& f, long long e, int a0,
                                   int a1, int cap) {
  const int lane = threadIdx.x & 31;
  const bool own = cap > 0 && a1 - a0 <= kOwnEntries;
  long long need = own ? flop_upto(f.a_idx + e * f.s_ai,
                                   f.indptr_b + e * f.s_ib, a0, a1, cap)
                       : 0;
  unsigned rows = __ballot_sync(0xffffffffu, cap > 0 && !own);
  while (rows) {
    const int src = __ffs(rows) - 1;
    rows &= rows - 1;
    const long long se = __shfl_sync(0xffffffffu, e, src);
    const int s0 = __shfl_sync(0xffffffffu, a0, src);
    const int s1 = __shfl_sync(0xffffffffu, a1, src);
    const int scap = __shfl_sync(0xffffffffu, cap, src);
    const int* ai = f.a_idx + se * f.s_ai;
    const int* ib = f.indptr_b + se * f.s_ib;
    long long sum = 0;
    for (int j0 = s0; j0 < s1 && sum < scap; j0 += 32) {
      long long len = 0;
      const int j = j0 + lane;
      if (j < s1) {
        const int k = ai[j];
        len = ib[k + 1] - ib[k];
      }
#pragma unroll
      for (int o = 16; o; o >>= 1) len += __shfl_xor_sync(0xffffffffu, len, o);
      sum += len;
    }
    if (lane == src) need = sum;
  }
  return need;
}

// Table classes (see the header), one thread a pair p = e * m + i: each
// pair's tsz_i goes to row_tsz[p] (0: no table) and, for a listed pair,
// its rank among its class's pairs to row_rank[p]; counts[c] gains one per
// pair of class c.  A numeric pair that indptr_c leaves empty but that
// has products adds one to errors, as does a pair whose class was not
// launched (bit c of launched clear), which joins no list.  Pairs outside
// every bin get no table and no error.
template <bool kNumeric>
__global__ void __launch_bounds__(kClassifyThreads) classify_kernel(
    Fleet f, int launched, int* __restrict__ counts,
    int* __restrict__ row_tsz, int* __restrict__ row_rank,
    int* __restrict__ errors) {
  __shared__ int s_n[kClasses];
  __shared__ int s_base[kClasses];
  if (threadIdx.x < kClasses) s_n[threadIdx.x] = 0;
  block_sync();
  const long long total = static_cast<long long>(f.n) * f.m;
  const long long p =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  long long e = 0;
  int i = 0, cap = -1, a0 = 0, a1 = 0;
  if (p < total) {
    e = p / f.m;
    i = static_cast<int>(p - e * f.m);
    cap = bin_cap(f, e, i);
    if (cap >= 0) {
      const int* ia = f.indptr_a + e * f.s_ia;
      a0 = ia[i];
      a1 = ia[i + 1];
    }
  }
  int tsz = 0;
  bool bad = false;
  if (kNumeric) {
    if (cap >= 0) {
      const int* ic = f.indptr_c + e * f.s_ic;
      const int want = ic[i + 1] - ic[i];
      tsz = row_table(cap, want);
      if (tsz == 0) {
        const int* ai = f.a_idx + e * f.s_ai;
        const int* ib = f.indptr_b + e * f.s_ib;
        bad = want < 0;
        for (int j = a0; j < a1 && !bad; ++j) {
          const int k = ai[j];
          bad = ib[k + 1] > ib[k];
        }
      }
    }
  } else {
    tsz = row_table(cap, symbolic_need(f, e, a0, a1, cap));
  }
  int c = kClasses, rank = 0;
  if (p < total) row_tsz[p] = tsz;
  if (tsz > 0) {
    c = row_class(tsz, kNumeric ? 0 : f.bitmap_above);
    if ((launched >> c) & 1) {
      rank = atomicAdd(&s_n[c], 1);
    } else {
      bad = true;
      c = kClasses;
    }
  }
  if (bad) atomicAdd(errors, 1);
  block_sync();
  if (threadIdx.x < kClasses && s_n[threadIdx.x])
    s_base[threadIdx.x] = atomicAdd(counts + threadIdx.x, s_n[threadIdx.x]);
  block_sync();
  if (c < kClasses) row_rank[p] = s_base[c] + rank;
}

// Lay every listed pair out in list, class after class (one thread a
// pair), at its class's start plus its rank.
__global__ void __launch_bounds__(kClassifyThreads) place_kernel(
    long long total, int launched, int bitmap_above,
    const int* __restrict__ counts,
    const int* __restrict__ row_tsz, const int* __restrict__ row_rank,
    int* __restrict__ list) {
  __shared__ int s_start[kClasses];
  if (threadIdx.x == 0) {
    int run = 0;
    for (int c = 0; c < kClasses; ++c) {
      s_start[c] = run;
      run += counts[c];
    }
  }
  block_sync();
  const long long p =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (p >= total) return;
  const int tsz = row_tsz[p];
  if (tsz == 0) return;
  const int c = row_class(tsz, bitmap_above);
  if ((launched >> c) & 1) list[s_start[c] + row_rank[p]] = static_cast<int>(p);
}

// The rows of table class kClass, either phase, of every member: a
// persistent grid whose blocks (classes 0-2, 6) or clusters (3-5) pop
// entries p = e * m + i from the class's part of list until it runs dry
// (pop counter *pop).  Class 6 keeps each block's table in the
// device-memory workspace (ws_tsz slots a block).
template <bool kNumeric, bool kVector, int kClass>
__global__ void __launch_bounds__(1024) hash_class_kernel(
    Fleet f, int ws_tsz, const int* __restrict__ counts, int* pop,
    const int* __restrict__ list, const int* __restrict__ row_tsz,
    int* __restrict__ errors, int* ws_keys, float* ws_vals) {
  constexpr int kBlocks = class_blocks(kClass);
  constexpr int kSlots = class_smem_slots(kClass);
  using Tab = typename std::conditional<kBlocks == 1, BlockTable,
                                        ClusterTable<kBlocks>>::type;
  extern __shared__ __align__(16) int smem[];
  __shared__ Scratch sh;
  Tab tab;
  if (kClass == kGlobalClass) {
    const size_t off = static_cast<size_t>(blockIdx.x) * ws_tsz;
    tab.keys = ws_keys + off;
    tab.vals = kNumeric ? ws_vals + off : nullptr;
  } else {
    tab.keys = smem;
    tab.vals = kNumeric ? reinterpret_cast<float*>(smem + kSlots) : nullptr;
  }
  if constexpr (kBlocks > 1) {
    tab.my_rank = static_cast<int>(cg::this_cluster().block_rank());
    tab.shift = 0;
  }
  const Stage st = stage_at(smem + (kNumeric ? 2 : 1) * kSlots);
  const bool leader = tab.rank() == 0;
  int start = 0;
  for (int c = 0; c < kClass; ++c) start += counts[c];
  const int rows = counts[kClass];
  const int* mine = list + start;
  if (threadIdx.x == 0) {
    scratch_reset(&sh, 0);
    scratch_reset(&sh, 1);
    if (leader) {
      const int idx = atomicAdd(pop, 1);
      sh.item[0] = idx < rows ? mine[idx] : -1;
    }
  }
  tab.sync();
  for (int p = 0;; p ^= 1) {
    const int item = tab.scratch_of(&sh, 0)->item[p];
    if (item < 0) break;
    const auto publish = [&] {
      if (leader) {
        const int idx = atomicAdd(pop, 1);
        sh.item[p ^ 1] = idx < rows ? mine[idx] : -1;
      }
    };
    const int cap_c = static_cast<int>(f.cap_c);
    if (f.n == 1) {
      // the arrays as they are: no member arithmetic held in registers
      hash_row<kNumeric, kVector>(
          tab, item, row_tsz[item], p, cap_c, f.indptr_a, f.a_idx, f.a_val,
          f.indptr_b, f.b_idx, f.b_val, f.indptr_c, f.out_cols, f.out_vals,
          f.row_nnz, errors, &sh, st, publish);
      continue;
    }
    const long long e = item / f.m;
    hash_row<kNumeric, kVector>(
        tab, item - static_cast<int>(e * f.m), row_tsz[item], p, cap_c,
        f.indptr_a + e * f.s_ia, f.a_idx + e * f.s_ai, f.a_val + e * f.s_av,
        f.indptr_b + e * f.s_ib, f.b_idx + e * f.s_bi, f.b_val + e * f.s_bv,
        kNumeric ? f.indptr_c + e * f.s_ic : nullptr,
        kNumeric ? f.out_cols + e * f.cap_c : nullptr,
        kNumeric ? f.out_vals + e * f.cap_c : nullptr,
        kNumeric ? nullptr : f.row_nnz + e * f.m, errors, &sh, st, publish);
  }
  // no block leaves while another may still read its shared memory
  if (kBlocks > 1) tab.sync();
}

// One symbolic row of the bitmap class by one block, every thread
// calling: the row's distinct columns are the bits set in a bitmap of B's
// n_cols columns (words of them, in shared memory).  Products are spread
// over the block and staged as in hash_row; each reads its word and sets
// its bit with atomicOr only when it is clear.  The count is the
// bitmap's popcount; past tsz (the table the classifier sized) it adds
// one to errors and writes tsz, as that table's full probe would have.  A
// column outside [0, n_cols) adds one and sets nothing.  p and publish as
// for hash_row.
template <class Publish>
__device__ __forceinline__ void bitmap_row(
    unsigned* bits, int words, int n_cols, int row, int tsz, int p,
    const int* __restrict__ indptr_a, const int* __restrict__ a_idx,
    const int* __restrict__ indptr_b, const int* __restrict__ b_idx,
    int* __restrict__ row_nnz, int* __restrict__ errors, Scratch* sh,
    const Stage& st, const Publish& publish) {
  const int tid = threadIdx.x;
  const int a0 = indptr_a[row];
  const int a1 = indptr_a[row + 1];
  int total = stage_chunk<false>(st, a0, a1, a_idx, nullptr, indptr_b, sh);
  for (int w = tid; w < words; w += blockDim.x) bits[w] = 0u;
  block_sync();  // A: the bitmap clear
  if (tid == 0) {
    scratch_reset(sh, p ^ 1);
    publish();
  }
  bool outside = false;
  for (int c0 = a0;;) {
    const int n_ent = min(static_cast<int>(blockDim.x), a1 - c0);
    int e = 0;
    // software-pipelined: the next product's column loads while this
    // one's bit is set
    int q = tid;
    int col = 0;
    if (q < total) {
      e = find_entry(st.end, e, n_ent, q);
      col = b_idx[st.bofs[e] + q];
    }
    while (q < total) {
      const int qn = q + blockDim.x;
      int col_n = 0;
      if (qn < total) {
        e = find_entry(st.end, e, n_ent, qn);
        col_n = b_idx[st.bofs[e] + qn];
      }
      if (static_cast<unsigned>(col) < static_cast<unsigned>(n_cols)) {
        unsigned* w = bits + (col >> 5);
        const unsigned bit = 1u << (col & 31);
        if (!(*reinterpret_cast<volatile unsigned*>(w) & bit))
          atomicOr(w, bit);
      } else {
        outside = true;
      }
      q = qn;
      col = col_n;
    }
    c0 += blockDim.x;
    if (c0 >= a1) break;
    block_sync();  // the stage is read
    total = stage_chunk<false>(st, c0, a1, a_idx, nullptr, indptr_b, sh);
  }
  if (outside) atomicAdd(errors, 1);
  block_sync();  // B: every bit set
  int n = 0;
  for (int w = tid; w < words; w += blockDim.x) n += __popc(bits[w]);
  n = warp_sum(n);
  if ((tid & 31) == 0 && n) atomicAdd(&sh->count[p], n);
  block_sync();  // C: every word counted
  if (tid == 0) {
    const int cnt = sh->count[p];
    if (cnt > tsz) atomicAdd(errors, 1);
    row_nnz[row] = min(cnt, tsz);
  }
}

// The rows of the bitmap class (symbolic only) of every member: a
// persistent grid of 1,024-thread blocks popping entries p = e * m + i as
// hash_class_kernel does, each block's dynamic shared memory the bitmap
// of bitmap_words(f.n_cols) words and the stage.  Either probe mode runs
// it: nothing is probed.  The unnamed arguments keep ClassKernel's
// signature.
__global__ void __launch_bounds__(1024) bitmap_class_kernel(
    Fleet f, int, const int* __restrict__ counts, int* pop,
    const int* __restrict__ list, const int* __restrict__ row_tsz,
    int* __restrict__ errors, int*, float*) {
  extern __shared__ __align__(16) int smem[];
  __shared__ Scratch sh;
  const int words = bitmap_words(f.n_cols);
  unsigned* bits = reinterpret_cast<unsigned*>(smem);
  const Stage st = stage_at(smem + words);
  int start = 0;
  for (int c = 0; c < kBitmapClass; ++c) start += counts[c];
  const int rows = counts[kBitmapClass];
  const int* mine = list + start;
  if (threadIdx.x == 0) {
    scratch_reset(&sh, 0);
    scratch_reset(&sh, 1);
    const int idx = atomicAdd(pop, 1);
    sh.item[0] = idx < rows ? mine[idx] : -1;
  }
  block_sync();
  for (int p = 0;; p ^= 1) {
    const int item = sh.item[p];
    if (item < 0) break;
    const auto publish = [&] {
      const int idx = atomicAdd(pop, 1);
      sh.item[p ^ 1] = idx < rows ? mine[idx] : -1;
    };
    if (f.n == 1) {
      // the arrays as they are, as in hash_class_kernel
      bitmap_row(bits, words, f.n_cols, item, row_tsz[item], p, f.indptr_a,
                 f.a_idx, f.indptr_b, f.b_idx, f.row_nnz, errors, &sh, st,
                 publish);
      continue;
    }
    const long long e = item / f.m;
    bitmap_row(bits, words, f.n_cols, item - static_cast<int>(e * f.m),
               row_tsz[item], p, f.indptr_a + e * f.s_ia,
               f.a_idx + e * f.s_ai, f.indptr_b + e * f.s_ib,
               f.b_idx + e * f.s_bi, f.row_nnz + e * f.m, errors, &sh, st,
               publish);
  }
}

using ClassKernel = void (*)(Fleet, int, const int*, int*, const int*,
                             const int*, int*, int*, float*);

template <bool kNumeric, bool kVector>
ClassKernel class_kernel_of(int c) {
  switch (c) {
    case 0: return hash_class_kernel<kNumeric, kVector, 0>;
    case 1: return hash_class_kernel<kNumeric, kVector, 1>;
    case 2: return hash_class_kernel<kNumeric, kVector, 2>;
    case 3: return hash_class_kernel<kNumeric, kVector, 3>;
    case 4: return hash_class_kernel<kNumeric, kVector, 4>;
    case 5: return hash_class_kernel<kNumeric, kVector, 5>;
    default: return hash_class_kernel<kNumeric, kVector, 6>;
  }
}

// Class c's kernel; null for the numeric phase's bitmap class, which does
// not exist.
ClassKernel class_kernel(int numeric, int vector, int c) {
  if (c == kBitmapClass) {
    if (numeric) return nullptr;
    return bitmap_class_kernel;
  }
  if (numeric)
    return vector ? class_kernel_of<true, true>(c)
                  : class_kernel_of<true, false>(c);
  return vector ? class_kernel_of<false, true>(c)
                : class_kernel_of<false, false>(c);
}

// Dynamic shared memory of class c's block: its table or slice (key +
// value numeric, keys symbolic) or its bitmap of n_cols bits, and the
// stage.
int class_smem(int numeric, int c, int n_cols) {
  const int table = c == kBitmapClass ? 4 * bitmap_words(n_cols)
                                      : class_smem_slots(c) * (numeric ? 8 : 4);
  return table + kStageBytes * class_threads(numeric, c);
}

// Whether class c exists for this phase and width.
bool class_valid(int numeric, int c, int n_cols) {
  if (c < 0 || c >= kClasses) return false;
  return c != kBitmapClass ||
         (!numeric && n_cols >= 0 && bitmap_words(n_cols) <= kBitmapMaxWords);
}

int set_smem(const void* kernel, int smem_bytes) {
  if (smem_bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes));
}

}  // namespace

// The table classes of a fleet's (member, row) pairs (numeric = 0: the
// symbolic phase): classify_kernel, then place_kernel.  launched has bit c
// set for each class that will be launched; counts holds kCountInts ints
// (kernel.py's COUNT_INTS), zeroed here, list, row_tsz and row_rank n * m
// ints each, n * m < 2^31.
extern "C" int spgemm_hash_classify(int numeric, int launched,
                                    const Fleet* f, int* counts, int* list,
                                    int* row_tsz, int* row_rank, int* errors,
                                    void* stream) {
  const long long total = static_cast<long long>(f->n) * f->m;
  if (total <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bitmap_above = numeric ? 0 : f->bitmap_above;
  if (total >= (1ll << 31) || f->n_bins < 1 || launched <= 0 ||
      launched >= (1 << kClasses) ||
      (bitmap_above > 0 && !class_valid(numeric, kBitmapClass, f->n_cols)))
    return static_cast<int>(cudaErrorInvalidValue);
  for (int c = 0; c < kClasses; ++c)
    if (((launched >> c) & 1) && !class_valid(numeric, c, f->n_cols))
      return static_cast<int>(cudaErrorInvalidValue);
  int err = static_cast<int>(
      cudaMemsetAsync(counts, 0, kCountInts * sizeof(int), s));
  if (err) return err;
  const unsigned grid =
      static_cast<unsigned>((total + kClassifyThreads - 1) / kClassifyThreads);
  if (numeric)
    classify_kernel<true><<<grid, kClassifyThreads, 0, s>>>(
        *f, launched, counts, row_tsz, row_rank, errors);
  else
    classify_kernel<false><<<grid, kClassifyThreads, 0, s>>>(
        *f, launched, counts, row_tsz, row_rank, errors);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  place_kernel<<<grid, kClassifyThreads, 0, s>>>(
      total, launched, bitmap_above, counts, row_tsz, row_rank, list);
  return static_cast<int>(cudaGetLastError());
}

// The launch shape of class c's kernel (numeric = 0: the symbolic phase;
// vector: the chunked probe; n_cols: B's width, which sizes the bitmap
// class) on the current device: out = {blocks a cluster, threads a block,
// dynamic shared memory bytes a block, resident blocks (the persistent
// grid), resident clusters (cudaOccupancyMaxActiveClusters; 0 below two
// blocks)}.
extern "C" int spgemm_hash_class_shape(int numeric, int vector, int c,
                                       int n_cols, int* out) {
  if (!class_valid(numeric, c, n_cols))
    return static_cast<int>(cudaErrorInvalidValue);
  const ClassKernel kernel = class_kernel(numeric, vector, c);
  const void* fn = reinterpret_cast<const void*>(kernel);
  const int blocks = class_blocks(c), threads = class_threads(numeric, c);
  const int smem = class_smem(numeric, c, n_cols);
  int err = set_smem(fn, smem);
  if (err) return err;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  err = static_cast<int>(
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev));
  if (err) return err;
  int resident = 0, clusters = 0;
  if (blocks == 1) {
    int per_sm = 0;
    err = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, fn, threads, smem));
    resident = per_sm * sms;
  } else {
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = blocks;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.gridDim = dim3(blocks);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = static_cast<int>(cudaOccupancyMaxActiveClusters(&clusters, fn,
                                                          &cfg));
    resident = clusters * blocks;
  }
  if (err) return err;
  out[0] = blocks;
  out[1] = threads;
  out[2] = smem;
  out[3] = resident;
  out[4] = clusters;
  return 0;
}

// One class's launch, either phase, over every member: grid blocks (a
// multiple of the class's cluster) pop the pairs that spgemm_hash_classify
// listed (counts, list and row_tsz as it left them, class c's pop counter
// zero); ws_keys (and, numeric, ws_vals) hold grid * ws_tsz slots for
// class 6, null otherwise.  The bitmap class (7) takes B's width from f.
extern "C" int spgemm_hash_class_launch(
    int numeric, int vector, int c, int grid, int ws_tsz, const Fleet* f,
    int* counts, const int* list, const int* row_tsz, int* errors,
    int* ws_keys, float* ws_vals, void* stream) {
  if (!class_valid(numeric, c, f->n_cols))
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = class_blocks(c);
  if (grid < blocks || grid % blocks ||
      (c == kGlobalClass &&
       (ws_keys == nullptr || (numeric && ws_vals == nullptr))))
    return static_cast<int>(cudaErrorInvalidValue);
  const ClassKernel kernel = class_kernel(numeric, vector, c);
  const int smem = class_smem(numeric, c, f->n_cols);
  const int err = set_smem(reinterpret_cast<const void*>(kernel), smem);
  if (err) return err;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = blocks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(class_threads(numeric, c));
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = blocks > 1 ? 1 : 0;
  cudaLaunchKernelEx(&cfg, kernel, *f, ws_tsz, counts, counts + kPops + c,
                     list, row_tsz, errors, ws_keys, ws_vals);
  return static_cast<int>(cudaGetLastError());
}
