// Propagation-blocking SpGEMM kernels for Hopper (sm_90a).
//
// Replace the Pallas TPU kernels of repro/kernels/spgemm_pb/kernel.py:
//   scatter_call (_scatter_kernel): for each bucket g and lane i,
//     pp[g, i] = a[clip(src_a[g, i])] * b[clip(src_b[g, i])]  i < bucket_nnz[g]
//     pp[g, i] = 0                                             otherwise
//   merge_call (_merge_kernel): for each bucket g in order and lane
//     i < bucket_nnz[g] in order, out[clip(seg[g, i])] += pp[g, i], the
//     output zeroed first.
//   batched_scatter_call and batched_merge_call (_batched_scatter_kernel,
//     _batched_merge_kernel): the same for each member e of a fleet; pp is
//     (members, buckets, lanes) and the merge's output (members, cap_c).
// One pair of kernels serves both: the single product is the fleet of one
// member, every argument shared.  Indices clip to [0, cap - 1] as the TPU
// kernels' do.  The plan (repro_torch/core/pb.py) freezes src_a, src_b,
// seg and bucket_nnz.
//
// Bound: memory.  Neither kernel does more than one multiply or add per
// byte it moves.  Scatter reads the live lanes' two indices (8 B per
// product), A's and B's values, and writes every lane of pp, pad lanes
// included; merge reads the live lanes' seg and pp (8 B per product) and
// writes C's values once.  At ER s18 ef16 (A·A, 67.1 M products into
// 67.1 M slots: 99.95% of slots take one product) the plan has 16,384
// buckets of 16 columns and 5,272 lanes, 29% of them pad; that is about
// 0.27 ms and 0.24 ms at 3.35 TB/s.  A fleet's bound counts a shared
// index array once and every member's values, pp and C.
//
// Design on this card:
//   * Each block takes one bucket (g = blockIdx.x; blocks walk with a grid
//     stride only past the grid's x limit) and its threads the lanes, one
//     thread per lane, so the reads of src_a/src_b/seg/pp and the writes
//     of pp are coalesced.  Pad lanes read no index.
//   * Members inside the block.  When every index array (bucket_nnz,
//     src_a, src_b; bucket_nnz, seg) is shared by the fleet -- every vmap
//     over a planned execute -- a lane reads its indices once and loops
//     over the members, 8 at a time (one 32-byte sector of float32) so
//     that registers stay bounded: 537 MB of scatter indices and 268 MB of
//     seg at ER s18 are read once a launch, not once a member (they do not
//     stay in the 50 MB L2).  When any index array is stacked per member,
//     a block takes one (member, bucket) pair instead (members-outer, the
//     general path): grid members x buckets.
//   * Slot-major member values.  A batched operand goes to the
//     members-inside scatter as (cap, n), members innermost (transposed by
//     transpose_kernel in the wrapper), so one gather brings every
//     member's value of a slot: one sector at 8 members (two 16-byte
//     loads) where member-major values cost a sector a member.  A shared
//     operand is gathered once a lane.  Each value operand comes with two
//     strides, element (e, slot) at p[e * se + slot * ss]; se = 0 shares
//     it.  kernel.py's scatter_layout says which operands go slot-major.
//   * Slot-major output for the merge.  The merge writes out (cap_c, w)
//     with out[slot * w + e], so a run head stores its members' sums as
//     one contiguous run (a whole sector at 8 members) where member-major
//     rows cost a lone 4-byte store a member: a bucket is a strip of 16
//     columns, so its slots lie in thousands of different rows of the
//     row-major C.  w = n, or n rounded up to a multiple of 8 where a
//     block takes every member and 4 <= n with n % 8 != 0 (kernel.py's
//     merge_width): the head then stores whole sectors, zeros past n.  At
//     4 members that took the merge from 4.81 to 3.54 ms on ER s18 (H100):
//     a part-sector store costs more than the padding's extra zeros.
//     n = 1 is the single product's (cap_c,) exactly.
//   * The scatter loads its indices and stores pp with evict-first hints
//     (__ldcs, __stcs): each is touched once.  2-5% on ER s18 (H100).  The
//     same hints on the merge's seg and pp loads cost it 4% at 8 members
//     (62 registers against 44), so it has none.
//   * Products round once (__fmul_rn): no FMA, no TF32.
//   * Merge without atomics.  Buckets own disjoint output slots, and inside
//     a bucket seg does not decrease (lanes are packed by (row, col)), so
//     every slot's products are one contiguous run of lanes of one bucket.
//     The thread at the head of a run (a live lane whose clipped slot
//     differs from the previous lane's) folds the run in lane order from
//     0 with __fadd_rn, for each member, and stores the sums: the TPU
//     kernel's exact order and rounding, whatever order the blocks run in,
//     so member e of a fleet is bitwise the single product on e's
//     arguments.  A slot no live lane names keeps the zero the caller
//     wrote before the launch (blocks run in no order, so nothing like the
//     TPU kernel's "zero at g == 0" is possible).
//   * Offsets are 64-bit (members x buckets x lanes passes 2^31 at about
//     32 members of ER s18 ef16).
//
// Plain C interface, loaded with ctypes; every launch reports
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Members a lane takes at a time: one 32-byte sector of float32.
constexpr int kChunk = 8;

__device__ __forceinline__ int clip(int v, int cap) {
  return min(max(v, 0), cap - 1);
}

// A value operand or an output: element (e, slot) at p[e * se + slot * ss].
// vec: se == 1, ss % 4 == 0 and p 16-byte aligned, so 4 members of a slot
// from a member that is a multiple of 4 move as one 16-byte access.
struct Layout {
  long long se, ss;
  bool vec;
};

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

__device__ __forceinline__ Layout layout_of(const void* p, long long se,
                                            long long ss) {
  return {se, ss, se == 1 && (ss & 3) == 0 && aligned16(p)};
}

// v[k] = p's element (e0 + k, slot) for k < m (m <= kChunk).
__device__ __forceinline__ void load_members(const float* __restrict__ p,
                                             Layout l, long long slot,
                                             int e0, int m,
                                             float (&v)[kChunk]) {
  const float* q = p + slot * l.ss + e0 * l.se;
  if (l.se == 0) {
    const float x = __ldg(q);
#pragma unroll
    for (int k = 0; k < kChunk; ++k) v[k] = x;
  } else if (l.vec && (m & 3) == 0) {
#pragma unroll
    for (int k = 0; k < kChunk; k += 4) {
      if (k < m) {
        const float4 x = __ldg(reinterpret_cast<const float4*>(q + k));
        v[k] = x.x;
        v[k + 1] = x.y;
        v[k + 2] = x.z;
        v[k + 3] = x.w;
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      if (k < m) v[k] = __ldg(q + k * l.se);
    }
  }
}

// p's element (e0 + k, slot) = v[k] for k < m.
__device__ __forceinline__ void store_members(float* __restrict__ p,
                                              Layout l, long long slot,
                                              int e0, int m,
                                              const float (&v)[kChunk]) {
  float* q = p + slot * l.ss + e0 * l.se;
  if (l.vec && (m & 3) == 0) {
#pragma unroll
    for (int k = 0; k < kChunk; k += 4) {
      if (k < m) {
        *reinterpret_cast<float4*>(q + k) =
            make_float4(v[k], v[k + 1], v[k + 2], v[k + 3]);
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      if (k < m) q[k * l.se] = v[k];
    }
  }
}

// Block w takes bucket g = w % n_buckets for members [e_lo, e_lo + group),
// e_lo = (w / n_buckets) * group; its index arrays are at member offset
// w / n_buckets (0 when group is the whole fleet: then they are shared).
// pp is (n_members, n_buckets, bucket_cap).
__global__ void scatter_batched_kernel(
    long long n_work, int group, int n_buckets, int bucket_cap, int cap_a,
    int cap_b, const int* __restrict__ bucket_nnz, long long s_nnz,
    const int* __restrict__ src_a, long long s_src_a,
    const int* __restrict__ src_b, long long s_src_b,
    const float* __restrict__ a, long long a_se, long long a_ss,
    const float* __restrict__ b, long long b_se, long long b_ss,
    float* __restrict__ pp) {
  const Layout la = layout_of(a, a_se, a_ss);
  const Layout lb = layout_of(b, b_se, b_ss);
  const long long s_pp = static_cast<long long>(n_buckets) * bucket_cap;
  for (long long w = blockIdx.x; w < n_work; w += gridDim.x) {
    const long long q = w / n_buckets;
    const int g = static_cast<int>(w - q * n_buckets);
    const long long row = static_cast<long long>(g) * bucket_cap;
    const int live = bucket_nnz[q * s_nnz + g];
    const int* ia = src_a + q * s_src_a + row;
    const int* ib = src_b + q * s_src_b + row;
    const int e_end = static_cast<int>(q) * group + group;
    float* out = pp + row;
    for (int i = threadIdx.x; i < bucket_cap; i += blockDim.x) {
      const bool on = i < live;
      const long long sa = on ? clip(__ldcs(ia + i), cap_a) : 0;
      const long long sb = on ? clip(__ldcs(ib + i), cap_b) : 0;
      for (int e0 = e_end - group; e0 < e_end; e0 += kChunk) {
        const int m = min(kChunk, e_end - e0);
        float av[kChunk], bv[kChunk];
        if (on) {
          load_members(a, la, sa, e0, m, av);
          load_members(b, lb, sb, e0, m, bv);
        }
#pragma unroll
        for (int k = 0; k < kChunk; ++k) {
          if (k < m) {
            __stcs(out + (e0 + k) * s_pp + i,
                   on ? __fmul_rn(av[k], bv[k]) : 0.0f);
          }
        }
      }
    }
  }
}

// Blocks as for scatter_batched_kernel, but bucket-major: block w takes bucket
// w / n_groups for member group w % n_groups, so that on the general path
// a bucket's members store into the same sectors of a slot-major output
// close together in time (member-major order left each sector to take
// one partial write a member pass: 44.6 against 15.1 ms at 8 members of
// ER s18 on an H100).  pp's member stride s_pp (0: shared); out element
// (e, slot) at out[slot * width + e], width >= n_members, zeroed by the
// caller.  Where a block takes every member, it stores each slot's whole
// row, zeros in the members past n_members.
__global__ void merge_batched_kernel(
    long long n_work, int group, int n_buckets, int bucket_cap, int cap_c,
    const int* __restrict__ bucket_nnz, long long s_nnz,
    const int* __restrict__ seg, long long s_seg,
    const float* __restrict__ pp, long long s_pp, float* __restrict__ out,
    int width) {
  const Layout lo = layout_of(out, 1, width);
  const long long n_groups = n_work / n_buckets;
  for (long long w = blockIdx.x; w < n_work; w += gridDim.x) {
    const int g = static_cast<int>(w / n_groups);
    const long long q = w - g * n_groups;
    const long long row = static_cast<long long>(g) * bucket_cap;
    const int live = min(bucket_nnz[q * s_nnz + g], bucket_cap);
    const int* sg = seg + q * s_seg + row;
    const int e_end = static_cast<int>(q) * group + group;
    const int store_end = n_groups == 1 ? width : e_end;
    const float* p = pp + row;
    for (int i = threadIdx.x; i < live; i += blockDim.x) {
      const int s = clip(sg[i], cap_c);
      if (i > 0 && clip(sg[i - 1], cap_c) == s) continue;
      int end = i + 1;
      while (end < live && clip(sg[end], cap_c) == s) ++end;
      for (int e0 = e_end - group; e0 < e_end; e0 += kChunk) {
        const int m = min(kChunk, e_end - e0);
        float acc[kChunk];
#pragma unroll
        for (int k = 0; k < kChunk; ++k) acc[k] = 0.0f;
        for (int j = i; j < end; ++j) {
#pragma unroll
          for (int k = 0; k < kChunk; ++k) {
            if (k < m) acc[k] = __fadd_rn(acc[k], p[(e0 + k) * s_pp + j]);
          }
        }
        store_members(out, lo, s, e0, min(kChunk, store_end - e0), acc);
      }
    }
  }
}

// out (cols, rows) = in (rows, cols) transposed, both row-major: a thread
// per column takes its rows 8 at a time, each read coalesced across the
// warp, and stores them as one contiguous run (a whole sector at 8 rows).
__global__ void transpose_kernel(int rows, long long cols,
                                 const float* __restrict__ in,
                                 float* __restrict__ out) {
  const Layout lo = layout_of(out, 1, rows);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long c = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       c < cols; c += stride) {
    for (int r0 = 0; r0 < rows; r0 += kChunk) {
      const int m = min(kChunk, rows - r0);
      float v[kChunk];
#pragma unroll
      for (int k = 0; k < kChunk; ++k) {
        if (k < m) v[k] = __ldcs(in + (r0 + k) * cols + c);
      }
      store_members(out, lo, c, r0, m, v);
    }
  }
}

// The grid's x limit; past it blocks walk the work with a grid stride.
constexpr long long kMaxGrid = 2147483647LL;

}  // namespace

// The scatter over n_members / group x n_buckets blocks, each taking
// `group` members of one bucket (group == n_members needs every index
// array shared, strides 0; group == 1 is the general path).  Each index
// array's pointer is followed by its member stride in elements (0:
// shared), each value operand's by its member and slot strides; pp is
// (n_members, n_buckets, bucket_cap).
extern "C" int pb_scatter_batched_launch(
    int n_members, int group, int n_buckets, int bucket_cap, int cap_a,
    int cap_b, int block, const int* bucket_nnz, long long s_nnz,
    const int* src_a, long long s_src_a, const int* src_b, long long s_src_b,
    const float* a, long long a_se, long long a_ss, const float* b,
    long long b_se, long long b_ss, float* pp, cudaStream_t stream) {
  const long long n_work =
      static_cast<long long>(n_members / group) * n_buckets;
  const int grid = static_cast<int>(n_work < kMaxGrid ? n_work : kMaxGrid);
  scatter_batched_kernel<<<grid, block, 0, stream>>>(
      n_work, group, n_buckets, bucket_cap, cap_a, cap_b, bucket_nnz, s_nnz,
      src_a, s_src_a, src_b, s_src_b, a, a_se, a_ss, b, b_se, b_ss, pp);
  return static_cast<int>(cudaGetLastError());
}

// The merge; blocks and index strides as for the scatter, pp's member
// stride (0: shared), out (cap_c, width) zeroed by the caller.
extern "C" int pb_merge_batched_launch(
    int n_members, int group, int n_buckets, int bucket_cap, int cap_c,
    int block, const int* bucket_nnz, long long s_nnz, const int* seg,
    long long s_seg, const float* pp, long long s_pp, float* out, int width,
    cudaStream_t stream) {
  const long long n_work =
      static_cast<long long>(n_members / group) * n_buckets;
  const int grid = static_cast<int>(n_work < kMaxGrid ? n_work : kMaxGrid);
  merge_batched_kernel<<<grid, block, 0, stream>>>(
      n_work, group, n_buckets, bucket_cap, cap_c, bucket_nnz, s_nnz, seg,
      s_seg, pp, s_pp, out, width);
  return static_cast<int>(cudaGetLastError());
}

// out (cols, rows) = in (rows, cols) transposed; block threads.
extern "C" int pb_transpose_launch(int rows, long long cols, int block,
                                   const float* in, float* out,
                                   cudaStream_t stream) {
  const long long blocks = (cols + block - 1) / block;
  const int grid = static_cast<int>(blocks < kMaxGrid ? blocks : kMaxGrid);
  transpose_kernel<<<grid, block, 0, stream>>>(rows, cols, in, out);
  return static_cast<int>(cudaGetLastError());
}
