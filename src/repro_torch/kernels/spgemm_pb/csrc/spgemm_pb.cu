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
//     _batched_merge_kernel): the same for each member e of a fleet, the
//     grid (members, buckets); pp is (members, buckets, lanes) and the
//     merge's output (members, cap_c).
// Indices clip to [0, cap - 1] as the TPU kernels' do.  The plan
// (repro_torch/core/pb.py) freezes src_a, src_b, seg and bucket_nnz.
//
// Bound: memory.  Neither kernel does more than one multiply or add per
// byte it moves.  Scatter reads the live lanes' two indices (8 B per
// product), A's and B's values, and writes every lane of pp, pad lanes
// included; merge reads the live lanes' seg and pp (8 B per product) and
// writes C's values once.  At ER s18 ef16 that is about 0.27 ms and
// 0.24 ms at 3.35 TB/s.  The batched pair's bound counts a shared index
// array once and every member's values, pp and C; its kernels read a
// shared index array once per member (537 MB of indices at ER s18 do not
// stay in the 50 MB L2), so n members cost about n single launches.
//
// Design on this card:
//   * The TPU grid walks the buckets in order on one core.  Here each
//     block takes buckets g = blockIdx.x, blockIdx.x + gridDim.x, ..., and
//     its threads take the lanes of one bucket, one thread per lane, so the
//     reads of src_a/src_b/seg/pp and the writes of pp are coalesced.  Pad
//     lanes read no index.
//   * Products round once (__fmul_rn): no FMA, no TF32.
//   * Merge without atomics.  Buckets own disjoint output slots, and inside
//     a bucket seg does not decrease (lanes are packed by (row, col)), so
//     every slot's products are one contiguous run of lanes of one bucket.
//     The thread at the head of a run (a live lane whose clipped slot
//     differs from the previous lane's) folds the run in lane order from
//     0 with __fadd_rn and stores the sum: the TPU kernel's exact order and
//     rounding, whatever order the blocks run in.  A slot no live lane
//     names keeps the zero the caller wrote before the launch (blocks run
//     in no order, so nothing like the TPU kernel's "zero at g == 0" is
//     possible).
//   * The batched kernels run the same bucket body (scatter_bucket,
//     merge_bucket: one __device__ function each, shared with the
//     single-product kernels) for each (member, bucket) pair: work item
//     w = e * n_buckets + g, one block per item (blocks walk the items
//     with a grid stride only past the grid's x limit: a walk of dozens
//     of items per block ran about 2x slower).  Every input has a member
//     stride in elements, 0 for an array all members share (the plan's
//     index arrays, a shared operand), so nothing is copied per member;
//     offsets are 64-bit (members x buckets x lanes passes 2^31 at about
//     32 members of ER s18 ef16).  Member e of a batched launch is
//     bitwise what the single-product kernel gives on e's arguments.
//
// Plain C interface, loaded with ctypes; every launch reports
// cudaGetLastError().

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ int clip(int v, int cap) {
  return min(max(v, 0), cap - 1);
}

// One bucket of the scatter: lanes i < live get a[clip(ia[i])] *
// b[clip(ib[i])], pad lanes 0.  ia, ib and out point at the bucket's row.
__device__ __forceinline__ void scatter_bucket(
    int live, int bucket_cap, int cap_a, int cap_b,
    const int* __restrict__ ia, const int* __restrict__ ib,
    const float* __restrict__ a, const float* __restrict__ b,
    float* __restrict__ out) {
  for (int i = threadIdx.x; i < bucket_cap; i += blockDim.x) {
    float v = 0.0f;
    if (i < live) {
      v = __fmul_rn(a[clip(ia[i], cap_a)], b[clip(ib[i], cap_b)]);
    }
    out[i] = v;
  }
}

// One bucket of the merge: the head of each run of equal clipped slots
// among the first `live` lanes folds the run in lane order into out.  sg
// and p point at the bucket's row.
__device__ __forceinline__ void merge_bucket(
    int live, int cap_c, const int* __restrict__ sg,
    const float* __restrict__ p, float* __restrict__ out) {
  for (int i = threadIdx.x; i < live; i += blockDim.x) {
    const int s = clip(sg[i], cap_c);
    if (i > 0 && clip(sg[i - 1], cap_c) == s) continue;
    float acc = 0.0f;
    int j = i;
    do {
      acc = __fadd_rn(acc, p[j]);
      ++j;
    } while (j < live && clip(sg[j], cap_c) == s);
    out[s] = acc;
  }
}

__global__ void scatter_kernel(int n_buckets, int bucket_cap, int cap_a,
                               int cap_b, const int* __restrict__ bucket_nnz,
                               const int* __restrict__ src_a,
                               const int* __restrict__ src_b,
                               const float* __restrict__ a,
                               const float* __restrict__ b,
                               float* __restrict__ pp) {
  for (int g = blockIdx.x; g < n_buckets; g += gridDim.x) {
    const long long row = static_cast<long long>(g) * bucket_cap;
    scatter_bucket(bucket_nnz[g], bucket_cap, cap_a, cap_b, src_a + row,
                   src_b + row, a, b, pp + row);
  }
}

__global__ void merge_kernel(int n_buckets, int bucket_cap, int cap_c,
                             const int* __restrict__ bucket_nnz,
                             const int* __restrict__ seg,
                             const float* __restrict__ pp,
                             float* __restrict__ out) {
  for (int g = blockIdx.x; g < n_buckets; g += gridDim.x) {
    const long long row = static_cast<long long>(g) * bucket_cap;
    merge_bucket(min(bucket_nnz[g], bucket_cap), cap_c, seg + row, pp + row,
                 out);
  }
}

__global__ void scatter_batched_kernel(
    long long n_work, int n_buckets, int bucket_cap, int cap_a, int cap_b,
    const int* __restrict__ bucket_nnz, long long s_nnz,
    const int* __restrict__ src_a, long long s_src_a,
    const int* __restrict__ src_b, long long s_src_b,
    const float* __restrict__ a, long long s_a,
    const float* __restrict__ b, long long s_b, float* __restrict__ pp) {
  for (long long w = blockIdx.x; w < n_work; w += gridDim.x) {
    const long long e = w / n_buckets;
    const int g = static_cast<int>(w - e * n_buckets);
    const long long row = static_cast<long long>(g) * bucket_cap;
    scatter_bucket(bucket_nnz[e * s_nnz + g], bucket_cap, cap_a, cap_b,
                   src_a + e * s_src_a + row, src_b + e * s_src_b + row,
                   a + e * s_a, b + e * s_b, pp + w * bucket_cap);
  }
}

__global__ void merge_batched_kernel(
    long long n_work, int n_buckets, int bucket_cap, int cap_c,
    const int* __restrict__ bucket_nnz, long long s_nnz,
    const int* __restrict__ seg, long long s_seg,
    const float* __restrict__ pp, long long s_pp, float* __restrict__ out) {
  for (long long w = blockIdx.x; w < n_work; w += gridDim.x) {
    const long long e = w / n_buckets;
    const int g = static_cast<int>(w - e * n_buckets);
    const long long row = static_cast<long long>(g) * bucket_cap;
    merge_bucket(min(bucket_nnz[e * s_nnz + g], bucket_cap), cap_c,
                 seg + e * s_seg + row, pp + e * s_pp + row,
                 out + e * cap_c);
  }
}

}  // namespace

extern "C" int pb_scatter_launch(int n_buckets, int bucket_cap, int cap_a,
                                 int cap_b, int grid, int block,
                                 const int* bucket_nnz, const int* src_a,
                                 const int* src_b, const float* a,
                                 const float* b, float* pp,
                                 cudaStream_t stream) {
  scatter_kernel<<<grid, block, 0, stream>>>(n_buckets, bucket_cap, cap_a,
                                             cap_b, bucket_nnz, src_a, src_b,
                                             a, b, pp);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int pb_merge_launch(int n_buckets, int bucket_cap, int cap_c,
                               int grid, int block, const int* bucket_nnz,
                               const int* seg, const float* pp, float* out,
                               cudaStream_t stream) {
  merge_kernel<<<grid, block, 0, stream>>>(n_buckets, bucket_cap, cap_c,
                                           bucket_nnz, seg, pp, out);
  return static_cast<int>(cudaGetLastError());
}

// The batched scatter over n_members x n_buckets work items; each input
// pointer is followed by its member stride in elements (0: shared), pp
// is (n_members, n_buckets, bucket_cap).
extern "C" int pb_scatter_batched_launch(
    int n_members, int n_buckets, int bucket_cap, int cap_a, int cap_b,
    int grid, int block, const int* bucket_nnz, long long s_nnz,
    const int* src_a, long long s_src_a, const int* src_b, long long s_src_b,
    const float* a, long long s_a, const float* b, long long s_b, float* pp,
    cudaStream_t stream) {
  const long long n_work = static_cast<long long>(n_members) * n_buckets;
  scatter_batched_kernel<<<grid, block, 0, stream>>>(
      n_work, n_buckets, bucket_cap, cap_a, cap_b, bucket_nnz, s_nnz, src_a,
      s_src_a, src_b, s_src_b, a, s_a, b, s_b, pp);
  return static_cast<int>(cudaGetLastError());
}

// The batched merge; strides as for the scatter, out (n_members, cap_c)
// zeroed by the caller.
extern "C" int pb_merge_batched_launch(
    int n_members, int n_buckets, int bucket_cap, int cap_c, int grid,
    int block, const int* bucket_nnz, long long s_nnz, const int* seg,
    long long s_seg, const float* pp, long long s_pp, float* out,
    cudaStream_t stream) {
  const long long n_work = static_cast<long long>(n_members) * n_buckets;
  merge_batched_kernel<<<grid, block, 0, stream>>>(
      n_work, n_buckets, bucket_cap, cap_c, bucket_nnz, s_nnz, seg, s_seg,
      pp, s_pp, out);
  return static_cast<int>(cudaGetLastError());
}
