// Propagation-blocking SpGEMM kernels for Hopper (sm_90a).
//
// Replace the Pallas TPU kernels of repro/kernels/spgemm_pb/kernel.py:
//   scatter_call (_scatter_kernel): for each bucket g and lane i,
//     pp[g, i] = a[clip(src_a[g, i])] * b[clip(src_b[g, i])]  i < bucket_nnz[g]
//     pp[g, i] = 0                                             otherwise
//   merge_call (_merge_kernel): for each bucket g in order and lane
//     i < bucket_nnz[g] in order, out[clip(seg[g, i])] += pp[g, i], the
//     output zeroed first.
// Indices clip to [0, cap - 1] as the TPU kernels' do.  The plan
// (repro_torch/core/pb.py) freezes src_a, src_b, seg and bucket_nnz.
//
// Bound: memory.  Neither kernel does more than one multiply or add per
// byte it moves.  Scatter reads the live lanes' two indices (8 B per
// product), A's and B's values, and writes every lane of pp, pad lanes
// included; merge reads the live lanes' seg and pp (8 B per product) and
// writes C's values once.  At ER s18 ef16 that is about 0.27 ms and
// 0.24 ms at 3.35 TB/s.
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
//
// Plain C interface, loaded with ctypes; every launch reports
// cudaGetLastError().

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ int clip(int v, int cap) {
  return min(max(v, 0), cap - 1);
}

__global__ void scatter_kernel(int n_buckets, int bucket_cap, int cap_a,
                               int cap_b, const int* __restrict__ bucket_nnz,
                               const int* __restrict__ src_a,
                               const int* __restrict__ src_b,
                               const float* __restrict__ a,
                               const float* __restrict__ b,
                               float* __restrict__ pp) {
  for (int g = blockIdx.x; g < n_buckets; g += gridDim.x) {
    const int live = bucket_nnz[g];
    const long long row = static_cast<long long>(g) * bucket_cap;
    for (int i = threadIdx.x; i < bucket_cap; i += blockDim.x) {
      float v = 0.0f;
      if (i < live) {
        v = __fmul_rn(a[clip(src_a[row + i], cap_a)],
                      b[clip(src_b[row + i], cap_b)]);
      }
      pp[row + i] = v;
    }
  }
}

__global__ void merge_kernel(int n_buckets, int bucket_cap, int cap_c,
                             const int* __restrict__ bucket_nnz,
                             const int* __restrict__ seg,
                             const float* __restrict__ pp,
                             float* __restrict__ out) {
  for (int g = blockIdx.x; g < n_buckets; g += gridDim.x) {
    const int live = min(bucket_nnz[g], bucket_cap);
    const long long row = static_cast<long long>(g) * bucket_cap;
    for (int i = threadIdx.x; i < live; i += blockDim.x) {
      const int s = clip(seg[row + i], cap_c);
      if (i > 0 && clip(seg[row + i - 1], cap_c) == s) continue;
      float acc = 0.0f;
      int j = i;
      do {
        acc = __fadd_rn(acc, pp[row + j]);
        ++j;
      } while (j < live && clip(seg[row + j], cap_c) == s);
      out[s] = acc;
    }
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
