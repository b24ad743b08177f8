// SpMM y = A @ X (A in CSR, X dense row-major (n, k)) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel spmm_call of
// repro/kernels/spmm/kernel.py (_spmm_kernel): for each row i,
//   y[i, :] = sum_j a_ij * X[col_j, :]
// accumulated in float32 over the row's nonzeros in order, from 0, and
// stored cast to X's dtype (float32, bfloat16 or float16; round to
// nearest even).
//
// Design on this card:
//   * The TPU grid walks equal-nnz row bins in order on one core, so that
//     one core sees balanced work.  On the card rows are independent and
//     thousands run at once, so there are no bins: one warp owns one
//     output row, lanes over k.
//   * Each lane keeps V float32 accumulators, for columns lane, lane + 32,
//     ..., lane + 32 (V - 1) of a 32 V-wide strip of k; k past the strip
//     takes further passes over the row, and lanes past k are masked, so
//     any k >= 1 runs.
//   * The warp loads 32 (column, value) pairs at a time, one per lane,
//     and hands them round with __shfl_sync.  The nonzero loop is unrolled
//     by kUnroll: the X gathers of kUnroll nonzeros are issued before the
//     first of their dependent adds, so a long row keeps several row loads
//     of X in flight instead of one.
//   * Each product is __fmul_rn and each add __fadd_rn, in the row's order:
//     no FMA, no tensor cores, no TF32.  The plain version (ref.py) does
//     the same operations in the same order, so the two agree bitwise.
//   * Slots at or past min(nnz, cap) count as 0; column ids are clipped to
//     [0, n), as the reference's gather clips them.
//
// Bound: memory.  The least traffic reads the row pointer, the column ids
// and values once, X once and writes Y once; 2 k operations per nonzero
// are far below the FP32 rate at these widths.  A skewed row (thousands
// of nonzeros) is walked by one warp and sets the kernel's tail.
//
// Plain C interface, loaded with ctypes; every launch reports
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kUnroll = 8;
constexpr int kWarpsPerBlock = 8;

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

template <typename T, int V>
__global__ void spmm_rows_kernel(int m, int n, int k, int cap,
                                 const int* __restrict__ nnz,
                                 const int* __restrict__ indptr,
                                 const int* __restrict__ indices,
                                 const float* __restrict__ data,
                                 const T* __restrict__ x,
                                 T* __restrict__ y) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= m) return;  // whole warps leave together
  const int live = min(*nnz, cap);
  const int p0 = indptr[row];
  const int p1 = min(indptr[row + 1], live);

  for (int c0 = 0; c0 < k; c0 += 32 * V) {
    float acc[V];
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] = 0.0f;
    for (int base = p0; base < p1; base += 32) {
      const int cnt = min(32, p1 - base);
      int my_col = 0;
      float my_val = 0.0f;
      if (lane < cnt) {
        my_col = min(max(indices[base + lane], 0), n - 1);
        my_val = data[base + lane];
      }
      for (int q0 = 0; q0 < cnt; q0 += kUnroll) {
        float av[kUnroll];
        float xv[kUnroll][V];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int q = q0 + u;
          const int col = __shfl_sync(kFull, my_col, q & 31);
          av[u] = __shfl_sync(kFull, my_val, q & 31);
          const T* xr = x + static_cast<size_t>(col) * k + c0 + lane;
#pragma unroll
          for (int v = 0; v < V; ++v)
            xv[u][v] = (q < cnt && c0 + 32 * v + lane < k)
                           ? load_f(xr + 32 * v) : 0.0f;
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (q0 + u < cnt) {
#pragma unroll
            for (int v = 0; v < V; ++v)
              acc[v] = __fadd_rn(acc[v], __fmul_rn(av[u], xv[u][v]));
          }
        }
      }
    }
    T* yr = y + static_cast<size_t>(row) * k + c0 + lane;
#pragma unroll
    for (int v = 0; v < V; ++v)
      if (c0 + 32 * v + lane < k) store_f(yr + 32 * v, acc[v]);
  }
}

template <typename T>
int launch(int m, int n, int k, int cap, const int* nnz, const int* indptr,
           const int* indices, const float* data, const void* x, void* y,
           cudaStream_t stream) {
  const int grid = (m + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const int block = 32 * kWarpsPerBlock;
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  if (k <= 32)
    spmm_rows_kernel<T, 1><<<grid, block, 0, stream>>>(
        m, n, k, cap, nnz, indptr, indices, data, xt, yt);
  else if (k <= 64)
    spmm_rows_kernel<T, 2><<<grid, block, 0, stream>>>(
        m, n, k, cap, nnz, indptr, indices, data, xt, yt);
  else
    spmm_rows_kernel<T, 4><<<grid, block, 0, stream>>>(
        m, n, k, cap, nnz, indptr, indices, data, xt, yt);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// y (m, k) = A (m, n; CSR with cap slots, nnz live on the device) @ x
// (n, k).  dtype: 0 float32, 1 bfloat16, 2 float16 (x and y alike); data
// is float32.  m, n, k >= 1.
extern "C" int spmm_launch(int dtype, int m, int n, int k, int cap,
                           const int* nnz, const int* indptr,
                           const int* indices, const float* data,
                           const void* x, void* y, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(m, n, k, cap, nnz, indptr, indices, data, x, y, s);
    case 1:
      return launch<__nv_bfloat16>(m, n, k, cap, nnz, indptr, indices, data,
                                   x, y, s);
    case 2:
      return launch<__half>(m, n, k, cap, nnz, indptr, indices, data, x, y,
                            s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
