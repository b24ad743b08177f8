// GQA flash-attention forward for Hopper (sm_90a) on the CUDA cores,
// online softmax: float32 q, k, v, and bfloat16 at head dims 16 and 32.
// bfloat16 at head dims 64, 128 and 256 runs on the tensor cores in
// flash_attention_wgmma.cu (kernel.py's flash_fwd picks by (dtype, D)).
//
// Replaces the Pallas TPU kernel fwd_call of
// repro/kernels/flash_attention/kernel.py (_fwd_kernel): for q (B, H, Sq, D)
// and k, v (B, Hkv, Skv, D), query head h reads KV head h / (H / Hkv), and
//   out[b, h, i] = sum_j softmax_j(scale * q_i . k_j) v_j
// over the keys j that query i sees: all of them, or with `causal` those
// with i >= j (no offset between the query and key positions, as the
// reference kernel's mask).  Constants as the reference: masked scores are
// -1e30, the running max starts at -1e30, the output is acc / max(l, 1e-30)
// cast to q's dtype.  Inputs are float32 or bfloat16; everything inside is
// float32.
//
// Bound: operations.  Each (query, key) pair that is not masked costs a
// D-long dot product and a D-long weighted add, 4 D operations, so the
// least work is 4 B H D (pairs) -- with `causal` and Sq == Skv = S, pairs
// = S (S + 1) / 2 -- at the card's 989 TFLOP/s bf16 tensor-core rate.  The
// bytes (q, k, v read once, out written once) take two orders of magnitude
// less time at 3.35 TB/s.
//
// Design on this card:
//   * The TPU grid (batch, head, q block, kv block) walks its kv axis in
//     order, carrying (m, l, acc) in scratch.  Here one block owns one
//     (batch, head, query tile) and loops over KV tiles itself; (m, l) stay
//     in registers of the threads that compute the scores, acc in the
//     registers of the threads that own output columns.
//   * Query tiles of 64 rows (32 at D = 256), KV tiles of 64 keys, 128
//     threads.  Q is staged once as float32 in shared memory, transposed
//     ([d][row]); each KV tile is staged as float32, K transposed ([d][key])
//     for the score product, then V ([key][d]) in the same buffer for the
//     weighted sum.  Above 48 KB the dynamic shared memory is opted into.
//   * Both products are register-tiled on the CUDA cores with fmaf: each
//     thread computes a (BQ/16) x 8 block of scores and owns a (BQ/8) x
//     (D/16) block of the output, so each shared load feeds several FMAs.
//     No tensor cores, no TF32: float32 inputs stay float32.
//   * Causal skip: the KV loop ends at the tile holding the tile's last
//     query row, so fully masked tiles are never loaded.  Query tiles are
//     launched longest first.  Ragged edges (Sq or Skv not a multiple of
//     the tile) are masked here: absent queries are zero and not stored,
//     absent keys score -1e30 and their values are zero.
//   * q, k and v may be strided (the model's projections are transposes):
//     the last dimension must be contiguous, the others take any stride.
//     out is contiguous (B, H, Sq, D).
//
// What it does not do about its bound: the scores and the weighted sum run
// at the float32 CUDA-core rate (67 TFLOP/s, 15x under the bound's 989),
// with no asynchronous copies overlapping the loads with the products and
// no sharing of a KV tile between the query heads of one GQA group.  That
// is what flash_attention_wgmma.cu does for bf16; float32 stays here so
// that its sums stay IEEE float32 (no TF32, no bf16 rounding).
//
// Plain C interface, loaded with ctypes; the launch reports
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 128;
constexpr int kBKV = 64;
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// N consecutive floats of shared memory (16-byte aligned when N % 4 == 0,
// 8-byte aligned when N == 2) into registers.
template <int N>
__device__ __forceinline__ void load_row(const float* p, float (&out)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 x = *reinterpret_cast<const float4*>(p + i);
      out[i] = x.x; out[i + 1] = x.y; out[i + 2] = x.z; out[i + 3] = x.w;
    }
  } else if constexpr (N == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    out[0] = x.x; out[1] = x.y;
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = p[i];
  }
}

template <int D>
struct Tile {
  static constexpr int BQ = D > 128 ? 32 : 64;   // query rows per block
  static constexpr int QP = BQ + 4;              // padded Qs / Ps row
  static constexpr int KP = kBKV + 4;            // padded Ks row
  static constexpr int SM = BQ / 16;             // score rows per thread
  static constexpr int SN = 8;                   // score columns per thread
  static constexpr int OM = BQ / 8;              // output rows per thread
  static constexpr int ON = D / 16;              // output columns per thread
  static constexpr int KV = D * KP > kBKV * D ? D * KP : kBKV * D;
  static constexpr int SMEM =
      (D * QP + KV + kBKV * QP + 2 * BQ) * int(sizeof(float));
  static_assert(D % 16 == 0 && SM * 16 == BQ && OM * 8 == BQ, "tile shape");
};

template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, int H,
                 int group, int Sq, int Skv, int causal, float scale,
                 int64_t qsb, int64_t qsh, int64_t qss, int64_t ksb,
                 int64_t ksh, int64_t kss, int64_t vsb, int64_t vsh,
                 int64_t vss) {
  using C = Tile<D>;
  extern __shared__ float4 smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);   // [D][QP]
  float* KVs = Qs + D * C::QP;                      // [D][KP] or [kBKV][D]
  float* Ps = KVs + C::KV;                          // [kBKV][QP]
  float* alpha_s = Ps + kBKV * C::QP;               // [BQ]
  float* l_s = alpha_s + C::BQ;                     // [BQ]

  const int tid = threadIdx.x;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * C::BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int rows = min(C::BQ, Sq - q0);
  const T* qb = q + b * qsb + h * qsh + q0 * qss;
  const T* kb = k + b * ksb + (h / group) * ksh;
  const T* vb = v + b * vsb + (h / group) * vsh;

  for (int i = tid; i < C::BQ * D; i += kThreads) {
    const int r = i / D, d = i % D;
    Qs[d * C::QP + r] = r < rows ? to_f(qb[r * qss + d]) : 0.f;
  }
  // Causal: the tile's last query row q0 + rows - 1 sees keys up to itself.
  const int kv_end = causal ? min(Skv, q0 + rows) : Skv;
  const int n_tiles = (kv_end + kBKV - 1) / kBKV;

  const int sy = tid / 8, sx = tid % 8;     // score block of this thread
  const int oy = tid / 16, ox = tid % 16;   // output block of this thread
  float m[C::SM], l[C::SM];
#pragma unroll
  for (int i = 0; i < C::SM; ++i) { m[i] = kNegInf; l[i] = 0.f; }
  float acc[C::OM][C::ON];
#pragma unroll
  for (int i = 0; i < C::OM; ++i)
#pragma unroll
    for (int c = 0; c < C::ON; ++c) acc[i][c] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int j0 = t * kBKV;
    const int cols = min(kBKV, Skv - j0);
    __syncthreads();   // the last tile's weighted sum is done with KVs, Ps
    for (int i = tid; i < kBKV * D; i += kThreads) {
      const int j = i / D, d = i % D;
      KVs[d * C::KP + j] = j < cols ? to_f(kb[(j0 + j) * kss + d]) : 0.f;
    }
    __syncthreads();

    float s[C::SM][C::SN];
#pragma unroll
    for (int i = 0; i < C::SM; ++i)
#pragma unroll
      for (int c = 0; c < C::SN; ++c) s[i][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[C::SM], kv[C::SN];
      load_row(Qs + d * C::QP + sy * C::SM, qv);
      load_row(KVs + d * C::KP + sx * C::SN, kv);
#pragma unroll
      for (int i = 0; i < C::SM; ++i)
#pragma unroll
        for (int c = 0; c < C::SN; ++c) s[i][c] = fmaf(qv[i], kv[c], s[i][c]);
    }

    // Online softmax; the 8 threads of a row are lanes sx = 0..7 of a warp.
#pragma unroll
    for (int i = 0; i < C::SM; ++i) {
      const int r = sy * C::SM + i;
      float mt = kNegInf;
#pragma unroll
      for (int c = 0; c < C::SN; ++c) {
        const int j = j0 + sx * C::SN + c;
        float x = s[i][c] * scale;
        if (j >= Skv || (causal && j > q0 + r)) x = kNegInf;
        s[i][c] = x;
        mt = fmaxf(mt, x);
      }
      mt = fmaxf(mt, __shfl_xor_sync(kFull, mt, 1));
      mt = fmaxf(mt, __shfl_xor_sync(kFull, mt, 2));
      mt = fmaxf(mt, __shfl_xor_sync(kFull, mt, 4));
      const float mn = fmaxf(m[i], mt);
      const float alpha = expf(m[i] - mn);
      float ps = 0.f;
#pragma unroll
      for (int c = 0; c < C::SN; ++c) {
        const float p = expf(s[i][c] - mn);
        Ps[(sx * C::SN + c) * C::QP + r] = p;
        ps += p;
      }
      ps += __shfl_xor_sync(kFull, ps, 1);
      ps += __shfl_xor_sync(kFull, ps, 2);
      ps += __shfl_xor_sync(kFull, ps, 4);
      l[i] = l[i] * alpha + ps;
      m[i] = mn;
      if (sx == 0) alpha_s[r] = alpha;
    }
    __syncthreads();   // Ps and alpha_s written, Ks read by every thread

    for (int i = tid; i < kBKV * D; i += kThreads) {
      const int j = i / D, d = i % D;
      KVs[j * D + d] = j < cols ? to_f(vb[(j0 + j) * vss + d]) : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < C::OM; ++i) {
      const float alpha = alpha_s[oy * C::OM + i];
#pragma unroll
      for (int c = 0; c < C::ON; ++c) acc[i][c] *= alpha;
    }
#pragma unroll 4
    for (int j = 0; j < kBKV; ++j) {
      float pv[C::OM], vv[C::ON];
      load_row(Ps + j * C::QP + oy * C::OM, pv);
      load_row(KVs + j * D + ox * C::ON, vv);
#pragma unroll
      for (int i = 0; i < C::OM; ++i)
#pragma unroll
        for (int c = 0; c < C::ON; ++c)
          acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

  if (sx == 0) {
#pragma unroll
    for (int i = 0; i < C::SM; ++i) l_s[sy * C::SM + i] = l[i];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < C::OM; ++i) {
    const int r = oy * C::OM + i;
    if (r >= rows) continue;
    const float denom = fmaxf(l_s[r], 1e-30f);
    T* o = out + ((int64_t(b) * H + h) * Sq + q0 + r) * D + ox * C::ON;
#pragma unroll
    for (int c = 0; c < C::ON; ++c) store_f(o + c, acc[i][c] / denom);
  }
}

template <int D, typename T>
cudaError_t launch(int B, int H, int Hkv, int Sq, int Skv, int causal,
                   float scale, const void* q, const void* k, const void* v,
                   void* out, const long long* st, cudaStream_t stream) {
  using C = Tile<D>;
  auto kern = flash_fwd_kernel<D, T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + C::BQ - 1) / C::BQ, H, B);
  kern<<<grid, kThreads, C::SMEM, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), H, H / Hkv, Sq, Skv,
      causal, scale, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
      st[8]);
  return cudaGetLastError();
}

// bfloat16 at head dims 64-256 runs on the tensor cores
// (flash_attention_wgmma.cu), so only float32 instantiates them here.
template <typename T>
cudaError_t launch_d(int D, int B, int H, int Hkv, int Sq, int Skv,
                     int causal, float scale, const void* q, const void* k,
                     const void* v, void* out, const long long* st,
                     cudaStream_t stream) {
  constexpr bool f32 = std::is_same<T, float>::value;
  switch (D) {
    case 16: return launch<16, T>(B, H, Hkv, Sq, Skv, causal, scale, q, k, v, out, st, stream);
    case 32: return launch<32, T>(B, H, Hkv, Sq, Skv, causal, scale, q, k, v, out, st, stream);
    case 64:
      if constexpr (f32) return launch<64, T>(B, H, Hkv, Sq, Skv, causal, scale, q, k, v, out, st, stream);
      break;
    case 128:
      if constexpr (f32) return launch<128, T>(B, H, Hkv, Sq, Skv, causal, scale, q, k, v, out, st, stream);
      break;
    case 256:
      if constexpr (f32) return launch<256, T>(B, H, Hkv, Sq, Skv, causal, scale, q, k, v, out, st, stream);
      break;
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (q, k, v and out alike; bfloat16 at head
// dims 16 and 32 only).  strides: the batch, head and row strides of q, k
// and v, in elements (9 values).
extern "C" int flash_fwd_launch(int dtype, int B, int H, int Hkv, int Sq,
                                int Skv, int D, int causal, float scale,
                                const void* q, const void* k, const void* v,
                                void* out, const long long* strides,
                                void* stream) {
  if (B <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 || Sq <= 0 || Skv <= 0)
    return int(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return int(launch_d<float>(D, B, H, Hkv, Sq, Skv, causal, scale, q, k, v,
                               out, strides, s));
  if (dtype == 1)
    return int(launch_d<__nv_bfloat16>(D, B, H, Hkv, Sq, Skv, causal, scale,
                                       q, k, v, out, strides, s));
  return int(cudaErrorInvalidValue);
}
