// Mamba-2 SSD (state-space duality) chunk scan for Hopper (sm_90a) on the
// CUDA cores.
//
// Replaces the Pallas TPU kernel ssd_call of
// repro/kernels/ssd_chunk/kernel.py (_ssd_kernel) for float32, for widths
// that are no multiple of 16 and for operands TMA cannot address;
// ssd_chunk_wgmma.cu beside it takes bfloat16 at multiples of 16 on the
// tensor cores (kernel.py's variant picks one of the two: the model's
// bfloat16 prefill runs there, its float32 gate here).  For xd (b, s, nh, hp)
// (inputs already scaled by dt), log_a (b, s, nh) float32 and B, C
// (b, s, g, n), head h reading group h / (nh / g), the sequence is cut into
// chunks of Q steps and, per (batch, head), chunk by chunk in order:
//   cum   = cumsum(log_a over the chunk)                       (Q,)
//   L_ij  = exp(cum_i - cum_j) for j <= i, 0 above the diagonal
//   y     = ((C B^T) o L) xd + exp(cum) o (C state)            (Q, hp)
//   state = exp(cum_Q) state + B^T (exp(cum_Q - cum) o xd)     (n, hp)
// starting from state 0; after the last chunk the state is written as hT
// (b, nh, n, hp) float32.  y is written (b, s, nh, hp) in xd's dtype.
// xd, B and C are float32 or bfloat16 (one dtype) and read as float32, as
// the Pallas kernel's astype(f32); every product and sum is IEEE float32
// on the CUDA cores (fmaf; no tensor cores, no TF32).  exp is taken of
// one difference cum_i - cum_j, never as a quotient of two exps, and never
// of the upper triangle: with A down to -16 and dt ~ softplus, cum falls
// to about -3,000 over a chunk and exp(cum) underflows to 0, which is
// right, while exp(cum_i) / exp(cum_j) would be 0/0.
//
// Bound (chip_smoke.py computes it from each run's shapes): bytes, at
// mamba2-780m's widths in bfloat16.  The least work shares C B^T between
// the heads of a group: per chunk Q (Q + 1) / 2 n multiply-adds per group,
// and per head Q (Q + 1) / 2 hp (the masked product) plus 2 Q n hp (the
// inter-chunk term and the state update).  At S 4,096 that is 9.8 GFLOP,
// 10 us at the 989 TFLOP/s bf16 tensor-core rate, against 55 MB (xd and y
// 25 MB each) at 3.35 TB/s, 16 us.
//
// Design on this card:
//   * The TPU grid (batch, head, chunk) walks its chunk axis in order and
//     carries the (n, hp) state in VMEM scratch.  Here one block owns one
//     (batch, head, 32-column slice of the head dim) and loops over the
//     chunks itself, the state slice (n x 32 float32) in shared memory.
//     The head-dim columns are independent (y[:, p] needs only xd[:, p]
//     and state[:, p]), so at batch 1 the grid is 48 heads x 2 slices = 96
//     blocks instead of 48, at the cost of computing C B^T o L once per
//     slice (twice per head).
//   * A chunk of 256 steps does not fit a block's shared memory whole (its
//     C B^T panel alone is 256 KB of float32), so its rows are taken in
//     tiles of 64: C's rows stay in shared memory (transposed, [k][i])
//     while B (transposed, [k][j]) and the xd slice ([j][p]) stream
//     through in column tiles of 64, only those on or below the diagonal.
//     Each column tile's 64 x 64 scores are register-tiled (4 x 2 a
//     thread), decayed and masked into a shared panel, then multiplied
//     into the row tile's y (2 x 2 a thread), which already holds the
//     inter-chunk term.  The state is updated after the row tiles, from B
//     and the decay-weighted xd streamed once more, each thread owning
//     4 x 2 blocks of state entries.
//   * Any chunk length from 1 to 256 (the model's _pick_chunk gives the
//     largest divisor of S up to 256: 13, 250, or 1 for a prime S): ragged
//     tiles are zero-padded in shared memory and masked on store.
//   * The chunk's cumsum runs in warp 0: each lane sums a run of
//     consecutive steps, then a shuffle scan adds the runs before it.
//   * Tiles are loaded into shared memory a row per warp, a value per lane,
//     with no division by the runtime n: such index arithmetic costs more
//     instructions than the products it feeds.
//   * 512 threads (16 warps) a block: with one block an SM at batch 1,
//     more warps hide more of the shared-memory and barrier latency than
//     larger register blocks per thread save (256 and 1,024 threads ran
//     slower on the H100).
//   * xd, B and C may be strided (the model's B and C are slices of the
//     convolution's output, row stride d_in + 2 g n): the last dimension
//     must be contiguous, the others take any stride.  log_a, y and hT are
//     contiguous.
//   * Shared memory (168 n + 6,656) x 4 bytes: 110 KB at n 128.
//
// What it does not do about its bound: every product runs at the float32
// CUDA-core rate (67 TFLOP/s), with no wgmma or TMA, C B^T is recomputed
// for every head of a group and every head-dim slice, and the chunks of a
// head run one after another in one block.  ssd_chunk_wgmma.cu does those
// for bfloat16; float32 keeps this kernel, whose gates a bf16 product
// could not hold.
//
// Plain C interface, loaded with ctypes; the launch reports
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
// what each thread computes: a kSR x kSC block of a column tile's scores,
// a kOR x kOC block of a row tile's y, kHR x kHC blocks of the state
constexpr int kSR = 4, kSC = 2;
constexpr int kOR = 2, kOC = 2;
constexpr int kHR = 4, kHC = 2;
constexpr int kMaxQ = 256;    // longest chunk
constexpr int kMaxN = 256;    // largest state size
constexpr int kR = 64;        // chunk rows per row tile
constexpr int kJ = 64;        // chunk columns per column tile
constexpr int kP = 32;        // head-dim columns per block
constexpr int kRP = kR + 4;   // padded row of Cs and Ps
constexpr int kJP = kJ + 4;   // padded row of Bs
static_assert(kR == kJ, "C's row tiles load like B's column tiles");
static_assert((kJ / kSC) * (kR / kSR) == kThreads &&
              (kP / kOC) * (kR / kOR) == kThreads, "thread blocks");
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// N consecutive floats of shared memory (aligned to 4 N bytes) into
// registers.
template <int N>
__device__ __forceinline__ void load_vec(const float* p, float (&out)[N]) {
  if constexpr (N == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    out[0] = x.x; out[1] = x.y; out[2] = x.z; out[3] = x.w;
  } else if constexpr (N == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    out[0] = x.x; out[1] = x.y;
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = p[i];
  }
}

size_t smem_bytes(int n) {
  return size_t(n * (kP + kRP + kJP) + kMaxQ + kJ * kP + kJ * kRP) *
         sizeof(float);
}

struct Args {
  const void* xd;
  const float* la;
  const void* B;
  const void* C;
  void* y;
  float* hT;
  int S, Q, nh, hp, g, n;
  int64_t xsb, xss, xsh;   // xd: batch, step and head strides
  int64_t bsb, bss, bsg;   // B: batch, step and group strides
  int64_t csb, css, csg;   // C alike
};

// Rows [0, cols) of an (S, n) operand (row stride rs) into dst[k][j] (row
// length ld), zero past cols: warp w takes rows w, w + 16.., its lanes the
// row's n values (no division by the runtime n).
template <typename T>
__device__ __forceinline__ void load_transposed(float* dst, int ld,
                                                const T* src, int64_t rs,
                                                int cols, int n, int tid) {
  const int lane = tid % 32;
  for (int j = tid / 32; j < kJ; j += kThreads / 32) {
    const T* row = src + j * rs;
#pragma unroll 4
    for (int k = lane; k < n; k += 32)
      dst[k * ld + j] = j < cols ? to_f(row[k]) : 0.f;
  }
}

// Rows [0, cols) of a block's xd slice (row stride rs, pw live columns)
// into xs[j][p], zero past them; with `decay`, row j is scaled by
// exp(cum_q - cum[j]).  Warp w takes rows w, w + 16.., lane p column p.
template <typename T>
__device__ __forceinline__ void load_xd(float* xs, const T* src, int64_t rs,
                                        int cols, int pw, const float* cum,
                                        float cum_q, bool decay, int tid) {
  const int p = tid % 32;
  static_assert(kP == 32, "one lane per head-dim column");
#pragma unroll
  for (int j = tid / 32; j < kJ; j += kThreads / 32) {
    float v = (j < cols && p < pw) ? to_f(src[j * rs + p]) : 0.f;
    if (decay && j < cols) v *= expf(cum_q - cum[j]);
    xs[j * kP + p] = v;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_chunk_kernel(Args a) {
  extern __shared__ float4 smem_raw[];
  const int n = a.n, Q = a.Q;
  float* state = reinterpret_cast<float*>(smem_raw);   // [n][kP]
  float* cum = state + n * kP;                          // [kMaxQ]
  float* Cs = cum + kMaxQ;                              // [n][kRP]
  float* Bs = Cs + n * kRP;                             // [n][kJP]
  float* xs = Bs + n * kJP;                             // [kJ][kP]
  float* Ps = xs + kJ * kP;                             // [kJ][kRP]

  const int tid = threadIdx.x;
  const int p0 = blockIdx.x * kP, h = blockIdx.y, b = blockIdx.z;
  const int pw = min(kP, a.hp - p0);                    // live columns
  const int grp = h / (a.nh / a.g);
  const T* xd = static_cast<const T*>(a.xd) + b * a.xsb + h * a.xsh + p0;
  const T* Bp = static_cast<const T*>(a.B) + b * a.bsb + grp * a.bsg;
  const T* Cp = static_cast<const T*>(a.C) + b * a.csb + grp * a.csg;
  const float* la = a.la + int64_t(b) * a.S * a.nh + h;
  const int64_t ys = int64_t(a.nh) * a.hp;              // y's step stride
  T* y = static_cast<T*>(a.y) + int64_t(b) * a.S * ys + h * a.hp + p0;

  for (int e = tid; e < n * kP; e += kThreads) state[e] = 0.f;

  const int sy = tid / (kJ / kSC), sx = tid % (kJ / kSC);   // score block
  const int oy = tid / (kP / kOC), ox = tid % (kP / kOC);   // y block
  const int hc = (tid % (kP / kHC)) * kHC;   // state columns of this thread
  constexpr int kHStep = kThreads / (kP / kHC);

  for (int t0 = 0; t0 < a.S; t0 += Q) {
    __syncthreads();   // the last chunk's state update is done with cum
    if (tid < 32) {
      const int per = (Q + 31) / 32;
      const int lo = tid * per, len = max(0, min(per, Q - lo));
      float v[kMaxQ / 32];
#pragma unroll
      for (int u = 0; u < kMaxQ / 32; ++u)
        v[u] = u < len ? la[int64_t(t0 + lo + u) * a.nh] : 0.f;
      float run = 0.f;
#pragma unroll
      for (int u = 0; u < kMaxQ / 32; ++u) {
        run += v[u];
        v[u] = run;
      }
      float incl = run;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float up = __shfl_up_sync(kFull, incl, o);
        if (tid >= o) incl += up;
      }
      const float off = incl - run;
#pragma unroll
      for (int u = 0; u < kMaxQ / 32; ++u)
        if (u < len) cum[lo + u] = v[u] + off;
    }
    __syncthreads();

    for (int r0 = 0; r0 < Q; r0 += kR) {
      const int rows = min(kR, Q - r0);
      load_transposed(Cs, kRP, Cp + int64_t(t0 + r0) * a.css, a.css, rows,
                      n, tid);
      __syncthreads();

      // inter-chunk term: exp(cum_i) (C_i . state)
      float acc[kOR][kOC];
#pragma unroll
      for (int r = 0; r < kOR; ++r)
#pragma unroll
        for (int c = 0; c < kOC; ++c) acc[r][c] = 0.f;
#pragma unroll 4
      for (int k = 0; k < n; ++k) {
        float ci[kOR], si[kOC];
        load_vec(Cs + k * kRP + oy * kOR, ci);
        load_vec(state + k * kP + ox * kOC, si);
#pragma unroll
        for (int r = 0; r < kOR; ++r)
#pragma unroll
          for (int c = 0; c < kOC; ++c)
            acc[r][c] = fmaf(ci[r], si[c], acc[r][c]);
      }
#pragma unroll
      for (int r = 0; r < kOR; ++r) {
        const int i = oy * kOR + r;
        const float e = i < rows ? expf(cum[r0 + i]) : 0.f;
#pragma unroll
        for (int c = 0; c < kOC; ++c) acc[r][c] *= e;
      }

      // intra-chunk term, column tiles on or below the diagonal
      for (int j0 = 0; j0 < r0 + rows; j0 += kJ) {
        const int cols = min(kJ, Q - j0);
        __syncthreads();   // the last tile's Ps, Bs and xs are read
        load_transposed(Bs, kJP, Bp + int64_t(t0 + j0) * a.bss, a.bss, cols,
                        n, tid);
        load_xd(xs, xd + int64_t(t0 + j0) * a.xss, a.xss, cols, pw, cum,
                0.f, false, tid);
        __syncthreads();

        float s[kSR][kSC];
#pragma unroll
        for (int r = 0; r < kSR; ++r)
#pragma unroll
          for (int c = 0; c < kSC; ++c) s[r][c] = 0.f;
#pragma unroll 4
        for (int k = 0; k < n; ++k) {
          float ci[kSR], bj[kSC];
          load_vec(Cs + k * kRP + sy * kSR, ci);
          load_vec(Bs + k * kJP + sx * kSC, bj);
#pragma unroll
          for (int r = 0; r < kSR; ++r)
#pragma unroll
            for (int c = 0; c < kSC; ++c)
              s[r][c] = fmaf(ci[r], bj[c], s[r][c]);
        }
        // decay and causal mask: exp only of cum_i - cum_j with j <= i
#pragma unroll
        for (int r = 0; r < kSR; ++r) {
          const int i = sy * kSR + r, gi = r0 + i;
          const float cum_i = gi < Q ? cum[gi] : 0.f;
#pragma unroll
          for (int c = 0; c < kSC; ++c) {
            const int j = sx * kSC + c, gj = j0 + j;
            Ps[j * kRP + i] = (gi < Q && gj <= gi)
                                  ? s[r][c] * expf(cum_i - cum[gj]) : 0.f;
          }
        }
        __syncthreads();

#pragma unroll 4
        for (int j = 0; j < kJ; ++j) {
          float pi[kOR], xj[kOC];
          load_vec(Ps + j * kRP + oy * kOR, pi);
          load_vec(xs + j * kP + ox * kOC, xj);
#pragma unroll
          for (int r = 0; r < kOR; ++r)
#pragma unroll
            for (int c = 0; c < kOC; ++c)
              acc[r][c] = fmaf(pi[r], xj[c], acc[r][c]);
        }
      }

#pragma unroll
      for (int r = 0; r < kOR; ++r) {
        const int i = oy * kOR + r;
        if (i >= rows) continue;
        T* yr = y + int64_t(t0 + r0 + i) * ys + ox * kOC;
#pragma unroll
        for (int c = 0; c < kOC; ++c)
          if (ox * kOC + c < pw) store_f(yr + c, acc[r][c]);
      }
      __syncthreads();   // Cs is read before the next row tile's load
    }

    // state <- exp(cum_Q) state + B^T (exp(cum_Q - cum) o xd); each thread
    // owns kHR x kHC blocks of entries: rows kHR kq.. for kq = tid /
    // (kP / kHC) + kHStep m, columns hc..
    const float cum_q = cum[Q - 1];
    const float dq = expf(cum_q);
    for (int kq = tid / (kP / kHC); kq * kHR < n; kq += kHStep)
      for (int r = 0; r < kHR && kq * kHR + r < n; ++r)
#pragma unroll
        for (int c = 0; c < kHC; ++c)
          state[(kq * kHR + r) * kP + hc + c] *= dq;
    for (int j0 = 0; j0 < Q; j0 += kJ) {
      const int cols = min(kJ, Q - j0);
      __syncthreads();
      load_transposed(Bs, kJP, Bp + int64_t(t0 + j0) * a.bss, a.bss, cols, n,
                      tid);
      load_xd(xs, xd + int64_t(t0 + j0) * a.xss, a.xss, cols, pw,
              cum + j0, cum_q, true, tid);
      __syncthreads();
      for (int kq = tid / (kP / kHC); kq * kHR < n; kq += kHStep) {
        const int kr = min(kHR, n - kq * kHR);
        const float* bq = Bs + kq * kHR * kJP;
        float acc[kHR][kHC];
#pragma unroll
        for (int r = 0; r < kHR; ++r)
#pragma unroll
          for (int c = 0; c < kHC; ++c) acc[r][c] = 0.f;
#pragma unroll 4
        for (int j = 0; j < cols; ++j) {
          float xj[kHC];
          load_vec(xs + j * kP + hc, xj);
#pragma unroll
          for (int r = 0; r < kHR; ++r) {
            const float bv = r < kr ? bq[r * kJP + j] : 0.f;
#pragma unroll
            for (int c = 0; c < kHC; ++c)
              acc[r][c] = fmaf(bv, xj[c], acc[r][c]);
          }
        }
        for (int r = 0; r < kr; ++r)
#pragma unroll
          for (int c = 0; c < kHC; ++c)
            state[(kq * kHR + r) * kP + hc + c] += acc[r][c];
      }
    }
  }

  // each thread writes the entries it owns
  float* out = a.hT + (int64_t(b) * a.nh + h) * n * a.hp + p0;
  for (int kq = tid / (kP / kHC); kq * kHR < n; kq += kHStep)
    for (int r = 0; r < kHR && kq * kHR + r < n; ++r)
#pragma unroll
      for (int c = 0; c < kHC; ++c)
        if (hc + c < pw)
          out[int64_t(kq * kHR + r) * a.hp + hc + c] =
              state[(kq * kHR + r) * kP + hc + c];
}

template <typename T>
cudaError_t launch(const Args& a, int batch, cudaStream_t stream) {
  auto kern = ssd_chunk_kernel<T>;
  const size_t smem = smem_bytes(a.n);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.hp + kP - 1) / kP, a.nh, batch);
  kern<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (xd, B, C and y alike; log_a and hT are
// float32).  strides: the batch, step and head (group) strides of xd, B
// and C, in elements (9 values).
extern "C" int ssd_chunk_launch(int dtype, int batch, int S, int nh, int hp,
                                int g, int n, int Q, const void* xd,
                                const void* log_a, const void* Bm,
                                const void* Cm, void* y, void* hT,
                                const long long* strides, void* stream) {
  if (batch <= 0 || S <= 0 || nh <= 0 || hp <= 0 || g <= 0 || n <= 0 ||
      n > kMaxN || Q <= 0 || Q > kMaxQ || S % Q != 0 || nh % g != 0)
    return int(cudaErrorInvalidValue);
  Args a{xd, static_cast<const float*>(log_a), Bm, Cm, y,
         static_cast<float*>(hT), S, Q, nh, hp, g, n,
         strides[0], strides[1], strides[2], strides[3], strides[4],
         strides[5], strides[6], strides[7], strides[8]};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return int(launch<float>(a, batch, s));
  if (dtype == 1) return int(launch<__nv_bfloat16>(a, batch, s));
  return int(cudaErrorInvalidValue);
}
