// Mamba-2 SSD (state-space duality) chunk scan for Hopper (sm_90a) on the
// tensor cores: bfloat16 xd, B and C with head dim and state multiples of
// 16 (state up to 256), operands that TMA can address.
//
// Replaces the Pallas TPU kernel ssd_call of
// repro/kernels/ssd_chunk/kernel.py:74 (_ssd_kernel) for those inputs;
// ssd_chunk.cu beside it keeps float32, odd widths and unaligned strides on
// the CUDA cores (kernel.py's variant picks one of the two).  The function
// is the same: for xd (b, s, nh, hp) (inputs already scaled by dt), log_a
// (b, s, nh) float32 and B, C (b, s, g, n), head h reading group
// h / (nh / g), the sequence is cut into chunks of Q steps and, per chunk,
//   cum   = cumsum(log_a over the chunk)                       (Q,)
//   L_ij  = exp(cum_i - cum_j) for j <= i, 0 above the diagonal
//   y     = ((C B^T) o L) xd + exp(cum) o (C H_{c-1})          (Q, hp)
//   H_c   = exp(cum_Q) H_{c-1} + B^T (exp(cum_Q - cum) o xd)   (n, hp)
// from H = 0; hT (b, nh, n, hp) float32 is the state after the last chunk,
// y (b, s, nh, hp) bfloat16.
//
// Bound (chip_smoke.py computes it from each run's shapes): at mamba2-780m's
// widths the least work is 9.8 GFLOP at S 4,096 (C B^T once per group, the
// masked product, the inter-chunk term and the state update), 10 us at the
// 989 TFLOP/s bf16 tensor-core rate, against 55 MB of xd, y, B, C, log_a
// and hT at 3.35 TB/s, 16 us: bytes bound it.
//
// Design: the chunks run in parallel, in three launches in stream order
// (arXiv:2405.21060 section 6), where the TPU kernel walks its chunk grid
// axis in order carrying the state in VMEM and ssd_chunk.cu loops over the
// chunks inside each block:
//   (a) ssd_chunk_states_kernel, a block per (batch, chunk, 4 heads of one
//       group, 64 head-dim columns): each head's cumsum over the chunk (a
//       warp scan, stored to `cum`, which (b) and (c) read bit for bit) and
//       its decay weights w = exp(cum_Q - cum) once, and the chunk's own
//       state S_c^T = (w o xd)^T B, (hp, n) float32, into `states`.  B stays
//       in shared memory for the block's heads; xd tiles stream through a
//       ring of 4.
//   (b) ssd_chunk_pass_kernel, a warp per (batch, head, head-dim column):
//       H_c = exp(cum_Q) H_{c-1} + S_c in series over the chunks (the next
//       chunk's row loaded ahead), writing in place of S_c the state
//       entering chunk c as a bf16 pair (below), and hT after the last
//       chunk.  Elementwise, float32 fmaf: it runs at the memory's rate.
//   (c) ssd_chunk_output_kernel, a block per (batch, chunk, 64-row tile of
//       the chunk, 6 heads of one group, 64 head-dim columns), two blocks an
//       SM: C B^T of the tile's rows against the chunk's columns on or below
//       the diagonal, once, kept in registers (128 of them); then for each
//       head the inter-chunk term C H_{c-1} scaled by exp(cum_i), and
//       ((C B^T) o L_h) xd_h with that head's decay.  Row tiles run longest
//       first.  The decay mask is branch-free (the masked exponent is -inf
//       before exp), so a thread's 32 exps of a tile overlap: as a branch
//       per value a tile took 2.5 times as long.
// All four products run on wgmma, bf16 operands, float32 accumulators; no
// TF32.  C B^T of bf16 inputs is exact product by product.  A float32
// operand -- (C B^T) o L, the state H, the decay-weighted xd -- enters as a
// pair hi = bf16(v), lo = bf16(v - hi) and takes two products (as the flash
// kernel's P V): one bf16 rounding of a float32 operand summed over 256
// terms would spend most of phase 19's tolerance, the pair leaves 2^-16 of
// each term.  The state pair is what (b) stores (hi then lo, n values each,
// in the 4n bytes of a float32 row of S_c), so (c) loads it by TMA.
// Operands: tiles of 64 rows x 64 bf16 (128 bytes, 128-byte swizzle) by TMA
// under mbarriers, zero fill past the tensor; a block of pass (a) or (c) is
// one warpgroup whose thread 0 keeps the ring's loads ahead of the products
// (a ring of 4 tiles in (a), 8 in (c), each slot refilled once the products
// of its group of tiles -- a column tile of B, a head's H pair, an xd tile
// -- are done).  xd's, B's and C's tensor maps take their real strides (the
// model's B and C are slices of the convolution's output, row stride d_in +
// 2 g n); each must be a multiple of 16 bytes and the base 16-byte aligned,
// as kernel.py checks.  Any chunk from 1 to 256: rows past the chunk's end
// belong to the next chunk, not past the tensor, so they are masked out of
// L and of the decay weights explicitly (never exponentiated: exp is taken
// of one difference cum_i - cum_j with j <= i, never as a quotient of two
// exps).  No atomics: two calls are bitwise equal.
// Scratch (the wrapper's): cum (b, s, nh) and states (b, nc, nh, hp, n)
// float32, 25 MB at S 4,096.
//
// Left for later: pass (c) builds a P tile while no product runs (its
// registers hold C B^T, so no second buffer fits); a block of two
// warpgroups with C B^T in shared memory, double-buffered P and a producer
// warp ran slower on the H100 (one block an SM left each block's prologue
// bare).  Also folding (b) into (c) with chunk-ordered tickets, and fp8.
//
// Plain C interface, loaded with ctypes; the launch reports
// cudaGetLastError().

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 128;         // one warpgroup a block, (a) and (c)
constexpr int kTile = 64;             // rows of a tile
constexpr int kPiece = kTile * 128;   // bytes of a 64 x 64 bf16 tile
constexpr int kMaxQ = 256;            // longest chunk
constexpr int kMaxN = 256;            // largest state
constexpr int kSlotsA = 4;            // xd ring of pass (a)
constexpr int kSlotsC = 8;            // ring of pass (c): 2 KB tiles
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(bytes) : "memory");
}

// Wait for the completion of the barrier's phase of this parity.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// One TMA box into shared memory; `order` packs, two bits each, which of
// the map's dimensions 1..3 holds the row, the head and the batch.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int order, int col,
                                         int row, int head, int batch) {
  const int pr = order & 3, ph = (order >> 2) & 3;
  const int c1 = pr == 0 ? row : ph == 0 ? head : batch;
  const int c2 = pr == 1 ? row : ph == 1 ? head : batch;
  const int c3 = pr == 2 ? row : ph == 2 ? head : batch;
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col),
         "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// Shared-memory matrix descriptor, 128-byte swizzle; offsets in bytes.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return uint64_t((addr & 0x3FFFF) >> 4) |
         (uint64_t((lbo >> 4) & 0x3FFF) << 16) |
         (uint64_t((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// Keep the compiler from moving accesses of a wgmma operand across the
// asynchronous window.
__device__ __forceinline__ void pin(float& r) {
  asm volatile("" : "+f"(r) :: "memory");
}
__device__ __forceinline__ void pin(uint32_t& r) {
  asm volatile("" : "+r"(r) :: "memory");
}
template <int N>
__device__ __forceinline__ void pin_all(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) pin(r[i]);
}
__device__ __forceinline__ void pin_frags(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int r = 0; r < 4; ++r) pin(a[k][r]);
}

// D[64 x 64] (+)= A[64 x 16] B[16 x 64], A and B K-major in shared memory;
// D is overwritten where `accumulate` is 0.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 64] += A[64 x 16] B[16 x 64], A in registers, B MN-major in
// shared memory (the transpose bit set).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// Two floats as bf16x2 (x in the low half) and, in `lo`, what rounding
// left behind, also as bf16x2.
__device__ __forceinline__ uint32_t split_bf16x2(float x, float y,
                                                 uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x - hf.x, y - hf.y);
  uint32_t hb, lb;
  memcpy(&hb, &h, 4);
  memcpy(&lb, &l, 4);
  lo = lb;
  return hb;
}

// Element (row, col) of a 64 x 64 bf16 tile as TMA's 128-byte swizzle laid
// it out: the 16-byte chunk col / 8 of row `row` sits at chunk
// (col / 8) ^ (row % 8).
__device__ __forceinline__ float tile_at(const uint8_t* tile, int row,
                                         int col) {
  const int off = row * 128 + ((((col >> 3) ^ (row & 7)) << 4) |
                               ((col & 7) << 1));
  return __bfloat162float(
      *reinterpret_cast<const __nv_bfloat16*>(tile + off));
}

struct Dims {
  int S, Q, nc, nh, hp, g, n;
  int G;          // heads a group
  int HB;         // heads a block
  int n_hc;       // head chunks a group: ceil(G / HB)
  int n_ps;       // 64-column slices of the head dim
  int JT;         // 64-row tiles of a chunk
  int xord, bord, cord, hord;   // the tensor maps' dimension orders
};

// The block's (chunk, group, first head, head count, head-dim slice) from
// an index over nc x g x n_hc x n_ps.
struct Work {
  int c, grp, h0, hb, p0;
};
__device__ __forceinline__ Work work_of(int idx, const Dims& d) {
  Work w;
  const int ps = idx % d.n_ps;
  idx /= d.n_ps;
  const int hc = idx % d.n_hc;
  idx /= d.n_hc;
  w.grp = idx % d.g;
  w.c = idx / d.g;
  w.h0 = w.grp * d.G + hc * d.HB;
  w.hb = min(d.HB, d.G - hc * d.HB);
  w.p0 = ps * kTile;
  return w;
}

// ---- pass (a): cumsums and chunk states ------------------------------------

template <int KB>
__global__ void __launch_bounds__(kThreads, 1)
ssd_chunk_states_kernel(const __grid_constant__ CUtensorMap txd,
                        const __grid_constant__ CUtensorMap tb,
                        const float* __restrict__ la, float* __restrict__ cum,
                        float* __restrict__ states, Dims d) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* gbase = smem_raw + (base - raw);
  const uint32_t bs = base;                            // B [kb][jt] tiles
  const uint32_t ring = bs + KB * d.JT * kPiece;       // xd tiles
  float* cum_s = reinterpret_cast<float*>(gbase + (ring - base) +
                                          kSlotsA * kPiece);   // [HB][kMaxQ]
  float* w_s = cum_s + d.HB * kMaxQ;           // decay weights [HB][kMaxQ]
  const uint32_t bbar = ring + kSlotsA * kPiece + 2 * d.HB * kMaxQ * 4;
  const uint32_t fbar = bbar + 8;                      // a full barrier a slot

  const Work w = work_of(blockIdx.x, d);
  const int b = blockIdx.z, Q = d.Q, t0 = w.c * Q;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int T = w.hb * d.JT;                           // xd tiles, head-major

  if (tid == 0) {
    mbar_init(bbar, 1);
    for (int s = 0; s < kSlotsA; ++s) mbar_init(fbar + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  auto issue = [&](int t) {
    const int s = t % kSlotsA;
    mbar_expect_tx(fbar + 8 * s, kPiece);
    tma_load(ring + s * kPiece, &txd, fbar + 8 * s, d.xord, w.p0,
             t0 + (t % d.JT) * kTile, w.h0 + t / d.JT, b);
  };
  if (tid == 0) {
    mbar_expect_tx(bbar, KB * d.JT * kPiece);
    for (int kb = 0; kb < KB; ++kb)
      for (int jt = 0; jt < d.JT; ++jt)
        tma_load(bs + (kb * d.JT + jt) * kPiece, &tb, bbar, d.bord, kb * 64,
                 t0 + jt * kTile, w.grp, b);
    for (int t = 0; t < T && t < kSlotsA; ++t) issue(t);
  }

  // each head's cumsum over the chunk, a warp a head: each lane sums a run
  // of consecutive steps, then a shuffle scan adds the runs before it
  for (int hh = warp; hh < w.hb; hh += kThreads / 32) {
    const int h = w.h0 + hh;
    const int per = (Q + 31) / 32;
    const int lo = lane * per, len = max(0, min(per, Q - lo));
    const float* lp = la + (int64_t(b) * d.S + t0 + lo) * d.nh + h;
    float v[kMaxQ / 32];
#pragma unroll
    for (int u = 0; u < kMaxQ / 32; ++u)
      v[u] = u < len ? lp[int64_t(u) * d.nh] : 0.f;
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
      if (lane >= o) incl += up;
    }
    const float off = incl - run;
    float* cp = cum + (int64_t(b) * d.S + t0 + lo) * d.nh + h;
#pragma unroll
    for (int u = 0; u < kMaxQ / 32; ++u)
      if (u < len) {
        cum_s[hh * kMaxQ + lo + u] = v[u] + off;
        if (w.p0 == 0) cp[int64_t(u) * d.nh] = v[u] + off;
      }
    __syncwarp();
    // the decay weights exp(cum_Q - cum_j), 0 past the chunk's end
    const float cq = cum_s[hh * kMaxQ + Q - 1];
    for (int j = lane; j < kMaxQ; j += 32)
      w_s[hh * kMaxQ + j] = j < Q ? expf(cq - cum_s[hh * kMaxQ + j]) : 0.f;
  }
  __syncthreads();
  mbar_wait(bbar, 0);

  // the A fragment: rows pa, pa + 8 (head-dim columns), chunk steps
  // 16 kk + c2 (+1) and + 8
  const int pa = warp * 16 + lane / 4, c2 = (lane % 4) * 2;
  for (int hh = 0; hh < w.hb; ++hh) {
    const float* ws = w_s + hh * kMaxQ;
    float acc[KB][32];
#pragma unroll
    for (int kb = 0; kb < KB; ++kb)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[kb][i] = 0.f;
    for (int jt = 0; jt < d.JT; ++jt) {
      const int t = hh * d.JT + jt, s = t % kSlotsA;
      const int nk = min(4, (Q - jt * kTile + 15) / 16);   // live k-steps
      mbar_wait(fbar + 8 * s, (t / kSlotsA) & 1);
      const uint8_t* xs = gbase + (ring - base) + s * kPiece;
      uint32_t ahi[4][4], alo[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int p = pa + (r & 1) * 8;
          const int jl = kk * 16 + c2 + (r >> 1) * 8, j = jt * kTile + jl;
          const float w0 = ws[j], w1 = ws[j + 1];
          const float x0 = kk < nk ? tile_at(xs, jl, p) : 0.f;
          const float x1 = kk < nk ? tile_at(xs, jl + 1, p) : 0.f;
          ahi[kk][r] = split_bf16x2(w0 * x0, w1 * x1, alo[kk][r]);
        }
#pragma unroll
      for (int kb = 0; kb < KB; ++kb) pin_all(acc[kb]);
      pin_frags(ahi);
      pin_frags(alo);
      wg_fence();
      const uint32_t bt = bs + jt * kPiece;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        if (kk < nk)
#pragma unroll
          for (int kb = 0; kb < KB; ++kb) {
            const uint32_t a = bt + kb * d.JT * kPiece + kk * 16 * 128;
            wgmma_rs_n64(acc[kb], ahi[kk],
                         smem_desc(a, d.JT * kPiece, 1024));
            wgmma_rs_n64(acc[kb], alo[kk],
                         smem_desc(a, d.JT * kPiece, 1024));
          }
      wg_commit();
      wg_wait_all();
#pragma unroll
      for (int kb = 0; kb < KB; ++kb) pin_all(acc[kb]);
      __syncthreads();   // every thread is done with the slot
      if (tid == 0 && t + kSlotsA < T) issue(t + kSlotsA);
    }
    // S_c^T: rows pa, pa + 8 of the slice, columns kb 64 + 8 jj + c2
    float* out = states + (((int64_t(b) * d.nc + w.c) * d.nh + w.h0 + hh) *
                               d.hp + w.p0) * d.n;
#pragma unroll
    for (int kb = 0; kb < KB; ++kb)
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int k = kb * 64 + 8 * jj + c2;
        if (k >= d.n) continue;
        if (w.p0 + pa < d.hp)
          *reinterpret_cast<float2*>(out + int64_t(pa) * d.n + k) =
              make_float2(acc[kb][4 * jj], acc[kb][4 * jj + 1]);
        if (w.p0 + pa + 8 < d.hp)
          *reinterpret_cast<float2*>(out + int64_t(pa + 8) * d.n + k) =
              make_float2(acc[kb][4 * jj + 2], acc[kb][4 * jj + 3]);
      }
  }
}

// ---- pass (b): the states entering each chunk ------------------------------

// A warp per (batch, head, head-dim column p), lane l holding state entries
// k = l + 32 u.  Row c of `states` (n float32: S_c^T[p]) is read whole by
// the warp, then overwritten by the state entering chunk c as bf16 hi (n
// values) then lo (n values).
__global__ void __launch_bounds__(kThreads)
ssd_chunk_pass_kernel(float* __restrict__ states,
                      const float* __restrict__ cum, float* __restrict__ hT,
                      int batch, Dims d) {
  const int gw = blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (gw >= batch * d.nh * d.hp) return;
  const int p = gw % d.hp, h = (gw / d.hp) % d.nh, b = gw / (d.hp * d.nh);
  const int n = d.n;
  constexpr int U = kMaxN / 32;
  const int64_t rstride = int64_t(d.nh) * d.hp * n;    // chunk to chunk
  float* row = states + ((int64_t(b) * d.nc * d.nh + h) * d.hp + p) * n;
  const float* cq = cum + (int64_t(b) * d.S + d.Q - 1) * d.nh + h;
  float H[U], cur[U], nxt[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    H[u] = 0.f;
    const int k = lane + 32 * u;
    cur[u] = k < n ? row[k] : 0.f;
  }
  for (int c = 0; c < d.nc; ++c) {
    float* r = row + c * rstride;
    if (c + 1 < d.nc)
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int k = lane + 32 * u;
        nxt[u] = k < n ? r[rstride + k] : 0.f;
      }
    const float a = expf(cq[int64_t(c) * d.Q * d.nh]);
    __syncwarp();   // the row is read whole before it is overwritten
    __nv_bfloat16* hi = reinterpret_cast<__nv_bfloat16*>(r);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int k = lane + 32 * u;
      if (k < n) {
        const __nv_bfloat16 x = __float2bfloat16_rn(H[u]);
        hi[k] = x;
        hi[n + k] = __float2bfloat16_rn(H[u] - __bfloat162float(x));
      }
      H[u] = fmaf(a, H[u], cur[u]);
      cur[u] = nxt[u];
    }
  }
  float* out = hT + (int64_t(b) * d.nh + h) * n * d.hp + p;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int k = lane + 32 * u;
    if (k < n) out[int64_t(k) * d.hp] = H[u];
  }
}

// ---- pass (c): the chunk outputs --------------------------------------------

template <int KB>
__global__ void __launch_bounds__(kThreads, 1)
ssd_chunk_output_kernel(const __grid_constant__ CUtensorMap txd,
                        const __grid_constant__ CUtensorMap tb,
                        const __grid_constant__ CUtensorMap tc,
                        const __grid_constant__ CUtensorMap thi,
                        const __grid_constant__ CUtensorMap tlo,
                        const float* __restrict__ cum,
                        __nv_bfloat16* __restrict__ y, Dims d) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* gbase = smem_raw + (base - raw);
  const uint32_t cs = base;                            // C [kb] tiles
  const uint32_t ring = cs + KB * kPiece;
  float* cum_s = reinterpret_cast<float*>(gbase + (ring - base) +
                                          kSlotsC * kPiece);   // [HB][kMaxQ]
  const uint32_t cbar = ring + kSlotsC * kPiece + d.HB * kMaxQ * 4;
  const uint32_t fbar = cbar + 8;

  // longest first: every block of the last row tile, then the one before
  const int per_tile = gridDim.x / d.JT;
  const int r = d.JT - 1 - blockIdx.x / per_tile;
  const Work w = work_of(blockIdx.x % per_tile, d);
  const int b = blockIdx.z, Q = d.Q, t0 = w.c * Q, r0 = r * kTile;
  const int jend = min(r0 + kTile, Q), JR = r + 1;     // columns, tiles
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // the ring's tiles: JR x KB of B, then a head at a time KB of H_hi, KB
  // of H_lo and JR of xd
  const int per_head = 2 * KB + JR;
  const int T = JR * KB + w.hb * per_head;

  if (tid == 0) {
    mbar_init(cbar, 1);
    for (int s = 0; s < kSlotsC; ++s) mbar_init(fbar + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  auto issue = [&](int t) {
    const int s = t % kSlotsC;
    const uint32_t dst = ring + s * kPiece, bar = fbar + 8 * s;
    mbar_expect_tx(bar, kPiece);
    if (t < JR * KB) {
      tma_load(dst, &tb, bar, d.bord, (t % KB) * 64, t0 + (t / KB) * kTile,
               w.grp, b);
      return;
    }
    const int u = (t - JR * KB) % per_head, h = w.h0 + (t - JR * KB) /
                                                 per_head;
    if (u < 2 * KB) {
      const int hrow = ((b * d.nc + w.c) * d.nh + h) * d.hp + w.p0;
      tma_load(dst, u < KB ? &thi : &tlo, bar, d.hord, (u % KB) * 64, hrow,
               0, 0);
    } else {
      tma_load(dst, &txd, bar, d.xord, w.p0, t0 + (u - 2 * KB) * kTile, h,
               b);
    }
  };
  if (tid == 0) {
    mbar_expect_tx(cbar, KB * kPiece);
    for (int kb = 0; kb < KB; ++kb)
      tma_load(cs + kb * kPiece, &tc, cbar, d.cord, kb * 64, t0 + r0, w.grp,
               b);
    for (int t = 0; t < T && t < kSlotsC; ++t) issue(t);
  }
  for (int e = tid; e < w.hb * jend; e += kThreads) {
    const int hh = e / jend, j = e % jend;
    cum_s[hh * kMaxQ + j] = cum[(int64_t(b) * d.S + t0 + j) * d.nh + w.h0 + hh];
  }
  __syncthreads();

  int t = 0;
  auto slot = [&](int t) {
    mbar_wait(fbar + 8 * (t % kSlotsC), (t / kSlotsC) & 1);
    return ring + (t % kSlotsC) * kPiece;
  };
  // tiles t .. t + cnt - 1 are done with: refill their slots
  auto release = [&](int t, int cnt) {
    __syncthreads();   // every thread's products from the slots are done
    if (tid == 0)
      for (int u = t + kSlotsC; u < t + kSlotsC + cnt && u < T; ++u)
        issue(u);
  };
  const int nkn = d.n / 16;                            // k-steps of n

  // C B^T of the tile's rows, column tiles on or below the diagonal
  mbar_wait(cbar, 0);
  float cb[4][32];
#pragma unroll
  for (int jt = 0; jt < 4; ++jt) {
    if (jt >= JR) break;
    wg_fence();
#pragma unroll
    for (int kb = 0; kb < KB; ++kb) {
      const uint32_t bt = slot(t + kb);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        if (kb * 4 + kk < nkn)
          wgmma_ss_n64(cb[jt], smem_desc(cs + kb * kPiece + kk * 32, 16, 1024),
                       smem_desc(bt + kk * 32, 16, 1024), kb + kk > 0);
    }
    wg_commit();
    wg_wait_all();
    pin_all(cb[jt]);
    release(t, KB);
    t += KB;
  }

  // the fragment's rows ia, ib = ia + 8 of the tile, columns 8 jj + c2 (+1)
  const int ia = warp * 16 + lane / 4, ib = ia + 8, c2 = (lane % 4) * 2;
  const bool live_a = r0 + ia < Q, live_b = r0 + ib < Q;
  for (int hh = 0; hh < w.hb; ++hh) {
    const float* ch = cum_s + hh * kMaxQ;
    const float cia = live_a ? ch[r0 + ia] : 0.f;
    const float cib = live_b ? ch[r0 + ib] : 0.f;
    float acc[32];
    // the inter-chunk term: exp(cum_i) (C H_hi + C H_lo)
    wg_fence();
#pragma unroll
    for (int half = 0; half < 2; ++half)
#pragma unroll
      for (int kb = 0; kb < KB; ++kb) {
        const uint32_t ht = slot(t + half * KB + kb);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          if (kb * 4 + kk < nkn)
            wgmma_ss_n64(acc, smem_desc(cs + kb * kPiece + kk * 32, 16, 1024),
                         smem_desc(ht + kk * 32, 16, 1024),
                         half + kb + kk > 0);
      }
    wg_commit();
    wg_wait_all();
    pin_all(acc);
    release(t, 2 * KB);
    t += 2 * KB;
    {
      const float ea = live_a ? __expf(cia) : 0.f;
      const float eb = live_b ? __expf(cib) : 0.f;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        acc[4 * jj] *= ea;
        acc[4 * jj + 1] *= ea;
        acc[4 * jj + 2] *= eb;
        acc[4 * jj + 3] *= eb;
      }
    }
    // the intra-chunk term: ((C B^T) o L) xd, L masked before exp
#pragma unroll
    for (int jt = 0; jt < 4; ++jt) {
      if (jt >= JR) break;
      const uint32_t xt = slot(t);
      uint32_t phi[4][4], plo[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          // registers 8 kk + 2 q, + 1: row (q odd ? b : a), columns
          // 16 kk + 8 (q / 2) + c2, + 1
          const int e = 8 * kk + 2 * q;
          const int i = r0 + ((q & 1) ? ib : ia);
          const float ci = (q & 1) ? cib : cia;
          const bool li = (q & 1) ? live_b : live_a;
          const int j = jt * kTile + 16 * kk + 8 * (q >> 1) + c2;
          // branch-free, so the 32 exps of a thread overlap: the masked
          // exponent is -inf (exp 0), selected before exp; columns past
          // the chunk's live ones are read but never exponentiated
          const float cj0 = ch[j], cj1 = ch[j + 1];
          const float x0 = li && j <= i ? ci - cj0 : -INFINITY;
          const float x1 = li && j + 1 <= i ? ci - cj1 : -INFINITY;
          phi[kk][q] = split_bf16x2(cb[jt][e] * __expf(x0),
                                    cb[jt][e + 1] * __expf(x1), plo[kk][q]);
        }
      pin_all(acc);
      pin_frags(phi);
      pin_frags(plo);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        if (jt * kTile + 16 * kk < jend)
          wgmma_rs_n64(acc, phi[kk],
                       smem_desc(xt + kk * 16 * 128, kPiece, 1024));
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        if (jt * kTile + 16 * kk < jend)
          wgmma_rs_n64(acc, plo[kk],
                       smem_desc(xt + kk * 16 * 128, kPiece, 1024));
      wg_commit();
      wg_wait_all();
      pin_all(acc);
      release(t++, 1);
    }
    // y rows t0 + r0 + ia, + ib of head h0 + hh, columns p0 + 8 jj + c2
    const int64_t ys = int64_t(d.nh) * d.hp;
    __nv_bfloat16* yp = y + (int64_t(b) * d.S + t0 + r0) * ys +
                        int64_t(w.h0 + hh) * d.hp + w.p0 + c2;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      if (w.p0 + 8 * jj + c2 >= d.hp) continue;
      if (live_a)
        *reinterpret_cast<__nv_bfloat162*>(yp + ia * ys + 8 * jj) =
            __floats2bfloat162_rn(acc[4 * jj], acc[4 * jj + 1]);
      if (live_b)
        *reinterpret_cast<__nv_bfloat162*>(yp + ib * ys + 8 * jj) =
            __floats2bfloat162_rn(acc[4 * jj + 2], acc[4 * jj + 3]);
    }
  }
}

// ---- host side -------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// Error codes past the runtime's: no cuTensorMapEncodeTiled, or an operand
// TMA cannot address; kEncodeFailed + the CUresult of a refused encoding.
constexpr int kNoEncoder = 10000, kBadOperand = 10001, kEncodeFailed = 20000;

// The tensor map of a (batch, heads, rows, cols) bf16 operand with element
// strides st[0..2] (batch, head, row), boxes of 64 columns x 64 rows.  Its
// dimensions 1..3 hold rows, heads and batch in the order of their strides
// (a dimension of size 1 last); `order` says where each went.
int make_map(CUtensorMap* map, const void* ptr, long long batch,
             long long heads, long long rows, long long cols,
             const long long* st, int* order) {
  struct Dim { unsigned long long size, stride; int role; };
  Dim d[3] = {{(unsigned long long)rows, (unsigned long long)st[2], 0},
              {(unsigned long long)heads, (unsigned long long)st[1], 1},
              {(unsigned long long)batch, (unsigned long long)st[0], 2}};
  unsigned long long span = cols;
  for (auto& x : d)
    if (x.size > 1 && x.size * x.stride > span) span = x.size * x.stride;
  for (auto& x : d) {
    if (x.size == 1) x.stride = span;
    if (x.stride == 0 || (x.stride * 2) % 16 != 0 ||
        x.stride * 2 >= (1ull << 40))
      return kBadOperand;
  }
  if (reinterpret_cast<uintptr_t>(ptr) % 16 != 0) return kBadOperand;
  for (int i = 1; i < 3; ++i)            // by stride, stable
    for (int j = i; j > 0 && d[j].stride < d[j - 1].stride; --j) {
      const Dim t = d[j]; d[j] = d[j - 1]; d[j - 1] = t;
    }
  cuuint64_t gdim[4] = {(cuuint64_t)cols, d[0].size, d[1].size, d[2].size};
  cuuint64_t gstride[3] = {d[0].stride * 2, d[1].stride * 2,
                           d[2].stride * 2};
  cuuint32_t box[4] = {64, 1, 1, 1};
  cuuint32_t estride[4] = {1, 1, 1, 1};
  int pos[3];
  for (int i = 0; i < 3; ++i) pos[d[i].role] = i;
  box[1 + pos[0]] = kTile;
  *order = pos[0] | (pos[1] << 2) | (pos[2] << 4);
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return kNoEncoder;
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(ptr), gdim, gstride, box, estride,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeFailed + int(r);
}

size_t smem_states(int KB, const Dims& d) {
  return 1024 + size_t(KB * d.JT + kSlotsA) * kPiece +
         size_t(d.HB) * kMaxQ * 8 + 8 * (1 + kSlotsA);
}

size_t smem_output(int KB, const Dims& d) {
  return 1024 + size_t(KB + kSlotsC) * kPiece + size_t(d.HB) * kMaxQ * 4 +
         8 * (1 + kSlotsC);
}

struct Maps {
  CUtensorMap xd, b, c, hi, lo;
};

template <int KB>
int launch(const Maps& m, int batch, Dims d, int heads_a, int heads_c,
           int passes, const float* la, float* cum, float* states, float* hT,
           __nv_bfloat16* y, cudaStream_t stream) {
  cudaError_t e;
  if (passes & 1) {
    Dims da = d;
    da.HB = min(heads_a, d.G);
    da.n_hc = (d.G + da.HB - 1) / da.HB;
    auto kern = ssd_chunk_states_kernel<KB>;
    const size_t smem = smem_states(KB, da);
    if ((e = cudaFuncSetAttribute(
             kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem))) !=
        cudaSuccess)
      return int(e);
    const dim3 grid(d.nc * d.g * da.n_hc * d.n_ps, 1, batch);
    kern<<<grid, kThreads, smem, stream>>>(m.xd, m.b, la, cum, states, da);
    if ((e = cudaGetLastError()) != cudaSuccess) return int(e);
  }
  if (passes & 2) {
    const long long warps = (long long)batch * d.nh * d.hp;
    const int per = kThreads / 32;
    ssd_chunk_pass_kernel<<<unsigned((warps + per - 1) / per), kThreads, 0,
                            stream>>>(states, cum, hT, batch, d);
    if ((e = cudaGetLastError()) != cudaSuccess) return int(e);
  }
  if (passes & 4) {
    Dims dc = d;
    dc.HB = min(heads_c, d.G);
    dc.n_hc = (d.G + dc.HB - 1) / dc.HB;
    auto kern = ssd_chunk_output_kernel<KB>;
    const size_t smem = smem_output(KB, dc);
    if ((e = cudaFuncSetAttribute(
             kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem))) !=
        cudaSuccess)
      return int(e);
    const dim3 grid(d.JT * d.nc * d.g * dc.n_hc * d.n_ps, 1, batch);
    kern<<<grid, kThreads, smem, stream>>>(m.xd, m.b, m.c, m.hi, m.lo, cum, y,
                                           dc);
    if ((e = cudaGetLastError()) != cudaSuccess) return int(e);
  }
  return 0;
}

}  // namespace

// bfloat16 xd (b, s, nh, hp), B and C (b, s, g, n) with hp and n multiples
// of 16, n <= 256, chunks of Q <= 256 steps; log_a (b, s, nh) float32;
// y (b, s, nh, hp) bfloat16, hT (b, nh, n, hp) float32, and the scratch cum
// (b, s, nh) and states (b, s / Q, nh, hp, n) float32, all contiguous.
// strides: the batch, step and head (group) strides of xd, B and C in
// elements (9 values), each a multiple of 8 where its dimension is longer
// than 1.  heads_a and heads_c: heads a block of pass (a) and of pass (c).
// passes: a bit mask of the passes to run (1 (a), 2 (b), 4 (c)); the
// kernel's function is 7.  Returns a CUDA error code, or kBadOperand
// (10001), kNoEncoder (10000) or 20000 + the CUresult of a refused tensor
// map.
extern "C" int ssd_chunk_wgmma_launch(int batch, int S, int nh, int hp,
                                      int g, int n, int Q, int heads_a,
                                      int heads_c, int passes, const void* xd,
                                      const void* log_a, const void* Bm,
                                      const void* Cm, void* y, void* hT,
                                      void* cum, void* states,
                                      const long long* strides,
                                      void* stream) {
  if (batch <= 0 || S <= 0 || nh <= 0 || hp <= 0 || hp % 16 != 0 || g <= 0 ||
      n <= 0 || n % 16 != 0 || n > kMaxN || Q <= 0 || Q > kMaxQ ||
      S % Q != 0 || nh % g != 0 || heads_a <= 0 || heads_c <= 0)
    return int(cudaErrorInvalidValue);
  Dims d;
  d.S = S; d.Q = Q; d.nc = S / Q; d.nh = nh; d.hp = hp; d.g = g; d.n = n;
  d.G = nh / g;
  d.HB = 1; d.n_hc = d.G;
  d.n_ps = (hp + kTile - 1) / kTile;
  d.JT = (Q + kTile - 1) / kTile;
  const long long xs[3] = {strides[0], strides[2], strides[1]};
  const long long bs[3] = {strides[3], strides[5], strides[4]};
  const long long cs[3] = {strides[6], strides[8], strides[7]};
  const long long hs[3] = {0, 0, 2LL * n};   // a state row: hi n, lo n
  const long long rows = (long long)batch * d.nc * nh * hp;
  Maps m;
  int err;
  if ((err = make_map(&m.xd, xd, batch, nh, S, hp, xs, &d.xord)) != 0 ||
      (err = make_map(&m.b, Bm, batch, g, S, n, bs, &d.bord)) != 0 ||
      (err = make_map(&m.c, Cm, batch, g, S, n, cs, &d.cord)) != 0 ||
      (err = make_map(&m.hi, states, 1, 1, rows, n, hs, &d.hord)) != 0 ||
      (err = make_map(&m.lo, static_cast<__nv_bfloat16*>(states) + n, 1, 1,
                      rows, n, hs, &d.hord)) != 0)
    return err;
  const float* la = static_cast<const float*>(log_a);
  float* cm = static_cast<float*>(cum);
  float* st = static_cast<float*>(states);
  float* ht = static_cast<float*>(hT);
  __nv_bfloat16* yo = static_cast<__nv_bfloat16*>(y);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((n + 63) / 64) {
    case 1: return launch<1>(m, batch, d, heads_a, heads_c, passes, la, cm,
                             st, ht, yo, s);
    case 2: return launch<2>(m, batch, d, heads_a, heads_c, passes, la, cm,
                             st, ht, yo, s);
    case 3: return launch<3>(m, batch, d, heads_a, heads_c, passes, la, cm,
                             st, ht, yo, s);
    default: return launch<4>(m, batch, d, heads_a, heads_c, passes, la, cm,
                              st, ht, yo, s);
  }
}
