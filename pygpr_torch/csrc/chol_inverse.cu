// Fused Cholesky factor and triangular inverse, f32, for sm_90a (kernel K2).
//
// Replaces: pygpr_tpu/ops/pallas_cholesky.py::cholesky_inverse_pallas
// (Pallas body _chol_inv_kernel, n <= 5632) and
// cholesky_inverse_pallas_rolled (_chol_inv_kernel_rolled, n <= 16384).  The
// TPU needed two kernels only because of Mosaic compile time; here n is a
// run-time argument, so one kernel family takes every n % 128 == 0.
//
// Given SPD K [n, n] it writes L (K = L L^T) and T = L^-1, both lower
// triangular with exact zeros above the diagonal, in one right-looking
// sweep over 128-wide panels (lo = 128 p, hi = lo + 128), two launches a
// panel.  A is the trailing matrix (K at the first panel, then the lower
// part of L's storage) and B the running right-hand side of L T = I (T's
// storage below the diagonal blocks; its entries left of the diagonal
// block are 0 before their first update):
//
//   1. panel: every block reads X = D^-1 of the panel's diagonal block
//      A[lo:hi, lo:hi] = D D^T (which the previous launch left in T), then
//      takes its share of the panel's 32-wide items: rows of L below the
//      block, L[r, lo:hi] = A[r, lo:hi] X^T (also written transposed to the
//      scratch P, so that the next launch reads every operand k-major), or
//      columns of T's band, T[lo:hi, c] = X B[lo:hi, c].  At the first
//      panel every block factors and inverts D itself first (below).
//   2. update: one 128x128 tile a block over the rows below the panel,
//      subtracting the rank-128 product of the panel's rows term by term:
//      A[hi:, hi:] -= L[hi:, lo:hi] L[hi:, lo:hi]^T on the lower triangle of
//      tiles, and B[hi:, :hi] -= L[hi:, lo:hi] T[lo:hi, :hi].  The block of
//      tile (0, 0), the next panel's diagonal block, goes on to factor it,
//      as 4x4 tiles of 32 with the warp routines of csrc/small_chol.cuh,
//      to invert it (X = D^-1: the diagonal tiles by warp-level row solves,
//      the rest by small products; invert_block, csrc/block_inverse.cuh,
//      which K6 shares), and to write D into L and X into T:
//      the pivot chain runs beside the other tiles of the update (look-
//      ahead), and no launch factors the diagonal block alone.
//
// Both updates subtract the short products from the running value one
// term at a time, in panel order: one long f32 sum of small products
// swamps the late terms (each under half an ulp of the running sum) and
// biases the pivots upward, and the NLML gradient with them.  No launch uses atomics, so two calls give the same bits.
//
// The caller's K is only read: the jitter ladder adds jitter to the same K
// again on every rung.  A non-positive pivot gives sqrtf's NaN, which is
// not guarded and spreads through everything after it: that is the
// ladder's signal to escalate.  Entries of L left of the failing pivot's
// column stay finite (D^-1's entries above its diagonal are exact zeros).
//
// What bounds it on an H100: the 2/3 n^3 flops (potrf n^3/3 + trtri n^3/3)
// at the FP32 FFMA rate (67 TFLOP/s on the SXM part: 5.5 ms at n = 8192);
// its bytes (read K, write L and T: 12 n^2) are far less.  At small n the
// sequential chain of n/128 diagonal blocks sets the pace.
//
// What the design does about it: the products are one tiled FFMA GEMM
// (128x128 output tile, 256 threads with 8x8 outputs each, float4
// shared-memory reads, the 128-deep k range in 32-deep chunks through a
// 3-stage cp.async ring, two blocks an SM), fed k-major operands so that
// every copy is a straight 16-byte cp.async; each panel's update is one
// launch over every tile of both products, which fills the 132 SMs without
// split-k partials.  The diagonal block's factorization (four 32-pivot warp
// factorizations in a row, the longest chain of the sweep) and inverse are
// hidden behind the update's other tiles whenever it has more than one wave
// of them.  IEEE
// f32 throughout, no tensor cores.  Not yet done: a wider panel (the
// update's k = 128 makes it read and write its output once per 128 terms),
// persistent update blocks, TMA.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "block_inverse.cuh"
#include "small_chol.cuh"

namespace {

using namespace small_chol;

constexpr int NB = 128;       // panel width and update tile; PANEL in ops/chol_inverse.py
constexpr int TW = 32;        // the diagonal block's sub-tile: one warp's factorization
constexpr int THREADS = 256;
constexpr int LDD = NB + 4;   // column-major 128x128 tiles in shared memory (LDD % 32 == 4)
constexpr int ITEM = 32;      // rows or columns of one panel item
constexpr int LDW = ITEM + 4;
constexpr int SCRATCH = INV_SCRATCH;  // floats (block_inverse.cuh); also holds one item (NB * LDW)
constexpr int GK = 32;        // k chunk of the update
constexpr int STAGES = 3;
static_assert(NB == INV_N && LDD == INV_LD && THREADS == INV_THREADS && NB * LDW <= SCRATCH,
              "the diagonal block's inverse (block_inverse.cuh) takes this block");

// the diagonal block's factorization: D and then X in place, column-major
// (Dm[k * LDD + i] = D[i][k]), the inverse's scratch, the pivots' reciprocals
constexpr int FACTOR_FLOATS = NB * LDD + SCRATCH + NB;
constexpr int GEMM_FLOATS = 2 * STAGES * GK * NB;
constexpr size_t PANEL_SMEM = sizeof(float) * FACTOR_FLOATS;
constexpr size_t UPDATE_SMEM = sizeof(float) * (FACTOR_FLOATS > GEMM_FLOATS ? FACTOR_FLOATS : GEMM_FLOATS);

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Factor the 128x128 diagonal block Dm (column-major, Dm[k * LDD + i] =
// A[i][k], lower triangle) in place: tile t's 32 pivots by warp 0
// (chol32) and their reciprocals into rcp, the rows below them by warps
// 1..3-t a row a lane (trsm32_rcp), and the rank-32 update of the rest a
// term at a time by every thread (update32_4x4).  Entries above the
// diagonal are undefined.
__device__ void factor_block(float* Dm, float* rcp) {
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  float v[TW];
#pragma unroll 1
  for (int t = 0; t < NB / TW; ++t) {
    float* col = Dm + TW * t * LDD;
    float* Dtt = col + TW * t;
    if (warp == 0) {
      factor_tile32<LDD>(Dtt, v);
      rcp[TW * t + lane] = 1.0f / Dtt[lane * LDD + lane];
    }
    __syncthreads();
    if (t == NB / TW - 1) break;
    if (warp >= 1 && warp < NB / TW - t) {
      const int r = TW * (t + warp) + lane;
#pragma unroll
      for (int k = 0; k < TW; ++k) v[k] = col[k * LDD + r];
      trsm32_rcp<LDD>(v, Dtt, rcp + TW * t);
#pragma unroll
      for (int k = 0; k < TW; ++k) col[k * LDD + r] = v[k];
    }
    __syncthreads();
    const int base = TW * (t + 1);
    const int s4 = (NB - base) / 4;
    for (int e = tid; e < s4 * (s4 + 1) / 2; e += THREADS) {
      int bi, bj;
      lower_tile(e, bi, bj);
      const int r0 = base + 4 * bi;
      const int c0 = base + 4 * bj;
      update32_4x4<LDD>(Dm + c0 * LDD + r0, col + r0, col + c0);
    }
    __syncthreads();
  }
}

// Factor the diagonal block in Dm (its lower triangle) and invert it in
// place; with `write`, store D into L (ld n) and X into T at the block's
// place, both lower with zeros above.  F: FACTOR_FLOATS of shared memory.
__device__ void factor_and_invert(float* F, float* L, float* T, size_t ld, bool write) {
  float* Dm = F;
  float* S = F + NB * LDD;
  float* rcp = S + SCRATCH;
  const int tid = threadIdx.x;
  factor_block(Dm, rcp);
  if (write)
    for (int e = tid; e < 32 * 32; e += THREADS) {
      int rg, kg;
      block_of(e, rg, kg);
      store_4x4_t<LDD>(L, ld, Dm, rg, kg, true);
    }
  __syncthreads();
  // zeros in the tiles above the diagonal: the inverse's products read them
  for (int e = tid; e < 6 * TW * TW / 4; e += THREADS) {
    const int tile = e / (TW * TW / 4);
    const int ti = tile < 3 ? 0 : tile < 5 ? 1 : 2;             // (0,1) (0,2) (0,3) (1,2) (1,3) (2,3)
    const int tj = tile < 3 ? tile + 1 : tile < 5 ? tile - 1 : 3;
    const int f = e % (TW * TW / 4);
    *reinterpret_cast<float4*>(Dm + (TW * tj + f / 8) * LDD + TW * ti + 4 * (f % 8)) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  __syncthreads();
  invert_block(Dm, S, rcp);
  if (write)
    for (int e = tid; e < 32 * 32; e += THREADS) {
      int rg, kg;
      block_of(e, rg, kg);
      store_4x4_t<LDD>(T, ld, Dm, rg, kg, true);
    }
}

// Launch 1 of panel lo: see the header.  A (ld n) is the trailing matrix,
// K at lo == 0 and L after.  P [128, n] gets P[k * n + r] = L[r][lo + k]
// for r >= hi.
__global__ void __launch_bounds__(THREADS, 1)
chol_inverse_panel_kernel(const float* A, float* L, float* T, float* __restrict__ P, int n, int lo) {
  extern __shared__ __align__(16) float smem[];
  float* Xm = smem;              // X = D^-1, column-major
  float* Ws = Xm + NB * LDD;     // one item's operand, k-major
  const int tid = threadIdx.x;
  const int hi = lo + NB;
  const size_t ld = (size_t)n;

  if (lo == 0) {
    for (int e = tid; e < 32 * 32; e += THREADS) {
      int rg, kg;
      block_of(e, rg, kg);
      if (kg <= rg) load_4x4_t<LDD>(Xm, A, ld, rg, kg);
    }
    __syncthreads();
    factor_and_invert(smem, L, T, ld, blockIdx.x == 0);
  } else {
    for (int e = tid; e < 32 * 32; e += THREADS) {
      int rg, kg;
      block_of(e, rg, kg);
      load_4x4_t<LDD>(Xm, T + lo * ld + lo, ld, rg, kg);
    }
  }

  const int rows = (n - hi) / ITEM;
  const int items = rows + lo / ITEM;
#pragma unroll 1
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    __syncthreads();  // Ws free
    float acc[4][4] = {};
    if (it < rows) {
      // L[r0:r0+32, lo:hi] = A[r0:r0+32, lo:hi] X^T (X[c][k] = 0 for k > c)
      const int r0 = hi + ITEM * it;
      int rg, kg;
      block_of(tid, rg, kg);
      load_4x4_t<LDW>(Ws, A + r0 * ld + lo, ld, rg, kg);
      __syncthreads();
      const int ty = tid & 7;   // rows 4 ty ..
      const int tx = tid >> 3;  // columns 4 tx ..
#pragma unroll 4
      for (int k = 0; k < 4 * tx + 4; ++k)
        fma4x4(acc, *reinterpret_cast<const float4*>(Ws + k * LDW + 4 * ty),
               *reinterpret_cast<const float4*>(Xm + k * LDD + 4 * tx));
#pragma unroll
      for (int u = 0; u < 4; ++u)
        *reinterpret_cast<float4*>(L + (size_t)(r0 + 4 * ty + u) * ld + lo + 4 * tx) =
            make_float4(acc[u][0], acc[u][1], acc[u][2], acc[u][3]);
#pragma unroll
      for (int v = 0; v < 4; ++v)
        *reinterpret_cast<float4*>(P + (size_t)(4 * tx + v) * ld + r0 + 4 * ty) =
            make_float4(acc[0][v], acc[1][v], acc[2][v], acc[3][v]);
    } else {
      // T[lo:hi, c0:c0+32] = X B[lo:hi, c0:c0+32], in place (X[i][k] = 0 for k > i)
      const int c0 = ITEM * (it - rows);
      for (int e = tid; e < NB * ITEM / 4; e += THREADS) {
        const int k = e >> 3;
        const int c4 = 4 * (e & 7);
        *reinterpret_cast<float4*>(Ws + k * LDW + c4) =
            *reinterpret_cast<const float4*>(T + (size_t)(lo + k) * ld + c0 + c4);
      }
      __syncthreads();
      const int tx = tid & 7;   // columns 4 tx ..
      const int ty = tid >> 3;  // rows 4 ty ..
#pragma unroll 4
      for (int k = 0; k < 4 * ty + 4; ++k)
        fma4x4(acc, *reinterpret_cast<const float4*>(Xm + k * LDD + 4 * ty),
               *reinterpret_cast<const float4*>(Ws + k * LDW + 4 * tx));
#pragma unroll
      for (int u = 0; u < 4; ++u)
        *reinterpret_cast<float4*>(T + (size_t)(lo + 4 * ty + u) * ld + c0 + 4 * tx) =
            make_float4(acc[u][0], acc[u][1], acc[u][2], acc[u][3]);
    }
  }
}

// Launch 2 of panel lo: see the header.  blockIdx.x enumerates first the
// lower triangle of 128x128 tiles of A[hi:, hi:] (row by row), then the
// tiles of B[hi:, :hi].  Every operand is k-major with leading dimension n:
// the panel's rows from P, T's rows lo..hi for B's right factor.  The
// block of tile (0, 0) of A, the next panel's diagonal block, factors and
// inverts it and writes D and X.
__global__ void __launch_bounds__(THREADS, 2)
chol_inverse_update_kernel(const float* A, float* L, float* T, const float* __restrict__ P, int n, int lo) {
  extern __shared__ __align__(16) float smem[];
  float* As = smem;                     // [STAGES][GK][NB]
  float* Bs = smem + STAGES * GK * NB;  // [STAGES][GK][NB]
  const int tid = threadIdx.x;
  const int hi = lo + NB;
  const size_t ld = (size_t)n;
  const int R = (n - hi) / NB;
  const int lower = R * (R + 1) / 2;
  int ti, tj;
  const bool in_a = (int)blockIdx.x < lower;
  if (in_a) {
    lower_tile(blockIdx.x, ti, tj);
  } else {
    const int y = blockIdx.x - lower;
    ti = y / (hi / NB);
    tj = y % (hi / NB);
  }
  const int r0 = hi + NB * ti;
  const int c0 = in_a ? hi + NB * tj : NB * tj;
  const float* Ag = P + r0;
  const float* Bg = in_a ? P + c0 : T + lo * ld + c0;
  const float* C = in_a ? A : T;  // running value in; none at B's first update (its column block lo..hi)
  float* D = in_a ? L : T;
  const bool first = !in_a && c0 == lo;

  auto load = [&](int stage, int chunk) {
    const int k0 = chunk * GK;
#pragma unroll
    for (int q = 0; q < GK * NB / 4 / THREADS; ++q) {
      const int f = tid + q * THREADS;
      const int kk = f >> 5;
      const int m4 = 4 * (f & 31);
      cp_async16(As + (stage * GK + kk) * NB + m4, Ag + (size_t)(k0 + kk) * ld + m4);
      cp_async16(Bs + (stage * GK + kk) * NB + m4, Bg + (size_t)(k0 + kk) * ld + m4);
    }
  };
  load(0, 0);
  cp_async_commit();
  load(1, 1);
  cp_async_commit();

  const int tx = tid & 15;
  const int ty = tid >> 4;
  // acc starts at the running value, and each term of the product is
  // subtracted from it in k order
  float acc[8][8];
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    const int i = r0 + (u < 4 ? 4 * ty + u : 64 + 4 * ty + u - 4);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float4 c = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (!first) c = *reinterpret_cast<const float4*>(C + (size_t)i * ld + c0 + 64 * h + 4 * tx);
      acc[u][4 * h + 0] = c.x;
      acc[u][4 * h + 1] = c.y;
      acc[u][4 * h + 2] = c.z;
      acc[u][4 * h + 3] = c.w;
    }
  }

#pragma unroll 1
  for (int chunk = 0; chunk < NB / GK; ++chunk) {
    if (chunk + 2 < NB / GK) load((chunk + 2) % STAGES, chunk + 2);
    cp_async_commit();
    cp_async_wait<2>();
    __syncthreads();
    const float* a_s = As + (chunk % STAGES) * GK * NB;
    const float* b_s = Bs + (chunk % STAGES) * GK * NB;
#pragma unroll
    for (int kk = 0; kk < GK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(a_s + kk * NB + 4 * ty);
      const float4 a1 = *reinterpret_cast<const float4*>(a_s + kk * NB + 64 + 4 * ty);
      const float4 b0 = *reinterpret_cast<const float4*>(b_s + kk * NB + 4 * tx);
      const float4 b1 = *reinterpret_cast<const float4*>(b_s + kk * NB + 64 + 4 * tx);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int u = 0; u < 8; ++u)
#pragma unroll
        for (int v = 0; v < 8; ++v) acc[u][v] = fmaf(-av[u], bv[v], acc[u][v]);
    }
    __syncthreads();
  }

  if (blockIdx.x == 0) {
    // the next diagonal block: into shared memory (the ring is free) for
    // its factorization and inverse
    float* Dm = smem;
#pragma unroll
    for (int u4 = 0; u4 < 2; ++u4)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int v = 0; v < 4; ++v)
          *reinterpret_cast<float4*>(Dm + (64 * h + 4 * tx + v) * LDD + 64 * u4 + 4 * ty) =
              make_float4(acc[4 * u4][4 * h + v], acc[4 * u4 + 1][4 * h + v], acc[4 * u4 + 2][4 * h + v],
                          acc[4 * u4 + 3][4 * h + v]);
    __syncthreads();
    factor_and_invert(smem, L + (size_t)hi * ld + hi, T + (size_t)hi * ld + hi, ld, true);
    return;
  }
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    const int i = r0 + (u < 4 ? 4 * ty + u : 64 + 4 * ty + u - 4);
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float4*>(D + (size_t)i * ld + c0 + 64 * h + 4 * tx) =
          make_float4(acc[u][4 * h], acc[u][4 * h + 1], acc[u][4 * h + 2], acc[u][4 * h + 3]);
  }
}

// Zeros of L and T in every 128x128 block strictly above the block diagonal.
__global__ void chol_inverse_zero_kernel(float* __restrict__ L, float* __restrict__ T, int n) {
  const int bi = blockIdx.y;
  const int bj = blockIdx.x;
  if (bj <= bi) return;
  const float4 z = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int e = threadIdx.x; e < NB * NB / 4; e += blockDim.x) {
    const size_t off = (size_t)(bi * NB + e / (NB / 4)) * n + bj * NB + 4 * (e % (NB / 4));
    *reinterpret_cast<float4*>(L + off) = z;
    *reinterpret_cast<float4*>(T + off) = z;
  }
}

int setup(int& sms) {
  static int cached = 0;
  if (cached == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&cached, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(chol_inverse_panel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)PANEL_SMEM);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(chol_inverse_update_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)UPDATE_SMEM);
    if (err != cudaSuccess) {
      cached = 0;
      return (int)err;
    }
  }
  sms = cached;
  return 0;
}

}  // namespace

// K, L, T: [n, n] f32 row-major; P: [128, n] scratch.  n % 128 == 0,
// n >= 256, and every pointer 16-byte aligned.  Everything is enqueued on
// `stream`; returns the first launch error.
extern "C" int chol_inverse_f32(const void* K_, void* L_, void* T_, void* P_, int n, void* stream_) {
  const float* K = (const float*)K_;
  float* L = (float*)L_;
  float* T = (float*)T_;
  float* P = (float*)P_;
  cudaStream_t stream = (cudaStream_t)stream_;
  if (n < 2 * NB || n % NB != 0) return (int)cudaErrorInvalidValue;
  for (const void* ptr : {K_, (const void*)L_, (const void*)T_, (const void*)P_})
    if (reinterpret_cast<size_t>(ptr) % 16 != 0) return (int)cudaErrorInvalidValue;
  int sms = 0;
  int err = setup(sms);
  if (err) return err;

  chol_inverse_zero_kernel<<<dim3(n / NB, n / NB), 256, 0, stream>>>(L, T, n);
  if ((err = (int)cudaGetLastError())) return err;
  for (int lo = 0; lo < n; lo += NB) {
    const float* A = lo == 0 ? K : L;
    const int hi = lo + NB;
    const int items = (n - hi) / ITEM + lo / ITEM;
    chol_inverse_panel_kernel<<<items < sms ? items : sms, THREADS, PANEL_SMEM, stream>>>(A, L, T, P, n, lo);
    if ((err = (int)cudaGetLastError())) return err;
    const int R = (n - hi) / NB;
    if (R == 0) continue;
    const int tiles = R * (R + 1) / 2 + R * (hi / NB);
    chol_inverse_update_kernel<<<tiles, THREADS, UPDATE_SMEM, stream>>>(A, L, T, P, n, lo);
    if ((err = (int)cudaGetLastError())) return err;
  }
  return 0;
}
