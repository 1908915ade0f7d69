// Warp-level building blocks for the small dense factorizations of K2
// (chol_inverse.cu), K3 (chol_batched.cu), K5 and K6 (block_probe.cu), f32,
// for sm_90a.
//
// A 32x32 tile is factored by ONE warp in its registers (chol32), so its
// 32 pivots pass values by shuffles and wait on no block barrier (about
// 3.2 us for the 32 pivots on an H100: each pivot's shuffle, IEEE square
// root, division and shuffle in a row), and the rows below it are solved
// against it one row a lane (trsm32), with the factor's columns read from
// shared memory as broadcasts.  What remains between tiles is a rank-32
// update (update32_4x4), which every thread of the block shares.  Every
// entry takes the operations of the unblocked right-looking factorization
// (a division by the pivot, then one fmaf a later pivot, in the order of
// the pivots), so a blocked factorization built from these routines gives
// the bits of the unblocked one.
//
// Layout: every tile lives in shared memory column-major, S[k * LD + i] =
// A[i][k], so that lane i reading row i of a tile reads consecutive words
// (no bank conflicts), and column k of a factor is a contiguous run that a
// warp reads as float4 broadcasts.  LD is a multiple of 4, and every tile
// pointer below is 16-byte aligned.
//
// Numerics: IEEE f32 throughout (sqrtf and division rounded to nearest,
// fmaf), no tensor cores.  A non-positive pivot gives sqrtf's NaN
// (or a division by 0), unguarded: no fmaxf, no early exit, so it reaches
// every later column of its tile and every row solved against it.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace small_chol {

constexpr unsigned FULL_MASK = 0xffffffffu;

// Cholesky factor of one 32x32 SPD tile in one warp's registers.  On entry
// lane i holds row i, a[k] = A[i][k]; only k <= i is read, and the entries
// above the diagonal may hold anything, NaN included.  On return a[k] =
// L[i][k] for k <= i (the entries above are left undefined).
//
// Right-looking, one pivot a step: every lane takes pivot j's diagonal
// from lane j by a shuffle and its square root, scales its own entry of
// column j, then subtracts L[i][j] L[k][j] from its a[k], k > j, with
// L[k][j] shuffled from lane k.  The shuffles a lane makes above its own
// diagonal carry values that no lane uses.
__device__ __forceinline__ void chol32(float (&a)[32]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const float p = sqrtf(__shfl_sync(FULL_MASK, a[j], j));
    const float l = a[j] / p;
    a[j] = lane == j ? p : l;
#pragma unroll
    for (int k = j + 1; k < 32; ++k) a[k] = fmaf(-l, __shfl_sync(FULL_MASK, l, k), a[k]);
  }
}

// x <- x D^-T for one row x a lane, against a 32x32 lower factor D:
// forward substitution, right-looking (x[k] is divided by D[k][k], then
// subtracted from every x[m], m > k), each entry's terms in the order of
// k, which is the order of the unblocked right-looking factorization.  D
// is column-major, D[k * LD + m] = D[m][k] (only m >= k is read).
template <int LD>
__device__ __forceinline__ void trsm32(float (&x)[32], const float* D) {
#pragma unroll
  for (int k = 0; k < 32; ++k) {
    x[k] = x[k] / D[k * LD + k];
#pragma unroll
    for (int m4 = (k + 1) & ~3; m4 < 32; m4 += 4) {
      const float4 d = *reinterpret_cast<const float4*>(D + k * LD + m4);
      if (m4 + 0 > k) x[m4 + 0] = fmaf(-d.x, x[k], x[m4 + 0]);
      if (m4 + 1 > k) x[m4 + 1] = fmaf(-d.y, x[k], x[m4 + 1]);
      if (m4 + 2 > k) x[m4 + 2] = fmaf(-d.z, x[k], x[m4 + 2]);
      if (m4 + 3 > k) x[m4 + 3] = fmaf(-d.w, x[k], x[m4 + 3]);
    }
  }
}

// trsm32 with the reciprocals of D's diagonal given, rcp[k] = 1 / D[k][k]
// (read as broadcasts): each step multiplies where trsm32 divides, which
// takes the IEEE division off the chain of 32 dependent steps, at the cost
// of one more rounding an entry a step.  A NaN or infinite reciprocal
// spreads as trsm32's quotient does.
template <int LD>
__device__ __forceinline__ void trsm32_rcp(float (&x)[32], const float* D, const float* rcp) {
#pragma unroll
  for (int k = 0; k < 32; ++k) {
    x[k] = x[k] * rcp[k];
#pragma unroll
    for (int m4 = (k + 1) & ~3; m4 < 32; m4 += 4) {
      const float4 d = *reinterpret_cast<const float4*>(D + k * LD + m4);
      if (m4 + 0 > k) x[m4 + 0] = fmaf(-d.x, x[k], x[m4 + 0]);
      if (m4 + 1 > k) x[m4 + 1] = fmaf(-d.y, x[k], x[m4 + 1]);
      if (m4 + 2 > k) x[m4 + 2] = fmaf(-d.z, x[k], x[m4 + 2]);
      if (m4 + 3 > k) x[m4 + 3] = fmaf(-d.w, x[k], x[m4 + 3]);
    }
  }
}

// Factor the 32x32 diagonal tile S (column-major, S[k * LD + i]) in place
// with the calling warp.  Returns lane i's row of L in a (entries above
// the diagonal undefined).
template <int LD>
__device__ __forceinline__ void factor_tile32(float* S, float (&a)[32]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 0; k < 32; ++k) a[k] = S[k * LD + lane];
  chol32(a);
#pragma unroll
  for (int k = 0; k < 32; ++k) S[k * LD + lane] = a[k];
  __syncwarp();
}

// Solve row r of the 32-column panel S (column-major, S[k * LD + r])
// against the factored tile D in place, with the calling lane: S's row r
// <- itself times D^-T.  Returns the solved row in x.
template <int LD>
__device__ __forceinline__ void solve_row32(float* S, int r, const float* D, float (&x)[32]) {
#pragma unroll
  for (int k = 0; k < 32; ++k) x[k] = S[k * LD + r];
  trsm32<LD>(x, D);
#pragma unroll
  for (int k = 0; k < 32; ++k) S[k * LD + r] = x[k];
}

// C[v * LD + u] = fmaf(-P[m * LD + u], Q[m * LD + v], C[v * LD + u]) for
// m = 0..31 in order: one thread's 4x4 tile of a rank-32 update applied
// one term at a time, as the unblocked right-looking factorization applies
// it to the entries right of its pivots.
template <int LD>
__device__ __forceinline__ void update32_4x4(float* C, const float* P, const float* Q) {
  float c[4][4];
#pragma unroll
  for (int v = 0; v < 4; ++v) {
    const float4 t = *reinterpret_cast<const float4*>(C + v * LD);
    c[0][v] = t.x;
    c[1][v] = t.y;
    c[2][v] = t.z;
    c[3][v] = t.w;
  }
#pragma unroll 8
  for (int m = 0; m < 32; ++m) {
    const float4 a = *reinterpret_cast<const float4*>(P + m * LD);
    const float4 b = *reinterpret_cast<const float4*>(Q + m * LD);
    const float av[4] = {a.x, a.y, a.z, a.w};
    const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int v = 0; v < 4; ++v) c[u][v] = fmaf(-av[u], bv[v], c[u][v]);
  }
#pragma unroll
  for (int v = 0; v < 4; ++v)
    *reinterpret_cast<float4*>(C + v * LD) = make_float4(c[0][v], c[1][v], c[2][v], c[3][v]);
}

// One thread's 4x4 block of a transposing copy from a row-major matrix in
// device memory (leading dimension ld) to a column-major one in shared
// memory: S[k * LD + r] = src[r * ld + k] for rows 4 rg .. 4 rg + 3 and
// columns 4 kg .. 4 kg + 3.  Four 16-byte reads of rows, four 16-byte
// writes of columns.  With LD % 32 == 4, a warp whose lanes take 8
// neighbouring kg and 4 neighbouring rg reads 4 rows of 128 bytes and
// writes shared memory without bank conflicts.
template <int LD>
__device__ __forceinline__ void load_4x4_t(float* S, const float* src, size_t ld, int rg, int kg) {
  float4 v[4];
#pragma unroll
  for (int u = 0; u < 4; ++u)
    v[u] = *reinterpret_cast<const float4*>(src + (size_t)(4 * rg + u) * ld + 4 * kg);
  float* s = S + 4 * kg * LD + 4 * rg;
  *reinterpret_cast<float4*>(s + 0 * LD) = make_float4(v[0].x, v[1].x, v[2].x, v[3].x);
  *reinterpret_cast<float4*>(s + 1 * LD) = make_float4(v[0].y, v[1].y, v[2].y, v[3].y);
  *reinterpret_cast<float4*>(s + 2 * LD) = make_float4(v[0].z, v[1].z, v[2].z, v[3].z);
  *reinterpret_cast<float4*>(s + 3 * LD) = make_float4(v[0].w, v[1].w, v[2].w, v[3].w);
}

// The inverse copy, dst[r * ld + k] = S[k * LD + r]; with `lower`, the
// entries above the diagonal (k > r) are written as 0.
template <int LD>
__device__ __forceinline__ void store_4x4_t(float* dst, size_t ld, const float* S, int rg, int kg,
                                            bool lower) {
  const float* s = S + 4 * kg * LD + 4 * rg;
  float c[4][4];  // c[q][u] = S[(4 kg + q) * LD + 4 rg + u]
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float4 v = *reinterpret_cast<const float4*>(s + q * LD);
    c[q][0] = v.x;
    c[q][1] = v.y;
    c[q][2] = v.z;
    c[q][3] = v.w;
  }
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int r = 4 * rg + u;
    float4 v;
    v.x = lower && 4 * kg + 0 > r ? 0.0f : c[0][u];
    v.y = lower && 4 * kg + 1 > r ? 0.0f : c[1][u];
    v.z = lower && 4 * kg + 2 > r ? 0.0f : c[2][u];
    v.w = lower && 4 * kg + 3 > r ? 0.0f : c[3][u];
    *reinterpret_cast<float4*>(dst + (size_t)r * ld + 4 * kg) = v;
  }
}

// The e-th 4x4 block (rg, kg) of a tile of up to 128x128, as load_4x4_t
// and store_4x4_t copy it: a warp takes 8 neighbouring kg and 4
// neighbouring rg (no bank conflicts with LD % 32 == 4).
__device__ __forceinline__ void block_of(int e, int& rg, int& kg) {
  kg = (e & 7) + 8 * ((e >> 5) & 3);
  rg = ((e >> 3) & 3) + 4 * (e >> 7);
}

// acc[u][v] += a[u] b[v]
__device__ __forceinline__ void fma4x4(float (&acc)[4][4], float4 a, float4 b) {
  const float av[4] = {a.x, a.y, a.z, a.w};
  const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int v = 0; v < 4; ++v) acc[u][v] = fmaf(av[u], bv[v], acc[u][v]);
}

// The tile (ti, tj), tj <= ti, of the x-th tile of a lower triangle of
// tiles numbered row by row (x = ti (ti + 1) / 2 + tj).
__device__ __forceinline__ void lower_tile(int x, int& ti, int& tj) {
  ti = (int)((sqrtf(8.0f * (float)x + 1.0f) - 1.0f) * 0.5f);
  while (ti * (ti + 1) / 2 > x) --ti;
  while ((ti + 1) * (ti + 2) / 2 <= x) ++ti;
  tj = x - ti * (ti + 1) / 2;
}

}  // namespace small_chol
