// The inverse of a factored 128x128 lower-triangular block in shared
// memory, f32, for sm_90a, by one block of 256 threads: K2
// (chol_inverse.cu) inverts each diagonal block of its sweep with it, and
// K6 (block_probe.cu) each block of the stage probe's strip.
//
// Layout: the block is column-major in shared memory, Dm[k * INV_LD + i] =
// D[i][k], with INV_LD % 32 == 4 as in small_chol.cuh; its 32x32 tiles
// above the diagonal hold zeros on entry, and rcp[i] = 1 / D[i][i].  The
// diagonal tiles are solved by trsm32_rcp (a multiplication by each
// pivot's reciprocal), so a zero pivot gives inf or NaN, unguarded, in
// this block only.  IEEE f32 FFMA throughout, no tensor cores.

#pragma once

#include <cuda_runtime.h>

#include "small_chol.cuh"

namespace small_chol {

constexpr int INV_N = 128;                // the block's order
constexpr int INV_LD = INV_N + 4;         // its column stride in shared memory
constexpr int INV_TW = 32;                // a diagonal tile: one warp's solve
constexpr int INV_THREADS = 256;
constexpr int INV_LDR0 = 64 + 4;          // invert_block's row-major scratch
constexpr int INV_LDR2 = INV_TW + 4;
constexpr int INV_SCRATCH = 2 * 64 * INV_LDR0 + INV_TW * INV_LDR2;  // floats of S

// X = D^-1 in place of the factored Dm (column-major; its tiles above the
// diagonal zero on entry), by recursive 2x2 blocking: the four diagonal
// tiles at once, one warp each, lane c solving e_c against D_ii (column c
// of D_ii^-1, trsm32_rcp); the two 64x64 halves' corner tiles, X_ij =
// -X_ii D_ij X_jj; then the lower left 64x64 block, -X[64:, 64:]
// D[64:, :64] X[:64, :64].  Each X tile replaces its D tile once no later
// step reads that D tile.  Every product
// reads its left factor column-major and its right factor row-major from
// the scratch S (row-major copies of the X tiles that are right factors,
// and of the left halves of the products), 4x4 outputs a thread, float4
// reads.  Entries of X above its diagonal are exact zeros.
__device__ void invert_block(float* Dm, float* S, const float* rcp) {
  float* Xm = Dm;  // the same storage: X tile by tile
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  float* XR0 = S;                       // X[0:64, 0:64], row-major
  float* XR2 = XR0 + 64 * INV_LDR0;     // X[64:96, 64:96], row-major
  float* YR = XR2 + INV_TW * INV_LDR2;  // the products' left halves, row-major
  for (int e = tid; e < INV_TW * INV_TW; e += INV_THREADS) XR0[(e / INV_TW) * INV_LDR0 + INV_TW + e % INV_TW] = 0.0f;
  if (warp < INV_N / INV_TW) {
    float x[INV_TW];
#pragma unroll
    for (int m = 0; m < INV_TW; ++m) x[m] = m == lane ? 1.0f : 0.0f;
    trsm32_rcp<INV_LD>(x, Dm + INV_TW * warp * INV_LD + INV_TW * warp, rcp + INV_TW * warp);
    __syncwarp();  // the tile is read by every lane's solve before it is overwritten
    float* dst = Xm + (INV_TW * warp + lane) * INV_LD + INV_TW * warp;
#pragma unroll
    for (int m = 0; m < INV_TW; m += 4) *reinterpret_cast<float4*>(dst + m) = make_float4(x[m], x[m + 1], x[m + 2], x[m + 3]);
    if (warp != 3) {
      float* row = warp < 2 ? XR0 + INV_TW * warp * INV_LDR0 + INV_TW * warp : XR2;
      const int ldr = warp < 2 ? INV_LDR0 : INV_LDR2;
#pragma unroll
      for (int m = 0; m < INV_TW; ++m) row[m * ldr + lane] = x[m];
    }
  }
  __syncthreads();
  // tiles (1, 0) and (3, 2)
  const int s = tid >> 6;
  const int j = 2 * s;
  const int i = j + 1;
  int r0 = 4 * (tid & 7);
  int c0 = 4 * ((tid >> 3) & 7);
  if (s < 2) {
    const float* xr = s == 0 ? XR0 : XR2;
    const int ldr = s == 0 ? INV_LDR0 : INV_LDR2;
    float acc[4][4] = {};
#pragma unroll 8
    for (int k = 0; k < INV_TW; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(Dm + (INV_TW * j + k) * INV_LD + INV_TW * i + r0);
      const float4 b = *reinterpret_cast<const float4*>(xr + k * ldr + c0);
      fma4x4(acc, a, b);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
      *reinterpret_cast<float4*>(YR + (INV_TW * s + r0 + u) * INV_LDR2 + c0) = make_float4(acc[u][0], acc[u][1], acc[u][2], acc[u][3]);
  }
  __syncthreads();
  if (s < 2) {
    float acc[4][4] = {};
#pragma unroll 8
    for (int k = 0; k < INV_TW; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(Xm + (INV_TW * i + k) * INV_LD + INV_TW * i + r0);
      const float4 b = *reinterpret_cast<const float4*>(YR + (INV_TW * s + k) * INV_LDR2 + c0);
      fma4x4(acc, a, b);
    }
#pragma unroll
    for (int v = 0; v < 4; ++v)
      *reinterpret_cast<float4*>(Xm + (INV_TW * j + c0 + v) * INV_LD + INV_TW * i + r0) =
          make_float4(-acc[0][v], -acc[1][v], -acc[2][v], -acc[3][v]);
    if (s == 0)
#pragma unroll
      for (int u = 0; u < 4; ++u)
        *reinterpret_cast<float4*>(XR0 + (INV_TW + r0 + u) * INV_LDR0 + c0) =
            make_float4(-acc[u][0], -acc[u][1], -acc[u][2], -acc[u][3]);
  }
  __syncthreads();
  // the lower left 64x64 block
  r0 = 4 * (tid & 15);
  c0 = 4 * (tid >> 4);
  {
    float acc[4][4] = {};
#pragma unroll 8
    for (int k = 0; k < 64; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(Dm + k * INV_LD + 64 + r0);
      const float4 b = *reinterpret_cast<const float4*>(XR0 + k * INV_LDR0 + c0);
      fma4x4(acc, a, b);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
      *reinterpret_cast<float4*>(YR + (r0 + u) * INV_LDR0 + c0) = make_float4(acc[u][0], acc[u][1], acc[u][2], acc[u][3]);
  }
  __syncthreads();
  {
    float acc[4][4] = {};
#pragma unroll 8
    for (int k = 0; k < 64; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(Xm + (64 + k) * INV_LD + 64 + r0);
      const float4 b = *reinterpret_cast<const float4*>(YR + k * INV_LDR0 + c0);
      fma4x4(acc, a, b);
    }
#pragma unroll
    for (int v = 0; v < 4; ++v)
      *reinterpret_cast<float4*>(Xm + (c0 + v) * INV_LD + 64 + r0) = make_float4(-acc[0][v], -acc[1][v], -acc[2][v], -acc[3][v]);
  }
  __syncthreads();
}

}  // namespace small_chol
