// Batched blocked Cholesky factor, f32, for sm_90a (kernel K3).
//
// Replaces two TPU kernels of pygpr_tpu/ops/pallas_cholesky.py:
//   * cholesky_pallas (body _chol_kernel): one [n, n] or a grid over
//     [nb, n, n], n <= 1024, each matrix resident in VMEM, identity-padded
//     to a multiple of 128;
//   * cholesky_pallas_batched (body _chol_batched_kernel with
//     _micro_cholesky_batched and _tri_inverse_batched): [nb, n, n],
//     nb >= 2, n % 128 == 0, streamed from HBM one column panel of every
//     matrix at a time, so that the nb pivot chains advance together.
// Neither design carries over: a 1024^2 f32 matrix is 4 MB against 227 KB
// of shared memory a block, and blocks run in no order, so there is no
// sequential grid to stream panels through.  Here n and nb are run-time
// arguments and one kernel family takes every shape.
//
// Given K [nb, n, n] it writes L [nb, n_pad, n_pad] (n_pad = n rounded up to
// a multiple of 64; the tail is an identity block, chol([[K,0],[0,I]]) =
// [[L,0],[0,I]]) with K = L L^T and exact zeros above the diagonal, by a
// right-looking sweep over 64-wide panels (lo = 64 p, hi = lo + 64), two
// launches a panel:
//
//   1. panel: every block factors the diagonal block A[lo:hi, lo:hi] = D D^T
//      itself, from a 16 KB copy that the launch before left in Diag,
//      inverts D, and solves its own 64-row tile A[hi + 64 x : hi + 64 x +
//      64, lo:hi] <- itself times D^-T; block 0 also writes D;
//   2. syrk: A[hi:, hi:] -= A[hi:, lo:hi] A[hi:, lo:hi]^T, one block per
//      64x64 tile of the lower triangle; the tile that is the next
//      diagonal block is also copied to Diag.
//
// Every launch puts the batch on gridDim.z, so the nb matrices' pivot
// chains run side by side on the card's 132 SMs.  Each panel's rank-64
// product is subtracted from the trailing matrix in order, as in both TPU
// kernels: a left-looking update would sum one long product in f32 first
// and bias the pivots upward.
//
// The caller's K is only read (the jitter ladder adds jitter to the same K
// on every rung).  A non-positive pivot gives sqrtf's NaN, unguarded; it
// stays inside its own matrix, because no launch mixes matrices: the ladder
// escalates each matrix on its own rung.  Every block of a panel computes D
// by the same instructions from the same 16 KB, so every copy is
// bit-identical, and a matrix's arithmetic depends neither on nb nor on
// which block did what: a matrix factored alone and inside a stack gives
// the same bits.  Each entry of L also takes the same operations, in the
// same order, as in the previous version of this kernel (one thread block
// a diagonal block, one pivot a step), so the factors are bit-identical to
// it: the f32 fits downstream (the SGPR bench's L-BFGS on an ELBO whose f32
// rounding is as large as its last decreases) take the same path as
// before.
//
// What bounds it on an H100: nb n^3 / 3 flops at the FP32 FFMA rate
// (67 TFLOP/s on the SXM part: 20.9 ms for [16, 6400, 6400]); its bytes
// (read K, write L: 8 nb n^2) are far less.  At n <= 1024 neither: the
// chain of n / 64 diagonal blocks, each waiting on the panel before it,
// sets the pace, once for the whole batch.
//
// What the design does about the chain: the diagonal block is factored as
// 2x2 tiles of 32 with the warp-level routines of csrc/small_chol.cuh --
// D00 by one warp in registers (32 pivots, shuffles, no block barrier),
// D10 = A10 D00^-T a row a lane, A11 -= D10 D10^T, D11 by one warp -- and
// while warps 0-1 do D10, A11 and D11, warps 4-7 already invert D00 (the
// first 32 rows of D^-1), four lanes a column; the last 32 rows of D^-1
// follow, and the block's tile is multiplied by D^-T: six block barriers
// a panel.  The products (the tile times D^-T,
// the trailing update) are one tiled FFMA routine (64x64 output tile, the
// whole 64-deep panel staged in shared memory, 256 threads with 4x4
// outputs each, float4 shared-memory reads, tiles copied in and out in
// whole 128-byte rows), and the trailing update moves the trailing matrix
// through memory once per panel (about n^3 / 24 bytes a matrix in all); a
// wider panel, tensor cores and TMA are later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "small_chol.cuh"

namespace {

using namespace small_chol;

constexpr int NB = 64;        // panel and tile width; PANEL in ops/chol_batched.py
constexpr int THREADS = 256;  // 16 x 16 threads, 4 x 4 outputs each
constexpr int PAD = 4;        // keeps float4 rows aligned, spreads banks
constexpr int LD = NB + PAD;
constexpr int TW = 32;        // the diagonal block's sub-tile: one warp's factorization
constexpr int MAX_Z = 65535;  // gridDim.z limit: larger batches go in chunks

typedef float Tile[NB][NB + PAD];

// This thread's 4x4 block (rg, kg) of a 64x64 tile in load_4x4_t and
// store_4x4_t: a warp takes 8 neighbouring kg and 4 neighbouring rg.
__device__ __forceinline__ void tile_block(int& rg, int& kg) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  kg = (lane & 7) + 8 * (warp & 1);
  rg = (lane >> 3) + 4 * (warp >> 1);
}

// S[k][r] = src[r * ld + k] for a 64x64 row-major tile (ld and src 16-byte
// aligned): a transposed copy, so that the products read float4 along r.
__device__ __forceinline__ void load_t(Tile& S, const float* src, size_t ld) {
  int rg, kg;
  tile_block(rg, kg);
  load_4x4_t<LD>(&S[0][0], src, ld, rg, kg);
}

// dst[r * ld + k] = S[k][r], the inverse of load_t; with `lower`, the
// entries above the diagonal (k > r) are written as 0.
__device__ __forceinline__ void store_t(float* dst, size_t ld, const Tile& S, bool lower) {
  int rg, kg;
  tile_block(rg, kg);
  store_4x4_t<LD>(dst, ld, &S[0][0], rg, kg, lower);
}

// acc[u][v] = sum_k A[ty*4+u][k] B[tx*4+v][k], k = 0..63 in order, with
// As = A^T and Bs = B^T as load_t leaves them.
__device__ __forceinline__ void product_t(const Tile& As, const Tile& Bs,
                                          float acc[4][4]) {
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int v = 0; v < 4; ++v) acc[u][v] = 0.0f;
#pragma unroll 8
  for (int k = 0; k < NB; ++k) {
    const float4 a = *reinterpret_cast<const float4*>(&As[k][ty * 4]);
    const float4 b = *reinterpret_cast<const float4*>(&Bs[k][tx * 4]);
    const float av[4] = {a.x, a.y, a.z, a.w};
    const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[u][v] = fmaf(av[u], bv[v], acc[u][v]);
  }
}

// L[b] = tril(K[b]) with an identity tail: rows and columns n..n_pad-1; the
// first diagonal block also goes to Diag[b].
__global__ void chol_batched_load_kernel(const float* __restrict__ K, float* __restrict__ L,
                                         float* __restrict__ Diag, int n, int n_pad) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n_pad) return;
  const size_t b = blockIdx.z;
  for (int i = blockIdx.y; i < n_pad; i += gridDim.y) {
    float v;
    if (j > i) {
      v = 0.0f;
    } else if (i < n) {
      v = K[(b * n + i) * n + j];
    } else {
      v = i == j ? 1.0f : 0.0f;
    }
    L[(b * n_pad + i) * n_pad + j] = v;
    if (i < NB && j < NB) Diag[b * NB * NB + i * NB + j] = v;
  }
}

// Named barrier of warps 0 and 1 (64 threads) of the block.
__device__ __forceinline__ void sync_warps01() { asm volatile("bar.sync 1, 64;" ::: "memory"); }

// Rows i0..i1-1 of column c of X = D^-1 (D lower, D[i][k] at T[k][i]; X
// stored transposed, X[i][c] at Y[c][i]) by forward substitution, row by
// row: the four lanes q of column c split the sum over k (lane q takes
// k = c + q + 4 t, in the order of t, all of a row's loads issued at once)
// and add the four parts by shuffles, so a row needs no block barrier.
// Rows above i0 must be in Y already.
__device__ __forceinline__ void inverse_rows(const Tile& T, Tile& Y, int c, int q, int i0, int i1) {
  for (int i = i0; i < i1; ++i) {
    float s = 0.0f;
#pragma unroll
    for (int t4 = 0; t4 < NB / 4; ++t4) {
      const int k = c + q + 4 * t4;
      if (k < i) s = fmaf(T[k][i], Y[c][k], s);
    }
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    if (q == 0) Y[c][i] = i < c ? 0.0f : ((i == c ? 1.0f : 0.0f) - s) / T[i][i];
    __syncwarp();
  }
}

// The panel at columns lo..lo+63 of matrix blockIdx.z: factor its diagonal
// block (the copy in Diag[blockIdx.z]) and solve the 64 rows hi + 64 x ..
// below it, x = blockIdx.x (none in the last panel, launched as one block).
// Block 0 writes D into L.
__global__ void __launch_bounds__(THREADS)
chol_batched_panel_kernel(float* L, const float* __restrict__ Diag, int n_pad, int lo) {
  __shared__ __align__(16) Tile T;  // T[k][i] = A[i][k] of the diagonal block, then D[i][k];
                                    // then this block's rows B, B[r][k] at T[k][r]
  __shared__ __align__(16) Tile Y;  // Y[c][i] = D^-1[i][c]
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  float* Lb = L + (size_t)blockIdx.z * n_pad * n_pad;
  const int r0 = lo + NB + blockIdx.x * NB;
  const bool rows = r0 < n_pad;
  float* B = Lb + (size_t)r0 * n_pad + lo;
  float* t = &T[0][0];
  load_t(T, Diag + (size_t)blockIdx.z * NB * NB, NB);
  int rg, kg;
  tile_block(rg, kg);
  float4 b[4];  // this thread's 4x4 of B, read now and stored after D^-1
  if (rows)
#pragma unroll
    for (int u = 0; u < 4; ++u)
      b[u] = *reinterpret_cast<const float4*>(B + (size_t)(4 * rg + u) * n_pad + 4 * kg);
  __syncthreads();

  // D: D00 by one warp; then warps 0-1 take D10 = A10 D00^-T a row a lane,
  // A11 -= D10 D10^T a term at a time and D11 by one warp (per entry the
  // operations, in the order, of the unblocked right-looking factorization
  // of the 64x64 block), while warps 4-7 invert D00 (rows 0..31 of D^-1)
  float v[TW];
  if (warp == 0) factor_tile32<LD>(t, v);
  __syncthreads();
  if (warp < 2) {
    if (warp == 0) solve_row32<LD>(t, TW + (tid & 31), t, v);
    sync_warps01();
    if ((tid >> 3) <= (tid & 7)) {
      const int ti = tid & 7;
      const int tj = tid >> 3;
      update32_4x4<LD>(t + (TW + 4 * tj) * LD + TW + 4 * ti, t + TW + 4 * ti, t + TW + 4 * tj);
    }
    sync_warps01();
    if (warp == 0) factor_tile32<LD>(t + TW * LD + TW, v);
  } else if (warp >= 4) {
    inverse_rows(T, Y, (tid - 128) >> 2, tid & 3, 0, TW);
  } else {  // warps 2-3: the zeros of D^-1's rows 0..31 in columns 32..63
    for (int e = tid - 64; e < TW * TW; e += 64) Y[TW + e / TW][e % TW] = 0.0f;
  }
  __syncthreads();
  inverse_rows(T, Y, tid >> 2, tid & 3, TW, NB);  // rows 32..63 of D^-1
  __syncthreads();
  if (blockIdx.x == 0) store_t(Lb + (size_t)lo * n_pad + lo, n_pad, T, true);
  if (!rows) return;
  __syncthreads();
  float* s = t + 4 * kg * LD + 4 * rg;  // B into T, transposed as load_t leaves it
  *reinterpret_cast<float4*>(s + 0 * LD) = make_float4(b[0].x, b[1].x, b[2].x, b[3].x);
  *reinterpret_cast<float4*>(s + 1 * LD) = make_float4(b[0].y, b[1].y, b[2].y, b[3].y);
  *reinterpret_cast<float4*>(s + 2 * LD) = make_float4(b[0].z, b[1].z, b[2].z, b[3].z);
  *reinterpret_cast<float4*>(s + 3 * LD) = make_float4(b[0].w, b[1].w, b[2].w, b[3].w);
  __syncthreads();
  // B <- B D^-T
  float acc[4][4];
  product_t(T, Y, acc);
  const int tx = tid & 15;
  const int ty = tid >> 4;
#pragma unroll
  for (int u = 0; u < 4; ++u)
    *reinterpret_cast<float4*>(B + (size_t)(ty * 4 + u) * n_pad + tx * 4) =
        make_float4(acc[u][0], acc[u][1], acc[u][2], acc[u][3]);
}

// Trailing update of one 64x64 tile (ti, tj), ti >= tj, of A[hi:, hi:]:
// blockIdx.x enumerates the lower triangle of tiles row by row.  Tile
// (0, 0), the next panel's diagonal block, also goes to Diag.
__global__ void __launch_bounds__(THREADS)
chol_batched_syrk_kernel(float* L, float* __restrict__ Diag, int n_pad, int lo) {
  __shared__ __align__(16) Tile As;
  __shared__ __align__(16) Tile Bs;
  const int x = blockIdx.x;
  int ti, tj;
  lower_tile(x, ti, tj);
  const int hi = lo + NB;
  float* Lb = L + (size_t)blockIdx.z * n_pad * n_pad;
  load_t(As, Lb + (size_t)(hi + ti * NB) * n_pad + lo, n_pad);
  load_t(Bs, Lb + (size_t)(hi + tj * NB) * n_pad + lo, n_pad);
  __syncthreads();
  float acc[4][4];
  product_t(As, Bs, acc);
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  float* C = Lb + (size_t)(hi + ti * NB) * n_pad + hi + tj * NB;
  float* Dg = Diag + (size_t)blockIdx.z * NB * NB;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    float4* c = reinterpret_cast<float4*>(C + (size_t)(ty * 4 + u) * n_pad + tx * 4);
    float4 v = *c;
    v.x -= acc[u][0];
    v.y -= acc[u][1];
    v.z -= acc[u][2];
    v.w -= acc[u][3];
    *c = v;
    if (x == 0) *reinterpret_cast<float4*>(Dg + (ty * 4 + u) * NB + tx * 4) = v;
  }
}

}  // namespace

// K: [nb, n, n] f32 row-major (any alignment); L: [nb, n_pad, n_pad] and
// Diag: [nb, 64, 64] scratch, both 16-byte aligned; n_pad the least
// multiple of 64 >= n.  Everything is enqueued on `stream`; returns the
// first launch error.
extern "C" int chol_batched_f32(const void* K_, void* L_, void* Diag_, int nb, int n, int n_pad,
                                void* stream_) {
  cudaStream_t stream = (cudaStream_t)stream_;
  if (nb <= 0 || n <= 0 || n_pad % NB != 0 || n_pad < n || n_pad - n >= NB)
    return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<size_t>(L_) % 16 != 0 || reinterpret_cast<size_t>(Diag_) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  int err = 0;
  for (int b0 = 0; b0 < nb; b0 += MAX_Z) {
    const int bz = nb - b0 < MAX_Z ? nb - b0 : MAX_Z;
    const float* K = (const float*)K_ + (size_t)b0 * n * n;
    float* L = (float*)L_ + (size_t)b0 * n_pad * n_pad;
    float* D = (float*)Diag_ + (size_t)b0 * NB * NB;
    const int rows = n_pad < MAX_Z ? n_pad : MAX_Z;
    chol_batched_load_kernel<<<dim3((n_pad + 255) / 256, rows, bz), 256, 0, stream>>>(K, L, D, n, n_pad);
    if ((err = (int)cudaGetLastError())) return err;
    for (int lo = 0; lo < n_pad; lo += NB) {
      const int t = (n_pad - lo) / NB - 1;  // row tiles below the panel
      chol_batched_panel_kernel<<<dim3(t > 0 ? t : 1, 1, bz), THREADS, 0, stream>>>(L, D, n_pad, lo);
      if ((err = (int)cudaGetLastError())) return err;
      if (t == 0) continue;
      chol_batched_syrk_kernel<<<dim3(t * (t + 1) / 2, 1, bz), THREADS, 0, stream>>>(L, D, n_pad, lo);
      if ((err = (int)cudaGetLastError())) return err;
    }
  }
  return 0;
}
