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
// arguments and one C entry takes every shape, by two launch sequences.
//
// Given K [nb, n, n] it writes L [nb, n_pad, n_pad] (n_pad = n rounded up to
// a multiple of 64; the tail is an identity block, chol([[K,0],[0,I]]) =
// [[L,0],[0,I]]) with K = L L^T and exact zeros above the diagonal.
//
// The arithmetic of every entry, in both sequences: a right-looking sweep
// over 64-wide panels (lo = 64 p, hi = lo + 64).  The diagonal block
// A[lo:hi, lo:hi] = D D^T is factored as 2x2 tiles of 32 with the
// warp-level routines of csrc/small_chol.cuh -- D00 by one warp in
// registers (32 pivots, shuffles), D10 = A10 D00^-T a row a lane, A11 -=
// D10 D10^T a term at a time, D11 by one warp -- and D^-1 by forward
// substitution (inverse_rows); each row below is multiplied by D^-T in one
// 64-term FFMA chain from 0; and each entry (i, j) of the trailing matrix
// receives, from each earlier panel in order, one 64-term FFMA chain from 0
// of that panel's rows i and j, subtracted from its running value.  Each
// panel's product leaves the trailing matrix on its own, as in both TPU
// kernels: a left-looking update would sum one long product in f32 first
// and bias the pivots upward.
//
// 1. One matrix, a stack outside cholesky_pallas_batched's domain (B4's
//    shapes, and ragged stacks such as [100, 628, 628]), or a small stack
//    inside it ([16, 768, 768]): two launches a 64-wide panel.
//      panel: every block factors the diagonal block itself, from a 16 KB
//        copy that the launch before left in Diag, inverts D, and solves
//        its own 64-row tile below it; block 0 also writes D;
//      syrk: A[hi:, hi:] -= A[hi:, lo:hi] A[hi:, lo:hi]^T, one block per
//        64x64 tile of the lower triangle; the tile that is the next
//        diagonal block is also copied to Diag.
//    The diagonal block's chain is the pace at n <= 1024, once for the
//    whole batch; six block barriers a panel.
//
// 2. B5's domain (nb >= 2, n % 128 == 0, n >= 256, K 16-byte aligned)
//    where an outer panel's flops outweigh its longer pivot chain
//    (outer_route: nb n^2 >= 3e5 an SM, so [16, 6400, 6400]):
//    outer panels of W = 128 columns (lo = 128 o, hi = lo + 128), each two
//    of the 64-wide panels above, two launches an outer panel after one
//    launch that factors the first diagonal block:
//      panel128: one block a 64-row tile below the outer panel.  It reads
//        D0^-1, D1^-1 and X0s1 (the rows of D1's block times D0^-T) from
//        the scratch G, multiplies its rows by D0^-T (X0), subtracts the
//        s0 group from its columns lo + 64 .. hi (one chain of X0 against
//        X0s1), multiplies them by D1^-T (X1), and writes X0 and X1 into L
//        and, transposed, into the scratch P [128, n], so that every
//        operand of the next launch is k-major.  It also writes the zeros
//        of L right of the outer panel's diagonal block in its columns.
//      update128: one 128x128 output tile a block over the lower triangle
//        of tiles of A[hi:, hi:], the outer panel's 128 terms in 32-deep
//        chunks through a 3-stage cp.async ring, 8x8 outputs a thread:
//        the terms of each 64-wide panel in their own chain from 0, each
//        chain subtracted from the running value in panel order.  The
//        trailing matrix goes through device memory once per 128 columns,
//        not once per 64.  The block of tile (0, 0), the next outer
//        panel's diagonal block, then factors it (look-ahead:
//        factor_outer_diag, the two 64-wide diagonal blocks and the s0
//        group between them, by the routines of sequence 1), writes it
//        into L and D0^-1, D1^-1, X0s1 into G: the pivot chain runs beside
//        the other tiles, and no launch factors a diagonal block alone
//        after the first.
//    Launches put the batch index fastest in blockIdx.x, so the nb
//    look-ahead blocks are the first of their launch to run.
//
// Sequence 2 gives every entry of L the operations of sequence 1, in the
// same order, and so the same bits (and the bits of the version of this
// kernel before it, which ran sequence 1 on every shape).  That is a
// contract, for two reasons: a matrix factored inside a stack (sequence 2)
// and alone (sequence 1) must give the same bits, and the f32 fits
// downstream (the SGPR bench's L-BFGS on an ELBO whose f32 rounding is as
// large as its last decreases) turn on K3's round-off.  So the products
// keep each 64-term group in its own chain from 0, the subtraction of a
// group from the running value is a separate instruction, and the
// diagonal blocks and D^-1 use the same routines.
//
// The caller's K is only read (the jitter ladder adds jitter to the same K
// on every rung).  A non-positive pivot gives sqrtf's NaN, unguarded; it
// stays inside its own matrix, because no launch mixes matrices and there
// are no atomics: the ladder escalates each matrix on its own rung, and
// two calls give the same bits.  In sequence 1 every block of a panel
// computes D by the same instructions from the same 16 KB, so every copy is
// bit-identical.
//
// What bounds it on an H100: nb n^3 / 3 flops at the FP32 FFMA rate
// (67 TFLOP/s on the SXM part: 20.9 ms for [16, 6400, 6400]); its bytes
// (read K, write L: 8 nb n^2) are far less.  At n <= 1024 neither: the
// chain of diagonal blocks, each waiting on the panel before it, sets the
// pace, once for the whole batch.  IEEE f32 throughout, no tensor cores.

#include <cuda_runtime.h>
#include <limits.h>
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

// sequence 2
constexpr int W = 2 * NB;     // outer panel and update tile; OUTER in ops/chol_batched.py
constexpr int LDD = W + PAD;  // the outer diagonal block, column-major in shared memory
constexpr int GK = 32;        // k chunk of the update
constexpr int STAGES = 3;
constexpr int G_FLOATS = 3 * NB * NB;  // D0^-1, D1^-1, X0s1^T; P [W, n] follows, per matrix
constexpr int DIAG_FLOATS = W * LDD + 2 * NB * LD;  // the block, D0^-1, D1^-1
constexpr int RING_FLOATS = 2 * STAGES * GK * W;
constexpr size_t DIAG_SMEM = sizeof(float) * DIAG_FLOATS;
constexpr size_t UPDATE_SMEM = sizeof(float) * (DIAG_FLOATS > RING_FLOATS ? DIAG_FLOATS : RING_FLOATS);
constexpr size_t PANEL_SMEM = sizeof(float) * 4 * NB * LD;

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

// acc[u][v] = sum_k A[ty*4+u][k] B[tx*4+v][k], k = 0..63 in order, one
// FFMA chain from 0 an output, with As[k * LDA + r] = A[r][k] and
// Bs[k * LDB + c] = B[c][k] (as load_t leaves them).
template <int LDA, int LDB>
__device__ __forceinline__ void tile_product(const float* As, const float* Bs, float (&acc)[4][4]) {
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int v = 0; v < 4; ++v) acc[u][v] = 0.0f;
#pragma unroll 8
  for (int k = 0; k < NB; ++k) {
    const float4 a = *reinterpret_cast<const float4*>(As + k * LDA + ty * 4);
    const float4 b = *reinterpret_cast<const float4*>(Bs + k * LDB + tx * 4);
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

// Rows i0..i1-1 of column c of X = D^-1 (D lower, D[i][k] at T[k * LDT +
// i]; X stored transposed, X[i][c] at Y[c * LD + i]) by forward
// substitution, row by row: the four lanes q of column c split the sum
// over k (lane q takes k = c + q + 4 t, in the order of t, all of a row's
// loads issued at once) and add the four parts by shuffles, so a row needs
// no block barrier.  Rows above i0 must be in Y already.
template <int LDT>
__device__ __forceinline__ void inverse_rows(const float* T, float* Y, int c, int q, int i0, int i1) {
  for (int i = i0; i < i1; ++i) {
    float s = 0.0f;
#pragma unroll
    for (int t4 = 0; t4 < NB / 4; ++t4) {
      const int k = c + q + 4 * t4;
      if (k < i) s = fmaf(T[k * LDT + i], Y[c * LD + k], s);
    }
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    if (q == 0) Y[c * LD + i] = i < c ? 0.0f : ((i == c ? 1.0f : 0.0f) - s) / T[i * LDT + i];
    __syncwarp();
  }
}

// Factor the 64x64 diagonal block t (column-major, t[k * LDT + i] =
// A[i][k]; only the lower triangle is read) in place, D = chol, and write
// Y = D^-1 transposed (y[c * LD + i] = D^-1[i][c], exact zeros above its
// diagonal), with all 256 threads of the block: D00 by one warp; then
// warps 0-1 take D10 = A10 D00^-T a row a lane, A11 -= D10 D10^T a term at
// a time and D11 by one warp (per entry the operations, in the order, of
// the unblocked right-looking factorization of the 64x64 block), while
// warps 4-7 invert D00 (rows 0..31 of D^-1); then rows 32..63 of D^-1.
// Entries of t above the diagonal are left undefined.
template <int LDT>
__device__ __forceinline__ void factor_invert64(float* t, float* y) {
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  float v[TW];
  if (warp == 0) factor_tile32<LDT>(t, v);
  __syncthreads();
  if (warp < 2) {
    if (warp == 0) solve_row32<LDT>(t, TW + (tid & 31), t, v);
    sync_warps01();
    if ((tid >> 3) <= (tid & 7)) {
      const int ti = tid & 7;
      const int tj = tid >> 3;
      update32_4x4<LDT>(t + (TW + 4 * tj) * LDT + TW + 4 * ti, t + TW + 4 * ti, t + TW + 4 * tj);
    }
    sync_warps01();
    if (warp == 0) factor_tile32<LDT>(t + TW * LDT + TW, v);
  } else if (warp >= 4) {
    inverse_rows<LDT>(t, y, (tid - 128) >> 2, tid & 3, 0, TW);
  } else {  // warps 2-3: the zeros of D^-1's rows 0..31 in columns 32..63
    for (int e = tid - 64; e < TW * TW; e += 64) y[(TW + e / TW) * LD + e % TW] = 0.0f;
  }
  __syncthreads();
  inverse_rows<LDT>(t, y, tid >> 2, tid & 3, TW, NB);  // rows 32..63 of D^-1
  __syncthreads();
}

// Sequence 1.  The panel at columns lo..lo+63 of matrix blockIdx.z: factor
// its diagonal block (the copy in Diag[blockIdx.z]) and solve the 64 rows
// hi + 64 x .. below it, x = blockIdx.x (none in the last panel, launched
// as one block).  Block 0 writes D into L.
__global__ void __launch_bounds__(THREADS)
chol_batched_panel_kernel(float* L, const float* __restrict__ Diag, int n_pad, int lo) {
  __shared__ __align__(16) Tile T;  // T[k][i] = A[i][k] of the diagonal block, then D[i][k];
                                    // then this block's rows B, B[r][k] at T[k][r]
  __shared__ __align__(16) Tile Y;  // Y[c][i] = D^-1[i][c]
  const int tid = threadIdx.x;
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
  factor_invert64<LD>(t, &Y[0][0]);
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
  tile_product<LD, LD>(t, &Y[0][0], acc);
  const int tx = tid & 15;
  const int ty = tid >> 4;
#pragma unroll
  for (int u = 0; u < 4; ++u)
    *reinterpret_cast<float4*>(B + (size_t)(ty * 4 + u) * n_pad + tx * 4) =
        make_float4(acc[u][0], acc[u][1], acc[u][2], acc[u][3]);
}

// Sequence 1.  Trailing update of one 64x64 tile (ti, tj), ti >= tj, of
// A[hi:, hi:]: blockIdx.x enumerates the lower triangle of tiles row by
// row.  Tile (0, 0), the next panel's diagonal block, also goes to Diag.
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
  tile_product<LD, LD>(&As[0][0], &Bs[0][0], acc);
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

// ---- sequence 2 ----------------------------------------------------------

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// dst[r * LD + c] = src[r * 64 + c] for a 64x64 block: a contiguous block
// of the scratch G into a padded tile.
__device__ __forceinline__ void copy_tile(float* dst, const float* src) {
  for (int e = threadIdx.x; e < NB * NB / 4; e += THREADS) {
    const int r = e >> 4;
    const int c4 = 4 * (e & 15);
    *reinterpret_cast<float4*>(dst + r * LD + c4) = *reinterpret_cast<const float4*>(src + r * NB + c4);
  }
}

// The outer panel's 128x128 diagonal block, in smem (column-major,
// Dm[k * LDD + i] = A[i][k], lower triangle read), factored as sequence 1
// factors its two 64-wide diagonal blocks: D0 and D0^-1, X0s1 = B0 D0^-T
// for the block's rows 64..127 (its left columns B0), the s0 group of the
// block's lower right quarter (one chain of X0s1 against itself, then a
// subtraction), D1 and D1^-1.  Writes the block of L (Lblk, ld; zeros
// above the diagonal) and, for the panel launch, G: D0^-1 and D1^-1 as Y
// tiles (G[c * 64 + i] = D^-1[i][c]) and X0s1 transposed (G[k * 64 + c] =
// X0s1[c][k]).  smem: DIAG_FLOATS.
__device__ void factor_outer_diag(float* smem, float* Lblk, size_t ld, float* G) {
  float* Dm = smem;
  float* Y0 = Dm + W * LDD;
  float* Y1 = Y0 + NB * LD;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  factor_invert64<LDD>(Dm, Y0);
  float acc[4][4];
  tile_product<LDD, LD>(Dm + NB, Y0, acc);  // X0s1
  __syncthreads();
#pragma unroll
  for (int v = 0; v < 4; ++v)
    *reinterpret_cast<float4*>(Dm + (4 * tx + v) * LDD + NB + 4 * ty) =
        make_float4(acc[0][v], acc[1][v], acc[2][v], acc[3][v]);
  __syncthreads();
  tile_product<LDD, LDD>(Dm + NB, Dm + NB, acc);  // the s0 group of D1's block
#pragma unroll
  for (int v = 0; v < 4; ++v) {
    float4* c = reinterpret_cast<float4*>(Dm + (NB + 4 * tx + v) * LDD + NB + 4 * ty);
    float4 a = *c;
    a.x -= acc[0][v];
    a.y -= acc[1][v];
    a.z -= acc[2][v];
    a.w -= acc[3][v];
    *c = a;
  }
  __syncthreads();
  factor_invert64<LDD>(Dm + NB * LDD + NB, Y1);
  for (int e = tid; e < 32 * 32; e += THREADS) {
    int rg, kg;
    block_of(e, rg, kg);
    store_4x4_t<LDD>(Lblk, ld, Dm, rg, kg, true);
  }
  for (int e = tid; e < NB * NB / 4; e += THREADS) {
    const int c = e >> 4;
    const int i4 = 4 * (e & 15);
    *reinterpret_cast<float4*>(G + c * NB + i4) = *reinterpret_cast<const float4*>(Y0 + c * LD + i4);
    *reinterpret_cast<float4*>(G + NB * NB + c * NB + i4) = *reinterpret_cast<const float4*>(Y1 + c * LD + i4);
    *reinterpret_cast<float4*>(G + 2 * NB * NB + c * NB + i4) =
        *reinterpret_cast<const float4*>(Dm + c * LDD + NB + i4);
  }
}

// The first outer panel's diagonal block of matrix blockIdx.x, from K.
// S: the matrix's scratch, `per` floats a matrix.
__global__ void __launch_bounds__(THREADS, 1)
chol_batched_diag128_kernel(const float* K, float* L, float* S, int n, size_t per) {
  extern __shared__ __align__(16) float smem[];
  const size_t ld = (size_t)n;
  const size_t z = blockIdx.x;
  const float* Kb = K + z * ld * ld;
  for (int e = threadIdx.x; e < 32 * 32; e += THREADS) {
    int rg, kg;
    block_of(e, rg, kg);
    if (kg <= rg) load_4x4_t<LDD>(smem, Kb, ld, rg, kg);
  }
  __syncthreads();
  factor_outer_diag(smem, L + z * ld * ld, ld, S + z * per);
}

// The rows below the outer panel at columns lo..lo+127: one block a 64-row
// tile, x = blockIdx.x / bz, of matrix blockIdx.x % bz (see the header).
// A (ld n) is K at lo == 0 and L after.
__global__ void __launch_bounds__(THREADS)
chol_batched_panel128_kernel(const float* A, float* L, float* S, int n, int lo, int bz, size_t per) {
  extern __shared__ __align__(16) float smem[];
  float* Ta = smem;           // Ta[k * LD + r]: B0, then X0
  float* Tb = Ta + NB * LD;   // the s1 columns after the s0 group
  float* Ya = Tb + NB * LD;   // D0^-1, then D1^-1 (Y tiles)
  float* Xs = Ya + NB * LD;   // Xs[k * LD + c] = X0s1[c][k]
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int x = blockIdx.x / bz;
  const size_t z = blockIdx.x - x * bz;
  const size_t ld = (size_t)n;
  const float* Ab = A + z * ld * ld;
  float* Lb = L + z * ld * ld;
  const float* Gb = S + z * per;
  float* Pb = S + z * per + G_FLOATS;
  const int r0 = lo + W + NB * x;
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int e = tid; e < W * NB / 4; e += THREADS)
    *reinterpret_cast<float4*>(Lb + (size_t)(lo + (e >> 4)) * ld + r0 + 4 * (e & 15)) = zero;
  copy_tile(Ya, Gb);
  copy_tile(Xs, Gb + 2 * NB * NB);
  int rg, kg;
  tile_block(rg, kg);
  load_4x4_t<LD>(Ta, Ab + (size_t)r0 * ld + lo, ld, rg, kg);
  float a1[4][4];  // the s1 columns of this thread's 4x4
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const float4 a = *reinterpret_cast<const float4*>(Ab + (size_t)(r0 + 4 * ty + u) * ld + lo + NB + 4 * tx);
    a1[u][0] = a.x;
    a1[u][1] = a.y;
    a1[u][2] = a.z;
    a1[u][3] = a.w;
  }
  __syncthreads();
  float acc[4][4];
  tile_product<LD, LD>(Ta, Ya, acc);  // X0 = B0 D0^-T
#pragma unroll
  for (int u = 0; u < 4; ++u)
    *reinterpret_cast<float4*>(Lb + (size_t)(r0 + 4 * ty + u) * ld + lo + 4 * tx) =
        make_float4(acc[u][0], acc[u][1], acc[u][2], acc[u][3]);
#pragma unroll
  for (int v = 0; v < 4; ++v)
    *reinterpret_cast<float4*>(Pb + (size_t)(4 * tx + v) * ld + r0 + 4 * ty) =
        make_float4(acc[0][v], acc[1][v], acc[2][v], acc[3][v]);
  __syncthreads();
#pragma unroll
  for (int v = 0; v < 4; ++v)
    *reinterpret_cast<float4*>(Ta + (4 * tx + v) * LD + 4 * ty) = make_float4(acc[0][v], acc[1][v], acc[2][v], acc[3][v]);
  copy_tile(Ya, Gb + NB * NB);
  __syncthreads();
  tile_product<LD, LD>(Ta, Xs, acc);  // the s0 group of the s1 columns
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int v = 0; v < 4; ++v) a1[u][v] -= acc[u][v];
#pragma unroll
  for (int v = 0; v < 4; ++v)
    *reinterpret_cast<float4*>(Tb + (4 * tx + v) * LD + 4 * ty) = make_float4(a1[0][v], a1[1][v], a1[2][v], a1[3][v]);
  __syncthreads();
  tile_product<LD, LD>(Tb, Ya, acc);  // X1 = (its columns) D1^-T
#pragma unroll
  for (int u = 0; u < 4; ++u)
    *reinterpret_cast<float4*>(Lb + (size_t)(r0 + 4 * ty + u) * ld + lo + NB + 4 * tx) =
        make_float4(acc[u][0], acc[u][1], acc[u][2], acc[u][3]);
#pragma unroll
  for (int v = 0; v < 4; ++v)
    *reinterpret_cast<float4*>(Pb + (size_t)(NB + 4 * tx + v) * ld + r0 + 4 * ty) =
        make_float4(acc[0][v], acc[1][v], acc[2][v], acc[3][v]);
}

// The trailing update of the outer panel at lo: one 128x128 tile (ti, tj),
// ti >= tj, of A[hi:, hi:] a block, x = blockIdx.x / bz enumerating the
// lower triangle of tiles row by row, of matrix blockIdx.x % bz; operands
// k-major from P.  Tile (0, 0)'s block then factors the next outer
// panel's diagonal block (see the header).  One block an SM: the running
// value and a group's chain are 128 registers a thread.
__global__ void __launch_bounds__(THREADS, 1)
chol_batched_update128_kernel(const float* A, float* L, float* S, int n, int lo, int bz, size_t per) {
  extern __shared__ __align__(16) float smem[];
  float* As = smem;                    // [STAGES][GK][W]
  float* Bs = smem + STAGES * GK * W;  // [STAGES][GK][W]
  const int tid = threadIdx.x;
  const int x = blockIdx.x / bz;
  const size_t z = blockIdx.x - x * bz;
  const size_t ld = (size_t)n;
  const float* Ab = A + z * ld * ld;
  float* Lb = L + z * ld * ld;
  float* Gb = S + z * per;
  const float* Pb = Gb + G_FLOATS;
  const int hi = lo + W;
  int ti, tj;
  lower_tile(x, ti, tj);
  const int r0 = hi + W * ti;
  const int c0 = hi + W * tj;
  const float* Ag = Pb + r0;
  const float* Bg = Pb + c0;

  auto load = [&](int stage, int chunk) {
    const int k0 = chunk * GK;
#pragma unroll
    for (int q = 0; q < GK * W / 4 / THREADS; ++q) {
      const int f = tid + q * THREADS;
      const int kk = f >> 5;
      const int m4 = 4 * (f & 31);
      cp_async16(As + (stage * GK + kk) * W + m4, Ag + (size_t)(k0 + kk) * ld + m4);
      cp_async16(Bs + (stage * GK + kk) * W + m4, Bg + (size_t)(k0 + kk) * ld + m4);
    }
  };
  load(0, 0);
  cp_async_commit();
  load(1, 1);
  cp_async_commit();

  const int tx = tid & 15;
  const int ty = tid >> 4;
  float run[8][8];  // the running value of rows r0 + {4 ty .., 64 + 4 ty ..}, columns c0 + {4 tx .., 64 + 4 tx ..}
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    const int i = r0 + (u < 4 ? 4 * ty + u : 64 + 4 * ty + u - 4);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float4 c = *reinterpret_cast<const float4*>(Ab + (size_t)i * ld + c0 + 64 * h + 4 * tx);
      run[u][4 * h + 0] = c.x;
      run[u][4 * h + 1] = c.y;
      run[u][4 * h + 2] = c.z;
      run[u][4 * h + 3] = c.w;
    }
  }
  float acc[8][8];  // one 64-wide panel's chain
#pragma unroll
  for (int u = 0; u < 8; ++u)
#pragma unroll
    for (int v = 0; v < 8; ++v) acc[u][v] = 0.0f;

#pragma unroll 1
  for (int chunk = 0; chunk < W / GK; ++chunk) {
    if (chunk + 2 < W / GK) load((chunk + 2) % STAGES, chunk + 2);
    cp_async_commit();
    cp_async_wait<2>();
    __syncthreads();
    const float* a_s = As + (chunk % STAGES) * GK * W;
    const float* b_s = Bs + (chunk % STAGES) * GK * W;
#pragma unroll
    for (int kk = 0; kk < GK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(a_s + kk * W + 4 * ty);
      const float4 a1 = *reinterpret_cast<const float4*>(a_s + kk * W + 64 + 4 * ty);
      const float4 b0 = *reinterpret_cast<const float4*>(b_s + kk * W + 4 * tx);
      const float4 b1 = *reinterpret_cast<const float4*>(b_s + kk * W + 64 + 4 * tx);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int u = 0; u < 8; ++u)
#pragma unroll
        for (int v = 0; v < 8; ++v) acc[u][v] = fmaf(av[u], bv[v], acc[u][v]);
    }
    __syncthreads();
    if ((chunk + 1) % (NB / GK) == 0) {  // a 64-wide panel's chain is complete
#pragma unroll
      for (int u = 0; u < 8; ++u)
#pragma unroll
        for (int v = 0; v < 8; ++v) {
          run[u][v] -= acc[u][v];
          acc[u][v] = 0.0f;
        }
    }
  }

  if (x == 0) {
    // the next outer panel's diagonal block: into shared memory (the ring
    // is free) for its factorization
    float* Dm = smem;
#pragma unroll
    for (int u4 = 0; u4 < 2; ++u4)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int v = 0; v < 4; ++v)
          *reinterpret_cast<float4*>(Dm + (64 * h + 4 * tx + v) * LDD + 64 * u4 + 4 * ty) =
              make_float4(run[4 * u4][4 * h + v], run[4 * u4 + 1][4 * h + v], run[4 * u4 + 2][4 * h + v],
                          run[4 * u4 + 3][4 * h + v]);
    __syncthreads();
    factor_outer_diag(smem, Lb + (size_t)hi * ld + hi, ld, Gb);
    return;
  }
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    const int i = r0 + (u < 4 ? 4 * ty + u : 64 + 4 * ty + u - 4);
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float4*>(Lb + (size_t)i * ld + c0 + 64 * h + 4 * tx) =
          make_float4(run[u][4 * h], run[u][4 * h + 1], run[u][4 * h + 2], run[u][4 * h + 3]);
  }
}

// The card's SM count, and the shared memory sequence 2 asks for (once).
int setup_outer(int& sms) {
  static int cached = 0;
  if (cached) {
    sms = cached;
    return 0;
  }
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(chol_batched_diag128_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)DIAG_SMEM);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(chol_batched_panel128_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)PANEL_SMEM);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(chol_batched_update128_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)UPDATE_SMEM);
  if (err == cudaSuccess) cached = sms;
  return (int)err;
}

// Whether sequence 2 takes the shape: B5's domain, where an outer panel's
// flops (128 nb n^2 / 3) outweigh its longer pivot chain.  Sequence 2
// factors an outer panel's two diagonal blocks in one block and then
// launches the panel, while the card idles; sequence 1 factors each
// diagonal block in every block of the launch that solves the rows below
// it.  On an H100 (132 SMs) sequence 2 ran at 0.81x to 0.97x sequence 1's
// speed at [16, 768], [16, 1024], [4, 1536], [3, 2560] and [3, 3584]
// (nb n^2 from 9.4e6 to 3.9e7), 1.05x and 1.12x at [16, 1536] (3.8e7),
// and 1.17x to 1.52x at [3, 4096], [16, 2048], [4, 4096], [16, 2560],
// [16, 3072], [16, 4096] and [16, 6400] (5.0e7 on).  The rule takes
// sequence 2 from 3e5 nb n^2 an SM, 4.0e7 on 132 SMs.
int outer_route(int nb, int n, int n_pad, bool& outer) {
  outer = false;
  if (nb < 2 || n % W != 0 || n < 2 * W || n_pad != n) return 0;
  int sms = 0;
  const int err = setup_outer(sms);
  outer = (long long)nb * n * n >= 300000LL * sms;
  return err;
}
size_t outer_floats(int n) { return G_FLOATS + (size_t)W * n; }

}  // namespace

// Floats of the scratch Diag that chol_batched_f32 needs for nb matrices
// [n, n] padded to n_pad on the current device: 64 x 64 a matrix in
// sequence 1, and in sequence 2 three 64 x 64 blocks and P [128, n] a
// matrix; -1 if the device cannot be read.
extern "C" long long chol_batched_scratch_floats(int nb, int n, int n_pad) {
  bool outer = false;
  if (nb <= 0 || outer_route(nb, n, n_pad, outer)) return -1;
  return (long long)nb * (long long)(outer ? outer_floats(n) : NB * NB);
}

// K: [nb, n, n] f32 row-major (any alignment; sequence 2 only where it is
// 16-byte aligned); L: [nb, n_pad, n_pad] and Diag: chol_batched_scratch_floats
// floats of scratch, both 16-byte aligned; n_pad the least multiple of 64
// >= n.  Everything is enqueued on `stream`; returns the first launch error.
extern "C" int chol_batched_f32(const void* K_, void* L_, void* Diag_, int nb, int n, int n_pad,
                                void* stream_) {
  cudaStream_t stream = (cudaStream_t)stream_;
  if (nb <= 0 || n <= 0 || n_pad % NB != 0 || n_pad < n || n_pad - n >= NB)
    return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<size_t>(L_) % 16 != 0 || reinterpret_cast<size_t>(Diag_) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  bool outer = false;
  int err = outer_route(nb, n, n_pad, outer);
  if (err) return err;
  if (outer && reinterpret_cast<size_t>(K_) % 16 == 0) {
    const size_t per = outer_floats(n);
    const long long R0 = n / W - 1;  // tile rows of the first trailing update
    const long long most = R0 * (R0 + 1) / 2 > 2 * R0 ? R0 * (R0 + 1) / 2 : 2 * R0;
    const int chunk = (int)(INT_MAX / most < MAX_Z ? INT_MAX / most : MAX_Z);
    for (int b0 = 0; b0 < nb; b0 += chunk) {
      const int bz = nb - b0 < chunk ? nb - b0 : chunk;
      const float* K = (const float*)K_ + (size_t)b0 * n * n;
      float* L = (float*)L_ + (size_t)b0 * n * n;
      float* S = (float*)Diag_ + (size_t)b0 * per;
      chol_batched_diag128_kernel<<<bz, THREADS, DIAG_SMEM, stream>>>(K, L, S, n, per);
      if ((err = (int)cudaGetLastError())) return err;
      for (int lo = 0; lo + W < n; lo += W) {
        const float* A = lo == 0 ? K : L;
        const int R = (n - lo - W) / W;
        chol_batched_panel128_kernel<<<2 * R * bz, THREADS, PANEL_SMEM, stream>>>(A, L, S, n, lo, bz, per);
        if ((err = (int)cudaGetLastError())) return err;
        chol_batched_update128_kernel<<<R * (R + 1) / 2 * bz, THREADS, UPDATE_SMEM, stream>>>(A, L, S, n, lo, bz,
                                                                                            per);
        if ((err = (int)cudaGetLastError())) return err;
      }
    }
    return 0;
  }
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
