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
// right-looking sweep over 64-wide panels (lo = 64 p, hi = lo + 64):
//
//   1. diag: one block per matrix factors A[lo:hi, lo:hi] = D D^T in
//      shared memory and inverts D;
//   2. trsm: A[hi:, lo:hi] = A[hi:, lo:hi] D^-T, one block per 64-row tile;
//   3. syrk: A[hi:, hi:] -= A[hi:, lo:hi] A[hi:, lo:hi]^T, one block per
//      64x64 tile of the lower triangle.
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
// escalates each matrix on its own rung.
//
// What bounds it on an H100: nb n^3 / 3 flops at the FP32 FFMA rate
// (67 TFLOP/s on the SXM part: 20.9 ms for [16, 6400, 6400]); its bytes
// (read K, write L: 8 nb n^2) are far less.  At small n the chain of n / 64
// diagonal factorizations sets the pace, once for the whole batch.
//
// What the design does about it: the three products are one tiled FFMA
// routine (64x64 output tile, the whole 64-deep panel staged in shared
// memory, 256 threads with 4x4 outputs each, float4 shared-memory reads),
// small in registers so that several blocks share an SM.  The diagonal
// block is factored column by column in shared memory, and inverted row by
// row with four threads a column reducing by warp shuffles, so the chain
// has no block-wide barrier in the inverse.  The trailing update moves the
// trailing matrix through memory once per panel (about n^3 / 24 bytes a
// matrix in all); a wider panel, tensor cores and TMA are later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int NB = 64;        // panel and tile width; PANEL in ops/chol_batched.py
constexpr int THREADS = 256;  // 16 x 16 threads, 4 x 4 outputs each
constexpr int PAD = 4;        // keeps float4 rows aligned, spreads banks
constexpr int MAX_Z = 65535;  // gridDim.z limit: larger batches go in chunks

typedef float Tile[NB][NB + PAD];

// S[k][r] = src[r * ld + k] for a 64x64 row-major tile (ld and src 16-byte
// aligned): a transposed copy, so that the product reads float4 along r.
__device__ __forceinline__ void load_t(Tile& S, const float* src, size_t ld) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int f = threadIdx.x + q * THREADS;  // 1024 float4 in the tile
    const int r = f >> 4;
    const int k4 = (f & 15) * 4;
    const float4 v = *reinterpret_cast<const float4*>(src + r * ld + k4);
    S[k4 + 0][r] = v.x;
    S[k4 + 1][r] = v.y;
    S[k4 + 2][r] = v.z;
    S[k4 + 3][r] = v.w;
  }
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

// L[b] = tril(K[b]) with an identity tail: rows and columns n..n_pad-1.
__global__ void chol_batched_load_kernel(const float* __restrict__ K,
                                         float* __restrict__ L, int n, int n_pad) {
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
  }
}

// Factor the diagonal block A[lo:hi, lo:hi] of matrix blockIdx.z in place
// (lower triangle, zeros above) and write D^-1 to Dinv[blockIdx.z].
__global__ void __launch_bounds__(THREADS)
chol_batched_diag_kernel(float* __restrict__ L, float* __restrict__ Dinv, int n_pad,
                         int lo) {
  __shared__ float A[NB][NB + 1];
  __shared__ float X[NB][NB + 1];
  __shared__ float piv[NB];
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  float* Ab = L + (size_t)blockIdx.z * n_pad * n_pad + (size_t)lo * n_pad + lo;
  float* Xb = Dinv + (size_t)blockIdx.z * NB * NB;

  for (int e = tid; e < NB * NB; e += THREADS)
    A[e / NB][e % NB] = Ab[(size_t)(e / NB) * n_pad + e % NB];
  __syncthreads();

  // Unblocked right-looking Cholesky of the lower triangle.  The pivot goes
  // to piv[] so that no thread overwrites A[j][j] while another reads it.
  for (int j = 0; j < NB; ++j) {
    const float p = sqrtf(A[j][j]);
    if (tid == 0) piv[j] = p;
    if (tid > j && tid < NB) A[tid][j] = A[tid][j] / p;
    __syncthreads();
#pragma unroll
    for (int a = 0; a < NB / 16; ++a) {
      const int i = ty + 16 * a;
#pragma unroll
      for (int c = 0; c < NB / 16; ++c) {
        const int k = tx + 16 * c;
        if (k > j && k <= i) A[i][k] = fmaf(-A[i][j], A[k][j], A[i][k]);
      }
    }
    __syncthreads();
  }
  if (tid < NB) A[tid][tid] = piv[tid];
  __syncthreads();

  // D^-1 by forward substitution, row by row: four lanes of one warp own a
  // column c and split the sum over k, so a row needs no block barrier.
  {
    const int c = tid >> 2;
    const int q = tid & 3;
    for (int i = 0; i < NB; ++i) {
      float s = 0.0f;
      for (int k = c + q; k < i; k += 4) s = fmaf(A[i][k], X[k][c], s);
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      if (q == 0) X[i][c] = i < c ? 0.0f : ((i == c ? 1.0f : 0.0f) - s) / A[i][i];
      __syncwarp();
    }
  }
  __syncthreads();

  for (int e = tid; e < NB * NB; e += THREADS) {
    const int i = e / NB;
    const int k = e % NB;
    Ab[(size_t)i * n_pad + k] = k <= i ? A[i][k] : 0.0f;
    Xb[e] = X[i][k];
  }
}

// A[hi + 64 x : hi + 64 x + 64, lo:hi] <- itself times D^-T, in place.
__global__ void __launch_bounds__(THREADS)
chol_batched_trsm_kernel(float* L, const float* __restrict__ Dinv, int n_pad, int lo) {
  __shared__ __align__(16) Tile As;
  __shared__ __align__(16) Tile Bs;
  float* P = L + (size_t)blockIdx.z * n_pad * n_pad +
             (size_t)(lo + NB + blockIdx.x * NB) * n_pad + lo;
  load_t(As, P, n_pad);
  load_t(Bs, Dinv + (size_t)blockIdx.z * NB * NB, NB);
  __syncthreads();
  float acc[4][4];
  product_t(As, Bs, acc);
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
#pragma unroll
  for (int u = 0; u < 4; ++u)
    *reinterpret_cast<float4*>(P + (size_t)(ty * 4 + u) * n_pad + tx * 4) =
        make_float4(acc[u][0], acc[u][1], acc[u][2], acc[u][3]);
}

// Trailing update of one 64x64 tile (ti, tj), ti >= tj, of A[hi:, hi:]:
// blockIdx.x enumerates the lower triangle of tiles row by row.
__global__ void __launch_bounds__(THREADS)
chol_batched_syrk_kernel(float* L, int n_pad, int lo) {
  __shared__ __align__(16) Tile As;
  __shared__ __align__(16) Tile Bs;
  const int x = blockIdx.x;
  int ti = (int)((sqrtf(8.0f * (float)x + 1.0f) - 1.0f) * 0.5f);
  while (ti * (ti + 1) / 2 > x) --ti;
  while ((ti + 1) * (ti + 2) / 2 <= x) ++ti;
  const int tj = x - ti * (ti + 1) / 2;
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
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    float4* c = reinterpret_cast<float4*>(C + (size_t)(ty * 4 + u) * n_pad + tx * 4);
    float4 v = *c;
    v.x -= acc[u][0];
    v.y -= acc[u][1];
    v.z -= acc[u][2];
    v.w -= acc[u][3];
    *c = v;
  }
}

}  // namespace

// K: [nb, n, n] f32 row-major (any alignment); L: [nb, n_pad, n_pad] and
// Dinv: [nb, 64, 64] scratch, both 16-byte aligned; n_pad the least
// multiple of 64 >= n.  Everything is enqueued on `stream`; returns the
// first launch error.
extern "C" int chol_batched_f32(const void* K_, void* L_, void* Dinv_, int nb,
                                int n, int n_pad, void* stream_) {
  cudaStream_t stream = (cudaStream_t)stream_;
  if (nb <= 0 || n <= 0 || n_pad % NB != 0 || n_pad < n || n_pad - n >= NB)
    return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<size_t>(L_) % 16 != 0 ||
      reinterpret_cast<size_t>(Dinv_) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  int err = 0;
  for (int b0 = 0; b0 < nb; b0 += MAX_Z) {
    const int bz = nb - b0 < MAX_Z ? nb - b0 : MAX_Z;
    const float* K = (const float*)K_ + (size_t)b0 * n * n;
    float* L = (float*)L_ + (size_t)b0 * n_pad * n_pad;
    float* D = (float*)Dinv_ + (size_t)b0 * NB * NB;
    const int rows = n_pad < MAX_Z ? n_pad : MAX_Z;
    chol_batched_load_kernel<<<dim3((n_pad + 255) / 256, rows, bz), 256, 0, stream>>>(K, L, n, n_pad);
    if ((err = (int)cudaGetLastError())) return err;
    for (int lo = 0; lo < n_pad; lo += NB) {
      chol_batched_diag_kernel<<<dim3(1, 1, bz), THREADS, 0, stream>>>(L, D, n_pad, lo);
      if ((err = (int)cudaGetLastError())) return err;
      const int t = (n_pad - lo) / NB - 1;  // row tiles below the panel
      if (t == 0) continue;
      chol_batched_trsm_kernel<<<dim3(t, 1, bz), THREADS, 0, stream>>>(L, D, n_pad, lo);
      if ((err = (int)cudaGetLastError())) return err;
      chol_batched_syrk_kernel<<<dim3(t * (t + 1) / 2, 1, bz), THREADS, 0, stream>>>(L, n_pad, lo);
      if ((err = (int)cudaGetLastError())) return err;
    }
  }
  return 0;
}
