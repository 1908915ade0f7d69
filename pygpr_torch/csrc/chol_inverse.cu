// Fused Cholesky factor and triangular inverse, f32, for sm_90a.
//
// Replaces: pygpr_tpu/ops/pallas_cholesky.py::cholesky_inverse_pallas
// (Pallas body _chol_inv_kernel, n <= 5632) and
// cholesky_inverse_pallas_rolled (_chol_inv_kernel_rolled, n <= 16384).  The
// TPU needed two kernels only because of Mosaic compile time; here n is a
// run-time argument, so one kernel family takes every n % 64 == 0.
//
// Given SPD K [n, n] it writes L (K = L L^T) and T = L^-1, both lower
// triangular with exact zeros above the diagonal, in one left-looking sweep
// over 64-wide panels (lo = 64 p, hi = lo + 64):
//
//   1. W = K[lo:n, lo:hi] - L[lo:n, :lo] L[lo:hi, :lo]^T        (GEMM, NT)
//   2. one block factors W[:64] (D) and inverts it (D^-1)
//   3. L[hi:n, lo:hi] = W[64:] D^-T                              (GEMM, NT)
//   4. T[lo:hi, :lo]  = -D^-1 (L[lo:hi, :lo] T[:lo, :lo])        (2 GEMMs, NN)
//
// The caller's K is only read: the ladder adds jitter to the same K again
// on every rung.  A non-positive pivot gives sqrtf's NaN, which is not
// guarded and spreads through everything after it: that is the ladder's
// signal to escalate.
//
// What bounds it on an H100: the 2/3 n^3 flops (potrf n^3/3 + trtri n^3/3)
// at the FP32 FFMA rate (67 TFLOP/s on the SXM part: 5.5 ms at n = 8192);
// its bytes (read K, write L and T: 12 n^2) are far less.  At small n the
// sequential chain of n/64 diagonal-block factorizations sets the pace.
//
// What the design does about it: all products run in one tiled FFMA GEMM
// (64x64 tiles, 64 threads with 8x8 outputs each, float4 shared-memory
// reads, 16-deep k steps double-buffered through shared memory).  The
// left-looking products are tall and thin (n x 64 with a long k) or short
// and wide, so they split k across blocks until the grid fills the card,
// and a second pass sums the partials in a fixed order.  The T band skips
// the zero upper triangle of T.  One 256-thread block factors the diagonal
// block in shared memory and inverts it one column a thread; this chain of
// n/64 single-block kernels is latency-bound (about 80 us each on an H100)
// and sets the pace at n <= 4096.  Not yet done: a blocked diagonal
// factorization, overlap of the pivot chain with the trailing products,
// tensor cores and TMA.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include <initializer_list>

namespace {

constexpr int NB = 64;  // panel width; pygpr_torch/ops/chol_inverse.py PANEL
constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int PAD = 4;  // keeps float4 rows aligned, spreads banks
constexpr int GEMM_THREADS = 64;
constexpr int DIAG_THREADS = 256;
constexpr int TARGET_BLOCKS = 792;  // about six GEMM blocks on each of 132 SMs
// Least k depth of one split.  Short splits are for accuracy as much as for
// parallelism: a long f32 sum of small products swamps the late terms
// (each is under half an ulp of the running sum), which biases the pivots
// of the left-looking update upward and the NLML gradient with them.
constexpr int KSPLIT_MIN = 16;

struct GemmArgs {
  int M, N, K;
  const float* A;  // A[i, k] = A[i * lda + k]
  int lda;
  const float* B;  // transposed: op(B)[k, j] = B[j * ldb + k]; else B[k * ldb + j]
  int ldb;
  const float* C;  // D = alpha * A op(B) + beta * C; C is read only if beta != 0
  int ldc;
  float* D;
  int ldd;
  float alpha, beta;
  int lower_b;  // op(B)[k, j] == 0 for k < j: column tile j0 starts at k = j0
  int ksplit;   // k extent of one blockIdx.z
  float* P;     // raw partial sums [gridDim.z][M][N] when split, else null
};

// D tile = op of A op(B) over this block's k range.  M, N are multiples of
// 64, every k bound a multiple of 16, every leading dimension and offset a
// multiple of 4 floats (the host's n % 64 == 0 guarantees all of it), so
// there is no edge masking and every global access is a float4.
template <bool B_TRANS>
__global__ void __launch_bounds__(GEMM_THREADS) gemm_kernel(GemmArgs g) {
  __shared__ __align__(16) float As[2][BK][BM + PAD];
  __shared__ __align__(16) float Bs[2][BK][BN + PAD];
  const int tid = threadIdx.x;
  const int tx = tid % 8;
  const int ty = tid / 8;
  const int i0 = blockIdx.y * BM;
  const int j0 = blockIdx.x * BN;
  int kb = blockIdx.z * g.ksplit;
  const int ke = min(g.K, kb + g.ksplit);
  if (g.lower_b) kb = max(kb, j0);

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  float4 ra[4];
  float4 rb[4];
  auto load = [&](int k0) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int f = tid + q * GEMM_THREADS;  // 256 float4 per 64x16 tile
      const int r = f / 4;
      const int k4 = (f % 4) * 4;
      ra[q] = *reinterpret_cast<const float4*>(g.A + (size_t)(i0 + r) * g.lda + k0 + k4);
      if (B_TRANS) {
        rb[q] = *reinterpret_cast<const float4*>(g.B + (size_t)(j0 + r) * g.ldb + k0 + k4);
      } else {
        const int kk = f / 16;
        const int c4 = (f % 16) * 4;
        rb[q] = *reinterpret_cast<const float4*>(g.B + (size_t)(k0 + kk) * g.ldb + j0 + c4);
      }
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int f = tid + q * GEMM_THREADS;
      const int r = f / 4;
      const int k4 = (f % 4) * 4;
      As[buf][k4 + 0][r] = ra[q].x;
      As[buf][k4 + 1][r] = ra[q].y;
      As[buf][k4 + 2][r] = ra[q].z;
      As[buf][k4 + 3][r] = ra[q].w;
      if (B_TRANS) {
        Bs[buf][k4 + 0][r] = rb[q].x;
        Bs[buf][k4 + 1][r] = rb[q].y;
        Bs[buf][k4 + 2][r] = rb[q].z;
        Bs[buf][k4 + 3][r] = rb[q].w;
      } else {
        *reinterpret_cast<float4*>(&Bs[buf][f / 16][(f % 16) * 4]) = rb[q];
      }
    }
  };

  if (kb < ke) {
    load(kb);
    store(0);
    __syncthreads();
    int buf = 0;
    for (int k0 = kb; k0 < ke; k0 += BK) {
      const bool more = k0 + BK < ke;
      if (more) load(k0 + BK);
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        const float4 a0 = *reinterpret_cast<const float4*>(&As[buf][kk][ty * 4]);
        const float4 a1 = *reinterpret_cast<const float4*>(&As[buf][kk][32 + ty * 4]);
        const float4 b0 = *reinterpret_cast<const float4*>(&Bs[buf][kk][tx * 4]);
        const float4 b1 = *reinterpret_cast<const float4*>(&Bs[buf][kk][32 + tx * 4]);
        const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      if (more) store(buf ^ 1);
      __syncthreads();
      buf ^= 1;
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gi = i0 + (i < 4 ? ty * 4 + i : 32 + ty * 4 + i - 4);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gj = j0 + h * 32 + tx * 4;
      float4 v = make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2], acc[i][4 * h + 3]);
      if (g.P != nullptr) {
        *reinterpret_cast<float4*>(g.P + ((size_t)blockIdx.z * g.M + gi) * g.N + gj) = v;
        continue;
      }
      v.x *= g.alpha;
      v.y *= g.alpha;
      v.z *= g.alpha;
      v.w *= g.alpha;
      if (g.beta != 0.0f) {
        const float4 c = *reinterpret_cast<const float4*>(g.C + (size_t)gi * g.ldc + gj);
        v.x += g.beta * c.x;
        v.y += g.beta * c.y;
        v.z += g.beta * c.z;
        v.w += g.beta * c.w;
      }
      *reinterpret_cast<float4*>(g.D + (size_t)gi * g.ldd + gj) = v;
    }
  }
}

// D = beta * C + alpha * P[0] + alpha * P[1] + ..., in this order: the
// update K - L L^T starts from K and shrinks towards the pivot, so the
// late partials meet a small running value.
__global__ void splitk_reduce_kernel(GemmArgs g, int splits) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t mn = (size_t)g.M * g.N;
  if (idx >= mn) return;
  const int gi = (int)(idx / g.N);
  const int gj = (int)(idx % g.N);
  float v = g.beta != 0.0f ? g.beta * g.C[(size_t)gi * g.ldc + gj] : 0.0f;
  for (int z = 0; z < splits; ++z) v = fmaf(g.alpha, g.P[(size_t)z * mn + idx], v);
  g.D[(size_t)gi * g.ldd + gj] = v;
}

// One block: W[:64, :64] (leading dimension ldw) -> the diagonal blocks of
// L (= D, the lower Cholesky factor) and T (= D^-1), leading dimension ldn.
__global__ void __launch_bounds__(DIAG_THREADS)
diag_block_kernel(const float* __restrict__ W, int ldw, float* __restrict__ L,
                  float* __restrict__ T, int ldn) {
  __shared__ float A[NB][NB + 1];
  __shared__ float X[NB][NB + 1];
  __shared__ float piv[NB];
  const int tid = threadIdx.x;

  for (int e = tid; e < NB * NB; e += DIAG_THREADS) {
    const int i = e / NB;
    const int k = e % NB;
    A[i][k] = W[(size_t)i * ldw + k];
  }
  __syncthreads();

  // Unblocked right-looking Cholesky of the lower triangle.  The pivot is
  // kept apart in piv[] so that no thread overwrites A[j][j] while another
  // still reads it.
  for (int j = 0; j < NB; ++j) {
    const float p = sqrtf(A[j][j]);
    if (tid == 0) piv[j] = p;
    for (int i = j + 1 + tid; i < NB; i += DIAG_THREADS) A[i][j] = A[i][j] / p;
    __syncthreads();
    const int m = NB - 1 - j;
    for (int e = tid; e < m * m; e += DIAG_THREADS) {
      const int i = j + 1 + e / m;
      const int k = j + 1 + e % m;
      if (k <= i) A[i][k] -= A[i][j] * A[k][j];
    }
    __syncthreads();
  }
  if (tid < NB) A[tid][tid] = piv[tid];
  __syncthreads();

  for (int e = tid; e < NB * NB; e += DIAG_THREADS) {
    const int i = e / NB;
    const int k = e % NB;
    L[(size_t)i * ldn + k] = k <= i ? A[i][k] : 0.0f;
  }

  // D^-1 by forward substitution, one column per thread.
  if (tid < NB) {
    const int c = tid;
    for (int i = 0; i < c; ++i) X[i][c] = 0.0f;
    X[c][c] = 1.0f / A[c][c];
    for (int i = c + 1; i < NB; ++i) {
      float s0 = 0.0f;
      float s1 = 0.0f;
      int k = c;
      for (; k + 1 < i; k += 2) {
        s0 = fmaf(A[i][k], X[k][c], s0);
        s1 = fmaf(A[i][k + 1], X[k + 1][c], s1);
      }
      if (k < i) s0 = fmaf(A[i][k], X[k][c], s0);
      X[i][c] = -(s0 + s1) / A[i][i];
    }
  }
  __syncthreads();

  for (int e = tid; e < NB * NB; e += DIAG_THREADS) {
    const int i = e / NB;
    const int k = e % NB;
    T[(size_t)i * ldn + k] = X[i][k];
  }
}

// Zeros of L and T in every 64x64 block strictly above the block diagonal.
__global__ void zero_upper_kernel(float* __restrict__ L, float* __restrict__ T,
                                  int n) {
  const int bi = blockIdx.y;
  const int bj = blockIdx.x;
  if (bj <= bi) return;
  for (int e = threadIdx.x; e < NB * NB; e += blockDim.x) {
    const size_t off = (size_t)(bi * NB + e / NB) * n + bj * NB + e % NB;
    L[off] = 0.0f;
    T[off] = 0.0f;
  }
}

int gemm(bool b_trans, GemmArgs g, float* partial, long long partial_cap,
         cudaStream_t stream) {
  const int tiles_m = g.M / BM;
  const int tiles_n = g.N / BN;
  int splits = 1;
  if (partial != nullptr && g.K >= 2 * KSPLIT_MIN) {
    const int tiles = tiles_m * tiles_n;
    splits = (TARGET_BLOCKS + tiles - 1) / tiles;
    splits = min(splits, g.K / KSPLIT_MIN);
    const long long cap = partial_cap / ((long long)g.M * g.N);
    if ((long long)splits > cap) splits = (int)cap;
    splits = max(splits, 1);
  }
  int ksplit = (g.K + splits - 1) / splits;
  ksplit = (ksplit + BK - 1) / BK * BK;
  if (ksplit > 0) splits = (g.K + ksplit - 1) / ksplit;
  splits = max(splits, 1);
  g.ksplit = ksplit;
  g.P = splits > 1 ? partial : nullptr;

  const dim3 grid(tiles_n, tiles_m, splits);
  if (b_trans) {
    gemm_kernel<true><<<grid, GEMM_THREADS, 0, stream>>>(g);
  } else {
    gemm_kernel<false><<<grid, GEMM_THREADS, 0, stream>>>(g);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const size_t mn = (size_t)g.M * g.N;
  splitk_reduce_kernel<<<(unsigned)((mn + 255) / 256), 256, 0, stream>>>(g, splits);
  return (int)cudaGetLastError();
}

}  // namespace

// K, L, T: [n, n] f32 row-major; W: [n, 64] and X: [64, n] scratch;
// P: partial_cap floats of split-k scratch (at least 64 n).  n % 64 == 0,
// and every pointer 16-byte aligned.  Everything is enqueued on `stream`;
// returns the first launch error.
extern "C" int chol_inverse_f32(const void* K_, void* L_, void* T_, void* W_,
                                void* X_, void* P_, long long partial_cap,
                                int n, void* stream_) {
  const float* K = (const float*)K_;
  float* L = (float*)L_;
  float* T = (float*)T_;
  float* W = (float*)W_;
  float* X = (float*)X_;
  float* P = (float*)P_;
  cudaStream_t stream = (cudaStream_t)stream_;
  if (n <= 0 || n % NB != 0 || partial_cap < (long long)NB * n)
    return (int)cudaErrorInvalidValue;
  for (const void* ptr : {K_, (const void*)L_, (const void*)T_, (const void*)W_,
                          (const void*)X_, (const void*)P_})
    if (reinterpret_cast<size_t>(ptr) % 16 != 0) return (int)cudaErrorInvalidValue;

  zero_upper_kernel<<<dim3(n / NB, n / NB), 256, 0, stream>>>(L, T, n);
  int err = (int)cudaGetLastError();
  if (err) return err;

  for (int lo = 0; lo < n; lo += NB) {
    const int hi = lo + NB;
    const int rows = n - lo;
    const size_t lo_row = (size_t)lo * n;

    GemmArgs upd = {};
    upd.M = rows; upd.N = NB; upd.K = lo;
    upd.A = L + lo_row; upd.lda = n;
    upd.B = L + lo_row; upd.ldb = n;
    upd.C = K + lo_row + lo; upd.ldc = n;
    upd.D = W; upd.ldd = NB;
    upd.alpha = -1.0f; upd.beta = 1.0f;
    if ((err = gemm(true, upd, P, partial_cap, stream))) return err;

    diag_block_kernel<<<1, DIAG_THREADS, 0, stream>>>(W, NB, L + lo_row + lo,
                                                      T + lo_row + lo, n);
    if ((err = (int)cudaGetLastError())) return err;

    if (rows > NB) {
      GemmArgs trsm = {};
      trsm.M = rows - NB; trsm.N = NB; trsm.K = NB;
      trsm.A = W + NB * NB; trsm.lda = NB;
      trsm.B = T + lo_row + lo; trsm.ldb = n;
      trsm.D = L + (size_t)hi * n + lo; trsm.ldd = n;
      trsm.alpha = 1.0f; trsm.beta = 0.0f;
      if ((err = gemm(true, trsm, nullptr, 0, stream))) return err;
    }

    if (lo > 0) {
      GemmArgs band = {};
      band.M = NB; band.N = lo; band.K = lo;
      band.A = L + lo_row; band.lda = n;
      band.B = T; band.ldb = n;
      band.D = X; band.ldd = n;
      band.alpha = 1.0f; band.beta = 0.0f;
      band.lower_b = 1;
      if ((err = gemm(false, band, P, partial_cap, stream))) return err;

      GemmArgs tb = {};
      tb.M = NB; tb.N = lo; tb.K = NB;
      tb.A = T + lo_row + lo; tb.lda = n;
      tb.B = X; tb.ldb = n;
      tb.D = T + lo_row; tb.ldd = n;
      tb.alpha = -1.0f; tb.beta = 0.0f;
      if ((err = gemm(false, tb, nullptr, 0, stream))) return err;
    }
  }
  return 0;
}
