// Per-block micro-Cholesky and triangular inverse of a strip of 128x128
// blocks, f32, for sm_90a: the two stages that the MFU probe times apart.
//
// Replaces: pygpr_tpu/bench/mfu_probe.py::_pivots_kernel (pivots_call),
// which runs _micro_cholesky (pygpr_tpu/ops/pallas_cholesky.py) on each
// 128x128 diagonal block of a strip, and _tinv_kernel (tinv_call), which
// runs _tri_inverse (the same file) on each lower-triangular block.  The
// strip is [P*128, 128] row-major; block p is rows 128p..128p+127.  The TPU
// ran the P blocks in series only because its grid is one core; they are
// independent, so here each is one thread block (gridDim.x = P) and they
// run at the same time.
//
//   micro_cholesky_blocks_f32: the lower factor L of each block (A = L L^T),
//     exact zeros above the diagonal.  A non-positive pivot gives sqrtf's
//     NaN (or 1/0's inf), which is not guarded and spreads through the rest
//     of its block and no other.
//   tri_inverse_blocks_f32: T = L^-1 of each block from its lower triangle
//     (the upper triangle is never read), exact zeros above the diagonal.
//     The strips have no padding rows, so unlike _tri_inverse there is no
//     guard that turns a zero pivot into 1: a zero pivot gives inf or NaN.
//
// What bounds it on an H100: latency.  Each kernel moves 2 P 128^2 4 bytes
// (read the strip, write the result: 2.5 us at P = 64 and 3.35 TB/s) and
// does P 128^3 / 3 flops (0.7 us at P = 64 and the 67 TFLOP/s FP32 rate),
// but a block's 128 pivots (or 128 rows of a substitution) depend on each
// other in order, so its time is 128 dependent steps, each behind a barrier
// or a shared-memory round trip.
//
// What the design does about it: the P blocks run in parallel (up to 132
// SMs, two blocks an SM), so the strip takes about one block's chain,
// whatever P.  The factorization keeps its block in dynamic shared memory
// (128 rows of 129 floats, the pad spreading a column's reads over the
// banks: 66,048 bytes, above the 48 KB static limit) and is right-looking
// and unblocked with ONE __syncthreads a pivot step: at step j every
// thread reads column j (final since the last barrier) and updates only
// columns > j, so no thread writes what another reads in the same step;
// the column-j threads write L's column j straight to device memory
// (scaled, with the zeros above the diagonal).  1024 threads: thread t owns
// column t % 128 and every 8th row from t / 128, so a warp holds 32
// neighbouring columns of one row (conflict-free) and the warps of the
// columns left of the pivot fall idle as j grows.  The pivot's reciprocal
// is taken once a step (l = a * (1/p) rather than a / p per element).
// The inverse gives each of 128 threads one column of T by forward
// substitution from shared memory (the block's L and T, 128 KiB: rows of
// 128 floats, so that thread c's reads of T[k][c] fall in bank c), with
// four partial sums a row and an IEEE division by the pivot.  No tensor
// cores, no TMA: IEEE f32 throughout.  Not yet done: a blocked
// factorization, or several blocks' chains sharing an SM's warps.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int BS = 128;              // block width; B in pallas_cholesky.py
constexpr int LDA = BS + 1;          // padded row of the factorization's block
constexpr int CHOL_THREADS = 1024;
constexpr int CHOL_ROW_STEP = CHOL_THREADS / BS;  // 8: rows r0, r0 + 8, ...
constexpr int TINV_THREADS = BS;
constexpr size_t CHOL_SMEM = (size_t)BS * LDA * sizeof(float);
constexpr size_t TINV_SMEM = 2 * (size_t)BS * BS * sizeof(float);

__global__ void __launch_bounds__(CHOL_THREADS)
micro_cholesky_blocks_kernel(const float* __restrict__ in, float* __restrict__ out) {
  extern __shared__ float A[];  // [BS][LDA]
  const size_t base = (size_t)blockIdx.x * BS * BS;
  const int tid = threadIdx.x;
  for (int e = tid; e < BS * BS; e += CHOL_THREADS) {
    A[(e / BS) * LDA + e % BS] = in[base + e];
  }
  __syncthreads();

  const int c = tid % BS;
  const int r0 = tid / BS;
  // first row >= c of this thread's residue class
  const int i0 = c + ((r0 - c) % CHOL_ROW_STEP + CHOL_ROW_STEP) % CHOL_ROW_STEP;
  for (int j = 0; j < BS; ++j) {
    const float p = sqrtf(A[j * LDA + j]);
    const float rp = 1.0f / p;
    if (c == j) {
      for (int i = r0; i < BS; i += CHOL_ROW_STEP) {
        out[base + (size_t)i * BS + j] = i < j ? 0.0f : (i == j ? p : A[i * LDA + j] * rp);
      }
    } else if (c > j) {
      const float lc = A[c * LDA + j] * rp;
      for (int i = i0; i < BS; i += CHOL_ROW_STEP) {
        const float li = A[i * LDA + j] * rp;
        A[i * LDA + c] -= li * lc;
      }
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(TINV_THREADS)
tri_inverse_blocks_kernel(const float* __restrict__ in, float* __restrict__ out) {
  extern __shared__ float smem[];
  float* L = smem;            // [BS][BS], lower triangle only
  float* T = smem + BS * BS;  // [BS][BS], column c written by thread c
  const size_t base = (size_t)blockIdx.x * BS * BS;
  const int tid = threadIdx.x;
  for (int e = tid; e < BS * BS; e += TINV_THREADS) {
    if (e % BS <= e / BS) L[e] = in[base + e];
  }
  __syncthreads();

  const int c = tid;
  T[c * BS + c] = 1.0f / L[c * BS + c];
  for (int i = c + 1; i < BS; ++i) {
    const float* Li = L + i * BS;
    float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f, s3 = 0.0f;
    int k = c;
    for (; k + 3 < i; k += 4) {
      s0 = fmaf(Li[k], T[k * BS + c], s0);
      s1 = fmaf(Li[k + 1], T[(k + 1) * BS + c], s1);
      s2 = fmaf(Li[k + 2], T[(k + 2) * BS + c], s2);
      s3 = fmaf(Li[k + 3], T[(k + 3) * BS + c], s3);
    }
    for (; k < i; ++k) s0 = fmaf(Li[k], T[k * BS + c], s0);
    T[i * BS + c] = -((s0 + s1) + (s2 + s3)) / Li[i];
  }
  __syncthreads();

  for (int e = tid; e < BS * BS; e += TINV_THREADS) {
    out[base + e] = e % BS <= e / BS ? T[e] : 0.0f;
  }
}

template <typename Kernel>
int launch(Kernel kernel, int threads, size_t smem, const void* in, void* out, int panels,
           void* stream) {
  if (panels <= 0) return (int)cudaErrorInvalidValue;
  int err = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err) return err;
  kernel<<<panels, threads, smem, (cudaStream_t)stream>>>((const float*)in, (float*)out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int micro_cholesky_blocks_f32(const void* in, void* out, int panels, void* stream) {
  return launch(micro_cholesky_blocks_kernel, CHOL_THREADS, CHOL_SMEM, in, out, panels, stream);
}

extern "C" int tri_inverse_blocks_f32(const void* in, void* out, int panels, void* stream) {
  return launch(tri_inverse_blocks_kernel, TINV_THREADS, TINV_SMEM, in, out, panels, stream);
}
