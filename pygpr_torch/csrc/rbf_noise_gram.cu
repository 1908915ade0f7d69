// Fused RBF + white-noise train gram, f32, for sm_90a.
//
// Replaces: pygpr_tpu/ops/pallas_kernels.py::rbf_noise_gram (Pallas body
// _gram_kernel), which writes K once in 256x256 tiles on the TPU.
//
// Computes, for x [n, d] row-major and params = [s, l_1..l_d, sn] on the
// device,
//
//     K[i, j] = s^2 * exp(-sum_k (x[i,k] l_k - x[j,k] l_k)^2) + (i == j) sn^2
//
// The parameters are read through a device pointer inside the kernel, so an
// NLML evaluation never waits on the host for them.
//
// What bounds it on an H100: the n^2 float store (4 n^2 bytes; 268 MB at
// n = 8192, about 80 us at 3.35 TB/s).  The arithmetic is 3 d flops and one
// expf per element, far under the FP32 rate for d <= 64.
//
// What the design does about it: one 256-thread block per 64x64 output
// tile; the tile's 64 row points and 64 column points, already scaled by l,
// are staged in shared memory as [d][64] so a warp reads consecutive words.
// A thread owns 8 rows (ty + 8 r) and 2 columns (tx, tx + 32): every store
// instruction of a warp writes 32 consecutive floats of one row, one full
// 128-byte line.  Distances are direct differences, not the
// |a|^2 + |b|^2 - 2 a.b trick, so the diagonal is exact (sqd = 0) and there
// is no cancellation.  The ragged edge is masked, never padded.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int TILE = 64;
constexpr int TX = 32;
constexpr int TY = 8;
constexpr int ROWS_PER_THREAD = TILE / TY;  // 8
constexpr int COLS_PER_THREAD = TILE / TX;  // 2

__global__ void __launch_bounds__(TX * TY)
rbf_noise_gram_kernel(const float* __restrict__ x,
                      const float* __restrict__ params,
                      float* __restrict__ out, int n, int d) {
  extern __shared__ float smem[];
  float* xr = smem;             // [d][TILE] scaled row points
  float* xc = smem + d * TILE;  // [d][TILE] scaled column points

  const int row0 = blockIdx.y * TILE;
  const int col0 = blockIdx.x * TILE;
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * TX + tx;

  for (int e = tid; e < d * TILE; e += TX * TY) {
    const int k = e / TILE;
    const int r = e - k * TILE;
    const float lk = params[1 + k];
    const int gi = row0 + r;
    const int gj = col0 + r;
    xr[e] = gi < n ? x[(size_t)gi * d + k] * lk : 0.0f;
    xc[e] = gj < n ? x[(size_t)gj * d + k] * lk : 0.0f;
  }
  __syncthreads();

  float acc[ROWS_PER_THREAD][COLS_PER_THREAD];
#pragma unroll
  for (int r = 0; r < ROWS_PER_THREAD; ++r)
#pragma unroll
    for (int c = 0; c < COLS_PER_THREAD; ++c) acc[r][c] = 0.0f;

  for (int k = 0; k < d; ++k) {
    float cv[COLS_PER_THREAD];
#pragma unroll
    for (int c = 0; c < COLS_PER_THREAD; ++c) cv[c] = xc[k * TILE + tx + c * TX];
#pragma unroll
    for (int r = 0; r < ROWS_PER_THREAD; ++r) {
      const float rv = xr[k * TILE + ty + r * TY];
#pragma unroll
      for (int c = 0; c < COLS_PER_THREAD; ++c) {
        const float df = rv - cv[c];
        acc[r][c] = fmaf(df, df, acc[r][c]);
      }
    }
  }

  const float s = params[0];
  const float sn = params[d + 1];
  const float s2 = s * s;
  const float sn2 = sn * sn;
#pragma unroll
  for (int r = 0; r < ROWS_PER_THREAD; ++r) {
    const int gi = row0 + ty + r * TY;
    if (gi >= n) continue;
#pragma unroll
    for (int c = 0; c < COLS_PER_THREAD; ++c) {
      const int gj = col0 + tx + c * TX;
      if (gj >= n) continue;
      float v = s2 * expf(-acc[r][c]);
      if (gi == gj) v += sn2;
      out[(size_t)gi * n + gj] = v;
    }
  }
}

}  // namespace

// x [n, d], params [d + 2], out [n, n]: f32, contiguous, on the device of
// `stream`.  Returns cudaGetLastError() after the launch.
extern "C" int rbf_noise_gram_f32(const void* x, const void* params, void* out,
                                  int n, int d, void* stream) {
  const dim3 grid((n + TILE - 1) / TILE, (n + TILE - 1) / TILE);
  const dim3 block(TX, TY);
  const size_t smem = 2 * (size_t)d * TILE * sizeof(float);
  rbf_noise_gram_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)params, (float*)out, n, d);
  return (int)cudaGetLastError();
}
