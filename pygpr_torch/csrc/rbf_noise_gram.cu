// Fused RBF + white-noise train grams over a stack, f32, for sm_90a.
//
// Replaces: pygpr_tpu/ops/pallas_kernels.py:136 rbf_noise_gram (Pallas body
// _gram_kernel), which writes K once in 256x256 tiles on the TPU, also as
// vmapped at pygpr_tpu/models/likelihood.py:88 (_nlml_batched_vals), where
// the batch axis joins the grid and the [nb, n, n] stack is one launch.
// Here too a stack is one launch.
//
// Computes, for each b < nb, with x_b [n, d] row-major and
// params_b = [s, l_1..l_d, sn] on the device,
//
//     K_b[i, j] = s^2 * exp(-sum_k (x_b[i,k] l_k - x_b[j,k] l_k)^2) + (i == j) sn^2
//
// x_b = x + b * x_batch_stride and params_b = params + b * params_batch_stride
// (in floats): a stride of 0 shares one x (MCMC chains over one data set)
// or one params (a committee under shared hyperparameters) across the
// stack, never copied.  The parameters are read through a device pointer
// inside the kernel, once a block from its own matrix's row, so an NLML
// evaluation never waits on the host for them.
//
// What bounds it on an H100: the nb n^2 float store (4 nb n^2 bytes; 16.8 MB
// for the MCMC chains' [4, 1024, 1024], 5.0 us at 3.35 TB/s; 268 MB at
// n = 8192, 80 us).  The arithmetic is 3 d flops and one expf per element,
// under the FP32 rate for d <= 64, but not by so much that it hides behind
// the store on its own: the IEEE expf is about ten instructions, so the
// instructions an element costs set the pace beside the bytes.  On a small
// gram the launch's own floor dominates (a one-matrix launch at
// [1024, 1024] took 3.7 us on an H100, whose store takes 1.25 us), which is
// why a stack is one launch and not nb of them.
//
// What the design does about it:
// - One launch a stack.  The grid is one dimension over the tiles of every
//   matrix, matrix by matrix, row tile by row tile (no grid dimension limit
//   binds), one block a tile, so a stack of small grams fills the card as
//   one large gram does.
// - Every store is 16 bytes a thread.  A 256-thread block owns a 64-row x
//   128-column tile; lane l of warp w takes the four consecutive columns
//   4 l .. 4 l + 3 of rows w + 8 r (r < 8), one row at a time, so each
//   float4 store of a warp writes 512 contiguous bytes of one row.  (When
//   n % 4 != 0 rows are not 16-byte aligned, and the same threads store
//   their four columns one float at a time.)  A grid of such tiles with
//   fewer blocks than the card has SMs (one gram of n <= 1024) takes
//   32-row tiles (r < 4) instead: on a few blocks the work of one block
//   sets the time, and a 32-row tile halves it.
// - Few instructions an element.  The tile's 64 row points and 128 column
//   points, already scaled by l, are staged in shared memory as [d][64] and
//   [d][128]: a warp reads its columns as one float4 each and its row's
//   value by broadcast.  d = 1, 2, 3 (the chains', the committees' and the
//   flagship's) have their own template with the sum over k unrolled; other
//   d loop.  Only the tiles that the diagonal crosses test i == j.
// - No streaming hint on the stores: K3 reads the stack next, and the main
//   path's stacks (16.8 MB; 37.7 MB at [16, 768, 768]) fit in the 50 MB L2.
//
// Arithmetic per element, the same as the one-matrix kernel it replaces:
// direct differences summed over k in order with fmaf, then expf, then
// s^2 e, and sn^2 added on the diagonal.  Not the |a|^2 + |b|^2 - 2 a.b
// trick, so the diagonal is exact (sqd = 0) and there is no cancellation.
// So every matrix of a stack has the bits of a launch on it alone, and
// every K is bit-symmetric ((a - b)^2 = (b - a)^2).  The ragged edge is
// masked, never padded.

#include <cuda_runtime.h>
#include <limits.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int MAX_DIM = 64;
constexpr int TN = 128;  // columns of a tile: 32 lanes x 4
constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;

// D > 0: d == D, the sum over k unrolled; D == 0: d at run time.  TM rows
// of a tile: 64, or 32 on a grid too small to fill the card.
template <bool VEC, int D, int TM>
__global__ void __launch_bounds__(THREADS)
rbf_noise_gram_stack_kernel(const float* __restrict__ x, long long x_stride,
                            const float* __restrict__ params, long long p_stride,
                            float* __restrict__ out, int n, int d_run, int col_tiles,
                            int tiles_per_matrix) {
  constexpr int ROWS_PER_WARP = TM / WARPS;
  extern __shared__ float smem[];
  const int d = D > 0 ? D : d_run;
  float* xr = smem;           // [d][TM] scaled row points
  float* xc = smem + d * TM;  // [d][TN] scaled column points

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int w = tid >> 5;
  const int b = (int)blockIdx.x / tiles_per_matrix;  // 32-bit: the grid is < 2^31 blocks
  const int tile = (int)blockIdx.x - b * tiles_per_matrix;
  const int row0 = (tile / col_tiles) * TM;
  const int col0 = (tile % col_tiles) * TN;
  const float* xb = x + b * x_stride;
  const float* pb = params + b * p_stride;

  for (int e = tid; e < d * TM; e += THREADS) {
    const int k = e / TM;
    const int gi = row0 + (e - k * TM);
    xr[e] = gi < n ? xb[(size_t)gi * d + k] * pb[1 + k] : 0.0f;
  }
  for (int e = tid; e < d * TN; e += THREADS) {
    const int k = e / TN;
    const int gj = col0 + (e - k * TN);
    xc[e] = gj < n ? xb[(size_t)gj * d + k] * pb[1 + k] : 0.0f;
  }
  __syncthreads();

  const float s = pb[0];
  const float sn = pb[d + 1];
  const float s2 = s * s;
  const float sn2 = sn * sn;
  const int gj0 = col0 + 4 * lane;
  const bool crosses_diagonal = row0 < col0 + TN && col0 < row0 + TM;
  if (gj0 >= n) return;
  for (int r = 0; r < ROWS_PER_WARP; ++r) {
    const int gi = row0 + w + r * WARPS;
    if (gi >= n) break;
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int k = 0; k < (D > 0 ? D : d); ++k) {
      const float4 c4 = *reinterpret_cast<const float4*>(xc + k * TN + 4 * lane);
      const float cv[4] = {c4.x, c4.y, c4.z, c4.w};
      const float rv = xr[k * TM + w + r * WARPS];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float df = rv - cv[c];
        acc[c] = fmaf(df, df, acc[c]);
      }
    }
    float v[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      v[c] = s2 * expf(-acc[c]);
      if (crosses_diagonal && gi == gj0 + c) v[c] += sn2;
    }
    float* row = out + ((size_t)b * n + gi) * n;
    if (VEC) {
      *reinterpret_cast<float4*>(row + gj0) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (gj0 + c < n) row[gj0 + c] = v[c];
    }
  }
}

template <bool VEC, int D, int TM>
int launch_tiles(const float* x, long long xs, const float* params, long long ps, float* out, int nb, int n, int d,
                 cudaStream_t stream) {
  const int row_tiles = (n + TM - 1) / TM;
  const int col_tiles = (n + TN - 1) / TN;
  const long long per_matrix = (long long)row_tiles * col_tiles;
  if (per_matrix * nb > INT_MAX) return (int)cudaErrorInvalidConfiguration;
  const size_t smem = (size_t)(TM + TN) * d * sizeof(float);  // <= 48 KB at d = 64
  rbf_noise_gram_stack_kernel<VEC, D, TM><<<(unsigned)(per_matrix * nb), THREADS, smem, stream>>>(
      x, xs, params, ps, out, n, d, col_tiles, (int)per_matrix);
  return (int)cudaGetLastError();
}

// SMs of the current device, read once.
int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess || cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      sms = 1;
  }
  return sms;
}

// A grid of 64-row tiles with fewer blocks than SMs (one gram of n <= 1024
// on an H100) takes 32-row tiles: twice the blocks, half the elements a
// thread, so a small gram's few blocks finish sooner.  The same bits.
template <bool VEC, int D>
int launch(const float* x, long long xs, const float* params, long long ps, float* out, int nb, int n, int d,
           cudaStream_t stream) {
  const long long tiles64 = (long long)((n + 63) / 64) * ((n + TN - 1) / TN) * nb;
  return tiles64 < sm_count() ? launch_tiles<VEC, D, 32>(x, xs, params, ps, out, nb, n, d, stream)
                              : launch_tiles<VEC, D, 64>(x, xs, params, ps, out, nb, n, d, stream);
}

template <bool VEC>
int dispatch(const float* x, long long xs, const float* params, long long ps, float* out, int nb, int n, int d,
             cudaStream_t stream) {
  switch (d) {
    case 1: return launch<VEC, 1>(x, xs, params, ps, out, nb, n, d, stream);
    case 2: return launch<VEC, 2>(x, xs, params, ps, out, nb, n, d, stream);
    case 3: return launch<VEC, 3>(x, xs, params, ps, out, nb, n, d, stream);
    default: return launch<VEC, 0>(x, xs, params, ps, out, nb, n, d, stream);
  }
}

}  // namespace

// x: [n, d] at x + b * x_batch_stride for b < nb (stride 0: one x for all);
// params: [d + 2] at params + b * params_batch_stride (stride 0: one params);
// out: [nb, n, n].  f32, each matrix and vector contiguous, on the device of
// `stream`; 1 <= d <= 64.  Returns the first CUDA error of the launch.
extern "C" int rbf_noise_gram_f32(const void* x, long long x_batch_stride, const void* params,
                                  long long params_batch_stride, void* out, int nb, int n, int d,
                                  void* stream) {
  if (nb < 1 || n < 1 || d < 1 || d > MAX_DIM) return (int)cudaErrorInvalidValue;
  const bool vec = n % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const float* xf = (const float*)x;
  const float* pf = (const float*)params;
  float* of = (float*)out;
  const cudaStream_t st = (cudaStream_t)stream;
  return vec ? dispatch<true>(xf, x_batch_stride, pf, params_batch_stride, of, nb, n, d, st)
             : dispatch<false>(xf, x_batch_stride, pf, params_batch_stride, of, nb, n, d, st);
}
