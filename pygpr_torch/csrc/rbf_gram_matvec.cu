// Fused RBF gram-matvec, f32, for sm_90a.  The gram is never stored.
//
// Replaces: pygpr_tpu/ops/pallas_matvec.py::rbf_gram_matvec (Pallas body
// _matvec_kernel, launched by _matvec_pallas), which sweeps the column
// tiles of K in order on a sequential grid axis and accumulates each
// 512-row output tile in VMEM.  Its custom VJP calls the same kernel once
// more on the batched columns [Wbar, x*V, x^2*V, x*Wbar]; the wrapper in
// pygpr_torch/ops/matvec.py does the same with this kernel.
//
// Computes, for x [n, d] and v [n, k] row-major and theta = [s, l_1..l_d]
// on the device,
//
//     out[i, c] = s^2 * sum_j exp(-sum_m (x[i,m] l_m - x[j,m] l_m)^2) v[j, c]
//
// What bounds it on an H100: operations.  The Pallas cost estimate is
// 2 n^2 (d + k) flops plus n^2 exponentials; at n = 32768, d = 2 that is
// 0.35 ms for k = 9 at the 67 TFLOP/s FP32 rate and 0.26 ms for the n^2
// expf on the special-function units (16 a clock per SM), while the bytes
// (x, v read once, out written once) take microseconds.  The XLA path of
// the JAX package streams every [block, n] tile of K through memory and
// reads it back; fused, nothing of size n^2 leaves the chip.
//
// What the design does about it: one 256-thread block owns 64 output rows
// and a chunk of KC columns of v, KC = 1 for k = 1, 8 for k <= 8 and 16
// above (the grid's second axis covers the chunks of a wider v,
// recomputing the exponentials for each chunk).  d = 2, the width of
// every launch on the iterative path, keeps the thread's row coordinates
// in registers; any other d reads them from shared memory.  The
// block sweeps the column points in steps of 128: it stages their scaled
// coordinates [d][128] and v's rows [128][KC] in shared memory, and each
// thread, which owns 2 rows, takes every 8th point of the step: warp ty
// reads point ty + 8 jj, the same address for all 32 lanes (a broadcast).
// The thread forms the distance by direct differences (exact on the
// diagonal; no matmul trick, no clamp), one expf (not __expf) per pair,
// and KC f32 FMAs into a step's partial sums, which it adds to its
// running sums at the end of the step: a sum in two levels, whose
// rounding grows with the n/128 steps and not with all n/8 of the
// thread's points.  No tensor cores: IEEE f32 throughout, the
// counterpart of the Pallas kernel's precision=HIGHEST.  At the end
// the 8 warps' partial sums of each row are added in warp order through
// shared memory and the block writes its [64, KC] tile once.  No atomics:
// the sums run in a fixed order and two launches give the same bits.  The
// ragged edges of n and k are masked (zero v rows and columns), never
// padded in memory.  s and l are read on the device, so a launch never
// waits on the host.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int TX = 32;             // lanes: one row each (times R)
constexpr int TY = 8;              // warps: one column point in 8 each
constexpr int NT = TX * TY;        // threads a block
constexpr int R = 2;               // rows a thread
constexpr int ROWS = TX * R;       // rows a block
constexpr int TC = 128;            // column points staged a step
constexpr int JPT = TC / TY;       // points a thread takes a step

// D == 2: d known at compile time, the thread's row coordinates kept in
// registers; D == 0: any d, read from shared memory.
template <int D, int KC>
__global__ void __launch_bounds__(NT)
rbf_gram_matvec_kernel(const float* __restrict__ x, const float* __restrict__ theta,
                       const float* __restrict__ v, float* __restrict__ out,
                       int n, int d, int k) {
  extern __shared__ __align__(16) float smem[];
  const int dd = D > 0 ? D : d;
  float* xr = smem;                   // [dd][ROWS] this block's rows, scaled
  float* xc = xr + dd * ROWS;         // [dd][TC]   this step's points, scaled
  float* vs = xc + dd * TC;           // [TC][KC]   this step's rows of v
  float* red = xc;                    // [TY][KC][ROWS] partial sums, at the end
  const int region = max(dd * TC + TC * KC, TY * KC * ROWS);
  float* ls = xc + region;            // [dd] inverse lengthscales

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * TX + tx;
  const int row0 = blockIdx.x * ROWS;
  const int c0 = blockIdx.y * KC;

  for (int e = tid; e < dd; e += NT) ls[e] = theta[1 + e];
  __syncthreads();
  for (int e = tid; e < dd * ROWS; e += NT) {
    const int m = e / ROWS;
    const int gi = row0 + e - m * ROWS;
    xr[e] = gi < n ? x[(size_t)gi * dd + m] * ls[m] : 0.0f;
  }
  __syncthreads();

  float xi[R][D > 0 ? D : 1];
  if constexpr (D > 0) {
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int m = 0; m < D; ++m) xi[r][m] = xr[m * ROWS + tx + r * TX];
  }

  float acc[R][KC];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < KC; ++c) acc[r][c] = 0.0f;

  for (int j0 = 0; j0 < n; j0 += TC) {
    float part[R][KC];  // this step's sums, added to acc at its end
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int c = 0; c < KC; ++c) part[r][c] = 0.0f;
    __syncthreads();  // the previous step's tiles are consumed
    for (int e = tid; e < dd * TC; e += NT) {
      const int m = e / TC;
      const int gj = j0 + e - m * TC;
      xc[e] = gj < n ? x[(size_t)gj * dd + m] * ls[m] : 0.0f;
    }
    for (int e = tid; e < TC * KC; e += NT) {
      const int j = e / KC;
      const int gj = j0 + j;
      const int gc = c0 + e - j * KC;
      vs[e] = (gj < n && gc < k) ? v[(size_t)gj * k + gc] : 0.0f;
    }
    __syncthreads();

#pragma unroll 4
    for (int jj = 0; jj < JPT; ++jj) {
      const int j = ty + TY * jj;  // the same for the whole warp
      float vj[KC];
      if constexpr (KC % 4 == 0) {
        const float4* src = reinterpret_cast<const float4*>(vs + j * KC);
#pragma unroll
        for (int q = 0; q < KC / 4; ++q) {
          const float4 t = src[q];
          vj[4 * q] = t.x;
          vj[4 * q + 1] = t.y;
          vj[4 * q + 2] = t.z;
          vj[4 * q + 3] = t.w;
        }
      } else {
#pragma unroll
        for (int c = 0; c < KC; ++c) vj[c] = vs[j * KC + c];
      }
      float sq[R];
      if constexpr (D > 0) {
        float xj[D];
#pragma unroll
        for (int m = 0; m < D; ++m) xj[m] = xc[m * TC + j];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          float s = 0.0f;
#pragma unroll
          for (int m = 0; m < D; ++m) {
            const float df = xi[r][m] - xj[m];
            s = fmaf(df, df, s);
          }
          sq[r] = s;
        }
      } else {
#pragma unroll
        for (int r = 0; r < R; ++r) sq[r] = 0.0f;
        for (int m = 0; m < dd; ++m) {
          const float xj = xc[m * TC + j];
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const float df = xr[m * ROWS + tx + r * TX] - xj;
            sq[r] = fmaf(df, df, sq[r]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float ev = expf(-sq[r]);
#pragma unroll
        for (int c = 0; c < KC; ++c) part[r][c] = fmaf(ev, vj[c], part[r][c]);
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int c = 0; c < KC; ++c) acc[r][c] += part[r][c];
  }

  __syncthreads();  // the staging tiles are free: red overlays them
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < KC; ++c) red[(ty * KC + c) * ROWS + r * TX + tx] = acc[r][c];
  __syncthreads();

  const float s = theta[0];
  const float s2 = s * s;
  for (int e = tid; e < KC * ROWS; e += NT) {
    const int c = e / ROWS;
    const int rr = e - c * ROWS;
    const int gi = row0 + rr;
    const int gc = c0 + c;
    float sum = 0.0f;
#pragma unroll
    for (int t = 0; t < TY; ++t) sum += red[(t * KC + c) * ROWS + rr];
    if (gi < n && gc < k) out[(size_t)gi * k + gc] = s2 * sum;
  }
}

template <int D, int KC>
int launch(const float* x, const float* theta, const float* v, float* out, int n, int d,
           int k, cudaStream_t stream) {
  const int dd = D > 0 ? D : d;
  const size_t region = (size_t)(dd * TC + TC * KC > TY * KC * ROWS ? dd * TC + TC * KC
                                                                    : TY * KC * ROWS);
  const size_t bytes = ((size_t)dd * ROWS + region + dd) * sizeof(float);
  auto kernel = rbf_gram_matvec_kernel<D, KC>;
  if (bytes > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((n + ROWS - 1) / ROWS, (k + KC - 1) / KC);
  kernel<<<grid, dim3(TX, TY), bytes, stream>>>(x, theta, v, out, n, d, k);
  return (int)cudaGetLastError();
}

template <int D>
int launch_k(const float* x, const float* theta, const float* v, float* out, int n, int d,
             int k, cudaStream_t stream) {
  if (k == 1) return launch<D, 1>(x, theta, v, out, n, d, k, stream);
  if (k <= 8) return launch<D, 8>(x, theta, v, out, n, d, k, stream);
  return launch<D, 16>(x, theta, v, out, n, d, k, stream);
}

}  // namespace

// x [n, d], theta [d + 1], v [n, k], out [n, k]: f32, contiguous, on the
// device of `stream`; n >= 1, 1 <= d <= 64, 1 <= k <= 16 * 65535.
// Returns cudaGetLastError() after the launch.
extern "C" int rbf_gram_matvec_f32(const void* x, const void* theta, const void* v, void* out,
                                   int n, int d, int k, void* stream) {
  const float* xf = (const float*)x;
  const float* tf = (const float*)theta;
  const float* vf = (const float*)v;
  float* of = (float*)out;
  cudaStream_t s = (cudaStream_t)stream;
  if (d == 2) return launch_k<2>(xf, tf, vf, of, n, d, k, s);
  return launch_k<0>(xf, tf, vf, of, n, d, k, s);
}
