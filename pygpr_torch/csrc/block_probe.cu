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
//   micro_cholesky_blocks_f32 (K5): the lower factor L of each block
//     (A = L L^T) from its lower triangle, exact zeros above the diagonal.
//     A non-positive pivot gives sqrtf's NaN (or a division by 0), which is
//     not guarded and spreads through the rest of its block and no other.
//   tri_inverse_blocks_f32 (K6): T = L^-1 of each block from its lower
//     triangle (the values above the diagonal are never used), exact zeros
//     above the diagonal.  The strips have no padding rows, so unlike _tri_inverse
//     there is no guard that turns a zero pivot into 1: a zero pivot gives
//     inf or NaN.
//
// What bounds them on an H100: latency.  Each kernel moves 2 P 128^2 4
// bytes (read the strip, write the result: 2.5 us at P = 64 and 3.35 TB/s)
// and does P 128^3 / 3 flops (0.7 us at P = 64 and the 67 TFLOP/s FP32
// rate), but a block's 128 pivots depend on each other in order (K5), and
// K6's solves and products on the ones before them.  The P blocks run in
// parallel (up to 132 SMs), so a strip takes about one block's chain,
// whatever P.
//
// What K5's design does about the chain: the block is factored as 4 panels
// of 32 columns, right-looking (csrc/small_chol.cuh).  For each panel one
// warp factors the 32x32 diagonal tile in its registers (its 32 pivots pass
// values by shuffles, with no barrier between them), the next warps solve
// the up to 96 rows below it one row a lane, and all 256 threads apply
// the rank-32 update to the trailing lower triangle, 4x4 outputs a
// thread: three block barriers a panel.
// The block sits in dynamic shared memory column-major (S[k * 132 + i] =
// A[i][k], 66 KiB), so a lane reading its row and a warp reading a
// factor's column both hit distinct banks or broadcasts, and the 4-float
// pad lets 4x4 transposing copies move the block in and each panel's
// finished columns out as whole 128-byte rows, without bank conflicts.
//
// K6 runs the blocked inverse that K2 applies to each diagonal block of its
// sweep (invert_block, csrc/block_inverse.cuh), 256 threads a block: the
// block goes to shared memory column-major with exact zeros above its
// diagonal, the pivots' reciprocals beside it; four warps solve the four
// 32x32 diagonal tiles at once (32 dependent steps, a multiplication by a
// reciprocal each, no division on the chain), then two levels of small
// FFMA products join them into the 64x64 halves and the whole.  No tensor
// cores, no TMA: IEEE f32 throughout.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "block_inverse.cuh"
#include "small_chol.cuh"

namespace {

using namespace small_chol;

constexpr int BS = 128;        // block width; B in pallas_cholesky.py
constexpr int LDB = BS + 4;     // column stride of the factorization's block
constexpr int TW = 32;          // panel width: one warp's tile
constexpr int CHOL_THREADS = 256;
constexpr int TINV_THREADS = INV_THREADS;
constexpr size_t CHOL_SMEM = (size_t)BS * LDB * sizeof(float);
constexpr size_t TINV_SMEM = (size_t)(BS * INV_LD + INV_SCRATCH + BS) * sizeof(float);
static_assert(BS == INV_N, "K6 inverts the blocks of block_inverse.cuh");

__global__ void __launch_bounds__(CHOL_THREADS)
micro_cholesky_blocks_kernel(const float* __restrict__ in, float* __restrict__ out) {
  extern __shared__ __align__(16) float chol_smem[];
  float* S = chol_smem;  // column-major: S[k * LDB + i] = A[i][k]
  const float* A = in + (size_t)blockIdx.x * BS * BS;
  float* Lo = out + (size_t)blockIdx.x * BS * BS;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  // this thread's 4x4 blocks: a warp takes 8 neighbouring column groups
  // and 4 neighbouring row groups (load_4x4_t)
  const int kg = (lane & 7) + 8 * (warp & 3);

  for (int it = 0; it < 4; ++it) {
    const int rg = (lane >> 3) + 4 * (warp >> 2) + 8 * it;
    load_4x4_t<LDB>(S, A, BS, rg, kg);
    if (kg / 8 > rg / 8)  // right of the diagonal tiles: L's zeros now
#pragma unroll
      for (int u = 0; u < 4; ++u)
        *reinterpret_cast<float4*>(Lo + (size_t)(4 * rg + u) * BS + 4 * kg) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  __syncthreads();

  float x[32];
  for (int c0 = 0; c0 < BS; c0 += TW) {
    float* P = S + c0 * LDB;  // the panel's 32 columns
    if (warp == 0) factor_tile32<LDB>(P + c0, x);
    __syncthreads();
    const int r = c0 + TW * warp + lane;  // warps 1, 2, ...: the rows below
    if (warp > 0 && r < BS) solve_row32<LDB>(P, r, P + c0, x);
    __syncthreads();
    // the panel's finished columns to device memory, rows c0..127
    const int rg = c0 / 4 + (lane >> 3) + 4 * warp;
    if (rg < BS / 4) store_4x4_t<LDB>(Lo, BS, S, rg, c0 / 4 + (lane & 7), true);
    // A[i][k] -= sum_m L[i][c0 + m] L[k][c0 + m] over the trailing lower
    // triangle (rows and columns r0..127), a 4x4 tile a thread
    const int r0 = c0 + TW;
    const int t4 = (BS - r0) / 4;
    for (int e = tid; e < t4 * (t4 + 1) / 2; e += CHOL_THREADS) {
      int ti, tk;
      lower_tile(e, ti, tk);
      update32_4x4<LDB>(S + (size_t)(r0 + 4 * tk) * LDB + r0 + 4 * ti, P + r0 + 4 * ti, P + r0 + 4 * tk);
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(TINV_THREADS)
tri_inverse_blocks_kernel(const float* __restrict__ in, float* __restrict__ out) {
  extern __shared__ __align__(16) float tinv_smem[];
  float* Dm = tinv_smem;           // column-major: Dm[k * INV_LD + i] = L[i][k], zeros above
  float* S = Dm + BS * INV_LD;     // invert_block's scratch
  float* rcp = S + INV_SCRATCH;    // rcp[i] = 1 / L[i][i]
  const float* A = in + (size_t)blockIdx.x * BS * BS;
  float* T = out + (size_t)blockIdx.x * BS * BS;
  const int tid = threadIdx.x;
  // the lower triangle, transposed as load_4x4_t copies it; every entry
  // above the diagonal is written as an exact zero and never read
  for (int e = tid; e < 32 * 32; e += TINV_THREADS) {
    int rg, kg;
    block_of(e, rg, kg);
    float c[4][4];  // c[u][q] = L[4 rg + u][4 kg + q]
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (kg <= rg) v = *reinterpret_cast<const float4*>(A + (size_t)(4 * rg + u) * BS + 4 * kg);
      c[u][0] = v.x;
      c[u][1] = v.y;
      c[u][2] = v.z;
      c[u][3] = v.w;
    }
    float* s = Dm + 4 * kg * INV_LD + 4 * rg;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float w[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) w[u] = 4 * kg + q > 4 * rg + u ? 0.0f : c[u][q];
      *reinterpret_cast<float4*>(s + q * INV_LD) = make_float4(w[0], w[1], w[2], w[3]);
    }
  }
  __syncthreads();
  if (tid < BS) rcp[tid] = 1.0f / Dm[tid * INV_LD + tid];
  __syncthreads();
  invert_block(Dm, S, rcp);
  for (int e = tid; e < 32 * 32; e += TINV_THREADS) {
    int rg, kg;
    block_of(e, rg, kg);
    store_4x4_t<INV_LD>(T, BS, Dm, rg, kg, true);
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
