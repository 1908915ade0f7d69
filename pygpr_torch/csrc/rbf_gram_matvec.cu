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
// What bounds it on an H100: operations.  2 n^2 (d + k) flops and n^2
// exponentials; at n = 32768, d = 2 that is 0.35 ms for k = 9 at the
// 67 TFLOP/s FP32 rate and 0.26 ms for the n^2 exponentials on the
// special-function units (16 a clock per SM), while the bytes (x, v read
// once, out written once) take microseconds.  In practice the pace is set
// by the instructions each pair costs: its distance, its exponential, k
// FMAs, and whatever loads and bookkeeping the design adds per pair.
//
// What the design does about it: two regimes behind one entry, chosen by
// the wrapper's plan (ops/matvec.py::plan), which passes the template
// width and the number of splits of the column sweep.
//
// The exponential.  The scaled coordinates are x l sqrt(log2 e), so that
// exp(-|(x_i - x_j) l|^2) = 2^(-|x_i' - x_j'|^2): one ex2.approx.ftz.f32
// (MUFU.EX2) a pair and no range reduction on the FMA pipe, where IEEE
// expf spends about 10 instructions around its MUFU.EX2.  Distances are direct
// differences of coordinates scaled by the same product, so the diagonal
// is exactly 2^0 = 1: no matrix-product trick, no clamp.  IEEE f32 FMAs
// throughout, no tensor cores.
//
// Narrow V (k <= 16): a 256-thread block owns 32 R rows (R = 8, or 2 at
// widths 12 and 16, as registers allow) and EVERY column of v, so each
// exponential is computed once per pair.  Widths 1, 5, 8, 9 (the iterative path's) have
// their own template, other k go to the next of 2, 4, 12, 16.  The block
// sweeps its span of column points in steps of 256: thread t copies point
// t's record (its coordinates and its row of v, padded to a multiple of
// 4 floats for float4 reads) by cp.async into one of two buffers while
// the previous step is computed, then scales its own coordinates in place.
// Lane l of warp w holds rows l + 32 r and takes points w, w + 8, ...: a
// point's record is read by broadcast once for R pairs.  A thread adds a
// step's terms into partial sums and those into running sums at the
// step's end (two levels: the rounding grows with the steps, not with
// all n terms), and the 8 warps' sums of a row are added in warp order.
//
// Wide V (k > 16): a GEMM whose A operand the block makes.  A block owns
// BM rows and BN columns of v (BN = 48 or 128, the plan's choice to keep
// padding low) and steps over column points 32 at a time.  v's
// [32, BN] tile and the points' coordinates come in through a 3-stage
// cp.async ring; each step the block writes the [32, BM] exponentials
// into shared memory, each computed once, and runs a register-tiled FFMA
// microkernel (TM rows x TN columns a thread: 8 x 8 at BN = 128, 4 x 6 at
// BN = 48; vector reads) on the two tiles, in the same two levels of
// sums.
//
// Both: when the rows alone give too few blocks to fill the card, the
// plan splits the column sweep over gridDim.z; each split writes its raw
// sums to a scratch [splits, n, k] and a second short launch adds them in
// split order and scales by s^2.  No atomics: two launches give the same
// bits.  The ragged edges of n and k are masked (zero-filled copies),
// never padded in memory.  s and l are read on the device, so a launch
// never waits on the host.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;     // threads a block, both regimes
constexpr int LS_PAD = 64;  // shared floats for the scales (d <= 64)

constexpr float COORD_SCALE = 1.2011224087864498f;  // sqrt(log2 e)
// 2^neg_sq: one MUFU.EX2, about 2 ulp; results below 2^-126 flush to 0
__device__ __forceinline__ float exp_of(float neg_sq) {
  float e;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(e) : "f"(neg_sq));
  return e;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
// BYTES from src into dst when ok, else BYTES of zeros (src is not read)
template <int BYTES>
__device__ __forceinline__ void cp_async(float* dst, const float* src, bool ok) {
  const int got = ok ? BYTES : 0;
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src), "r"(got)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(smem_u32(dst)), "l"(src), "n"(BYTES),
                 "r"(got)
                 : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---------------------------------------------------------------- narrow --

constexpr int TY = NT / 32;  // warps
constexpr int TC = NT;       // column points a step: one record a thread copies

template <int KC>
struct Narrow {
  static constexpr int R = KC <= 9 ? 8 : 2;               // rows a thread
  static constexpr int MINB = 2 * R * KC > 100 ? 1 : 2;  // blocks an SM, as registers allow
  static constexpr int ROWS = 32 * R;                    // rows a block
};

template <int D, int KC>
__global__ void __launch_bounds__(NT, Narrow<KC>::MINB)
rbf_gram_matvec_kernel_narrow(const float* __restrict__ x, const float* __restrict__ theta,
                              const float* __restrict__ v, float* __restrict__ out, int n, int d, int k,
                              int span) {
  constexpr int R = Narrow<KC>::R;
  constexpr int ROWS = Narrow<KC>::ROWS;
  extern __shared__ __align__(16) float smem[];
  const int dd = D > 0 ? D : d;
  const int W = (dd + KC + 3) & ~3;          // a record: dd coordinates, KC of v's row, padding
  float* sl = smem;                          // [dd] coordinate scales
  float* xr = smem + LS_PAD;                 // [dd][ROWS] this block's rows, scaled (D == 0)
  float* rec = xr + (D > 0 ? 0 : dd * ROWS);  // [2][TC][W] two steps' records
  float* red = rec;                          // [TY][KC][ROWS] the warps' sums, at the end

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int ty = tid >> 5;
  const int row0 = blockIdx.x * ROWS;
  const int jbeg = blockIdx.z * span;
  const int jend = min(n, jbeg + span);

  for (int m = tid; m < dd; m += NT) sl[m] = theta[1 + m] * COORD_SCALE;
  __syncthreads();
  float xi[R][D > 0 ? D : 1];
  if constexpr (D > 0) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int gi = row0 + lane + 32 * r;
#pragma unroll
      for (int m = 0; m < D; ++m) xi[r][m] = gi < n ? x[(size_t)gi * D + m] * sl[m] : 0.0f;
    }
  } else {
    for (int e = tid; e < dd * ROWS; e += NT) {
      const int m = e / ROWS;
      const int gi = row0 + e - m * ROWS;
      xr[e] = gi < n ? x[(size_t)gi * dd + m] * sl[m] : 0.0f;
    }
  }

  // thread t copies point j0 + t's record into buffer buf; points past the
  // span (the next split's, or past n) read as zeros
  auto stage = [&](int j0, int buf) {
    const int gj = j0 + tid;
    const bool ok = gj < jend;
    float* r = rec + (buf * TC + tid) * W;
    const float* xs = x + (ok ? (size_t)gj * dd : 0);
    const float* vs = v + (ok ? (size_t)gj * k : 0);
    if constexpr (D > 0) {
#pragma unroll
      for (int m = 0; m < D; ++m) cp_async<4>(r + m, xs + m, ok);
    } else {
      for (int m = 0; m < dd; ++m) cp_async<4>(r + m, xs + m, ok);
    }
#pragma unroll
    for (int c = 0; c < KC; ++c) cp_async<4>(r + dd + c, vs + (c < k ? c : 0), ok && c < k);
  };

  float acc[R][KC];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < KC; ++c) acc[r][c] = 0.0f;

  if (jbeg < jend) stage(jbeg, 0);
  cp_async_commit();
  int buf = 0;
  for (int j0 = jbeg; j0 < jend; j0 += TC) {
    if (j0 + TC < jend) stage(j0 + TC, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    {  // this thread's own copy has landed: scale its coordinates
      float* r = rec + (buf * TC + tid) * W;
      for (int m = 0; m < dd; ++m) r[m] *= sl[m];
    }
    __syncthreads();

    const float* rb = rec + buf * TC * W;
    float part[R][KC];  // this step's sums, added to acc at its end
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int c = 0; c < KC; ++c) part[r][c] = 0.0f;
#pragma unroll 4
    for (int jj = 0; jj < TC / TY; ++jj) {
      const float* p = rb + (ty + TY * jj) * W;  // the same for the whole warp: a broadcast
      float xj[D > 0 ? D : 1];
      float vj[KC];
      if constexpr (D > 0) {
        constexpr int W4 = (D + KC + 3) / 4;
        float f[4 * W4];
#pragma unroll
        for (int q = 0; q < W4; ++q) {
          const float4 t = reinterpret_cast<const float4*>(p)[q];
          f[4 * q] = t.x;
          f[4 * q + 1] = t.y;
          f[4 * q + 2] = t.z;
          f[4 * q + 3] = t.w;
        }
#pragma unroll
        for (int m = 0; m < D; ++m) xj[m] = f[m];
#pragma unroll
        for (int c = 0; c < KC; ++c) vj[c] = f[D + c];
      } else {
#pragma unroll
        for (int c = 0; c < KC; ++c) vj[c] = p[dd + c];
      }
      float sq[R];  // -|x_i' - x_j'|^2
      if constexpr (D > 0) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float df = xi[r][0] - xj[0];
          float s = -df * df;
#pragma unroll
          for (int m = 1; m < D; ++m) {
            const float dm = xi[r][m] - xj[m];
            s = fmaf(-dm, dm, s);
          }
          sq[r] = s;
        }
      } else {
#pragma unroll
        for (int r = 0; r < R; ++r) sq[r] = 0.0f;
        for (int m = 0; m < dd; ++m) {
          const float xm = p[m];
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const float df = xr[m * ROWS + lane + 32 * r] - xm;
            sq[r] = fmaf(-df, df, sq[r]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float ev = exp_of(sq[r]);
#pragma unroll
        for (int c = 0; c < KC; ++c) part[r][c] = fmaf(ev, vj[c], part[r][c]);
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int c = 0; c < KC; ++c) acc[r][c] += part[r][c];
    __syncthreads();  // every warp is done with this buffer before it is refilled
    buf ^= 1;
  }
  cp_async_wait<0>();
  __syncthreads();  // the record buffers are free: red overlays them

#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < KC; ++c) red[(ty * KC + c) * ROWS + lane + 32 * r] = acc[r][c];
  __syncthreads();

  const float s2 = gridDim.z == 1 ? theta[0] * theta[0] : 1.0f;
  float* dst = out + (size_t)blockIdx.z * n * k;
  for (int e = tid; e < ROWS * k; e += NT) {
    const int rr = e / k;
    const int c = e - rr * k;
    const int gi = row0 + rr;
    if (gi >= n) break;
    float sum = 0.0f;
#pragma unroll
    for (int t = 0; t < TY; ++t) sum += red[(t * KC + c) * ROWS + rr];
    dst[(size_t)gi * k + c] = s2 * sum;
  }
}

// ------------------------------------------------------------------ wide --

constexpr int BK = 32;     // column points a step
constexpr int STAGES = 3;  // cp.async ring

// TN columns a thread, read as TN / VW vectors of VW floats from segments
// BN / (TN / VW) apart (neighbouring lanes on neighbouring vectors: no
// bank conflicts)
template <int BN>
struct Wide;
template <>
struct Wide<128> {
  static constexpr int TM = 8, TN = 8, VW = 4;
};
template <>
struct Wide<48> {
  static constexpr int TM = 4, TN = 6, VW = 2;
};
template <int BN>
struct WideShape {
  static constexpr int TM = Wide<BN>::TM, TN = Wide<BN>::TN, VW = Wide<BN>::VW;
  static constexpr int NA = TM / 4;     // float4s a thread reads of a column of the exponentials
  static constexpr int ASEG = 4 * NT / (BN / TN);  // rows between them
  static constexpr int CG = BN / TN;    // column groups
  static constexpr int RG = NT / CG;    // row groups
  static constexpr int BM = TM * RG;    // rows a block
  static constexpr int NSEG = TN / VW;  // vectors a thread reads of a row of v's tile
  static constexpr int SEG = BN / NSEG;
};

// VEC: v's rows are 16-byte aligned (k % 4 == 0 and an aligned base), so
// its tile comes in 16 bytes a copy
template <int D, int BN, bool VEC>
__global__ void __launch_bounds__(NT, Wide<BN>::TM > 4 ? 1 : 2)
rbf_gram_matvec_kernel_wide(const float* __restrict__ x, const float* __restrict__ theta,
                            const float* __restrict__ v, float* __restrict__ out, int n, int d, int k,
                            int span) {
  using S = WideShape<BN>;
  constexpr int TM = S::TM, TN = S::TN, VW = S::VW, CG = S::CG, BM = S::BM, NSEG = S::NSEG, SEG = S::SEG;
  constexpr int NA = S::NA, ASEG = S::ASEG;
  constexpr int GJ = NT / BM;   // groups of points a step's exponentials are made in
  constexpr int GQ = BK / GJ;   // exponentials a thread a step
  extern __shared__ __align__(16) float smem[];
  const int dd = D > 0 ? D : d;
  float* sl = smem;                      // [dd] coordinate scales
  float* Es = smem + LS_PAD;             // [BK][BM] this step's exponentials
  float* Vs = Es + BK * BM;              // [STAGES][BK][BN] v's tiles
  float* Xs = Vs + STAGES * BK * BN;     // [STAGES][BK][dd] the points' coordinates
  float* xr = Xs + STAGES * BK * dd;     // [dd][BM] this block's rows, scaled (D == 0)

  const int tid = threadIdx.x;
  const int tx = tid % CG;
  const int ty = tid / CG;
  const int row0 = blockIdx.x * BM;
  const int c0 = blockIdx.y * BN;
  const int jbeg = blockIdx.z * span;
  const int jend = min(n, jbeg + span);
  const int steps = jend > jbeg ? (jend - jbeg + BK - 1) / BK : 0;

  for (int m = tid; m < dd; m += NT) sl[m] = theta[1 + m] * COORD_SCALE;
  __syncthreads();
  // the exponentials: thread t makes rows gr's entries for points gj + GJ q
  const int gr = tid % BM;
  const int gj = tid / BM;
  float xg[D > 0 ? D : 1];
  if constexpr (D > 0) {
    const int gi = row0 + gr;
#pragma unroll
    for (int m = 0; m < D; ++m) xg[m] = gi < n ? x[(size_t)gi * D + m] * sl[m] : 0.0f;
  } else {
    for (int e = tid; e < dd * BM; e += NT) {
      const int m = e / BM;
      const int gi = row0 + e - m * BM;
      xr[e] = gi < n ? x[(size_t)gi * dd + m] * sl[m] : 0.0f;
    }
  }

  auto load = [&](int stage, int j0) {
    float* vs = Vs + stage * BK * BN;
    if constexpr (VEC) {
#pragma unroll
      for (int q = 0; q < (BK * BN / 4 + NT - 1) / NT; ++q) {
        const int f = tid + q * NT;
        if (f >= BK * BN / 4) break;
        const int kk = f / (BN / 4);
        const int c = 4 * (f - kk * (BN / 4));
        const bool ok = j0 + kk < jend && c0 + c < k;
        cp_async<16>(vs + kk * BN + c, v + (ok ? (size_t)(j0 + kk) * k + c0 + c : 0), ok);
      }
    } else {
#pragma unroll
      for (int q = 0; q < (BK * BN + NT - 1) / NT; ++q) {
        const int f = tid + q * NT;
        if (f >= BK * BN) break;
        const int kk = f / BN;
        const int c = f - kk * BN;
        const bool ok = j0 + kk < jend && c0 + c < k;
        cp_async<4>(vs + kk * BN + c, v + (ok ? (size_t)(j0 + kk) * k + c0 + c : 0), ok);
      }
    }
    float* xs = Xs + stage * BK * dd;
    for (int f = tid; f < BK * dd; f += NT) {
      const bool ok = j0 + f / dd < jend;
      cp_async<4>(xs + f, x + (ok ? (size_t)j0 * dd + f : 0), ok);
    }
  };

  float acc[TM][TN];
#pragma unroll
  for (int u = 0; u < TM; ++u)
#pragma unroll
    for (int t = 0; t < TN; ++t) acc[u][t] = 0.0f;

  if (steps > 0) load(0, jbeg);
  cp_async_commit();
  if (steps > 1) load(1, jbeg + BK);
  cp_async_commit();

#pragma unroll 1
  for (int s = 0; s < steps; ++s) {
    const int stage = s % STAGES;
    cp_async_wait<1>();  // this thread's copies of step s have landed
    float* xs = Xs + stage * BK * dd;
    for (int f = tid; f < BK * dd; f += NT) xs[f] *= sl[f % dd];
    // step s is visible to all, and step s - 1 is done with Es and with the
    // slot that step s + 2 fills
    __syncthreads();
    if (s + 2 < steps) load((s + 2) % STAGES, jbeg + (s + 2) * BK);
    cp_async_commit();

#pragma unroll
    for (int q = 0; q < GQ; ++q) {
      const int jl = gj + GJ * q;
      const float* p = xs + jl * dd;  // the same for the whole warp: a broadcast
      float sq;
      if constexpr (D > 0) {
        const float df = xg[0] - p[0];
        sq = -df * df;
#pragma unroll
        for (int m = 1; m < D; ++m) {
          const float dm = xg[m] - p[m];
          sq = fmaf(-dm, dm, sq);
        }
      } else {
        sq = 0.0f;
        for (int m = 0; m < dd; ++m) {
          const float df = xr[m * BM + gr] - p[m];
          sq = fmaf(-df, df, sq);
        }
      }
      Es[jl * BM + gr] = exp_of(sq);
    }
    __syncthreads();

    const float* vs = Vs + stage * BK * BN;
    float part[TM][TN];  // this step's sums, added to acc at its end
#pragma unroll
    for (int u = 0; u < TM; ++u)
#pragma unroll
      for (int t = 0; t < TN; ++t) part[u][t] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM];
#pragma unroll
      for (int g = 0; g < NA; ++g) {
        const float4 t = *reinterpret_cast<const float4*>(Es + kk * BM + g * ASEG + 4 * ty);
        a[4 * g] = t.x;
        a[4 * g + 1] = t.y;
        a[4 * g + 2] = t.z;
        a[4 * g + 3] = t.w;
      }
      float b[TN];
#pragma unroll
      for (int g = 0; g < NSEG; ++g) {
        const float* bp = vs + kk * BN + g * SEG + VW * tx;
        if constexpr (VW == 4) {
          const float4 t = *reinterpret_cast<const float4*>(bp);
          b[4 * g] = t.x;
          b[4 * g + 1] = t.y;
          b[4 * g + 2] = t.z;
          b[4 * g + 3] = t.w;
        } else {
          const float2 t = *reinterpret_cast<const float2*>(bp);
          b[2 * g] = t.x;
          b[2 * g + 1] = t.y;
        }
      }
#pragma unroll
      for (int u = 0; u < TM; ++u)
#pragma unroll
        for (int t = 0; t < TN; ++t) part[u][t] = fmaf(a[u], b[t], part[u][t]);
    }
#pragma unroll
    for (int u = 0; u < TM; ++u)
#pragma unroll
      for (int t = 0; t < TN; ++t) acc[u][t] += part[u][t];
  }
  cp_async_wait<0>();

  const float s2 = gridDim.z == 1 ? theta[0] * theta[0] : 1.0f;
  float* dst = out + (size_t)blockIdx.z * n * k;
#pragma unroll
  for (int u = 0; u < TM; ++u) {
    const int gi = row0 + (u / 4) * ASEG + 4 * ty + u % 4;
    if (gi >= n) continue;
#pragma unroll
    for (int g = 0; g < NSEG; ++g)
#pragma unroll
      for (int w = 0; w < VW; ++w) {
        const int gc = c0 + g * SEG + VW * tx + w;
        if (gc < k) dst[(size_t)gi * k + gc] = s2 * acc[u][g * VW + w];
      }
  }
}

// ------------------------------------------------------------------ sums --

// out = s^2 * sum over the splits of part[split], in split order
__global__ void __launch_bounds__(NT)
rbf_gram_matvec_kernel_sum(const float* __restrict__ part, const float* __restrict__ theta,
                           float* __restrict__ out, size_t nk, int splits) {
  const float s = theta[0];
  const float s2 = s * s;
  for (size_t e = (size_t)blockIdx.x * NT + threadIdx.x; e < nk; e += (size_t)gridDim.x * NT) {
    float sum = part[e];
    for (int b = 1; b < splits; ++b) sum += part[(size_t)b * nk + e];
    out[e] = s2 * sum;
  }
}

// ---------------------------------------------------------------- launch --

int set_smem(const void* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// the first point of each split is a multiple of `step`
int span_of(int n, int splits, int step) {
  const int per = (n + splits - 1) / splits;
  return (per + step - 1) / step * step;
}

template <int D, int KC>
int launch_narrow(const float* x, const float* th, const float* v, float* dst, int n, int d, int k, int splits,
                  cudaStream_t stream) {
  constexpr int ROWS = Narrow<KC>::ROWS;
  const int dd = D > 0 ? D : d;
  const size_t W = (size_t)((dd + KC + 3) & ~3);
  const size_t recs = 2 * TC * W;
  const size_t red = (size_t)TY * KC * ROWS;
  const size_t bytes = sizeof(float) * (LS_PAD + (D > 0 ? 0 : (size_t)dd * ROWS) + (recs > red ? recs : red));
  auto kernel = rbf_gram_matvec_kernel_narrow<D, KC>;
  const int err = set_smem((const void*)kernel, bytes);
  if (err) return err;
  const dim3 grid((n + ROWS - 1) / ROWS, 1, splits);
  kernel<<<grid, NT, bytes, stream>>>(x, th, v, dst, n, d, k, span_of(n, splits, TC));
  return (int)cudaGetLastError();
}

template <int D, int BN, bool VEC>
int launch_wide(const float* x, const float* th, const float* v, float* dst, int n, int d, int k, int splits,
                cudaStream_t stream) {
  constexpr int BM = WideShape<BN>::BM;
  const size_t dd = D > 0 ? D : d;
  const size_t bytes = sizeof(float) * (LS_PAD + BK * BM + STAGES * BK * BN + STAGES * BK * dd +
                                        (D > 0 ? 0 : dd * BM));
  auto kernel = rbf_gram_matvec_kernel_wide<D, BN, VEC>;
  const int err = set_smem((const void*)kernel, bytes);
  if (err) return err;
  const dim3 grid((n + BM - 1) / BM, (k + BN - 1) / BN, splits);
  kernel<<<grid, NT, bytes, stream>>>(x, th, v, dst, n, d, k, span_of(n, splits, BK));
  return (int)cudaGetLastError();
}

// Every template the kernel instantiates, in one list: calls f(Width<W>{})
// for width W, or returns cudaErrorInvalidValue for another width
template <int W>
struct Width {
  static constexpr int value = W;
  static constexpr bool wide = W > 16;
};
template <class F>
int with_template(int width, F&& f) {
  switch (width) {
    case 1: return f(Width<1>{});
    case 2: return f(Width<2>{});
    case 4: return f(Width<4>{});
    case 5: return f(Width<5>{});
    case 8: return f(Width<8>{});
    case 9: return f(Width<9>{});
    case 12: return f(Width<12>{});
    case 16: return f(Width<16>{});
    case 48: return f(Width<48>{});
    case 128: return f(Width<128>{});
    default: return (int)cudaErrorInvalidValue;
  }
}

template <int D>
int launch_width(const float* x, const float* th, const float* v, float* dst, int n, int d, int k, int width,
                 int splits, cudaStream_t stream) {
  return with_template(width, [&](auto w) {
    constexpr int W = decltype(w)::value;
    if constexpr (!decltype(w)::wide) {
      if (k > W) return (int)cudaErrorInvalidValue;
      return launch_narrow<D, W>(x, th, v, dst, n, d, k, splits, stream);
    } else {
      if (k <= 16) return (int)cudaErrorInvalidValue;
      const bool vec = D == 2 && k % 4 == 0 && ((uintptr_t)v & 15) == 0;
      return vec ? launch_wide<D, W, D == 2>(x, th, v, dst, n, d, k, splits, stream)
                 : launch_wide<D, W, false>(x, th, v, dst, n, d, k, splits, stream);
    }
  });
}

}  // namespace

// x [n, d], theta [d + 1], v [n, k], out [n, k]: f32, contiguous, on the
// device of `stream`; n >= 1, 1 <= d <= 64, k >= 1.  width: the template
// (narrow: 1, 2, 4, 5, 8, 9, 12 or 16, at least k; wide, for k > 16: 48
// or 128 columns a block); splits >= 1 parts of the column sweep, and
// when splits > 1 a scratch part [splits, n, k].  Returns
// cudaGetLastError() after the launches, or cudaErrorInvalidValue for a
// width or split the kernel does not take.
extern "C" int rbf_gram_matvec_f32(const void* x, const void* theta, const void* v, void* out, void* part,
                                   int n, int d, int k, int width, int splits, void* stream) {
  const float* xf = (const float*)x;
  const float* tf = (const float*)theta;
  const float* vf = (const float*)v;
  cudaStream_t s = (cudaStream_t)stream;
  if (splits < 1 || splits > 65535 || (splits > 1 && part == nullptr)) return (int)cudaErrorInvalidValue;
  float* dst = splits > 1 ? (float*)part : (float*)out;
  const int err = d == 2 ? launch_width<2>(xf, tf, vf, dst, n, d, k, width, splits, s)
                         : launch_width<0>(xf, tf, vf, dst, n, d, k, width, splits, s);
  if (err || splits == 1) return err;
  const size_t nk = (size_t)n * k;
  const size_t want = (nk + NT - 1) / NT;
  const int blocks = (int)(want < 4096 ? want : 4096);
  rbf_gram_matvec_kernel_sum<<<blocks, NT, 0, s>>>((const float*)part, tf, (float*)out, nk, splits);
  return (int)cudaGetLastError();
}

// The launch geometry of template `width` (as rbf_gram_matvec_f32 takes
// it): geom[0] the rows a block, geom[1] the column points a step of the
// sweep.  Returns 0, or cudaErrorInvalidValue for a width the kernel does
// not instantiate.  The wrapper's plan (ops/matvec.py) is held against
// this before its first launch.
extern "C" int rbf_gram_matvec_geometry(int width, int* geom) {
  return with_template(width, [&](auto w) {
    constexpr int W = decltype(w)::value;
    if constexpr (decltype(w)::wide) {
      geom[0] = WideShape<W>::BM;
      geom[1] = BK;
    } else {
      geom[0] = Narrow<W>::ROWS;
      geom[1] = TC;
    }
    return 0;
  });
}
