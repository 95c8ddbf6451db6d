// K10: a compute-bound GEMM and a memory-bound reduction in ONE launch,
//   c (M, N) = x (M, K) @ y (K, N)
//   r (C,)   = sum over the R rows of silu(z (R, C))
//
// Replaces the TPU kernel repro/kernels/fused_branches.py::_fused_kernel
// (launcher fused_gemm_reduce): the ``fused`` plan mode, the paper's
// intra-SM co-location of a compute-bound kernel with a memory-bound one
// (Table 1), where the reduction's bytes ride under the GEMM's
// arithmetic.
//
// Design.  The TPU kernel walks a (M/bm, N/bn, K/bk) grid in order on one
// core, carries the GEMM accumulator across the K axis, and hands each
// grid step the next slice of z, whose per-slice column sums its wrapper
// adds.  Hopper runs CTAs concurrently and in no order, so here each CTA
// owns one 128 x 128 tile of c (the reference's 128-blocks, K4's
// ``large_tile`` tile) and loops over all of K itself (rt::tile_gemm).
// Each CTA also owns a fixed contiguous share of
// z's rows, ceil(R / #CTAs) of them.  Threads walk z's columns in
// neighbouring order (a row is read coalesced); with C < 256 the block's
// threads form 256 / C row lanes.  At every k-step, after the step's
// tiles are loaded, each lane issues the load of its next row of the
// share into registers and adds the silu of the row it loaded one k-step
// earlier, so a z load is in flight under a whole k-step of FMAs and the
// block's barrier never waits for it; rows left after the last k-step (or
// every row when K is 0) are reduced after the loop.  The lanes'
// per-column sums are added in lane order at the end.  Each
// CTA writes its C column sums into its own row of a (#CTAs, C) f32
// workspace and the wrapper sums the rows in a fixed order, as the
// reference's wrapper sums its per-step rows.  No atomics: results repeat
// bit for bit.  Rows past R are never read (the reference pads z with
// zeros, and silu(0) = 0).  C is at most 4 * 256 columns.
//
// Bound on this card: the reference's co-execution shape (2048^3 GEMM
// beside a 65536 x 128 reduction) is operation-bound (17.2 GFLOP against
// 84 MB); this first design runs f32 FMA on the CUDA cores.
#include "tile_gemm.cuh"

namespace {

constexpr int MAXQ = 4;   // z columns a thread owns: C <= MAXQ * NT

struct FusedArgs {
  const float* x;   // (M, K) row-major
  const float* y;   // (K, N) row-major
  const float* z;   // (R, C) row-major
  float* c;         // (M, N) row-major
  float* part;      // (#CTAs, C): each CTA's column sums of silu(z)
  int m, n, k, r, cz, rows_per_cta;
};

__device__ __forceinline__ float silu(float v) {
  return v / (1.f + expf(-v));
}

// the c tile, and the outputs one thread owns
constexpr int TILE_M = 128, TILE_N = 128, THR_M = 8, THR_N = 8;
static_assert((TILE_M / THR_M) * (TILE_N / THR_N) == rt::NT,
              "256 threads a CTA");

// Q_: z columns a thread owns (1 when C <= NT, else MAXQ), so that the
// common case spends no registers on columns it does not have.  At least
// two CTAs an SM, as K4's 128 x 128 tile gets (the z share's registers
// would otherwise push it past 128 registers and to one CTA an SM).
template <int Q_>
__global__ void __launch_bounds__(rt::NT, 2) fused_kernel(FusedArgs p) {
  const int n0 = blockIdx.x * TILE_N;
  const int m0 = blockIdx.y * TILE_M;
  const int cta = blockIdx.y * gridDim.x + blockIdx.x;
  const float* __restrict__ x = p.x;
  const float* __restrict__ y = p.y;
  const float* __restrict__ z = p.z;
  const int M = p.m, N = p.n, K = p.k, C = p.cz;
  const int tid = threadIdx.x;

  // this CTA's share of z: rows [r0, r1)
  const long long lo = (long long)cta * p.rows_per_cta;
  const int r0 = lo < p.r ? (int)lo : p.r;
  const int r1 = min(p.r, r0 + p.rows_per_cta);
  const int cw = C < rt::NT ? C : rt::NT;   // columns one lane covers
  const int lanes = rt::NT / cw;
  const int lane = tid / cw;
  const int col = tid % cw;
  const bool active = lane < lanes;
  float zacc[Q_], pend[Q_];
#pragma unroll
  for (int q = 0; q < Q_; ++q) zacc[q] = pend[q] = 0.f;
  // pend holds row ``next - lanes + lane`` (zeros where that row is not
  // this lane's or lies past the share; silu(0) = 0)
  int next = r0;   // first row of the share whose load is not issued
  auto add_pending = [&]() {
#pragma unroll
    for (int q = 0; q < Q_; ++q)
      if (col + q * cw < C) zacc[q] += silu(pend[q]);
  };
  auto step = [&](int) {
    if (next >= r1) return;
    add_pending();
    const int row = next + lane;
    const bool live = active && row < r1;
    const float* __restrict__ zr = z + (size_t)row * C;
#pragma unroll
    for (int q = 0; q < Q_; ++q) {
      const int cc = col + q * cw;
      pend[q] = (live && cc < C) ? zr[cc] : 0.f;
    }
    next += lanes;
  };

  auto load_a = [&](int r, int kk) -> float {
    const int gr = m0 + r;
    return (gr < M && kk < K) ? x[(size_t)gr * K + kk] : 0.f;
  };
  auto load_b = [&](int kk, int c) -> float {
    const int gc = n0 + c;
    return (kk < K && gc < N) ? y[(size_t)kk * N + gc] : 0.f;
  };
  float acc[THR_M][THR_N];
#pragma unroll
  for (int i = 0; i < THR_M; ++i)
#pragma unroll
    for (int j = 0; j < THR_N; ++j) acc[i][j] = 0.f;
  rt::tile_gemm<TILE_M, TILE_N, THR_M, THR_N, true, true>(acc, K, load_a,
                                                          load_b, step);
  add_pending();
  if (active) {
    for (int row = next + lane; row < r1; row += lanes) {
      const float* __restrict__ zr = z + (size_t)row * C;
#pragma unroll
      for (int q = 0; q < Q_; ++q) {
        const int cc = col + q * cw;
        if (cc < C) zacc[q] += silu(zr[cc]);
      }
    }
  }

  const int tx = tid % (TILE_N / THR_N);
  const int ty = tid / (TILE_N / THR_N);
#pragma unroll
  for (int i = 0; i < THR_M; ++i) {
    const int r = m0 + ty * THR_M + i;
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < THR_N; ++j) {
      const int cc = n0 + tx * THR_N + j;
      if (cc < N) p.c[(size_t)r * N + cc] = acc[i][j];
    }
  }

  float* __restrict__ part = p.part + (size_t)cta * C;
  if (lanes == 1) {
#pragma unroll
    for (int q = 0; q < Q_; ++q) {
      const int cc = col + q * cw;
      if (cc < C) part[cc] = zacc[q];
    }
  } else {
    // C < NT: add the lanes' sums of each column in lane order
    __shared__ float red[rt::NT];
    red[tid] = zacc[0];
    __syncthreads();
    if (tid < C) {
      float s = 0.f;
      for (int l = 0; l < lanes; ++l) s += red[l * C + tid];
      part[tid] = s;
    }
  }
}

}  // namespace

// part: (ceil(n / 128) * ceil(m / 128), cz) f32 workspace;
// rows_per_cta = ceil(r / that CTA count).
extern "C" int rt_fused_gemm_reduce(const void* x, const void* y,
                                    const void* z, void* c, void* part,
                                    int m, int n, int k, int r, int cz,
                                    int rows_per_cta, void* stream) {
  FusedArgs p;
  p.x = static_cast<const float*>(x);
  p.y = static_cast<const float*>(y);
  p.z = static_cast<const float*>(z);
  p.c = static_cast<float*>(c);
  p.part = static_cast<float*>(part);
  p.m = m;
  p.n = n;
  p.k = k;
  p.r = r;
  p.cz = cz;
  p.rows_per_cta = rows_per_cta;
  if (m <= 0 || n <= 0) return (int)cudaErrorInvalidValue;
  if (cz < 1 || cz > MAXQ * rt::NT) return (int)cudaErrorInvalidValue;
  const dim3 grid((n + TILE_N - 1) / TILE_N, (m + TILE_M - 1) / TILE_M);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cz > rt::NT)
    fused_kernel<MAXQ><<<grid, rt::NT, 0, s>>>(p);
  else
    fused_kernel<1><<<grid, rt::NT, 0, s>>>(p);
  return (int)cudaGetLastError();
}
