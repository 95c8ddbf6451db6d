// K5: the whole backward of a grouped branch launch in ONE launch.
//
// Replaces the TPU kernel
// repro/kernels/grouped_matmul.py::_gmm_bwd_kernel (launcher
// grouped_matmul_bwd, table _plan_tiles_bwd): for G branches sharing M
// with ragged (K_g, N_g), with dym_g = dy_g where mask_g > 0, else 0,
//   dx_g = dym_g @ w_g^T      (M, K_g)
//   dw_g = x_g^T @ dym_g      (K_g, N_g)
//   db_g = sum_M dym_g        (N_g,)
// It is the backward of K1 and K2 (kernels/ops.py's autograd Functions).
//
// Design.  The TPU kernel walks one flattened in-order grid of steps (all
// dx steps, then all dw steps) and carries the accumulator from step to
// step; that order does not exist on Hopper.  Here the table has ONE
// entry per OUTPUT TILE, (kind, g, i, j), and each CTA loops over its own
// contraction:
//   dw entries (kind 1): 64 x 64 tile (k-block i, n-block j) of dw_g,
//     looping over all of M; the k-block-0 CTA of each n-block also sums
//     db over masked dy in the same loop (each of its threads loads one
//     tile column, so it keeps a private partial sum per column; four
//     partials per column are added in a fixed order at the end);
//   dx entries (kind 0): 64 x 64 tile (m-block i, k-block j) of dx_g,
//     looping over N_g.
// The long dw entries come first in the table, so they start first.
// dy is masked as it loads (the reference folds the ReLU mask into its
// dy packing), and read in place through a row stride, so a concat's
// joint cotangent is never split into copies.  No atomics: every output
// element has one owner, and results repeat bit for bit.
//
// Bound on this card: at the training shapes (M up to 25088, K up to
// 864, N up to 384) each launch is operation-bound on paper; this first
// design runs f32 FMA on the CUDA cores, and a dw tile's M-long loop is
// one CTA's work (a group has tens of dw tiles), so few SMs carry the
// dw half.  Split-M dw with a second reduction pass, and tensor cores,
// are later work.
#include "tile_gemm.cuh"

namespace {

constexpr int MAXG = 8;
static_assert(rt::NT % rt::BN == 0,
              "db relies on each thread loading one fixed tile column");

struct BwdArgs {
  const float* x[MAXG];     // (M, K_g) contiguous: forward lhs
  const float* w[MAXG];     // (K_g, N_g) contiguous
  const float* dy[MAXG];    // (M, N_g), row stride lddy[g]
  const float* mask[MAXG];  // (M, N_g), row stride ldm[g]; null: no mask
  float* dx[MAXG];          // (M, K_g) contiguous
  float* dw[MAXG];          // (K_g, N_g) contiguous
  float* db[MAXG];          // (N_g,)
  int k[MAXG];
  int n[MAXG];
  int lddy[MAXG];
  int ldm[MAXG];
  const int* tiles;         // per output tile: (kind, g, i, j)
  int m;
};

__device__ __forceinline__ float masked_dy(const BwdArgs& a, int g, int r,
                                           int c) {
  const float v = a.dy[g][(size_t)r * a.lddy[g] + c];
  const float* mk = a.mask[g];
  // dy where mask > 0, else 0 (a NaN mask zeroes, as mask > 0 is false)
  return (mk == nullptr || mk[(size_t)r * a.ldm[g] + c] > 0.f) ? v : 0.f;
}

__global__ void __launch_bounds__(rt::NT) gmm_bwd_kernel(BwdArgs a) {
  const int* t = a.tiles + 4 * blockIdx.x;
  const int kind = t[0];
  const int g = t[1];
  const int i0 = t[2] * rt::BM;
  const int j0 = t[3] * rt::BN;
  const int M = a.m;
  const int K = a.k[g];
  const int N = a.n[g];
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;

  float acc[rt::TM][rt::TN];
#pragma unroll
  for (int i = 0; i < rt::TM; ++i)
#pragma unroll
    for (int j = 0; j < rt::TN; ++j) acc[i][j] = 0.f;

  if (kind == 1) {
    // dw tile: rows i0.. over K_g, columns j0.. over N_g, depth M
    const float* __restrict__ x = a.x[g];
    const bool do_db = (i0 == 0);
    float dbp = 0.f;
    auto load_a = [&](int r, int kk) -> float {       // x^T, k-major
      const int gk = i0 + r;
      return (gk < K && kk < M) ? x[(size_t)kk * K + gk] : 0.f;
    };
    auto load_b = [&](int kk, int c) -> float {       // masked dy
      const int gc = j0 + c;
      const float v = (kk < M && gc < N) ? masked_dy(a, g, kk, gc) : 0.f;
      dbp += v;
      return v;
    };
    rt::tile_gemm<rt::BM, rt::BN, rt::TM, rt::TN, false, true>(
        acc, M, load_a, load_b);
    float* __restrict__ dw = a.dw[g];
#pragma unroll
    for (int i = 0; i < rt::TM; ++i) {
      const int r = i0 + ty * rt::TM + i;
      if (r >= K) continue;
#pragma unroll
      for (int j = 0; j < rt::TN; ++j) {
        const int c = j0 + tx * rt::TN + j;
        if (c < N) dw[(size_t)r * N + c] = acc[i][j];
      }
    }
    if (do_db) {
      // thread tid loaded tile column tid % BN at every k-step; add the
      // NT / BN partials of each column in thread order
      __shared__ float part[rt::NT];
      part[threadIdx.x] = dbp;
      __syncthreads();
      if (threadIdx.x < rt::BN) {
        float s = 0.f;
#pragma unroll
        for (int q = 0; q < rt::NT / rt::BN; ++q)
          s += part[threadIdx.x + q * rt::BN];
        const int c = j0 + threadIdx.x;
        if (c < N) a.db[g][c] = s;
      }
    }
  } else {
    // dx tile: rows i0.. over M, columns j0.. over K_g, depth N_g
    const float* __restrict__ w = a.w[g];
    auto load_a = [&](int r, int kk) -> float {       // masked dy
      const int gr = i0 + r;
      return (gr < M && kk < N) ? masked_dy(a, g, gr, kk) : 0.f;
    };
    auto load_b = [&](int kk, int c) -> float {       // w^T, n-major
      const int gk = j0 + c;
      return (kk < N && gk < K) ? w[(size_t)gk * N + kk] : 0.f;
    };
    rt::tile_gemm<rt::BM, rt::BN, rt::TM, rt::TN, true, false>(
        acc, N, load_a, load_b);
    float* __restrict__ dx = a.dx[g];
#pragma unroll
    for (int i = 0; i < rt::TM; ++i) {
      const int r = i0 + ty * rt::TM + i;
      if (r >= M) continue;
#pragma unroll
      for (int j = 0; j < rt::TN; ++j) {
        const int c = j0 + tx * rt::TN + j;
        if (c < K) dx[(size_t)r * K + c] = acc[i][j];
      }
    }
  }
}

}  // namespace

extern "C" int rt_gmm_bwd(int g, const void* const* x, const void* const* w,
                          const void* const* dy, const void* const* mask,
                          void* const* dx, void* const* dw,
                          void* const* db, const int* k, const int* n,
                          const int* lddy, const int* ldm, const void* tiles,
                          int ntiles, int m, void* stream) {
  if (g < 1 || g > MAXG) return (int)cudaErrorInvalidValue;
  BwdArgs a = {};
  for (int i = 0; i < g; ++i) {
    a.x[i] = static_cast<const float*>(x[i]);
    a.w[i] = static_cast<const float*>(w[i]);
    a.dy[i] = static_cast<const float*>(dy[i]);
    a.mask[i] = static_cast<const float*>(mask[i]);
    a.dx[i] = static_cast<float*>(dx[i]);
    a.dw[i] = static_cast<float*>(dw[i]);
    a.db[i] = static_cast<float*>(db[i]);
    a.k[i] = k[i];
    a.n[i] = n[i];
    a.lddy[i] = lddy[i];
    a.ldm[i] = ldm[i];
  }
  a.tiles = static_cast<const int*>(tiles);
  a.m = m;
  if (ntiles == 0) return (int)cudaSuccess;
  gmm_bwd_kernel<<<ntiles, rt::NT, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
