// K7: the backward-weight half of a grouped branch launch in ONE launch:
// for G branches sharing M with ragged (K_g, N_g), with
// dym_g = dy_g where mask_g > 0, else 0 (no mask: dym_g = dy_g),
//   dw_g = x_g^T @ dym_g      (K_g, N_g)
//   db_g = sum_M dym_g        (N_g,)
//
// Replaces the TPU kernel
// repro/kernels/grouped_matmul.py::_gmm_dw_kernel (launcher
// grouped_matmul_dw, table _plan_tiles_dw), exported as the library call
// ``ops.grouped_matmul_dw``.  No plan launches it: K5 computes the same
// dw and db together with dx, and the training path keeps K5, as the
// reference does.
//
// Design.  The TPU kernel walks one flattened in-order grid of (branch,
// n-block, k-block, m-step) steps and carries its accumulators across a
// tile's m-steps.  Hopper runs CTAs concurrently and in no order, so here
// the table holds ONE entry per output tile, (g, i, j): the 64 x 64 tile
// (k-block i, n-block j) of dw_g, whose CTA loops over all of M itself
// (rt::tile_gemm).  The mask is applied as dy loads, before both the
// product and db.  db_g is summed only by the k-block-0 CTAs, as the
// reference does with DW_DODB: each of their threads loads one fixed tile
// column at every k-step, so it keeps a private partial sum, and a
// column's four partials are added in thread order at the end; each db
// element has one writer, no atomics, and results repeat bit for bit.
// dy and the mask are read in place through a row stride, so column
// slices of a joint cotangent need no copy.
//
// Bound on this card: at the training shapes (M up to 25088 at batch 8,
// K_g up to 864, N_g up to 384) a launch is operation-bound on paper; a
// tile's M-long loop is one CTA's work and a group has only tens of
// tiles, so few SMs carry it.  Split-M with a second reduction pass is
// later speed work.
#include "tile_gemm.cuh"

namespace {

constexpr int MAXG = 8;
static_assert(rt::NT % rt::BN == 0,
              "db relies on each thread loading one fixed tile column");

struct DwArgs {
  const float* x[MAXG];     // (M, K_g) contiguous
  const float* dy[MAXG];    // (M, N_g), row stride lddy[g]
  const float* mask[MAXG];  // (M, N_g), row stride ldm[g]; null: no mask
  float* dw[MAXG];          // (K_g, N_g) contiguous
  float* db[MAXG];          // (N_g,)
  int k[MAXG];
  int n[MAXG];
  int lddy[MAXG];
  int ldm[MAXG];
  const int* tiles;         // per output tile: (g, i, j)
  int m;
};

__global__ void __launch_bounds__(rt::NT) gmm_dw_kernel(DwArgs a) {
  const int* t = a.tiles + 3 * blockIdx.x;
  const int g = t[0];
  const int i0 = t[1] * rt::BM;
  const int j0 = t[2] * rt::BN;
  const int M = a.m;
  const int K = a.k[g];
  const int N = a.n[g];
  const float* __restrict__ x = a.x[g];
  const float* __restrict__ dy = a.dy[g];
  const float* __restrict__ mk = a.mask[g];
  const size_t lddy = a.lddy[g], ldm = a.ldm[g];
  const bool do_db = (i0 == 0);

  float acc[rt::TM][rt::TN];
#pragma unroll
  for (int i = 0; i < rt::TM; ++i)
#pragma unroll
    for (int j = 0; j < rt::TN; ++j) acc[i][j] = 0.f;
  float dbp = 0.f;
  auto load_a = [&](int r, int kk) -> float {       // x^T, k-major
    const int gk = i0 + r;
    return (gk < K && kk < M) ? x[(size_t)kk * K + gk] : 0.f;
  };
  auto load_b = [&](int kk, int c) -> float {       // masked dy
    const int gc = j0 + c;
    if (kk >= M || gc >= N) return 0.f;
    const float v = dy[(size_t)kk * lddy + gc];
    // dy where mask > 0, else 0 (a NaN mask zeroes, as mask > 0 is false)
    const float d = (mk == nullptr || mk[(size_t)kk * ldm + gc] > 0.f)
                        ? v : 0.f;
    dbp += d;
    return d;
  };
  rt::tile_gemm<rt::BM, rt::BN, rt::TM, rt::TN, false, true>(acc, M, load_a,
                                                             load_b);

  const int tx = threadIdx.x % (rt::BN / rt::TN);
  const int ty = threadIdx.x / (rt::BN / rt::TN);
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
}

}  // namespace

extern "C" int rt_gmm_dw(int g, const void* const* x, const void* const* dy,
                         const void* const* mask, void* const* dw,
                         void* const* db, const int* k, const int* n,
                         const int* lddy, const int* ldm, const void* tiles,
                         int ntiles, int m, void* stream) {
  if (g < 1 || g > MAXG) return (int)cudaErrorInvalidValue;
  DwArgs a = {};
  for (int i = 0; i < g; ++i) {
    a.x[i] = static_cast<const float*>(x[i]);
    a.dy[i] = static_cast<const float*>(dy[i]);
    a.mask[i] = static_cast<const float*>(mask[i]);
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
  gmm_dw_kernel<<<ntiles, rt::NT, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
