// Grouped ragged branch GEMMs: K1 (fused epilogue-concat) and K2 (pooled).
//
// Replaces the TPU kernels
//   K1 repro/kernels/grouped_matmul.py::_gmm_kernel        (the concat
//      launcher grouped_matmul_concat),
//   K2 repro/kernels/grouped_matmul.py::_gmm_pooled_kernel (the launcher
//      _pooled_launch, grouped_matmul_pooled).
// Both compute y_g = relu(pool(x_g) @ w_g + b_g) for G branches sharing
// M with ragged (K_g, N_g), rows at/past m_lim stored as zeros.
//
// Design.  The TPU kernels walk one flattened in-order grid and carry the
// accumulator (and the pooled-lhs scratch) from step to step.  Here each
// CTA owns one 64 x 64 output tile: blockIdx.x is the M-block, blockIdx.y
// indexes a per-output-tile table (branch g, first column) that the
// wrapper builds once per launch shape and keeps on the device.  The CTA
// loops over all of its branch's k-steps itself.
//   K1 writes each branch's tile straight to its column offset in the
//      join buffer (masked column edge), in place of the TPU's padded
//      panel plus gather.
//   K2 reads a pooled branch's lhs from the tap stack the wrapper hands
//      it, (T, M, K_g) contiguous: every lhs element is the max of its T
//      taps, the first tap seeding, with the NaN-propagating select of
//      the reference fold — computed while the tile loads into shared
//      memory, so the pooled activation never reaches device memory.
//      Unpooled branches are T = 1.
// Bound on this card: at the serving shapes both are operation-bound on
// paper (K up to 1440, N up to 624), but this first design runs plain f32
// FMA on the CUDA cores with one 64 x 64 tile per CTA and no overlap of
// loads with math, so it reaches a fraction of the 67 TFLOP/s f32 rate;
// tensor-core (TF32 or bf16) tiles are later work.
#include "tile_gemm.cuh"

namespace {

constexpr int MAXG = 8;

struct GroupArgs {
  const float* x[MAXG];    // (taps_g, M, K_g) contiguous lhs (taps_g = 1: plain)
  const float* w[MAXG];    // (K_g, N_g) contiguous
  const float* b[MAXG];    // (N_g,) or null
  float* out[MAXG];        // branch g's output base
  int k[MAXG];
  int n[MAXG];
  int taps[MAXG];
  int ldo[MAXG];           // output row stride (floats)
  int ocol[MAXG];          // first output column of branch g
  int nstore[MAXG];        // columns of branch g to store (>= n: zero pad)
  const int* tiles;        // per column tile: (branch, first column)
  int m;                   // rows of the lhs and the output
  int m_lim;               // rows at/past this store zeros
  int relu;
};

template <bool POOLED>
__global__ void __launch_bounds__(rt::NT) gmm_kernel(GroupArgs a) {
  const int g = a.tiles[2 * blockIdx.y];
  const int c0 = a.tiles[2 * blockIdx.y + 1];
  const int m0 = blockIdx.x * rt::BM;
  const float* __restrict__ x = a.x[g];
  const float* __restrict__ w = a.w[g];
  const int K = a.k[g];
  const int N = a.n[g];
  const int T = POOLED ? a.taps[g] : 1;
  const size_t plane = (size_t)a.m * K;
  const int m_lim = a.m_lim;

  auto load_a = [&](int r, int k) -> float {
    const int gr = m0 + r;
    if (gr >= m_lim || k >= K) return 0.f;
    const float* p = x + (size_t)gr * K + k;
    float v = p[0];
    if (POOLED) {
      for (int t = 1; t < T; ++t) v = rt::pool_max(v, p[t * plane]);
    }
    return v;
  };
  auto load_b = [&](int k, int c) -> float {
    const int gc = c0 + c;
    return (k < K && gc < N) ? w[(size_t)k * N + gc] : 0.f;
  };

  float acc[rt::TM][rt::TN];
#pragma unroll
  for (int i = 0; i < rt::TM; ++i)
#pragma unroll
    for (int j = 0; j < rt::TN; ++j) acc[i][j] = 0.f;
  rt::tile_gemm(acc, K, load_a, load_b);

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const float* __restrict__ bias = a.b[g];
  float* __restrict__ out = a.out[g];
  const int ldo = a.ldo[g];
  const int ocol = a.ocol[g];
  const int nstore = a.nstore[g];
#pragma unroll
  for (int i = 0; i < rt::TM; ++i) {
    const int r = m0 + ty * rt::TM + i;
    if (r >= a.m) continue;
#pragma unroll
    for (int j = 0; j < rt::TN; ++j) {
      const int c = c0 + tx * rt::TN + j;
      if (c >= nstore) continue;
      float y = 0.f;
      if (r < m_lim) {
        y = acc[i][j] + ((bias != nullptr && c < N) ? bias[c] : 0.f);
        if (a.relu) y = rt::relu_keep_nan(y);
      }
      out[(size_t)r * ldo + ocol + c] = y;
    }
  }
}

int launch(bool pooled, int g, const void* const* x, const void* const* w,
           const void* const* b, void* const* out, const int* k,
           const int* n, const int* taps, const int* ldo, const int* ocol,
           const int* nstore, const void* tiles, int ntiles, int m,
           int m_lim, int relu, void* stream) {
  if (g < 1 || g > MAXG) return (int)cudaErrorInvalidValue;
  GroupArgs a = {};
  for (int i = 0; i < g; ++i) {
    a.x[i] = static_cast<const float*>(x[i]);
    a.w[i] = static_cast<const float*>(w[i]);
    a.b[i] = static_cast<const float*>(b[i]);
    a.out[i] = static_cast<float*>(out[i]);
    a.k[i] = k[i];
    a.n[i] = n[i];
    a.taps[i] = taps[i];
    a.ldo[i] = ldo[i];
    a.ocol[i] = ocol[i];
    a.nstore[i] = nstore[i];
  }
  a.tiles = static_cast<const int*>(tiles);
  a.m = m;
  a.m_lim = m_lim;
  a.relu = relu;
  const dim3 grid((m_lim + rt::BM - 1) / rt::BM, ntiles);
  if (grid.x == 0 || ntiles == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (pooled)
    gmm_kernel<true><<<grid, rt::NT, 0, s>>>(a);
  else
    gmm_kernel<false><<<grid, rt::NT, 0, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K1: branch outputs land in one join buffer at their column offsets.
int rt_gmm_concat(int g, const void* const* x, const void* const* w,
                  const void* const* b, void* out, const int* k,
                  const int* n, int ldo, const int* ocol, const int* nstore,
                  const void* tiles, int ntiles, int m, int m_lim, int relu,
                  void* stream) {
  if (g < 1 || g > MAXG) return (int)cudaErrorInvalidValue;
  void* outs[MAXG];
  int ldos[MAXG];
  int taps[MAXG];
  for (int i = 0; i < g; ++i) {
    outs[i] = out;
    ldos[i] = ldo;
    taps[i] = 1;
  }
  return launch(false, g, x, w, b, outs, k, n, taps, ldos, ocol, nstore,
                tiles, ntiles, m, m_lim, relu, stream);
}

// K2: pooled branches max their taps in the lhs load; one output per branch.
int rt_gmm_pooled(int g, const void* const* x, const void* const* w,
                  const void* const* b, void* const* out, const int* k,
                  const int* n, const int* taps, const void* tiles,
                  int ntiles, int m, int m_lim, int relu, void* stream) {
  if (g < 1 || g > MAXG) return (int)cudaErrorInvalidValue;
  int zero[MAXG] = {};
  return launch(true, g, x, w, b, out, k, n, taps, n, zero, n, tiles,
                ntiles, m, m_lim, relu, stream);
}

}  // extern "C"
