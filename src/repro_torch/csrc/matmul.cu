// K4: tiled f32 GEMM C (M, N) = A (M, K) @ B (K, N).
//
// Replaces the TPU kernel repro/kernels/matmul.py::_mm_kernel (launcher
// matmul_tiled, the ``mxu128`` and ``large_tile`` algorithms): a tiled
// GEMM with an f32 accumulator.  On the training path it runs stem0's
// im2col forward and the dX / dW GEMMs of every serial conv
// (models/cnn.py::_conv_gemm_bwd).
//
// Design.  The TPU kernel walks a (M/bm, N/bn, K/bk) grid in order and
// carries the accumulator across the K axis in VMEM; operands arrive
// padded to 128.  Here each CTA owns one output tile and loops over all
// of K itself (rt::tile_gemm), and the loaders mask the ragged edges, so
// nothing is padded or copied.  Either operand may be row-major or a
// transposed view of a row-major array (x.t() in torch): the flag picks
// the loader's addressing and the thread order that keeps a warp's loads
// on neighbouring addresses, so x2^T @ dy2 and dy2 @ wmat^T need no copy.
// ``mxu128`` is the 64 x 64 tile, ``large_tile`` the 128 x 128 one.
//
// Bound on this card: the training shapes are operation-bound on paper
// (up to 2 * 100352 * 576 * 192 FLOP against a few hundred MB), but this
// first design runs f32 FMA on the CUDA cores.  The dW GEMMs contract over
// M = 100352 into tiny outputs (stem1's 64 x 64 dW is ONE tile, so one
// CTA on one of 132 SMs): they are the slowest calls; split-K (the
// reference's ``ksplit``, K8) is the fix and later work.
#include "tile_gemm.cuh"

namespace {

struct MatmulArgs {
  const float* a;   // A(r, k) = a[r * lda + k], or a[k * lda + r] if a_t
  const float* b;   // B(k, c) = b[k * ldb + c], or b[c * ldb + k] if b_t
  float* c;         // (M, N) row-major
  int m, n, k, lda, ldb;
};

template <int BM_, int BN_, int TM_, int TN_, bool A_T, bool B_T>
__global__ void __launch_bounds__((BM_ / TM_) * (BN_ / TN_))
matmul_kernel(MatmulArgs p) {
  const int m0 = blockIdx.x * BM_;
  const int n0 = blockIdx.y * BN_;
  const float* __restrict__ a = p.a;
  const float* __restrict__ b = p.b;
  const int M = p.m, N = p.n, K = p.k;
  const size_t lda = p.lda, ldb = p.ldb;

  auto load_a = [&](int r, int kk) -> float {
    const int gr = m0 + r;
    if (gr >= M || kk >= K) return 0.f;
    return A_T ? a[(size_t)kk * lda + gr] : a[(size_t)gr * lda + kk];
  };
  auto load_b = [&](int kk, int c) -> float {
    const int gc = n0 + c;
    if (kk >= K || gc >= N) return 0.f;
    return B_T ? b[(size_t)gc * ldb + kk] : b[(size_t)kk * ldb + gc];
  };

  float acc[TM_][TN_];
#pragma unroll
  for (int i = 0; i < TM_; ++i)
#pragma unroll
    for (int j = 0; j < TN_; ++j) acc[i][j] = 0.f;
  rt::tile_gemm<BM_, BN_, TM_, TN_, !A_T, !B_T>(acc, K, load_a, load_b);

  const int tx = threadIdx.x % (BN_ / TN_);
  const int ty = threadIdx.x / (BN_ / TN_);
#pragma unroll
  for (int i = 0; i < TM_; ++i) {
    const int r = m0 + ty * TM_ + i;
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < TN_; ++j) {
      const int c = n0 + tx * TN_ + j;
      if (c < N) p.c[(size_t)r * N + c] = acc[i][j];
    }
  }
}

template <int BM_, int BN_, int TM_, int TN_>
int launch(const MatmulArgs& p, int a_t, int b_t, cudaStream_t s) {
  const dim3 grid((p.m + BM_ - 1) / BM_, (p.n + BN_ - 1) / BN_);
  const int nt = (BM_ / TM_) * (BN_ / TN_);
  if (a_t && b_t)
    matmul_kernel<BM_, BN_, TM_, TN_, true, true><<<grid, nt, 0, s>>>(p);
  else if (a_t)
    matmul_kernel<BM_, BN_, TM_, TN_, true, false><<<grid, nt, 0, s>>>(p);
  else if (b_t)
    matmul_kernel<BM_, BN_, TM_, TN_, false, true><<<grid, nt, 0, s>>>(p);
  else
    matmul_kernel<BM_, BN_, TM_, TN_, false, false><<<grid, nt, 0, s>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// large: 0 = ``mxu128`` (64 x 64 tile), 1 = ``large_tile`` (128 x 128).
extern "C" int rt_matmul(const void* a, const void* b, void* c, int m, int n,
                         int k, int lda, int ldb, int a_t, int b_t,
                         int large, void* stream) {
  MatmulArgs p;
  p.a = static_cast<const float*>(a);
  p.b = static_cast<const float*>(b);
  p.c = static_cast<float*>(c);
  p.m = m;
  p.n = n;
  p.k = k;
  p.lda = lda;
  p.ldb = ldb;
  if (m <= 0 || n <= 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return large ? launch<128, 128, 8, 8>(p, a_t, b_t, s)
               : launch<rt::BM, rt::BN, rt::TM, rt::TN>(p, a_t, b_t, s);
}
