// K8: split-K f32 GEMM into a workspace of partial products,
//   ws[s] (M, N) = A[:, K_s] @ B[K_s, :]   for each split s,
// whose sum over s is C = A (M, K) @ B (K, N).
//
// Replaces the TPU kernel repro/kernels/matmul.py::_ksplit_kernel
// (launcher matmul_ksplit, the ``ksplit`` algorithm of the GEMM zoo): the
// paper's C4 quantity made concrete, an algorithm that trades a
// (splits, M, N) f32 workspace in device memory for parallelism on GEMMs
// with small outputs and a long contraction.  The wrapper sums the
// partials over splits outside the kernel, in a fixed order, as the
// reference's wrapper does (``partials.sum(axis=0)``).
//
// Design.  The TPU kernel walks a (splits, M/bm, N/bn, K/(bk splits))
// grid in order and carries each split's accumulator across its k-steps.
// Here the grid is (N tiles, M tiles, splits): each CTA owns one 64 x 64
// output tile of one split's slice of the workspace and loops over that
// split's K range itself (rt::tile_gemm), so nothing passes between
// CTAs.  Split s covers k in [s * kper, min(K, (s + 1) * kper)); the
// wrapper sets kper to a whole number of the reference's 128-deep
// blocks, so with ragged K the last split is the short one.  The loaders
// mask the edges (nothing is padded) and read either operand row-major
// or as the transpose of a row-major array, in place, as K4 does, so the
// transposed operands of the training step's dW GEMMs need no copy.
//
// Bound on this card: the captured dW GEMMs (K up to 100352, outputs of
// 64 x 64 to 576 x 192) are operation-bound on paper; this first design
// runs f32 FMA on the CUDA cores, and splits multiply the CTAs such a
// GEMM has (stem2's dW: 27 tiles, so 108 CTAs with 4 splits) at the
// cost of writing and re-reading splits * M * N f32 words.
#include "tile_gemm.cuh"

namespace {

struct KsplitArgs {
  const float* a;   // A(r, k) = a[r * lda + k], or a[k * lda + r] if a_t
  const float* b;   // B(k, c) = b[k * ldb + c], or b[c * ldb + k] if b_t
  float* ws;        // (splits, M, N) row-major
  int m, n, k, lda, ldb, kper;
};

template <bool A_T, bool B_T>
__global__ void __launch_bounds__(rt::NT) ksplit_kernel(KsplitArgs p) {
  const int n0 = blockIdx.x * rt::BN;
  const int m0 = blockIdx.y * rt::BM;
  const int s = blockIdx.z;
  const float* __restrict__ a = p.a;
  const float* __restrict__ b = p.b;
  const int M = p.m, N = p.n;
  const long long kbeg_l = (long long)s * p.kper;
  const int kbeg = kbeg_l < p.k ? (int)kbeg_l : p.k;
  const int nk = min(p.k, kbeg + p.kper) - kbeg;
  const size_t lda = p.lda, ldb = p.ldb;

  auto load_a = [&](int r, int kk) -> float {
    const int gr = m0 + r;
    if (gr >= M || kk >= nk) return 0.f;
    const size_t gk = (size_t)kbeg + kk;
    return A_T ? a[gk * lda + gr] : a[(size_t)gr * lda + gk];
  };
  auto load_b = [&](int kk, int c) -> float {
    const int gc = n0 + c;
    if (kk >= nk || gc >= N) return 0.f;
    const size_t gk = (size_t)kbeg + kk;
    return B_T ? b[(size_t)gc * ldb + gk] : b[gk * ldb + gc];
  };

  float acc[rt::TM][rt::TN];
#pragma unroll
  for (int i = 0; i < rt::TM; ++i)
#pragma unroll
    for (int j = 0; j < rt::TN; ++j) acc[i][j] = 0.f;
  rt::tile_gemm<rt::BM, rt::BN, rt::TM, rt::TN, !A_T, !B_T>(acc, nk, load_a,
                                                            load_b);

  float* __restrict__ ws = p.ws + (size_t)s * M * N;
  const int tx = threadIdx.x % (rt::BN / rt::TN);
  const int ty = threadIdx.x / (rt::BN / rt::TN);
#pragma unroll
  for (int i = 0; i < rt::TM; ++i) {
    const int r = m0 + ty * rt::TM + i;
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < rt::TN; ++j) {
      const int c = n0 + tx * rt::TN + j;
      if (c < N) ws[(size_t)r * N + c] = acc[i][j];
    }
  }
}

}  // namespace

// ws: (splits, m, n) f32; kper: the depth of every split but the last.
extern "C" int rt_matmul_ksplit(const void* a, const void* b, void* ws,
                                int m, int n, int k, int lda, int ldb,
                                int a_t, int b_t, int splits, int kper,
                                void* stream) {
  KsplitArgs p;
  p.a = static_cast<const float*>(a);
  p.b = static_cast<const float*>(b);
  p.ws = static_cast<float*>(ws);
  p.m = m;
  p.n = n;
  p.k = k;
  p.lda = lda;
  p.ldb = ldb;
  p.kper = kper;
  if (m <= 0 || n <= 0) return (int)cudaSuccess;
  if (splits < 1 || kper < 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((n + rt::BN - 1) / rt::BN, (m + rt::BM - 1) / rt::BM,
                  splits);
  if (grid.y > 65535 || grid.z > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a_t && b_t)
    ksplit_kernel<true, true><<<grid, rt::NT, 0, s>>>(p);
  else if (a_t)
    ksplit_kernel<true, false><<<grid, rt::NT, 0, s>>>(p);
  else if (b_t)
    ksplit_kernel<false, true><<<grid, rt::NT, 0, s>>>(p);
  else
    ksplit_kernel<false, false><<<grid, rt::NT, 0, s>>>(p);
  return (int)cudaGetLastError();
}
