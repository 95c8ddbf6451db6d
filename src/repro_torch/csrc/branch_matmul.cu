// K9: G independent same-shape f32 GEMMs,
// C[g] (M, N) = A[g] (M, K) @ B[g] (K, N).
//
// Replaces the TPU kernel repro/kernels/branch_matmul.py::_bmm_kernel
// (launcher branch_matmul): the ``stacked`` co-execution mode, where the
// G branch GEMMs of an inception quad, padded to the widest K and N, run
// as one launch with a leading branch grid axis; its VJP
// (repro/kernels/ops.py::_branch_matmul_bwd) runs the same kernel on the
// backward GEMMs dX = dY @ B^T and dB = A^T @ dY.
//
// Design.  The TPU kernel walks a (G, M/bm, N/bn, K/bk) grid in order and
// carries the accumulator across the K axis in VMEM; its wrapper pads M,
// K and N to 128.  Here the grid is (N tiles, M tiles, G): each CTA owns
// one 64 x 64 output tile of one branch and loops over all of K itself
// (rt::tile_gemm), so no state passes between CTAs, which Hopper runs in
// no order.  The loaders mask the M, K and N edges, so nothing is padded
// or copied, and the tile computes what the padded launch computes on the
// unpadded region.  Either operand may be row-major or a transposed view
// of a row-major array (x.transpose(1, 2) in torch), per branch at any
// batch stride: the flag picks the loader's addressing and the thread
// order that keeps a warp's loads on neighbouring addresses, so the
// backward's B^T and A^T need no copy.
//
// Bound on this card: the stacked GoogLeNet quads are operation-bound on
// paper (2 G M K N FLOP against G (M K + K N + M N) f32 words, e.g.
// 4 x 25088 x 192 x 96 at inc0), but this first design runs f32 FMA on
// the CUDA cores.  The dB GEMMs contract over M (up to 25088 rows) into
// small (K, N) outputs, a few CTAs each walking all of M: they are the
// slowest calls; split-K is the fix and later work.
#include "tile_gemm.cuh"

namespace {

// A[g](r, k) = a[g * sa + r * lda + k], or a[g * sa + k * lda + r] if a_t;
// B[g](k, c) = b[g * sb + k * ldb + c], or b[g * sb + c * ldb + k] if b_t;
// C is (G, M, N), contiguous.
struct BmmArgs {
  const float* a;
  const float* b;
  float* c;
  int m, n, k, lda, ldb;
  long long sa, sb;
};

template <bool A_T, bool B_T>
__global__ void __launch_bounds__(rt::NT) bmm_kernel(BmmArgs p) {
  const int n0 = blockIdx.x * rt::BN;
  const int m0 = blockIdx.y * rt::BM;
  const int g = blockIdx.z;
  const float* __restrict__ a = p.a + (size_t)g * p.sa;
  const float* __restrict__ b = p.b + (size_t)g * p.sb;
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

  float acc[rt::TM][rt::TN];
#pragma unroll
  for (int i = 0; i < rt::TM; ++i)
#pragma unroll
    for (int j = 0; j < rt::TN; ++j) acc[i][j] = 0.f;
  rt::tile_gemm<rt::BM, rt::BN, rt::TM, rt::TN, !A_T, !B_T>(acc, K, load_a,
                                                            load_b);

  float* __restrict__ c = p.c + (size_t)g * M * N;
  const int tx = threadIdx.x % (rt::BN / rt::TN);
  const int ty = threadIdx.x / (rt::BN / rt::TN);
#pragma unroll
  for (int i = 0; i < rt::TM; ++i) {
    const int r = m0 + ty * rt::TM + i;
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < rt::TN; ++j) {
      const int cc = n0 + tx * rt::TN + j;
      if (cc < N) c[(size_t)r * N + cc] = acc[i][j];
    }
  }
}

}  // namespace

// sa / sb: each operand's batch stride in elements; lda / ldb: its
// leading dimension; a_t / b_t: 1 when the operand is read transposed.
extern "C" int rt_branch_matmul(const void* a, const void* b, void* c, int g,
                                int m, int n, int k, long long sa,
                                long long sb, int lda, int ldb, int a_t,
                                int b_t, void* stream) {
  BmmArgs p;
  p.a = static_cast<const float*>(a);
  p.b = static_cast<const float*>(b);
  p.c = static_cast<float*>(c);
  p.m = m;
  p.n = n;
  p.k = k;
  p.lda = lda;
  p.ldb = ldb;
  p.sa = sa;
  p.sb = sb;
  if (g <= 0 || m <= 0 || n <= 0) return (int)cudaSuccess;
  const dim3 grid((n + rt::BN - 1) / rt::BN, (m + rt::BM - 1) / rt::BM, g);
  if (grid.y > 65535 || grid.z > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a_t && b_t)
    bmm_kernel<true, true><<<grid, rt::NT, 0, s>>>(p);
  else if (a_t)
    bmm_kernel<true, false><<<grid, rt::NT, 0, s>>>(p);
  else if (b_t)
    bmm_kernel<false, true><<<grid, rt::NT, 0, s>>>(p);
  else
    bmm_kernel<false, false><<<grid, rt::NT, 0, s>>>(p);
  return (int)cudaGetLastError();
}
