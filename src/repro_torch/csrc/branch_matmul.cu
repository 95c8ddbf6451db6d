// K9: G independent same-shape f32 GEMMs,
// C[g] (M, N) = A[g] (M, K) @ B[g] (K, N).
//
// Replaces the TPU kernel repro/kernels/branch_matmul.py::_bmm_kernel
// (launcher branch_matmul): the ``stacked`` co-execution mode, where the
// G branch GEMMs of an inception quad, padded to the widest K and N, run
// as one launch with a leading branch grid axis; its VJP
// (repro/kernels/ops.py::_branch_matmul_bwd) runs the same kernel on the
// backward GEMMs dX = dY @ B^T and dB = A^T @ dY.  Winograd's 16
// transform-domain GEMMs (kernels/conv2d.py::conv2d_winograd3x3) are one
// launch of it too.
//
// Bound on this card: operations.  The stacked GoogLeNet quads do 2 G M K
// N FLOP on G (M K + K N + M N) f32 words, e.g. 4 x 25088 x 192 x 96 at
// inc0, far above the f32 ridge; the kernel stays on the CUDA cores in
// f32.  The dB GEMMs contract over M = 25088 rows into (K, N) outputs of
// two tiles a branch, 8 tiles in all: with one CTA a tile, 8 CTAs walk
// all of M while the other SMs idle.
//
// Design.  The TPU kernel walks a (G, M/bm, N/bn, K/bk) grid in order and
// carries the accumulator across the K axis in VMEM; its wrapper pads M,
// K and N to 128.  Here each CTA owns one 128 x 128 output tile of one
// branch and runs the pipelined engine of gemm_pipe.cuh (3-stage cp.async
// ring, 8 x 8 micro-tiles, two CTAs an SM) over its share of K, as K4
// (matmul.cu) does: the edges are zero-fill copies, so nothing is padded
// or copied, and the tile computes what the padded launch computes on the
// unpadded region.  Either operand may be row-major or a transposed view
// of a row-major array (x.transpose(1, 2) in torch), per branch at any
// batch stride; the wrapper picks each operand's copy layout from its
// strides and address (KC when contiguous along K, XC16 / XC along M or
// N), so the backward's A^T and B^T need no copy.  When the G branches'
// tiles do not cover the SMs, the wrapper cuts K into splits of whole
// 16-deep k-steps (matmul.py::split_plan, from the SM count); each split
// CTA writes its partial tile into a workspace and the last CTA of the
// tile to arrive sums the partials in split order (gp::Split): one
// launch, deterministic.
#include "gemm_pipe.cuh"

namespace {

constexpr int T = 128;
using E = gp::Mma<T, T>;
using Sp = gp::Split<T, T>;

// A[g](r, k) = a[g * sa + r * lda + k] (KC) or a[g * sa + k * lda + r];
// B[g](k, c) = b[g * sb + c * ldb + k] (KC) or b[g * sb + k * ldb + c];
// C is (G, M, N), contiguous.
struct BmmArgs {
  const float* a;
  const float* b;
  float* c;
  float* ws;        // splits > 1: (G * tiles, splits, T * T) partials
  int* counters;    // splits > 1: one zeroed arrival counter per tile
  long long sa, sb;
  int m, n, k, lda, ldb, kper, splits;
};

template <int LA, int LB>
__global__ void __launch_bounds__(E::NT, 2) bmm_kernel(BmmArgs p) {
  using TA = gp::Tile<T, E::NT, LA>;
  using TB = gp::Tile<T, E::NT, LB>;
  extern __shared__ float4 smem_raw[];
  float* sa = reinterpret_cast<float*>(smem_raw);
  float* sb = sa + gp::STAGES * TA::STAGE;

  const int m0 = blockIdx.x * T, n0 = blockIdx.y * T;
  const int g = blockIdx.z / p.splits, split = blockIdx.z % p.splits;
  const float* a = p.a + (size_t)g * p.sa;
  const float* b = p.b + (size_t)g * p.sb;
  float* c = p.c + (size_t)g * p.m * p.n;
  const int k_lo = split * p.kper;
  const int k_hi = min(p.k, k_lo + p.kper);
  const int nk = (k_hi - k_lo + gp::BK - 1) / gp::BK;
  const int rows = p.m - m0, cols = p.n - n0;

  float acc[8][8];
  gp::gemm<T, T>(
      acc, sa, TA::STAGE, sb, TB::STAGE, nk, E::warp_live(rows),
      [&](int st, int kt) {
        const int k0 = k_lo + kt * gp::BK;
        TA::issue(sa + st * TA::STAGE, a, p.lda, m0, p.m, k0, k_hi);
        TB::issue(sb + st * TB::STAGE, b, p.ldb, n0, p.n, k0, k_hi);
      });
  const bool vec = (p.n % 4) == 0;
  if (p.splits == 1) {
    gp::store_tile<T, T, 8>(c, p.m, p.n, m0, n0, vec, acc);
    return;
  }
  const int tile = (g * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
  float* slot0 = p.ws + (size_t)tile * p.splits * Sp::TILE;
  Sp::put(slot0 + (size_t)split * Sp::TILE, acc, rows, cols);
  if (!Sp::arrive(p.counters + tile, p.splits)) return;
  Sp::reduce(slot0, p.splits, rows, cols, [&](int r, int cc, float4 v) {
    gp::store4(c + (size_t)(m0 + r) * p.n + n0 + cc, cols - cc, vec, v);
  });
}

template <int LA, int LB>
int launch(const BmmArgs& p, int g, cudaStream_t s) {
  constexpr int smem =
      gp::STAGES *
      (gp::Tile<T, E::NT, LA>::STAGE + gp::Tile<T, E::NT, LB>::STAGE) *
      (int)sizeof(float);
  auto kern = bmm_kernel<LA, LB>;
  static unsigned opted = 0;
  cudaError_t e = gp::opt_in_smem(kern, smem, opted);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((p.m + T - 1) / T, (p.n + T - 1) / T, g * p.splits);
  kern<<<grid, E::NT, smem, s>>>(p);
  return (int)cudaGetLastError();
}

template <int LA>
int launch_b(const BmmArgs& p, int g, int lb, cudaStream_t s) {
  switch (lb) {
    case gp::KC: return launch<LA, gp::KC>(p, g, s);
    case gp::XC: return launch<LA, gp::XC>(p, g, s);
    default: return launch<LA, gp::XC16>(p, g, s);
  }
}

}  // namespace

// sa / sb: each operand's batch stride in elements; lda / ldb: its
// leading dimension; la / lb: its copy layout (gp::Layout: 0 KC,
// contiguous along K; 1 XC, contiguous along M / N; 2 XC16, XC with
// 16-byte copies).  splits, kper: K cut into splits of kper (the last may
// be shorter); splits > 1 needs ws and counters (see BmmArgs).
extern "C" int rt_branch_matmul(const void* a, const void* b, void* c,
                                void* ws, void* counters, int g, int m,
                                int n, int k, long long sa, long long sb,
                                int lda, int ldb, int la, int lb, int splits,
                                int kper, void* stream) {
  BmmArgs p;
  p.a = static_cast<const float*>(a);
  p.b = static_cast<const float*>(b);
  p.c = static_cast<float*>(c);
  p.ws = static_cast<float*>(ws);
  p.counters = static_cast<int*>(counters);
  p.sa = sa;
  p.sb = sb;
  p.m = m;
  p.n = n;
  p.k = k;
  p.lda = lda;
  p.ldb = ldb;
  p.kper = kper;
  p.splits = splits;
  if (g <= 0 || m <= 0 || n <= 0) return (int)cudaSuccess;
  if (splits < 1 || la < 0 || la > 2 || lb < 0 || lb > 2 ||
      (long long)g * splits > 65535 || (n + T - 1) / T > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (la) {
    case gp::KC: return launch_b<gp::KC>(p, g, lb, s);
    case gp::XC: return launch_b<gp::XC>(p, g, lb, s);
    default: return launch_b<gp::XC16>(p, g, lb, s);
  }
}
