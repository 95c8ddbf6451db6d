// K4: tiled f32 GEMM C (M, N) = A (M, K) @ B (K, N).
//
// Replaces the TPU kernel repro/kernels/matmul.py::_mm_kernel (launcher
// matmul_tiled, the ``mxu128`` and ``large_tile`` algorithms): a tiled
// GEMM with an f32 accumulator.  On the training path it runs stem0's
// im2col forward and the dX / dW GEMMs of every serial conv
// (models/cnn.py::_conv_gemm_bwd): 6 launches a concurrent step, 119 a
// serial one.
//
// Bound on this card: operations.  The training shapes do up to 2 *
// 100352 * 576 * 192 FLOP on a few hundred MB, far above the f32 ridge
// (67 TFLOP/s of CUDA-core FMA against 3.35 TB/s); this kernel stays on
// the CUDA cores in f32 (3xTF32 on the tensor cores would change both
// the bound and the numerics, and is later work).
//
// Design.  The TPU kernel walks a (M/bm, N/bn, K/bk) grid in order and
// carries the accumulator across the K axis in VMEM.  Here a CTA owns one
// output tile (128 x 128 for ``mxu128``, 256 x 128 for ``large_tile``)
// and runs the pipelined engine of gemm_pipe.cuh over its share of K: a
// 3-stage cp.async ring, 8 x 8 (``mxu128``, two CTAs an SM) or 16 x 8
// (``large_tile``, one CTA an SM) register micro-tiles read as float4.
// Either operand may be row-major or a transposed view of a row-major
// array (x.t() in torch), read in place; the wrapper picks each
// operand's copy layout (16-byte copies where base and leading dimension
// allow, 4-byte otherwise) from its strides and address.
//
// The dW GEMMs contract over M = 8 * 112 * 112 = 100352 into outputs of a
// few tiles (stem1's 64 x 64 dW is one tile): one CTA per tile would leave
// all but a few of the 132 SMs idle.  So when the output has fewer tiles
// than the card has SMs, the wrapper cuts K into S splits of whole
// 16-deep k-steps (matmul.py::split_plan, from the SM count) and the grid
// gets a third axis; each split CTA writes its partial tile into a
// workspace the wrapper allocates, and the last CTA of each tile to
// arrive sums the S partials in split order and writes C (gp::Split):
// one launch, deterministic, no atomics on values.  The dX GEMMs
// (100352 x 576, 100352 x 64) have thousands of tiles and take no split.
#include "gemm_pipe.cuh"

namespace {

using MatmulArgs = gp::MatmulArgs;

// the CTA body is gp::matmul_cta, shared with K10 (fused_branches.cu),
// whose c equals this kernel's bit for bit
template <int BM, int BN, int TM, int LA, int LB>
__global__ void __launch_bounds__(256, TM == 8 ? 2 : 1)
matmul_kernel(MatmulArgs p) {
  extern __shared__ float4 smem_raw[];
  gp::matmul_cta<BM, BN, TM, LA, LB>(p, reinterpret_cast<float*>(smem_raw),
                                     blockIdx.x, blockIdx.y, blockIdx.z,
                                     blockIdx.y * gridDim.x + blockIdx.x);
}

template <int BM, int BN, int TM, int LA, int LB>
int launch(const MatmulArgs& p, cudaStream_t s) {
  using E = gp::Mma<BM, BN, TM>;
  constexpr int smem =
      gp::matmul_smem_floats<BM, BN, TM, LA, LB>() * (int)sizeof(float);
  auto kern = matmul_kernel<BM, BN, TM, LA, LB>;
  static unsigned opted = 0;
  cudaError_t e = gp::opt_in_smem(kern, smem, opted);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((p.m + BM - 1) / BM, (p.n + BN - 1) / BN, p.splits);
  kern<<<grid, E::NT, smem, s>>>(p);
  return (int)cudaGetLastError();
}

template <int BM, int BN, int TM, int LA>
int launch_b(const MatmulArgs& p, int lb, cudaStream_t s) {
  switch (lb) {
    case gp::KC: return launch<BM, BN, TM, LA, gp::KC>(p, s);
    case gp::XC: return launch<BM, BN, TM, LA, gp::XC>(p, s);
    default: return launch<BM, BN, TM, LA, gp::XC16>(p, s);
  }
}

template <int BM, int BN, int TM>
int launch_ab(const MatmulArgs& p, int la, int lb, cudaStream_t s) {
  switch (la) {
    case gp::KC: return launch_b<BM, BN, TM, gp::KC>(p, lb, s);
    case gp::XC: return launch_b<BM, BN, TM, gp::XC>(p, lb, s);
    default: return launch_b<BM, BN, TM, gp::XC16>(p, lb, s);
  }
}

}  // namespace

// la, lb: each operand's copy layout (gp::Layout: 0 KC, contiguous along
// K; 1 XC, contiguous along M / N; 2 XC16, XC with 16-byte copies).
// large: 0 = ``mxu128`` (128 x 128 tiles), 1 = ``large_tile`` (256 x 128,
// 16 x 8 micro-tiles).
// splits, kper: K cut into splits of kper (the last may be shorter);
// splits > 1 needs ws and counters (see MatmulArgs).
extern "C" int rt_matmul(const void* a, const void* b, void* c, void* ws,
                         void* counters, int m, int n, int k, int lda,
                         int ldb, int la, int lb, int large, int splits,
                         int kper, void* stream) {
  MatmulArgs p;
  p.a = static_cast<const float*>(a);
  p.b = static_cast<const float*>(b);
  p.c = static_cast<float*>(c);
  p.ws = static_cast<float*>(ws);
  p.counters = static_cast<int*>(counters);
  p.m = m;
  p.n = n;
  p.k = k;
  p.lda = lda;
  p.ldb = ldb;
  p.kper = kper;
  p.splits = splits;
  if (m <= 0 || n <= 0) return (int)cudaSuccess;
  if (splits < 1 || la < 0 || la > 2 || lb < 0 || lb > 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return large ? launch_ab<256, 128, 16>(p, la, lb, s)
               : launch_ab<128, 128, 8>(p, la, lb, s);
}
