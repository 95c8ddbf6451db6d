// K8: split-K f32 GEMM into a workspace of partial products,
//   ws[s] (M, N) = A[:, K_s] @ B[K_s, :]   for each split s,
// whose sum over s, in split order, is C = A (M, K) @ B (K, N).
//
// Replaces the TPU kernel repro/kernels/matmul.py::_ksplit_kernel
// (launcher matmul_ksplit, the ``ksplit`` algorithm of the GEMM zoo): the
// paper's C4 quantity made concrete, an algorithm that trades a
// (splits, M, N) f32 workspace in device memory for parallelism on GEMMs
// with small outputs and a long contraction.  The reference cuts K into
// up to 4 splits of whole 128-deep blocks (the last one short when K is
// ragged), writes each split's partial into the workspace and sums the
// partials over splits (``partials.sum(axis=0)``).
//
// Design.  The TPU kernel walks a (splits, M/bm, N/bn, k-blocks) grid in
// order and carries each split's accumulator across its k-steps.  Here
// each reference split's slice runs as K4's ``mxu128`` CTAs
// (gp::matmul_cta: 128 x 128 tiles on the pipelined engine, a 3-stage
// cp.async ring) over that slice's K range, storing its tile of ws[s].
// A (reference split, tile) pair is one unit; where the units do not
// cover the SMs, each slice is cut again into ``inner`` splits of
// ``kper_in`` (matmul.py::split_plan over the units), which the tile's
// last CTA to arrive sums in split order (gp::Split), as K4 does.  Then
// the last of a tile's S slices to be stored sums ws[0 .. S - 1] for that
// tile in split order and writes C: one launch, no atomics on values,
// results repeat bit for bit.  The grid is (m-blocks, n-blocks, S x
// inner), the launch table matmul.py::ksplit_launch.  Either operand may
// be row-major or the transpose of a row-major array, read in place in
// the copy layout the wrapper picks (as K4), so the training step's dW
// GEMMs pass x2.t() with no copy.  A slice's CTAs are K4's CTAs on that
// slice's operands: where the inner split is the one K4 takes for that
// slice, ws[s] equals K4 on x[:, K_s] @ y[K_s] bit for bit.
//
// Bound on this card: the captured dW GEMMs (K up to 100352, outputs of
// 64 x 64 to 576 x 192) are operation-bound on paper; the kernel runs f32
// FMA on the CUDA cores (3xTF32 on the tensor cores is later work), and
// the workspace costs writing and re-reading S x M x N f32 words (1.77 MB
// at stem2's dW), a few microseconds.
#include "gemm_pipe.cuh"

namespace {

constexpr int T = 128;   // K4 mxu128's tile
constexpr int TM = 8;

struct KsplitArgs {
  gp::MatmulArgs mm;  // the whole GEMM's a, b, m, n, k, lda, ldb
  float* ws;          // (splits, M, N) partial products
  float* part;        // inner > 1: (splits, tiles, inner, T * T) partials
  float* out;         // (M, N): the sum over splits; null at one split
  int* counters;      // splits * tiles inner counters, then tiles more
  int splits, kref, inner, kper_in;
};

// ws[0 .. splits - 1] of output tile (m0, n0), summed in split order,
// into out.  Every thread takes four-column chunks in turn (neighbouring
// threads on neighbouring chunks), two at a time, and issues the loads of
// all their splits (at most MAX_SPLITS) before it sums any: the partials
// are in L2, and a loop of dependent loads would wait on each one.
constexpr int MAX_SPLITS = 4;   // ksplit_splits: at most 4

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// four floats at p[0 .. lim - 1] (zeros past lim): one 16-byte load
// where vec (p 16-byte aligned) and all four are wanted
__device__ __forceinline__ float4 load4(const float* p, int lim, bool vec) {
  if (vec && lim >= 4) return __ldcg(reinterpret_cast<const float4*>(p));
  float e[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (j < lim) e[j] = __ldcg(p + j);
  return make_float4(e[0], e[1], e[2], e[3]);
}

__device__ __forceinline__ void fold(const KsplitArgs& p, int m0, int n0) {
  constexpr int U = 2;   // chunks a thread has in flight
  const int m = p.mm.m, n = p.mm.n;
  const int rows = min(m - m0, T), cols = min(n - n0, T);
  const int nc4 = (cols + 3) / 4, chunks = rows * nc4;
  const size_t plane = (size_t)m * n;
  const bool vec = n % 4 == 0;
  for (int f0 = threadIdx.x; f0 < chunks; f0 += U * blockDim.x) {
    float4 v[U][MAX_SPLITS];
    size_t at[U];
    int lim[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int f = min(f0 + u * (int)blockDim.x, chunks - 1);
      const int c = (f % nc4) * 4;
      at[u] = (size_t)(m0 + f / nc4) * n + n0 + c;
      lim[u] = f0 + u * (int)blockDim.x < chunks ? cols - c : 0;
#pragma unroll
      for (int s = 0; s < MAX_SPLITS; ++s)
        if (s < p.splits) v[u][s] = load4(p.ws + s * plane + at[u], lim[u],
                                          vec);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float4 sum = v[u][0];
#pragma unroll
      for (int s = 1; s < MAX_SPLITS; ++s)
        if (s < p.splits) sum = add4(sum, v[u][s]);
      gp::store4(p.out + at[u], lim[u], vec, sum);
    }
  }
}

template <int LA, int LB>
__global__ void __launch_bounds__(256, 2) ksplit_kernel(KsplitArgs p) {
  extern __shared__ float4 smem_raw[];
  const int tiles = gridDim.x * gridDim.y;
  const int tile = blockIdx.y * gridDim.x + blockIdx.x;
  const int s = blockIdx.z / p.inner, split = blockIdx.z % p.inner;
  const size_t k_lo = (size_t)s * p.kref;
  gp::MatmulArgs q = p.mm;
  // the slice's operands: column k_lo of A, row k_lo of B
  q.a += LA == gp::KC ? k_lo : k_lo * q.lda;
  q.b += LB == gp::KC ? k_lo : k_lo * q.ldb;
  q.k = min(q.k - (int)k_lo, p.kref);
  q.kper = p.kper_in;
  q.splits = p.inner;
  q.c = p.ws + (size_t)s * q.m * q.n;
  q.ws = p.part + (size_t)s * tiles * p.inner * T * T;
  q.counters = p.counters + s * tiles;
  const bool stored = gp::matmul_cta<T, T, TM, LA, LB>(
      q, reinterpret_cast<float*>(smem_raw), blockIdx.x, blockIdx.y, split,
      tile);
  if (!stored || p.out == nullptr) return;
  using S = gp::Split<T, T, TM>;
  if (!S::arrive(p.counters + p.splits * tiles + tile, p.splits)) return;
  fold(p, blockIdx.x * T, blockIdx.y * T);
}

template <int LA, int LB>
int launch(const KsplitArgs& p, cudaStream_t st) {
  constexpr int smem =
      gp::matmul_smem_floats<T, T, TM, LA, LB>() * (int)sizeof(float);
  auto kern = ksplit_kernel<LA, LB>;
  static unsigned opted = 0;
  cudaError_t e = gp::opt_in_smem(kern, smem, opted);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((p.mm.m + T - 1) / T, (p.mm.n + T - 1) / T,
                  p.splits * p.inner);
  kern<<<grid, gp::Mma<T, T, TM>::NT, smem, st>>>(p);
  return (int)cudaGetLastError();
}

template <int LA>
int launch_b(const KsplitArgs& p, int lb, cudaStream_t st) {
  switch (lb) {
    case gp::KC: return launch<LA, gp::KC>(p, st);
    case gp::XC: return launch<LA, gp::XC>(p, st);
    default: return launch<LA, gp::XC16>(p, st);
  }
}

}  // namespace

// la, lb: each operand's copy layout (gp::Layout, as for rt_matmul).
// splits, kref: the reference's split count and the depth of every split
// but the last; inner, kper_in: each split's own cut (inner > 1 needs
// part); ws: (splits, m, n); out: (m, n), null at one split (ws is C);
// counters: splits * tiles + tiles zeroed ints.
extern "C" int rt_matmul_ksplit(const void* a, const void* b, void* ws,
                                void* part, void* out, void* counters, int m,
                                int n, int k, int lda, int ldb, int la,
                                int lb, int splits, int kref, int inner,
                                int kper_in, void* stream) {
  KsplitArgs p;
  p.mm.a = static_cast<const float*>(a);
  p.mm.b = static_cast<const float*>(b);
  p.mm.c = nullptr;
  p.mm.ws = nullptr;
  p.mm.counters = nullptr;
  p.mm.m = m;
  p.mm.n = n;
  p.mm.k = k;
  p.mm.lda = lda;
  p.mm.ldb = ldb;
  p.mm.kper = kper_in;
  p.mm.splits = inner;
  p.ws = static_cast<float*>(ws);
  p.part = static_cast<float*>(part);
  p.out = static_cast<float*>(out);
  p.counters = static_cast<int*>(counters);
  p.splits = splits;
  p.kref = kref;
  p.inner = inner;
  p.kper_in = kper_in;
  if (m <= 0 || n <= 0) return (int)cudaSuccess;
  if (splits < 1 || splits > MAX_SPLITS || inner < 1 || kref < 0 ||
      kper_in < 0 || la < 0 || la > 2 || lb < 0 || lb > 2 ||
      (inner > 1 && part == nullptr) || counters == nullptr ||
      (long long)splits * inner > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (la) {
    case gp::KC: return launch_b<gp::KC>(p, lb, st);
    case gp::XC: return launch_b<gp::XC>(p, lb, st);
    default: return launch_b<gp::XC16>(p, lb, st);
  }
}
