// K6: one phase of a chained grouped launch (cross-module streaming).
//
// Replaces the TPU kernel
// repro/kernels/grouped_matmul.py::_gmm_chained_kernel (launcher
// grouped_matmul_chained).  The TPU runs all P phases of a chain in ONE
// launch on a lag-1 wave (wave w runs phase p's M-block w - p) and keeps
// the producer phase's row blocks in a 3-slot VMEM ring.  Hopper runs
// CTAs in no fixed order, so this first design launches the kernel once
// per phase, in phase order on one stream: stream order replaces the
// wave, and a ring consumer reads its producer phase's finished output
// panel from device memory (L2 for the chain's working set).  The single
// persistent launch, with each CTA owning an image-aligned stripe and the
// ring in shared memory, is later work.
//
// One launch computes, for every branch of the phase,
//   y = relu(lhs @ w + b) into its columns of the phase's padded panel,
// where lhs is the concatenation of the branch's k-steps, each a
// 128-column slab read from one of three places:
//   x      a dense (M, K_i) lhs array, column block cb (cols >= K_i: 0);
//   panel  a previous chain's padded panel in place, column block cb;
//   ring   an earlier phase's panel of THIS chain, column block cb, at row
//          offset dh*W + dw under the in-image border mask (a KxK conv as
//          K^2 shifted tap GEMMs).
// The weight rows come k-step-major (one 128-row slab per k-step).  Each
// CTA owns one 64 x 64 output tile: blockIdx.x is the M-block, blockIdx.y
// a per-output-tile table row (branch, first column); the branch's k-step
// list is a second table, both built once per chain shape by the wrapper
// and kept on the device.  The whole padded width of every branch is
// stored, so padding columns come out exactly 0 (relu(0 + 0)).
// Ragged M: the wrapper launches only the M-blocks below m_lim
// (image-aligned), rows at/past m_lim inside a live block store zeros,
// and dead blocks are never launched.
// Bound on this card: the chains are operation-bound on paper; this first
// design runs f32 FMA on the CUDA cores and re-reads ring taps from L2,
// so it reaches a fraction of the 67 TFLOP/s f32 rate.
#include "tile_gemm.cuh"

namespace {

constexpr int MAXB = 8;       // branches per phase
constexpr int MAXX = 8;       // dense lhs arrays per phase
constexpr int MAXS = 8;       // panel sources (previous chain + this chain)
constexpr int MAXSTEPS = 128; // k-steps per branch
constexpr int KSTEP = 128;    // columns per k-step

enum StepKind { kX = 0, kPanel = 1, kRing = 2 };

struct ChainArgs {
  const float* x[MAXX];   // dense lhs arrays, (M, K_i) contiguous
  int ldx[MAXX];
  const float* src[MAXS]; // panels: previous chain's, then this chain's
  int lds[MAXS];
  const float* w[MAXB];   // (nsteps_b * 128, n_b) contiguous
  const float* b[MAXB];   // (n_b,) or null
  int n[MAXB];
  int nsteps[MAXB];
  int step0[MAXB];        // first row of the branch in the k-step table
  int ocol[MAXB];         // first output column of the branch
  float* out;             // (Mp, ldo) padded panel of this phase
  int ldo;
  const int* tiles;       // per column tile: (branch, first column)
  const int* steps;       // per k-step: (kind, array/src, col block, a, b)
  int m_lim;              // rows at/past this store zeros (and read none)
  int mp;                 // rows of the output panel
  int h, w_;              // spatial dims decoding ring rows (m = B*h*w)
};

__global__ void __launch_bounds__(rt::NT) gmm_chained_kernel(ChainArgs a) {
  __shared__ int st[MAXSTEPS * 5];
  const int g = a.tiles[2 * blockIdx.y];
  const int c0 = a.tiles[2 * blockIdx.y + 1];
  const int m0 = blockIdx.x * rt::BM;
  const int nsteps = a.nsteps[g];
  for (int i = threadIdx.x; i < nsteps * 5; i += rt::NT)
    st[i] = a.steps[a.step0[g] * 5 + i];
  __syncthreads();

  const float* __restrict__ w = a.w[g];
  const int N = a.n[g];
  const int m_lim = a.m_lim;
  const int hw = a.h * a.w_;

  auto load_a = [&](int r, int k) -> float {
    const int gr = m0 + r;
    if (gr >= m_lim) return 0.f;
    const int s = k / KSTEP;
    const int cc = k - s * KSTEP;
    const int* d = st + 5 * s;
    const int col = d[2] * KSTEP + cc;
    if (d[0] == kX) {
      if (col >= d[3]) return 0.f;
      return a.x[d[1]][(size_t)gr * a.ldx[d[1]] + col];
    }
    if (d[0] == kPanel) return a.src[d[1]][(size_t)gr * a.lds[d[1]] + col];
    const int rem = gr % hw;
    const int yy = rem / a.w_ + d[3];
    const int xx = rem % a.w_ + d[4];
    if (yy < 0 || yy >= a.h || xx < 0 || xx >= a.w_) return 0.f;
    const int sr = gr + d[3] * a.w_ + d[4];
    return a.src[d[1]][(size_t)sr * a.lds[d[1]] + col];
  };
  auto load_b = [&](int k, int c) -> float {
    const int gc = c0 + c;
    return gc < N ? w[(size_t)k * N + gc] : 0.f;
  };

  float acc[rt::TM][rt::TN];
#pragma unroll
  for (int i = 0; i < rt::TM; ++i)
#pragma unroll
    for (int j = 0; j < rt::TN; ++j) acc[i][j] = 0.f;
  rt::tile_gemm(acc, nsteps * KSTEP, load_a, load_b);

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const float* __restrict__ bias = a.b[g];
  const int ocol = a.ocol[g];
#pragma unroll
  for (int i = 0; i < rt::TM; ++i) {
    const int r = m0 + ty * rt::TM + i;
    if (r >= a.mp) continue;
#pragma unroll
    for (int j = 0; j < rt::TN; ++j) {
      const int c = c0 + tx * rt::TN + j;
      float y = 0.f;
      if (r < m_lim) {
        y = acc[i][j] + ((bias != nullptr && c < N) ? bias[c] : 0.f);
        y = rt::relu_keep_nan(y);
      }
      a.out[(size_t)r * a.ldo + ocol + c] = y;
    }
  }
}

}  // namespace

extern "C" int rt_gmm_chained(
    int nb, const void* const* w, const void* const* b, const int* n,
    const int* nsteps, const int* step0, const int* ocol, int nx,
    const void* const* x, const int* ldx, int nsrc, const void* const* src,
    const int* lds, void* out, int ldo, const void* tiles, int ntiles,
    const void* steps, int m_lim, int mp, int grid_m, int h, int wd,
    void* stream) {
  if (nb < 1 || nb > MAXB || nx < 0 || nx > MAXX || nsrc < 0 ||
      nsrc > MAXS)
    return (int)cudaErrorInvalidValue;
  ChainArgs a = {};
  for (int i = 0; i < nb; ++i) {
    if (nsteps[i] > MAXSTEPS) return (int)cudaErrorInvalidValue;
    a.w[i] = static_cast<const float*>(w[i]);
    a.b[i] = static_cast<const float*>(b[i]);
    a.n[i] = n[i];
    a.nsteps[i] = nsteps[i];
    a.step0[i] = step0[i];
    a.ocol[i] = ocol[i];
  }
  for (int i = 0; i < nx; ++i) {
    a.x[i] = static_cast<const float*>(x[i]);
    a.ldx[i] = ldx[i];
  }
  for (int i = 0; i < nsrc; ++i) {
    a.src[i] = static_cast<const float*>(src[i]);
    a.lds[i] = lds[i];
  }
  a.out = static_cast<float*>(out);
  a.ldo = ldo;
  a.tiles = static_cast<const int*>(tiles);
  a.steps = static_cast<const int*>(steps);
  a.m_lim = m_lim;
  a.mp = mp;
  a.h = h;
  a.w_ = wd;
  const dim3 grid(grid_m, ntiles);
  if (grid_m == 0 || ntiles == 0) return (int)cudaSuccess;
  gmm_chained_kernel<<<grid, rt::NT, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
