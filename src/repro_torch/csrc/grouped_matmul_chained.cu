// K6: every phase of a chained grouped launch in ONE launch
// (cross-module streaming).
//
// Replaces the TPU kernel
// repro/kernels/grouped_matmul.py::_gmm_chained_kernel (launcher
// grouped_matmul_chained).  For every branch of every phase it computes
//   y = relu(lhs @ w + b) into the branch's columns of its phase's
// padded output panel, where lhs is the concatenation of the branch's
// k-steps, each a 128-column slab read from one of three places:
//   x      a dense (M, K_i) lhs array, column block cb;
//   panel  a previous chain's padded panel in place, column block cb;
//   ring   an earlier phase's panel of THIS chain, column block cb, at row
//          offset dh*W + dw under the in-image border mask (a KxK conv as
//          K^2 shifted tap GEMMs).
// The weight rows come k-step-major (one 128-row slab per k-step).
//
// Bound on this card: operations.  A bucket-2 serving dispatch's chains
// need 23.9 GFLOP of f32 FMA on the CUDA cores (0.36 ms at 67 TFLOP/s);
// their bytes are a few tens of MB, mostly rows one phase writes and the
// next reads, which stay in the 50 MB L2.
//
// Design.  The TPU runs the phases on one in-order grid, a lag-1 wave,
// with the producer's rows in a VMEM ring.  Hopper runs CTAs in no fixed
// order, so the wrapper lists work items -- (phase, m-block, branch,
// 128 x 128 output tile, split) -- in a topological wavefront order, and
// each CTA takes the next item from an atomic ticket, never from
// blockIdx.  A ring consumer waits, one thread spinning on an acquire
// load, until the producer phase's m-blocks that its rows, widened by
// the taps' offsets, overlap have stored all their tiles: a done counter
// per (phase, m-block) that a tile raises after its stores and a fence.
// Every item a CTA waits on has a smaller ticket, so it was taken by a
// CTA already running: the launch cannot deadlock, whatever the
// residency or the block dispatch order.  The ring stays in device
// memory: one 128-column slab of a 56 x 56 image is 1.6 MB, far above an
// SM's shared memory, and the L2 holds it; rows this launch wrote are
// read through L2 (cp.async.cg), never through L1.
//
// Each item runs the pipelined engine of gemm_pipe.cuh (3-stage cp.async
// ring, 8 x 8 micro-tiles, two CTAs an SM).  The lhs tile of a k-step is
// one source slab: per row the source address and the in-image mask are
// worked out once per k-step, rows outside the image or past m_lim are
// zero-fill copies.  Panels and 16-byte aligned x arrays take 16-byte
// copies along the depth, so the lhs lands row-major (Mma::step_rows);
// an x array with another leading dimension (stem0's im2col, K = 147)
// takes 4-byte ones.  No FMA is issued on padding: a k-step runs only
// its live columns (rounded up to BK), the layout's widths that the
// table holds, and a tile with at most 64 live columns multiplies only
// its left half; the padding columns are still stored as exact zeros.
// A chain is a few dependent phases, so its time is its critical path: a
// phase whose tiles do not fill two CTAs on every SM has its depth cut
// into shallow splits, and the last split CTA of a tile sums the partials
// in split order (gp::Split), so results repeat bit for bit.  The CTA
// that finishes last sets the ticket, finish and done counters back to 0
// for the next launch.
#include "gemm_pipe.cuh"

namespace {

constexpr int MAXX = 16;   // dense lhs arrays per chain
constexpr int MAXS = 16;   // panels: previous chain's, then this chain's
constexpr int MAXB = 32;   // branches per chain
constexpr int T = 128;     // tile rows and columns
constexpr int KSTEP = 128; // columns of a k-step slab
constexpr int BK = gp::BK;
using E = gp::Mma<T, T>;   // 256 threads
using Sp = gp::Split<T, T>;
// table rows (kernels/grouped_matmul.py::chained_launch)
constexpr int IT = 13, DP = 3, BRW = 6, STW = 8;
constexpr int A_STAGE = T * BK;   // lhs tile, row-major [T][BK]
constexpr int B_STAGE = gp::Tile<T, E::NT, gp::XC16>::STAGE;
constexpr int SMEM = gp::STAGES * (A_STAGE + B_STAGE) * (int)sizeof(float);

enum StepKind { kX = 0, kPanel = 1, kRing = 2 };

struct ChainArgs {
  const float* x[MAXX];   // dense lhs arrays, (M, K_i) row-major
  int ldx[MAXX];
  int x16[MAXX];          // 16-byte copies (address and ldx allow them)
  const float* src[MAXS]; // panels: previous chain's, then one per phase
  int lds[MAXS];
  const float* w[MAXB];   // (k-steps * 128, n_g) row-major
  const float* b[MAXB];   // (n_g,) or null
  const int* tab;         // the chain's table
  int it_off, dp_off, br_off, st_off, tg_off;
  int n_items, nblk, nphase, npanels;
  int m_lim;              // rows at/past this store zeros (and read none)
  int h, w_;              // spatial dims decoding ring rows (m = B*h*w)
  int* ctr;               // [ticket, finish, done[nphase][nblk], splits]
  float* ws;              // split partials, one T x T slot per split
};

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

// bias, ReLU, the row limit and the branch's true width on tile row r,
// columns c .. c + 3 (c relative to the tile), stored at the branch's
// columns of its phase's panel
__device__ __forceinline__ void store4(float* out, int ldo, int ocol,
                                       const float* bias, int n, int m_lim,
                                       int m0, int n0, int r, int c,
                                       float4 v) {
  const int gr = m0 + r, col = n0 + c;
  float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float y = 0.f;
    if (gr < m_lim && col + j < n) {
      y = e[j] + (bias != nullptr ? __ldg(bias + col + j) : 0.f);
      y = gp::relu_keep_nan(y);
    }
    e[j] = y;
  }
  __stcg(reinterpret_cast<float4*>(out + (size_t)gr * ldo + ocol + col),
         make_float4(e[0], e[1], e[2], e[3]));
}

// LB: the weights' copy layout (XC16 or XC)
template <int LB>
__global__ void __launch_bounds__(E::NT, 2) gmm_chained_kernel(ChainArgs a) {
  using TB = gp::Tile<T, E::NT, LB>;
  extern __shared__ float4 smem_raw[];
  float* sa = reinterpret_cast<float*>(smem_raw);
  float* sb = sa + gp::STAGES * A_STAGE;
  __shared__ int s_ticket, s_last;
  const int tid = threadIdx.x;
  if (tid == 0) s_ticket = atomicAdd(a.ctr, 1);
  __syncthreads();
  const int* it = a.tab + a.it_off + IT * s_ticket;
  const int p = it[0], mb = it[1], g = it[2], n0 = it[3];
  const bool half = it[4] < T;
  const int s = it[5], S = it[6], klo = it[7], khi = it[8];
  const int tile = it[9], slot = it[10], dep0 = it[11], ndep = it[12];
  const int* br = a.tab + a.br_off + BRW * g;
  const int n = br[1], ocol = br[2], step0 = br[3];
  const int m0 = mb * T, m_lim = a.m_lim;
  int* done = a.ctr + 2;

  // wait for the producer blocks this item's ring taps read
  if (tid == 0) {
    for (int d = 0; d < ndep; ++d) {
      const int* dp = a.tab + a.dp_off + DP * (dep0 + d);
      const int pp = dp[0], want = a.tab[a.tg_off + pp];
      for (int j = dp[1]; j <= dp[2]; ++j)
        while (ld_acquire(done + pp * a.nblk + j) < want) __nanosleep(64);
    }
  }
  __syncthreads();

  // this thread's lhs copies: rows ar and ar + T / 2, depths 4 * aq ..
  // + 3 of each BK chunk; their image coordinates for the ring masks
  const int ar = tid / 4, aq = tid % 4;
  const int hw = a.h * a.w_;
  int gr[2], ry[2], rx[2];
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    gr[q] = m0 + ar + q * (T / 2);
    const int rem = gr[q] % hw;
    ry[q] = rem / a.w_;
    rx[q] = rem - ry[q] * a.w_;
  }
  const float* zsrc = reinterpret_cast<const float*>(a.tab);  // 0-byte copies

  // the k-step cursor: step si of the branch covers chunks [c0, c1)
  int si = step0, c0 = 0, c1 = 0, live = 0, slab = 0;
  bool v16 = true;
  const float* rp[2] = {nullptr, nullptr};
  auto enter = [&](int k) {
    const int* st = a.tab + a.st_off + STW * k;
    const int kind = st[0], arr = st[1], cb = st[2], dh = st[3], dw = st[4];
    live = st[5];
    c0 = st[6];
    c1 = c0 + (live + BK - 1) / BK;
    slab = st[7];
    v16 = kind != kX || a.x16[arr];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const float* r = nullptr;
      if (gr[q] < m_lim) {
        if (kind == kX) {
          r = a.x[arr] + (size_t)gr[q] * a.ldx[arr] + cb * KSTEP;
        } else if (kind == kPanel) {
          r = a.src[arr] + (size_t)gr[q] * a.lds[arr] + cb * KSTEP;
        } else {
          const int yy = ry[q] + dh, xx = rx[q] + dw;
          if (yy >= 0 && yy < a.h && xx >= 0 && xx < a.w_)
            r = a.src[arr] + (size_t)(gr[q] + dh * a.w_ + dw) * a.lds[arr] +
                cb * KSTEP;
        }
      }
      rp[q] = r;
    }
  };
  enter(si);
  while (klo >= c1) enter(++si);

  const float* __restrict__ wg = a.w[g];
  float acc[8][8];
  gp::gemm<T, T>(
      acc, sa, A_STAGE, sb, B_STAGE, khi - klo, E::warp_live(m_lim - m0),
      [&](int st, int kt) {
        const int ch = klo + kt;
        while (ch >= c1) enter(++si);
        const int col = (ch - c0) * BK;
        const int ca = col + 4 * aq;
        const int nv = min(max(live - ca, 0), 4);
        float* dst = sa + st * A_STAGE + ar * BK + 4 * aq;
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const float* r = rp[q];
          const int nq = r != nullptr ? nv : 0;
          const unsigned d = gp::smem_u32(dst + q * (T / 2) * BK);
          if (v16) {
            gp::cp16(d, nq ? r + ca : zsrc, 4 * nq);
          } else {
#pragma unroll
            for (int e = 0; e < 4; ++e)
              gp::cp4(d + 4 * e, e < nq ? r + ca + e : zsrc, e < nq ? 4 : 0);
          }
        }
        const int k0 = slab * KSTEP + col;
        TB::issue(sb + st * B_STAGE, wg, n, n0, n, k0, slab * KSTEP + live);
      },
      gp::NoHook(),
      [&](float (&c)[8][8], const float* As, const float* Bs) {
        if (half)
          E::step_rows<true>(c, As, Bs);
        else
          E::step_rows<false>(c, As, Bs);
      });

  float* out = const_cast<float*>(a.src[a.npanels + p]);
  const int ldo = a.lds[a.npanels + p];
  const float* bias = a.b[g];
  bool stored = true;
  if (S == 1) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        store4(out, ldo, ocol, bias, n, m_lim, m0, n0, E::row(i),
               E::col(4 * h),
               make_float4(acc[i][4 * h], acc[i][4 * h + 1],
                           acc[i][4 * h + 2], acc[i][4 * h + 3]));
  } else {
    float* slot0 = a.ws + (size_t)slot * Sp::TILE;
    Sp::put(slot0 + (size_t)s * Sp::TILE, acc, T, T);
    stored = Sp::arrive(done + a.nphase * a.nblk + tile, S);
    if (stored)
      Sp::reduce(slot0, S, T, T, [&](int r, int c, float4 v) {
        store4(out, ldo, ocol, bias, n, m_lim, m0, n0, r, c, v);
      });
  }
  // publish the tile: its stores, a fence, then the done count
  if (stored) {
    __threadfence();
    __syncthreads();
    if (tid == 0) atomicAdd(done + p * a.nblk + mb, 1);
  }
  // the CTA that finishes last zeroes the ticket, finish and done counters
  if (tid == 0) {
    __threadfence();
    s_last = atomicAdd(a.ctr + 1, 1) == a.n_items - 1;
  }
  __syncthreads();
  if (s_last)
    for (int k = tid; k < 2 + a.nphase * a.nblk; k += E::NT) a.ctr[k] = 0;
}

template <int LB>
int launch(const ChainArgs& a, cudaStream_t s) {
  auto kern = gmm_chained_kernel<LB>;
  static unsigned opted = 0;
  cudaError_t e = gp::opt_in_smem(kern, SMEM, opted);
  if (e != cudaSuccess) return (int)e;
  kern<<<a.n_items, E::NT, SMEM, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// One launch of a whole chain.  ptrs: the nx dense lhs arrays, the nsrc
// panels (the previous chain's, then this chain's output panel of each
// phase), the nb branches' weights, then their biases (null: none).
// ints: ldx and x16 of each array, then lds of each panel.  tab: the
// chain's int32 table on the device, its sections at offs (items,
// dependencies, branches, k-steps, per-phase done counts).  counters:
// 2 + nphase * nblk + split tiles zeroed ints, left zeroed; ws: one
// T x T f32 slot per split item.  w16: every weight takes 16-byte copies.
extern "C" int rt_gmm_chained(const void* const* ptrs, const int* ints,
                              int nx, int nsrc, int nb, const void* tab,
                              const int* offs, int n_items, int nblk,
                              int nphase, int npanels, int m_lim, int h,
                              int wd, void* counters, void* ws, int w16,
                              void* stream) {
  if (nx < 0 || nx > MAXX || nsrc < 1 || nsrc > MAXS || nb < 1 ||
      nb > MAXB || npanels + nphase != nsrc)
    return (int)cudaErrorInvalidValue;
  ChainArgs a = {};
  for (int i = 0; i < nx; ++i) {
    a.x[i] = static_cast<const float*>(ptrs[i]);
    a.ldx[i] = ints[i];
    a.x16[i] = ints[nx + i];
  }
  for (int i = 0; i < nsrc; ++i) {
    a.src[i] = static_cast<const float*>(ptrs[nx + i]);
    a.lds[i] = ints[2 * nx + i];
  }
  for (int i = 0; i < nb; ++i) {
    a.w[i] = static_cast<const float*>(ptrs[nx + nsrc + i]);
    a.b[i] = static_cast<const float*>(ptrs[nx + nsrc + nb + i]);
  }
  a.tab = static_cast<const int*>(tab);
  a.it_off = offs[0];
  a.dp_off = offs[1];
  a.br_off = offs[2];
  a.st_off = offs[3];
  a.tg_off = offs[4];
  a.n_items = n_items;
  a.nblk = nblk;
  a.nphase = nphase;
  a.npanels = npanels;
  a.m_lim = m_lim;
  a.h = h;
  a.w_ = wd;
  a.ctr = static_cast<int*>(counters);
  a.ws = static_cast<float*>(ws);
  if (n_items == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return w16 ? launch<gp::XC16>(a, s) : launch<gp::XC>(a, s);
}
