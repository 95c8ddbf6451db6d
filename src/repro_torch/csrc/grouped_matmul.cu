// Grouped ragged branch GEMMs: K1 (fused epilogue-concat) and K2 (pooled).
//
// Replaces the TPU kernels
//   K1 repro/kernels/grouped_matmul.py::_gmm_kernel        (the concat
//      launcher grouped_matmul_concat),
//   K2 repro/kernels/grouped_matmul.py::_gmm_pooled_kernel (the launcher
//      _pooled_launch, grouped_matmul_pooled).
// Both compute y_g = relu(pool(x_g) @ w_g + b_g) for G branches sharing
// M with ragged (K_g, N_g), rows at/past m_lim stored as zeros.  On the
// training path they are each inception module's two forward launches
// (9 + 9 a GoogLeNet step); at serve bucket 1, 1 + 2 a dispatch.
//
// Bound on this card: operations.  The training shapes do up to 2 *
// 25088 * 256 * 288 FLOP a branch on far fewer bytes than the f32 ridge
// (67 TFLOP/s of CUDA-core FMA against 3.35 TB/s) allows; at serve
// bucket 1 (M = 196 to 3136) a launch has a few tiles, so it is bound by
// how many SMs its CTAs reach.  The kernel stays on the CUDA cores in
// f32 (3xTF32 is later work).
//
// Design.  The TPU kernels walk one flattened in-order grid and carry the
// accumulator (and the pooled-lhs scratch) from step to step.  Here every
// CTA takes one entry of a table the wrapper builds once per launch shape
// and keeps on the device, (branch g, m-block i, n-block j, split s of S,
// k_lo, k_hi), and runs the pipelined engine of gemm_pipe.cuh (128 x 128
// tile, 8 x 8 micro-tiles, 3-stage ring, two CTAs an SM) over its
// branch's depth [k_lo, k_hi).  The n-blocks of an m-block are
// neighbours in the table, so CTAs running together read the same lhs
// rows.  When a launch has fewer output tiles than the card has SMs
// (the 14 x 14 modules of a step, the deeper launches at serve bucket
// 1), the wrapper cuts the depth into splits (matmul.py::split_plan) and the
// last CTA of a tile to arrive sums the partials in split order
// (gp::Split) and applies the epilogue: results repeat bit for bit.
//   The lhs of a dense branch is (M, K_g) row-major: cp.async copies
//      into the ring (the engine's KC layout).  The weights are (K_g, N_g)
//      row-major: 16-byte copies when every base and width allows (XC16),
//      else 4-byte ones (XC).
//   The lhs of a pooled branch is never stored: it is the max of T taps,
//      each a view of the pooling stage's padded input, read where they
//      lie.  The taps share one row map, row m -> (b, oh, ow) ->
//      b * sb + oh * sh + ow * sw, channels contiguous; a contiguous
//      (M, K) tap is OH = 1, OW = M.  cp.async cannot take a max, so the
//      pooled tile reaches the ring through registers: each thread owns
//      4 consecutive depths of two tile rows (a 16-byte load a row and
//      tap when the taps' bases, strides and K_g are multiples of 4
//      floats, four 4-byte loads otherwise), four threads a row's 16
//      depths, so a warp's load covers 8 rows of 64 bytes; it reads the
//      T taps through the L1 cache (neighbouring taps and rows overlap,
//      so most reads hit),
//      folds them with the reference's NaN-propagating, first-tap-seeded
//      select (gp::pool_max), and stores the result into the ring stage
//      the copies of that k-step would fill.  The loads stall only the
//      warp that issues them; the SM's other warps multiply meanwhile.
//   The epilogue adds the bias, applies ReLU (NaN kept), stores zeros at
//      and past m_lim, and writes K1's branches at their column offsets
//      of the join buffer (columns no branch owns are left alone).
#include "gemm_pipe.cuh"

namespace {

constexpr int MAXG = 8;
constexpr int MAXT = 16;   // grouped_matmul.py POOL_TAP_LIMIT
constexpr int T = 128;                 // tile rows and columns
using E = gp::Mma<T, T>;               // 256 threads
using Sp = gp::Split<T, T>;
using TKC = gp::Tile<T, E::NT, gp::KC>;

struct FwdArgs {
  const float* x[MAXG];          // dense lhs (M, K_g), row stride ldx
  const float* tap[MAXG][MAXT];  // pooled lhs: taps[g] tap bases
  const float* w[MAXG];          // (K_g, N_g) contiguous
  const float* b[MAXG];          // (N_g,) or null
  float* out[MAXG];              // branch g's output base
  long long sb[MAXG];            // the taps' row map (floats)
  long long sh[MAXG];
  long long sw[MAXG];
  int k[MAXG];
  int n[MAXG];
  int taps[MAXG];                // 0: dense lhs
  int ldx[MAXG];
  int plane[MAXG];               // rows per image, OH * OW
  int ow[MAXG];
  int ldo[MAXG];                 // output row stride (floats)
  int ocol[MAXG];                // first output column of branch g
  int nstore[MAXG];              // columns of branch g to store (>= n: zeros)
  const int* tiles;              // per CTA: (g, i, j, s, S, k_lo, k_hi)
  float* ws;                     // split: one T x T partial per entry
  int* counters;                 // split: a zeroed counter per entry
  int m;                         // rows of the lhs and the output
  int m_lim;                     // rows at/past this store zeros
  int relu;
};

constexpr int ENTRY = 7;
constexpr int SMEM = gp::STAGES * 2 * TKC::STAGE * (int)sizeof(float);

__device__ __forceinline__ float4 pool_max4(float4 a, float4 v) {
  return make_float4(gp::pool_max(a.x, v.x), gp::pool_max(a.y, v.y),
                     gp::pool_max(a.z, v.z), gp::pool_max(a.w, v.w));
}

// The pooled A tile of k-step k0 into ring stage s ([BK][T + PAD], as
// TKC lays it out): this thread's rows r and r + T / 2 (offsets roff in
// every tap, < 0 past m_lim) at depths k0 + 4q .. + 3, below klim.  A
// warp reads 8 rows of 16 consecutive depths (64 bytes) a tap.
template <bool V4>
__device__ __forceinline__ void pool_tile(float* s, const FwdArgs& a, int g,
                                          int ntap,
                                          const long long (&roff)[2], int r,
                                          int q, int k0, int klim) {
  const int kb = k0 + 4 * q;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float4 u = make_float4(0.f, 0.f, 0.f, 0.f);
    if (roff[i] >= 0 && kb < klim) {
      const float* p = a.tap[g][0] + roff[i] + kb;
      if (V4) {
        // klim is K_g or a split edge, both multiples of 4 here
        u = __ldg(reinterpret_cast<const float4*>(p));
#pragma unroll 2
        for (int t = 1; t < ntap; ++t)
          u = pool_max4(u, __ldg(reinterpret_cast<const float4*>(
                               a.tap[g][t] + roff[i] + kb)));
      } else {
        const int nj = min(klim - kb, 4);
        float v[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (j < nj) v[j] = __ldg(p + j);
        for (int t = 1; t < ntap; ++t) {
          p = a.tap[g][t] + roff[i] + kb;
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (j < nj) v[j] = gp::pool_max(v[j], __ldg(p + j));
        }
        u = make_float4(v[0], v[1], v[2], v[3]);
      }
    }
    float* d = s + 4 * q * TKC::LD + r + i * (T / 2);
    d[0] = u.x;
    d[TKC::LD] = u.y;
    d[2 * TKC::LD] = u.z;
    d[3 * TKC::LD] = u.w;
  }
}

// bias, ReLU and the row limit on output row r, branch columns c .. c + 3
// (those below nstore), stored at the branch's column offset
__device__ __forceinline__ void store4(const FwdArgs& a, int g, int r, int c,
                                       float4 v) {
  const int nstore = a.nstore[g];
  if (c >= nstore) return;
  const int N = a.n[g];
  const float* __restrict__ bias = a.b[g];
  const bool live = r < a.m_lim;
  float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float y = 0.f;
    if (live && c + j < N) {
      y = e[j] + (bias != nullptr ? bias[c + j] : 0.f);
      if (a.relu) y = gp::relu_keep_nan(y);
    }
    e[j] = y;
  }
  const int ldo = a.ldo[g], ocol = a.ocol[g];
  float* dst = a.out[g] + (size_t)r * ldo + ocol + c;
  if (c + 3 < nstore && (ldo % 4) == 0 && (ocol % 4) == 0) {
    *reinterpret_cast<float4*>(dst) = make_float4(e[0], e[1], e[2], e[3]);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (c + j < nstore) dst[j] = e[j];
  }
}

// LB: the weights' copy layout (XC or XC16); V4: the pooled taps take
// 16-byte loads
template <int LB, bool V4>
__global__ void __launch_bounds__(E::NT, 2) gmm_kernel(FwdArgs a) {
  using TB = gp::Tile<T, E::NT, LB>;
  extern __shared__ float4 smem_raw[];
  float* sa = reinterpret_cast<float*>(smem_raw);
  float* sb = sa + gp::STAGES * TKC::STAGE;
  const int* t = a.tiles + ENTRY * blockIdx.x;
  const int g = t[0], m0 = t[1] * T, n0 = t[2] * T, s = t[3], S = t[4];
  const int klo = t[5], khi = t[6];
  const int ntap = a.taps[g];

  // a pooled branch: this thread's two tile rows and their offsets in
  // the taps
  const int pr = threadIdx.x / 4, pq = threadIdx.x % 4;
  long long roff[2] = {-1, -1};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int gm = m0 + pr + i * (T / 2);
    if (ntap > 0 && gm < a.m_lim) {
      const int bi = gm / a.plane[g], rem = gm - bi * a.plane[g];
      const int oh = rem / a.ow[g], ow = rem - oh * a.ow[g];
      roff[i] = bi * a.sb[g] + oh * a.sh[g] + ow * a.sw[g];
    }
  }

  float acc[8][8];
  gp::gemm<T, T>(
      acc, sa, TKC::STAGE, sb, TB::STAGE,
      (khi - klo + gp::BK - 1) / gp::BK, E::warp_live(a.m_lim - m0),
      [&](int st, int kt) {
        const int k0 = klo + kt * gp::BK;
        if (ntap == 0)
          TKC::issue(sa + st * TKC::STAGE, a.x[g], a.ldx[g], m0, a.m_lim,
                     k0, khi);
        else
          pool_tile<V4>(sa + st * TKC::STAGE, a, g, ntap, roff, pr, pq, k0,
                        khi);
        TB::issue(sb + st * TB::STAGE, a.w[g], a.n[g], n0, a.n[g], k0,
                  khi);
      });

  const int rows = a.m - m0, cols = a.nstore[g] - n0;
  if (S == 1) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = m0 + E::row(i);
      if (r >= a.m) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h)
        store4(a, g, r, n0 + E::col(4 * h),
               make_float4(acc[i][4 * h], acc[i][4 * h + 1],
                           acc[i][4 * h + 2], acc[i][4 * h + 3]));
    }
    return;
  }
  const int e0 = blockIdx.x - s;   // the tile's split 0 entry
  float* slot0 = a.ws + (size_t)e0 * Sp::TILE;
  Sp::put(slot0 + (size_t)s * Sp::TILE, acc, rows, cols);
  if (!Sp::arrive(a.counters + e0, S)) return;
  Sp::reduce(slot0, S, rows, cols, [&](int r, int c, float4 v) {
    store4(a, g, m0 + r, n0 + c, v);
  });
}

template <int LB, bool V4>
int launch(const FwdArgs& a, int ntiles, cudaStream_t s) {
  auto kern = gmm_kernel<LB, V4>;
  static unsigned opted = 0;
  cudaError_t e = gp::opt_in_smem(kern, SMEM, opted);
  if (e != cudaSuccess) return (int)e;
  kern<<<ntiles, E::NT, SMEM, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// One launch of K1 or K2.  ptrs: 4 * g pointers, per branch in turn the
// dense lhs (null for a pooled branch), w, b (null: none), out; then the
// taps of every pooled branch, branch by branch.  ints: 9 * g, in turn
// k, n, taps (0: dense), ldx, plane, ow, ldo, ocol, nstore.  longs: 3 * g,
// in turn sb, sh, sw.  tiles: ntiles entries (g, i, j, s, S, k_lo, k_hi);
// a split launch needs ws (ntiles T x T partials) and ntiles zeroed
// counters.  w16: every weight takes 16-byte copies; v4: every pooled
// branch's taps take 16-byte loads.
extern "C" int rt_gmm_fwd(int g, const void* const* ptrs, const int* ints,
                          const long long* longs, const void* tiles,
                          int ntiles, int m, int m_lim, int relu, void* ws,
                          void* counters, int w16, int v4, void* stream) {
  if (g < 1 || g > MAXG) return (int)cudaErrorInvalidValue;
  FwdArgs a = {};
  int tp = 4 * g;
  for (int i = 0; i < g; ++i) {
    a.x[i] = static_cast<const float*>(ptrs[i]);
    a.w[i] = static_cast<const float*>(ptrs[g + i]);
    a.b[i] = static_cast<const float*>(ptrs[2 * g + i]);
    a.out[i] = static_cast<float*>(const_cast<void*>(ptrs[3 * g + i]));
    a.k[i] = ints[i];
    a.n[i] = ints[g + i];
    a.taps[i] = ints[2 * g + i];
    a.ldx[i] = ints[3 * g + i];
    a.plane[i] = ints[4 * g + i];
    a.ow[i] = ints[5 * g + i];
    a.ldo[i] = ints[6 * g + i];
    a.ocol[i] = ints[7 * g + i];
    a.nstore[i] = ints[8 * g + i];
    a.sb[i] = longs[i];
    a.sh[i] = longs[g + i];
    a.sw[i] = longs[2 * g + i];
    if (a.taps[i] < 0 || a.taps[i] > MAXT) return (int)cudaErrorInvalidValue;
    for (int j = 0; j < a.taps[i]; ++j)
      a.tap[i][j] = static_cast<const float*>(ptrs[tp++]);
  }
  a.tiles = static_cast<const int*>(tiles);
  a.ws = static_cast<float*>(ws);
  a.counters = static_cast<int*>(counters);
  a.m = m;
  a.m_lim = m_lim;
  a.relu = relu;
  if (ntiles == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (w16)
    return v4 ? launch<gp::XC16, true>(a, ntiles, s)
              : launch<gp::XC16, false>(a, ntiles, s);
  return v4 ? launch<gp::XC, true>(a, ntiles, s)
            : launch<gp::XC, false>(a, ntiles, s);
}
