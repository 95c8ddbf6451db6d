// Pipelined f32 tile GEMM engine for K1 and K2 (grouped_matmul.cu), K3
// (conv2d.cu), K4 (matmul.cu), K5 and K7 (grouped_matmul_bwd.cu), K6
// (grouped_matmul_chained.cu), K8 (matmul_ksplit.cu), K9
// (branch_matmul.cu), K10 (fused_branches.cu), K11
// (grouped_matmul_experts.cu) and K12 (grouped_matmul_experts_bwd.cu),
// the in-launch split reduction, tile stores and epilogue selects they
// share, and K4's CTA (matmul_cta), which K8 and K10 run as their GEMM.
//
// One CTA of 256 threads owns a BM x BN output tile and walks its depth
// BK = 16 at a time.  Each thread keeps a TM x 8 register micro-tile of
// f32 accumulators (8 x 8 in a 128 x 128 tile, two CTAs an SM; 16 x 8 in
// a 256 x 128 tile, one CTA an SM): rows ty * TM .. + TM - 1 and columns
// tx * 4 .. + 3 and BN / 2 + tx * 4 .. + 3, so per k a thread reads TM / 4
// float4 of A and two of B from shared memory for 8 * TM FMAs, and a
// warp's B reads cover 64 neighbouring floats (no bank conflict).
//
// Operand tiles move through a STAGES-deep ring in shared memory with
// cp.async, so STAGES - 1 k-steps of copies are in flight while the warps
// multiply: one barrier per k-step, no register staging.  Every tile lands
// k-major, [BK][R + PAD], whatever the operand's layout in device memory
// (K3 and K6 land their lhs row-major, [BM][BK], from copies along the
// depth, and multiply it with ``Mma::step_rows``):
//   XC16  contiguous along the tile's row/column index (A transposed, B
//         row-major), base and leading dimension multiples of 16 bytes:
//         16-byte copies of 4 neighbours;
//   XC    the same layout, unaligned (stem0's im2col operand has lda =
//         147): one 4-byte copy per element;
//   KC    contiguous along the depth (A row-major, B transposed): 4-byte
//         copies that transpose on the way, a warp reading 4 rows of 8
//         consecutive k (full 32-byte sectors) and writing 32 banks.
// Edges are the zero-fill form of cp.async (a source size below the copy
// size), never a branch per element.  In the XC and XC16 layouts a thread
// copies the same tile row/column at every k-step (``Tile::own``), which
// K5 uses to mask dy and sum db on the elements it copied itself, right
// after its own copies land and before the block's barrier.
//
// Shared memory (3 stages of two 128-wide tiles: 50,688 bytes) is above
// the 48 KB static limit, so kernels take it as opted-in dynamic shared
// memory.  Warps whose rows all lie past the operand's edge skip the
// multiply (a 64-row dW in a 128-row tile runs half its warps).
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace gp {

constexpr int BK = 16;
constexpr int STAGES = 3;
constexpr int PAD = 4;

enum Layout { KC = 0, XC = 1, XC16 = 2 };

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16-byte copy to shared address dst; bytes < 16 reads only that many
// and zero-fills the rest
__device__ __forceinline__ void cp16(unsigned dst, const float* src,
                                     int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

// 4-byte copy to shared address dst; bytes = 0 reads nothing, writes 0
__device__ __forceinline__ void cp4(unsigned dst, const float* src,
                                    int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ReLU that keeps NaN, as torch.relu and jnp.maximum(y, 0) do
// (fmaxf would turn a NaN into 0).
__device__ __forceinline__ float relu_keep_nan(float y) {
  return y < 0.f ? 0.f : y;
}

// NaN-propagating max with the first operand seeding, the select the
// reference pool fold uses: where(isnan(v) | (v > acc), v, acc).
__device__ __forceinline__ float pool_max(float acc, float v) {
  return (isnan(v) || v > acc) ? v : acc;
}

// One operand's BK x R tile (R = BM for A, BN for B).  Element (x, k) --
// x a row of A or a column of B, k the depth -- lies at base[x * ld + k]
// (KC) or base[k * ld + x] (XC, XC16); it lands at s[k * LD + x].
// A thread's copies sit at (x0 + i * DX, k0 + i * DK), i < PER, from one
// base coordinate (x0, k0), so a copy costs one pointer step.  LDX, the
// stage's row length, is R + PAD unless R columns fill part of a wider
// stage (K11 lands W_in's and W_gate's 64 columns side by side).
template <int R, int NT, int L, int LDX = R + PAD>
struct Tile {
  static constexpr int LD = LDX;
  static constexpr int STAGE = BK * LD;          // floats per ring stage
  static constexpr int VW = L == XC16 ? 4 : 1;   // floats per copy
  static constexpr int PER = BK * R / VW / NT;   // copies per thread
  // step between a thread's copies: KC along x (a warp's 32 copies take
  // 4 x-rows of 8 consecutive k); XC / XC16 along k (one fixed x)
  static constexpr int DX = L == KC ? NT / 16 : 0;
  static constexpr int DK = L == KC ? 0 : NT * VW / R;
  static_assert(PER >= 1 && (BK * R / VW) % NT == 0,
                "tile copies must divide evenly over the threads");
  static_assert(L == KC || NT % (R / VW) == 0,
                "XC/XC16: each thread copies one fixed row/column");
  static_assert(L != KC || (BK == 16 && NT % 64 == 0 && R % (NT / 16) == 0),
                "KC warp shape");

  // tile coordinates of this thread's first copy
  __device__ __forceinline__ static void first(int& x, int& kk) {
    const int t = threadIdx.x;
    if (L == XC16) {
      x = (t % (R / 4)) * 4;
      kk = t / (R / 4);
    } else if (L == XC) {
      x = t % R;
      kk = t / R;
    } else {
      x = (t % 32) / 8 + 4 * (t / 64);
      kk = t % 8 + 8 * ((t / 32) % 2);
    }
  }

  // issue this thread's copies of the tile at (x0, k0) into stage s;
  // x >= xlim or k >= klim reads nothing and lands as 0.  The source
  // pointer steps from copy to copy, so only it stays live.
  __device__ __forceinline__ static void issue(float* s, const float* base,
                                               int ld, int x0, int xlim,
                                               int k0, int klim) {
    int x, kk;
    first(x, kk);
    const int gx = x0 + x, gk = k0 + kk;
    const unsigned d = smem_u32(s + kk * LD + x);
    if (L == KC) {
      const float* src = base + (size_t)gx * ld + gk;
      const int rem = gk < klim ? xlim - gx : 0;   // copy i: i * DX < rem
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        const bool ok = i * DX < rem;
        cp4(d + 4 * i * DX, ok ? src : base, ok ? 4 : 0);
        src += (size_t)DX * ld;
      }
    } else {
      const float* src = base + (size_t)gk * ld + gx;
      const int nv = L == XC16 ? min(max(xlim - gx, 0), 4) : (gx < xlim);
      const int krem = klim - gk;                  // copy i: i * DK < krem
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        const int n = i * DK < krem ? nv : 0;
        if (L == XC16)
          cp16(d + 4 * i * DK * LD, n ? src : base, 4 * n);
        else
          cp4(d + 4 * i * DK * LD, n ? src : base, 4 * n);
        src += (size_t)DK * ld;
      }
    }
  }

  // f(v, m, e) on each element this thread copied into stage s (v) and
  // the element at the same place of a twin stage t (m); e counts the
  // floats of a 16-byte copy.  Valid once this thread's copies landed.
  template <class F>
  __device__ __forceinline__ static void own(float* s, const float* t,
                                             F f) {
    int x, kk;
    first(x, kk);
    const int o = kk * LD + x;
#pragma unroll
    for (int i = 0; i < PER; ++i)
#pragma unroll
      for (int e = 0; e < VW; ++e) {
        const int at = o + i * (DX + DK * LD) + e;
        f(s[at], t[at], e);
      }
  }

  // XC/XC16: the first tile row/column this thread copies, and the
  // number of threads that share it
  __device__ __forceinline__ static int own_x() {
    int x, kk;
    first(x, kk);
    return x;
  }
  static constexpr int SHARERS = NT * VW / R;
};

// The thread's TM x 8 micro-tile of the BM x BN tile (NT = BM * BN /
// (8 * TM) threads): rows ty * TM .. + TM - 1, columns tx * 4 .. + 3 and
// BN / 2 + tx * 4 .. + 3.
template <int BM, int BN, int TM = 8>
struct Mma {
  static constexpr int NT = BM * BN / (8 * TM);
  static constexpr int TX = BN / 8;
  static constexpr int LDA = BM + PAD;
  static constexpr int LDB = BN + PAD;
  static_assert(32 % TX == 0 && TM % 4 == 0, "micro-tile shape");
  static constexpr int WARP_ROWS = 32 / TX * TM;

  __device__ __forceinline__ static int tx() { return threadIdx.x % TX; }
  __device__ __forceinline__ static int ty() { return threadIdx.x / TX; }
  // accumulator (i, j): tile row row(i), column col(j)
  __device__ __forceinline__ static int row(int i) { return ty() * TM + i; }
  __device__ __forceinline__ static int col(int j) {
    return (j / 4) * (BN / 2) + tx() * 4 + j % 4;
  }
  // does any of this warp's rows lie below ``rows`` (warp-uniform)?
  __device__ __forceinline__ static bool warp_live(int rows) {
    return (int)(threadIdx.x / 32) * WARP_ROWS < rows;
  }

  __device__ __forceinline__ static void step(float (&acc)[TM][8],
                                              const float* As,
                                              const float* Bs) {
    const int ra = ty() * TM, cb = tx() * 4;
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM];
#pragma unroll
      for (int q = 0; q < TM / 4; ++q) {
        const float4 v =
            *reinterpret_cast<const float4*>(As + kk * LDA + ra + 4 * q);
        a[4 * q] = v.x;
        a[4 * q + 1] = v.y;
        a[4 * q + 2] = v.z;
        a[4 * q + 3] = v.w;
      }
      const float4 b0 = *reinterpret_cast<const float4*>(Bs + kk * LDB + cb);
      const float4 b1 =
          *reinterpret_cast<const float4*>(Bs + kk * LDB + BN / 2 + cb);
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }

  // The same product with the A tile row-major, As[row * BK + k]: per
  // four depths a thread reads TM float4 of A along the depth (the
  // threads of a quarter warp share one row: a broadcast) and two of B
  // per depth.  HALF: only the left BN / 2 columns (j < 4), the right
  // half of the tile being padding that the caller stores as zeros.
  template <bool HALF>
  __device__ __forceinline__ static void step_rows(float (&acc)[TM][8],
                                                   const float* As,
                                                   const float* Bs) {
    const int ra = ty() * TM, cb = tx() * 4;
#pragma unroll
    for (int k4 = 0; k4 < BK; k4 += 4) {
      float4 a[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i)
        a[i] = *reinterpret_cast<const float4*>(As + (ra + i) * BK + k4);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float* brow = Bs + (k4 + kk) * LDB;
        const float4 b0 = *reinterpret_cast<const float4*>(brow + cb);
        float4 b1 = make_float4(0.f, 0.f, 0.f, 0.f);
        if (!HALF) b1 = *reinterpret_cast<const float4*>(brow + BN / 2 + cb);
        const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float av = kk == 0 ? a[i].x
                         : kk == 1 ? a[i].y
                         : kk == 2 ? a[i].z
                                   : a[i].w;
#pragma unroll
          for (int j = 0; j < (HALF ? 4 : 8); ++j)
            acc[i][j] = fmaf(av, b[j], acc[i][j]);
        }
      }
    }
  }
};

// A hook that does nothing (gemm's landed, matmul_cta's ring riders).
struct NoHook {
  template <class... Args>
  __device__ __forceinline__ void operator()(Args...) const {}
};

// The default product of one k-step: Mma::step on k-major tiles.
template <int BM, int BN, int TM>
struct MmaStep {
  __device__ __forceinline__ void operator()(float (&acc)[TM][8],
                                             const float* As,
                                             const float* Bs) const {
    Mma<BM, BN, TM>::step(acc, As, Bs);
  }
};

// acc = A @ B over nk k-steps.  load(stage, kt) issues the copies of
// k-step kt into a ring stage (kt = 0, 1, 2, ... in turn); landed(stage,
// kt), where given, runs in every thread once its own copies of k-step kt
// have landed in that stage and before the block's barrier (it may touch
// only the elements the thread copied); step(acc, As, Bs), where given,
// multiplies one stage's tiles (default: Mma::step).  live: this warp
// multiplies (warp-uniform).  Ends with the block synchronised and every
// copy drained, so the caller may reuse the ring.
template <int BM, int BN, int TM, class Load, class Landed = NoHook,
          class Step = MmaStep<BM, BN, TM>>
__device__ __forceinline__ void gemm(float (&acc)[TM][8], const float* sa,
                                     int sa_stage, const float* sb,
                                     int sb_stage, int nk, bool live,
                                     Load load, Landed landed = Landed(),
                                     Step step = Step()) {
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load(s, s);
    commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    const int st = kt % STAGES;
    wait_group<STAGES - 2>();
    landed(st, kt);
    __syncthreads();
    const int nx = kt + STAGES - 1;
    if (nx < nk) load(nx % STAGES, nx);
    commit();
    if (live) step(acc, sa + st * sa_stage, sb + st * sb_stage);
  }
  wait_group<0>();
  __syncthreads();
}

// The split-K reduction of one output tile inside the launch.  Each of
// the tile's S split CTAs writes the valid part of its partial into its
// own workspace slot (2 * TM float4 per thread, [chunk][thread], chunk =
// 2 * i + column half), then arrives on the tile's counter; the CTA that
// arrives last sums the S partials in split order with all its threads,
// so no value depends on which CTA finished first and results repeat bit
// for bit.  The counter is the only atomic; the last CTA sets it back
// to 0, so a later launch on the same stream finds it zeroed.  The
// wrappers keep one counter buffer per stream (runtime.split_counters),
// so two launches at once on two streams never share a counter.
template <int BM, int BN, int TM = 8>
struct Split {
  using E = Mma<BM, BN, TM>;
  static constexpr int TILE = BM * BN;

  __device__ __forceinline__ static bool chunk_live(int i, int h, int rows,
                                                    int cols) {
    return E::row(i) < rows && E::col(4 * h) < cols;
  }

  __device__ __forceinline__ static void put(float* slot,
                                             const float (&acc)[TM][8],
                                             int rows, int cols) {
    float4* w = reinterpret_cast<float4*>(slot);
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (chunk_live(i, h, rows, cols))
          __stcg(&w[(2 * i + h) * E::NT + threadIdx.x],
                 make_float4(acc[i][4 * h], acc[i][4 * h + 1],
                             acc[i][4 * h + 2], acc[i][4 * h + 3]));
  }

  // true in every thread of the CTA that arrived last
  __device__ __forceinline__ static bool arrive(int* counter, int splits) {
    __shared__ int last;
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) {
      last = atomicAdd(counter, 1) == splits - 1;
      if (last) *counter = 0;
    }
    __syncthreads();
    if (last) __threadfence();
    return last;
  }

  // The last CTA: every one of its threads takes valid float4 chunks of
  // the tile in turn (row r, columns c .. c + 3, neighbouring threads on
  // neighbouring chunks), sums the splits' partials of each in split
  // order, U at a time in flight, and hands the sum to store(r, c, v).
  template <class Store>
  __device__ __forceinline__ static void reduce(const float* slot0,
                                                int splits, int rows,
                                                int cols, Store store) {
    constexpr int U = 16;
    const int nr = min(rows, BM), nc4 = (min(cols, BN) + 3) / 4;
    for (int f = threadIdx.x; f < nr * nc4; f += E::NT) {
      const int r = f / nc4, c = (f % nc4) * 4;
      const int owner = (r / TM) * E::TX + (c % (BN / 2)) / 4;
      const int chunk = 2 * (r % TM) + c / (BN / 2);
      const float4* p =
          reinterpret_cast<const float4*>(slot0) + chunk * E::NT + owner;
      float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
      int s = 0;
      for (; s + U <= splits; s += U) {
        float4 v[U];
#pragma unroll
        for (int u = 0; u < U; ++u)
          v[u] = __ldcg(p + (size_t)(s + u) * (TILE / 4));
#pragma unroll
        for (int u = 0; u < U; ++u) {
          sum.x += v[u].x;
          sum.y += v[u].y;
          sum.z += v[u].z;
          sum.w += v[u].w;
        }
      }
      for (; s < splits; ++s) {
        const float4 v = __ldcg(p + (size_t)s * (TILE / 4));
        sum.x += v.x;
        sum.y += v.y;
        sum.z += v.z;
        sum.w += v.w;
      }
      store(r, c, sum);
    }
  }
};

// accumulator columns j0 .. j0 + 3 of row i, as one float4
template <int TM>
__device__ __forceinline__ float4 quad(const float (&acc)[TM][8], int i,
                                       int j0) {
  return make_float4(acc[i][j0], acc[i][j0 + 1], acc[i][j0 + 2],
                     acc[i][j0 + 3]);
}

// Four floats v at out[0 .. 3], the first lim of them: one 16-byte store
// where vec (out 16-byte aligned) and all four are wanted.
__device__ __forceinline__ void store4(float* out, int lim, bool vec,
                                       float4 v) {
  if (vec && lim >= 4) {
    *reinterpret_cast<float4*>(out) = v;
  } else {
    const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (j < lim) out[j] = e[j];
  }
}

// The accumulator tile of an unsplit CTA into the row-major (m, n) matrix
// c at (m0, n0): rows below m, columns below n; vec: n % 4 == 0 and c
// 16-byte aligned.
template <int BM, int BN, int TM>
__device__ __forceinline__ void store_tile(float* c, int m, int n, int m0,
                                           int n0, bool vec,
                                           const float (&acc)[TM][8]) {
  using E = Mma<BM, BN, TM>;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = m0 + E::row(i);
    if (r >= m) continue;
    float* crow = c + (size_t)r * n;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = n0 + E::col(4 * h);
      store4(crow + col, n - col, vec,
             make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                         acc[i][4 * h + 3]));
    }
  }
}

// K4's operands (matmul.cu): C (M, N) = A (M, K) @ B (K, N), K cut into
// ``splits`` splits of ``kper`` (the last may be shorter).
struct MatmulArgs {
  const float* a;   // A(r, k) = a[r * lda + k] (KC), a[k * lda + r] (XC*)
  const float* b;   // B(k, c) = b[c * ldb + k] (KC), b[k * ldb + c] (XC*)
  float* c;         // (M, N) row-major
  float* ws;        // splits > 1: (tiles, splits, BM * BN) partials
  int* counters;    // splits > 1: one zeroed arrival counter per tile
  int m, n, k, lda, ldb, kper, splits;
};

// Shared memory of one matmul_cta: the A and B rings.
template <int BM, int BN, int TM, int LA, int LB>
constexpr int matmul_smem_floats() {
  return STAGES * (Tile<BM, Mma<BM, BN, TM>::NT, LA>::STAGE +
                   Tile<BN, Mma<BM, BN, TM>::NT, LB>::STAGE);
}

// One CTA of K4: split ``split`` of output tile (m-block bm, n-block bn),
// ``tile`` its index among the tiles, over ring memory ``smem``
// (matmul_smem_floats).  Unsplit, it stores its tile of C; split, it
// writes its partial and the tile's last CTA to arrive sums the splits in
// split order (Split) and stores C.  Returns true in the CTA that stored
// the tile of C.  xload(stage, kt) and xlanded(stage, kt) ride the ring:
// they run right after this CTA's own copies of k-step kt are issued, and
// where gemm's landed runs (K10 streams z through them; K4 and K8 pass
// none).
template <int BM, int BN, int TM, int LA, int LB, class XLoad = NoHook,
          class XLanded = NoHook>
__device__ __forceinline__ bool matmul_cta(const MatmulArgs& p, float* smem,
                                           int bm, int bn, int split,
                                           int tile, XLoad xload = XLoad(),
                                           XLanded xlanded = XLanded()) {
  using E = Mma<BM, BN, TM>;
  using TA = Tile<BM, E::NT, LA>;
  using TB = Tile<BN, E::NT, LB>;
  float* sa = smem;
  float* sb = sa + STAGES * TA::STAGE;
  const int m0 = bm * BM;
  const int n0 = bn * BN;
  const int k_lo = split * p.kper;
  const int k_hi = min(p.k, k_lo + p.kper);
  const int nk = (k_hi - k_lo + BK - 1) / BK;
  const int rows = p.m - m0, cols = p.n - n0;

  float acc[TM][8];
  gemm<BM, BN, TM>(
      acc, sa, TA::STAGE, sb, TB::STAGE, nk, E::warp_live(rows),
      [&](int st, int kt) {
        const int k0 = k_lo + kt * BK;
        TA::issue(sa + st * TA::STAGE, p.a, p.lda, m0, p.m, k0, k_hi);
        TB::issue(sb + st * TB::STAGE, p.b, p.ldb, n0, p.n, k0, k_hi);
        xload(st, kt);
      },
      xlanded);
  const bool vec = (p.n % 4) == 0;
  if (p.splits == 1) {
    store_tile<BM, BN, TM>(p.c, p.m, p.n, m0, n0, vec, acc);
    return true;
  }
  using S = Split<BM, BN, TM>;
  float* slot0 = p.ws + (size_t)tile * p.splits * S::TILE;
  S::put(slot0 + (size_t)split * S::TILE, acc, rows, cols);
  if (!S::arrive(p.counters + tile, p.splits)) return false;
  S::reduce(slot0, p.splits, rows, cols, [&](int r, int c, float4 v) {
    store4(p.c + (size_t)(m0 + r) * p.n + n0 + c, cols - c, vec, v);
  });
  return true;
}

// 16-byte copies of a (.., ld) row-major operand at p when every row
// starts on a 16-byte boundary
inline bool aligned16(const void* p, int ld) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && ld % 4 == 0;
}

// Opt kernel ``kern`` into ``bytes`` of dynamic shared memory on the
// current device, once: ``opted`` (one per kernel) keeps a bit per device
// it was set on, so a launch pays no driver call after the first.
template <class Kernel>
inline cudaError_t opt_in_smem(Kernel kern, int bytes, unsigned& opted) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 32 && ((opted >> dev) & 1u)) return cudaSuccess;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           bytes);
  if (e == cudaSuccess && dev < 32) opted |= 1u << dev;
  return e;
}

}  // namespace gp
