// K5: the whole backward of a grouped branch launch in ONE launch, and
// K7, its backward-weight half alone.
//
// K5 replaces the TPU kernel
// repro/kernels/grouped_matmul.py::_gmm_bwd_kernel (launcher
// grouped_matmul_bwd, table _plan_tiles_bwd): for G branches sharing M
// with ragged (K_g, N_g), with dym_g = dy_g where mask_g > 0, else 0,
//   dx_g = dym_g @ w_g^T      (M, K_g)
//   dw_g = x_g^T @ dym_g      (K_g, N_g)
//   db_g = sum_M dym_g        (N_g,)
// It is the backward of K1 and K2 (kernels/ops.py's autograd Functions):
// 18 launches a concurrent GoogLeNet training step, 15 a stacked one.
// K7 (gmm_dw_kernel, rt_gmm_dw) replaces
// repro/kernels/grouped_matmul.py::_gmm_dw_kernel (launcher
// grouped_matmul_dw, table _plan_tiles_dw): dw_g and db_g alone, the
// reference's library call ``ops.grouped_matmul_dw``.  No plan launches
// it (the training path keeps K5, as the reference does).  Its table is
// K5's without the dx entries and it runs the same dw_tile, so on the
// same inputs its dw and db equal K5's bit for bit.
//
// Bound on this card: operations (at the training shapes, M up to 25088,
// K up to 864, N up to 384, each launch does far more FLOP per byte than
// the f32 ridge of 67 TFLOP/s against 3.35 TB/s).  It stays on the CUDA
// cores in f32; 3xTF32 on the tensor cores is later work.
//
// Design.  The TPU kernel walks one flattened in-order grid (all dx
// steps, then all dw steps) and carries the accumulator from step to
// step; that order does not exist on Hopper.  Here the table has one
// entry per CTA, (kind, g, i, j, s, S, m_lo, m_hi), and each CTA runs
// the pipelined engine of gemm_pipe.cuh (128 x 128 tile, 3-stage
// cp.async ring, 8 x 8 micro-tiles) over its own contraction:
//   dx entries (kind 0): tile (m-block i, k-block j) of dx_g over all of
//     N_g (s = 0, S = 1);
//   dw entries (kind 1): split s of S of tile (k-block i, n-block j) of
//     dw_g, over rows [m_lo, m_hi) of M.  A group has only tens of dw
//     tiles, each contracting over all of M, so one CTA per tile would
//     leave the dw half on a few SMs; the wrapper cuts M into S splits
//     from the SM count (matmul.py::split_plan) and the last CTA of a
//     tile to arrive sums the S partials in split order (gp::Split).
//     The tile is computed transposed, rows over N_g and columns over
//     K_g, so a narrow branch (N_g = 16, 32) fills whole warps' rows and
//     the warps past N_g skip the multiply.
// dy and the mask are read in place through their row strides (column
// slices of the joint cotangent).  Each thread zeroes dy where mask <= 0
// (or NaN) on the elements it copied itself, once they land and before
// the block's barrier; no separate masking pass.  db: the dw CTAs of
// k-block 0 sum their masked dy per row in the same step (in the dw
// layout a thread copies the same rows at every k-step), add the threads
// that share a row in a fixed order, and the split partials are reduced
// in split order with the dw partials.  The dw entries come first in the
// table, so they start first.  No atomics on values: the only atomic is
// a tile's arrival counter; results repeat bit for bit.
#include "gemm_pipe.cuh"

namespace {

constexpr int MAXG = 8;
constexpr int T = 128;                 // tile rows and columns
using E = gp::Mma<T, T>;               // 256 threads
using Sp = gp::Split<T, T>;
using TKC = gp::Tile<T, E::NT, gp::KC>;
// the ring (dy, mask and x or w stages) and the db partial sums (one
// slot per (sharing thread, row))
constexpr int DB_SLOTS = 8 * T;
constexpr int SMEM =
    (gp::STAGES * 3 * TKC::STAGE + DB_SLOTS) * (int)sizeof(float);

struct BwdArgs {
  const float* x[MAXG];     // (M, K_g) contiguous: forward lhs
  const float* w[MAXG];     // (K_g, N_g) contiguous
  const float* dy[MAXG];    // (M, N_g), row stride lddy[g]
  const float* mask[MAXG];  // (M, N_g), row stride ldm[g]; null: no mask
  float* dx[MAXG];          // (M, K_g) contiguous
  float* dw[MAXG];          // (K_g, N_g) contiguous
  float* db[MAXG];          // (N_g,)
  int k[MAXG];
  int n[MAXG];
  int lddy[MAXG];
  int ldm[MAXG];
  const int* tiles;         // per CTA: (kind, g, i, j, s, S, m_lo, m_hi)
  float* ws;                // per dw entry: one T x T partial
  float* dbws;              // per dw entry: T db partials
  int* counters;            // per dw entry: zeroed arrival counter
  int m;
};

// One CTA's GEMM, put in shared memory by thread 0 and read again after
// every barrier instead of held in registers through the loop (indexed
// by a runtime branch, each would take a register): A (dy, masked by mk)
// rows x0a.. below xlima, B rows x0b.. below xlimb, depth [klo, khi).
struct Job {
  const float* a;
  const float* mk;   // null: no mask
  const float* b;
  int lda, ldm, ldb, x0a, xlima, x0b, xlimb, klo, khi;
};

// acc = the job's (masked) A @ B; landed(st, job) runs on the thread's own
// landed copies of ring stage st (A's in sa, the mask's in sm)
template <class TA, class TB, class Landed>
__device__ __forceinline__ void run_job(float (&acc)[8][8], float* smem,
                                        const Job& job, Landed landed) {
  float* sa = smem;
  float* sm = sa + gp::STAGES * TA::STAGE;
  float* sb = sm + gp::STAGES * TA::STAGE;
  gp::gemm<T, T>(
      acc, sa, TA::STAGE, sb, TB::STAGE,
      (job.khi - job.klo + gp::BK - 1) / gp::BK,
      E::warp_live(job.xlima - job.x0a),
      [&](int st, int kt) {
        const int k0 = job.klo + kt * gp::BK;
        TA::issue(sa + st * TA::STAGE, job.a, job.lda, job.x0a, job.xlima,
                  k0, job.khi);
        if (job.mk)
          TA::issue(sm + st * TA::STAGE, job.mk, job.ldm, job.x0a,
                    job.xlima, k0, job.khi);
        TB::issue(sb + st * TB::STAGE, job.b, job.ldb, job.x0b, job.xlimb,
                  k0, job.khi);
      },
      [&](int st, int) {
        landed(sa + st * TA::STAGE, sm + st * TA::STAGE, job.mk != nullptr);
      });
}

// dw tile (k-block i, n-block j) of branch g over rows [mlo, mhi) of M
// (split s of S, entry t of the table), computed as dw^T: rows n (A =
// dym^T, A(n, m) = dy[m * lddy + n]), columns k (B(m, k) = x[m * K + k]).
template <int LDY, int LX>
__device__ __forceinline__ void dw_tile(const BwdArgs& a, float* smem,
                                        Job& job, const int* t) {
  using TA = gp::Tile<T, E::NT, LDY>;
  using TB = gp::Tile<T, E::NT, LX>;
  static_assert(TA::SHARERS * T <= DB_SLOTS, "db slots");
  // db partial sums after the ring: slot (sharer q, row x) is one thread's
  float* dbs_slot = smem + gp::STAGES * 3 * TKC::STAGE;
  if (threadIdx.x == 0) {
    const int g = t[1];
    job = {a.dy[g], a.mask[g], a.x[g], a.lddy[g], a.ldm[g], a.k[g],
           t[3] * T, a.n[g], t[2] * T, a.k[g], t[6], t[7]};
  }
  const bool do_db = t[2] == 0;
  if (do_db)
#pragma unroll
    for (int e = 0; e < TA::VW; ++e)
      dbs_slot[(threadIdx.x / (T / TA::VW)) * T + TA::own_x() + e] = 0.f;
  __syncthreads();

  float acc[8][8];
  run_job<TA, TB>(acc, smem, job, [&](float* sa, float* sm, bool masked) {
    if (!masked && !do_db) return;
    float* mine = dbs_slot + (threadIdx.x / (T / TA::VW)) * T + TA::own_x();
    TA::own(sa, sm, [&](float& v, float m, int e) {
      if (masked && !(m > 0.f)) v = 0.f;
      if (do_db) mine[e] += v;
    });
  });

  // geometry again from the job (shared) and the table, not held
  // through the loop
  const int n0 = job.x0a, c0 = job.x0b, N = job.xlima, K = job.xlimb;
  const int rows = N - n0, cols = K - c0;
  const int g = t[1], s = t[4], S = t[5];
  // db partial of this split: the SHARERS threads that copied a row add
  // their sums in thread order (run_job ended on a barrier); written at
  // once, to db or to this entry's slot
  if (do_db && threadIdx.x < T) {
    float v = 0.f;
    for (int q = 0; q < TA::SHARERS; ++q) v += dbs_slot[q * T + threadIdx.x];
    if (S > 1)
      a.dbws[(size_t)blockIdx.x * T + threadIdx.x] = v;
    else if ((int)threadIdx.x < rows)
      a.db[g][n0 + threadIdx.x] = v;
  }

  // dw^T through shared memory (tr[k][n], row stride T + 1), so dw's rows
  // are stored whole
  float* tr = smem;
  auto store = [&]() {
    __syncthreads();
    float* dw = a.dw[g];
    const int nr = min(rows, T), nc = min(cols, T);
    for (int idx = threadIdx.x; idx < nc * T; idx += E::NT) {
      const int c = idx / T, n = idx % T;
      if (n < nr) dw[(size_t)(c0 + c) * N + n0 + n] = tr[c * (T + 1) + n];
    }
  };
  if (S == 1) {
#pragma unroll
    for (int ii = 0; ii < 8; ++ii)
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
        tr[E::col(jj) * (T + 1) + E::row(ii)] = acc[ii][jj];
    store();
    return;
  }
  const int e0 = blockIdx.x - s;   // the tile's split 0 entry
  float* slot0 = a.ws + (size_t)e0 * Sp::TILE;
  Sp::put(slot0 + (size_t)s * Sp::TILE, acc, rows, cols);
  if (!Sp::arrive(a.counters + e0, S)) return;
  Sp::reduce(slot0, S, rows, cols, [&](int r, int c, float4 v) {
    tr[c * (T + 1) + r] = v.x;
    tr[(c + 1) * (T + 1) + r] = v.y;
    tr[(c + 2) * (T + 1) + r] = v.z;
    tr[(c + 3) * (T + 1) + r] = v.w;
  });
  store();
  if (do_db && (int)threadIdx.x < min(rows, T)) {
    float v = 0.f;
    for (int q = 0; q < S; ++q)
      v += __ldcg(&a.dbws[(size_t)(e0 + q) * T + threadIdx.x]);
    a.db[g][n0 + threadIdx.x] = v;
  }
}

// dx tile (m-block i, k-block j) of branch g over all of N_g:
// A(m, n) = dym[m][n], B(n, k) = w[k * N + n]; both contiguous along n.
__device__ __forceinline__ void dx_tile(const BwdArgs& a, float* smem,
                                        Job& job, const int* t) {
  const int g = t[1], i = t[2], j = t[3];
  if (threadIdx.x == 0)
    job = {a.dy[g], a.mask[g], a.w[g], a.lddy[g], a.ldm[g], a.n[g],
           i * T, a.m, j * T, a.k[g], 0, a.n[g]};
  __syncthreads();

  float acc[8][8];
  run_job<TKC, TKC>(acc, smem, job, [](float* sa, float* sm, bool masked) {
    if (masked)
      TKC::own(sa, sm, [](float& v, float m, int) {
        if (!(m > 0.f)) v = 0.f;
      });
  });

  const int m0 = i * T, c0 = j * T;
  const int M = a.m, K = a.k[g];
  float* dx = a.dx[g];
  const bool vec = (K % 4) == 0;
#pragma unroll
  for (int ii = 0; ii < 8; ++ii) {
    const int r = m0 + E::row(ii);
    if (r >= M) continue;
    float* row = dx + (size_t)r * K;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = c0 + E::col(4 * h);
      if (vec && c + 3 < K) {
        *reinterpret_cast<float4*>(row + c) =
            make_float4(acc[ii][4 * h], acc[ii][4 * h + 1],
                        acc[ii][4 * h + 2], acc[ii][4 * h + 3]);
      } else {
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          if (c + jj < K) row[c + jj] = acc[ii][4 * h + jj];
      }
    }
  }
}

// LDY: the dw half's copy layout of dy and the mask (XC or XC16), LX:
// of x (XC or XC16); the dx half copies KC.
template <int LDY, int LX>
__global__ void __launch_bounds__(E::NT, 2) gmm_bwd_kernel(BwdArgs a) {
  extern __shared__ float4 smem_raw[];
  __shared__ Job job;
  float* smem = reinterpret_cast<float*>(smem_raw);
  const int* t = a.tiles + 8 * blockIdx.x;
  if (t[0] == 1)
    dw_tile<LDY, LX>(a, smem, job, t);
  else
    dx_tile(a, smem, job, t);
}

// K7: a table of dw entries only (K5's without its dx entries)
template <int LDY, int LX>
__global__ void __launch_bounds__(E::NT, 2) gmm_dw_kernel(BwdArgs a) {
  extern __shared__ float4 smem_raw[];
  __shared__ Job job;
  dw_tile<LDY, LX>(a, reinterpret_cast<float*>(smem_raw), job,
                   a.tiles + 8 * blockIdx.x);
}

template <bool DW_ONLY, int LDY, int LX>
int launch(const BwdArgs& a, int ntiles, cudaStream_t s) {
  auto kern = DW_ONLY ? gmm_dw_kernel<LDY, LX> : gmm_bwd_kernel<LDY, LX>;
  static unsigned opted = 0;
  cudaError_t e = gp::opt_in_smem(kern, SMEM, opted);
  if (e != cudaSuccess) return (int)e;
  kern<<<ntiles, E::NT, SMEM, s>>>(a);
  return (int)cudaGetLastError();
}

// dy16: dy and the masks take 16-byte copies in the dw entries (every
// base and row stride a multiple of 16 bytes); x16: the same for x
template <bool DW_ONLY>
int dispatch(const BwdArgs& a, int ntiles, int dy16, int x16,
             void* stream) {
  if (ntiles == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dy16)
    return x16 ? launch<DW_ONLY, gp::XC16, gp::XC16>(a, ntiles, s)
               : launch<DW_ONLY, gp::XC16, gp::XC>(a, ntiles, s);
  return x16 ? launch<DW_ONLY, gp::XC, gp::XC16>(a, ntiles, s)
             : launch<DW_ONLY, gp::XC, gp::XC>(a, ntiles, s);
}

}  // namespace

// ptrs: 7 * g pointers, per branch in turn x, w, dy, mask (null: none),
// dx, dw, db; ints: 4 * g, in turn k, n, lddy, ldm.  dy16, x16: see
// dispatch.
extern "C" int rt_gmm_bwd(int g, const void* const* ptrs, const int* ints,
                          const void* tiles, int ntiles, int m, void* ws,
                          void* dbws, void* counters, int dy16, int x16,
                          void* stream) {
  if (g < 1 || g > MAXG) return (int)cudaErrorInvalidValue;
  BwdArgs a = {};
  for (int i = 0; i < g; ++i) {
    a.x[i] = static_cast<const float*>(ptrs[i]);
    a.w[i] = static_cast<const float*>(ptrs[g + i]);
    a.dy[i] = static_cast<const float*>(ptrs[2 * g + i]);
    a.mask[i] = static_cast<const float*>(ptrs[3 * g + i]);
    a.dx[i] = static_cast<float*>(const_cast<void*>(ptrs[4 * g + i]));
    a.dw[i] = static_cast<float*>(const_cast<void*>(ptrs[5 * g + i]));
    a.db[i] = static_cast<float*>(const_cast<void*>(ptrs[6 * g + i]));
    a.k[i] = ints[i];
    a.n[i] = ints[g + i];
    a.lddy[i] = ints[2 * g + i];
    a.ldm[i] = ints[3 * g + i];
  }
  a.tiles = static_cast<const int*>(tiles);
  a.ws = static_cast<float*>(ws);
  a.dbws = static_cast<float*>(dbws);
  a.counters = static_cast<int*>(counters);
  a.m = m;
  return dispatch<false>(a, ntiles, dy16, x16, stream);
}

// K7.  ptrs: 5 * g pointers, per branch in turn x, dy, mask (null: none),
// dw, db; ints as rt_gmm_bwd's; tiles: K5's table without its dx entries
// (every entry kind 1), with K5's workspace and counters.
extern "C" int rt_gmm_dw(int g, const void* const* ptrs, const int* ints,
                         const void* tiles, int ntiles, int m, void* ws,
                         void* dbws, void* counters, int dy16, int x16,
                         void* stream) {
  if (g < 1 || g > MAXG) return (int)cudaErrorInvalidValue;
  BwdArgs a = {};
  for (int i = 0; i < g; ++i) {
    a.x[i] = static_cast<const float*>(ptrs[i]);
    a.dy[i] = static_cast<const float*>(ptrs[g + i]);
    a.mask[i] = static_cast<const float*>(ptrs[2 * g + i]);
    a.dw[i] = static_cast<float*>(const_cast<void*>(ptrs[3 * g + i]));
    a.db[i] = static_cast<float*>(const_cast<void*>(ptrs[4 * g + i]));
    a.k[i] = ints[i];
    a.n[i] = ints[g + i];
    a.lddy[i] = ints[2 * g + i];
    a.ldm[i] = ints[3 * g + i];
  }
  a.tiles = static_cast<const int*>(tiles);
  a.ws = static_cast<float*>(ws);
  a.dbws = static_cast<float*>(dbws);
  a.counters = static_cast<int*>(counters);
  a.m = m;
  return dispatch<true>(a, ntiles, dy16, x16, stream);
}
