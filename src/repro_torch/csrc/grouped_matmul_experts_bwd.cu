// K12: the whole backward of the expert engine (K11): dX and every dW.
//
// Replaces the TPU kernel
// repro/kernels/grouped_matmul.py::_gmm_experts_bwd_kernel (launcher
// grouped_matmul_experts_bwd, table _plan_tiles_experts_bwd).  With dYs
// the output cotangent times the combine weight (folded in by the
// caller) and the forward's saved pre-activations pre_i, pre_g, per live
// row of expert e:
//   dH     = dYs W_out[e]^T
//   gated:   s = act(pre_g),  h = s * pre_i,
//            dIn = dH * s,    dGate = act'(pre_g) * (dH * pre_i)
//   ungated: h = act(pre_i),  dIn = act'(pre_i) * dH
//   dX     = dIn W_in[e]^T (+ dGate W_gate[e]^T)
//   dW_out[e] = sum over e's rows of h^T dYs
//   dW_in[e]  = sum over e's rows of X^T dIn,  dW_gate[e] likewise
//
// Bound on this card: at granite-moe-1b-a400m's shapes (16384 routed
// rows, D 1024, F 512, gated) the work is 103 GFLOP against about 0.5 GB
// moved, so it is operation-bound (1.54 ms at 67 TFLOP/s f32, against
// 0.15 ms of bytes).  What the design does about it: every CTA runs the
// pipelined engine of gemm_pipe.cuh (128 x 128 tiles, 8 x 8 register
// micro-tiles: 64 FMAs per 4 float4 shared-memory reads a k; a 3-stage
// cp.async ring, so copies overlap the multiply; 256 threads, 50,688 B
// of dynamic shared memory, two CTAs an SM), on f32 FMA on the CUDA
// cores; tensor cores are later work.
//
// Design.  The TPU kernel walks four phases per M-block in one in-order
// grid and carries each expert's dW tiles in VMEM from its first block
// to its last.  Hopper's CTAs run in no order, so two launches on the
// stream, their tables mirrored by grouped_matmul.py::experts_bwd_launch:
//   stage A (experts_dh_kernel), one CTA per (row tile, 128-wide F tile),
//     F tile fastest: dH = dYs W_out[e]^T over D (both operands copied
//     along the depth, KC), then the activation VJP in the epilogue from
//     the saved pre-activations of the thread's own accumulator
//     elements; the cotangent panel [dIn | dGate] (rows, nw*F) and h
//     (rows, F) go to global scratch, exact zeros past the live rows;
//   stage B (experts_dxw_kernel), one launch, dW tiles first (the long,
//     ragged-depth CTAs start first), expert by expert, dW_out's, then
//     dW_in's, then dW_gate's, each 128 x 128 tile owned by one CTA that
//     walks all of its expert's live rows (its segment, found in the
//     block-meta table) as the depth: dW_out = h^T dYs, dW_in = X^T dIn,
//     dW_gate = X^T dGate, all four operands contiguous along the tile's
//     rows or columns (XC16 16-byte copies when every base and leading
//     dimension is a multiple of 16 bytes, XC otherwise); then the dX
//     tiles, one per (row tile, 128-wide D tile), D tile fastest, over
//     a depth of nw*F: dIn with W_in[e]^T, then dGate with W_gate[e]^T,
//     in one accumulator (KC copies).
// A row tile is min(bm, 128) rows of one M-block, as K11's, so each has
// one expert; warps whose rows lie past its live count skip the
// multiply, and a tile with no live row skips its GEMM.  Rows past a
// block's valid count never enter a sum: the copies of dYs and of the
// panel stop at the live rows and the dW depth at the expert's live
// rows (the zero-fill form of cp.async), so garbage there adds nothing;
// a zero-token expert's dW tiles take zero k-steps and store exact
// zeros.  At granite's layer 0 there are 3,072 dW CTAs (11.6 waves of
// 264), so M is not split: every output element has one owner, there
// is no workspace and no atomic, and results repeat bit for bit.
#include "gemm_pipe.cuh"
#include "moe_act.cuh"

namespace {

constexpr int T = 128;   // CTA tile rows and columns
constexpr int TM = 8;
using E = gp::Mma<T, T, TM>;
using TK = gp::Tile<T, E::NT, gp::KC>;
constexpr int SMEM = 2 * gp::STAGES * TK::STAGE * (int)sizeof(float);

struct BwdArgs {
  const float* x;       // (rows, D)
  const float* dy;      // (rows, D): dY * sw
  const float* w_in;    // (E, D, F)
  const float* w_gate;  // (E, D, F); null: ungated
  const float* w_out;   // (E, F, D)
  const float* hin;     // (rows, F) saved in pre-activations
  const float* gate;    // (rows, F) saved gate pre-activations; null
  const int* meta;      // (2, mbs): expert id (sorted), valid rows
  float* dx;            // (rows, D)
  float* dw_in;         // (E, D, F)
  float* dw_gate;       // (E, D, F); null
  float* dw_out;        // (E, F, D)
  float* dpan;          // (rows, nw * F) scratch: [dIn | dGate]
  float* hpost;         // (rows, F) scratch: h
  int d, f, e, bm, mbs, act, nw;
  int pre16;            // hin (and gate): 16-byte loads
  int n_dw;             // stage B's dW CTAs, before its dX CTAs
};

// The launches' CTA counts: stage A, stage B's dW tiles, its dX tiles.
struct Grids {
  int dh, dw, dx;
};

Grids grids(int d, int f, int e, int bm, int mbs, int nw) {
  const int nfb = (f + T - 1) / T, ndb = (d + T - 1) / T;
  const int row_tiles = mbs * ((bm + T - 1) / T);
  return {row_tiles * nfb, e * nfb * ndb * (1 + nw), row_tiles * ndb};
}

// Row tile q: packed rows row0 .. row0 + rows - 1 of one M-block, of
// which the first `live` are routed tokens of expert `e`.
struct RowTile {
  int row0, rows, e, live;
};

__device__ __forceinline__ RowTile row_tile(const BwdArgs& a, int q) {
  const int per = (a.bm + T - 1) / T;   // row tiles per M-block
  const int blk = q / per, sub = q % per;
  RowTile t;
  t.row0 = blk * a.bm + sub * T;
  t.rows = min(T, a.bm - sub * T);
  t.e = a.meta[blk];
  t.live = max(0, min(t.rows, a.meta[a.mbs + blk] - sub * T));
  return t;
}

// Expert e's segment: its first packed row and its live rows.  Its blocks
// start where the sorted expert-id row first reaches e and run while it
// stays e; the live rows fill them from the first (dead tail blocks of
// expert E - 1 and a zero-token expert's one block add 0).
__device__ __forceinline__ void segment_of(const BwdArgs& a, int e, int& r0,
                                           int& n) {
  int lo = 0, hi = a.mbs;
  while (lo < hi) {
    const int mid = (lo + hi) / 2;
    if (a.meta[mid] < e) lo = mid + 1; else hi = mid;
  }
  r0 = lo * a.bm;
  n = 0;
  for (int b = lo; b < a.mbs && a.meta[b] == e; ++b) n += a.meta[a.mbs + b];
}

// One CTA's GEMM, put in shared memory by thread 0 and read again at
// every k-step instead of held in registers through the loop.  Its depth
// is one or two halves of nkh k-steps each, cut at klim: the first half
// multiplies A at a0 by B at b0, the second A at a1 by B at b1 (dX: the
// dIn panel with W_in, then the dGate panel with W_gate).  A's rows are
// x0a .. below xlima, B's columns x0b .. below xlimb.
struct Job {
  const float* a0;
  const float* a1;
  const float* b0;
  const float* b1;
  int lda, ldb, x0a, xlima, x0b, xlimb, klim, nkh;
};

template <class TA, class TB>
__device__ __forceinline__ void run_job(float (&acc)[TM][8], float* smem,
                                        const Job& job, int nk) {
  float* sa = smem;
  float* sb = sa + gp::STAGES * TA::STAGE;
  gp::gemm<T, T, TM>(
      acc, sa, TA::STAGE, sb, TB::STAGE, nk,
      E::warp_live(job.xlima - job.x0a), [&](int st, int kt) {
        const bool second = kt >= job.nkh;
        const int k0 = (second ? kt - job.nkh : kt) * gp::BK;
        TA::issue(sa + st * TA::STAGE, second ? job.a1 : job.a0, job.lda,
                  job.x0a, job.xlima, k0, job.klim);
        TB::issue(sb + st * TB::STAGE, second ? job.b1 : job.b0, job.ldb,
                  job.x0b, job.xlimb, k0, job.klim);
      });
}

// the first lim (up to 4) floats at p, zeros after them; one 16-byte load
// where vec (p 16-byte aligned) and all four are wanted
__device__ __forceinline__ void load4(float (&v)[4], const float* p, int lim,
                                      bool vec) {
  if (vec && lim >= 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
    return;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) v[j] = j < lim ? p[j] : 0.f;
}

__device__ __forceinline__ float4 f4(const float (&v)[4]) {
  return make_float4(v[0], v[1], v[2], v[3]);
}

// Stage A: dH for one (row tile, F tile), then the activation VJP.
template <bool GATED>
__global__ void __launch_bounds__(256, 2) experts_dh_kernel(BwdArgs a) {
  extern __shared__ float4 smem_raw[];
  __shared__ Job job;
  const int D = a.d, F = a.f, P = (GATED ? 2 : 1) * F;
  const int nfb = (F + T - 1) / T;
  const RowTile t = row_tile(a, blockIdx.x / nfb);
  const int f0 = (blockIdx.x % nfb) * T;
  if (threadIdx.x == 0) {
    // dYs (row-major) @ W_out[e]^T: B's element (f, d) is w_out[e][f][d],
    // so both operands run along the depth
    const float* dy = a.dy + (size_t)t.row0 * D;
    const float* w = a.w_out + (size_t)t.e * F * D;
    const int nk = (D + gp::BK - 1) / gp::BK;
    job = {dy, dy, w, w, D, D, 0, t.live, f0, F, D, nk};
  }
  __syncthreads();
  float acc[TM][8];
  run_job<TK, TK>(acc, reinterpret_cast<float*>(smem_raw), job,
                  t.live > 0 ? job.nkh : 0);

  const bool vec = F % 4 == 0, pvec = vec && a.pre16;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = E::row(i);
    if (r >= t.rows) continue;
    const size_t row = (size_t)(t.row0 + r);
    const bool on = r < t.live;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int c = f0 + E::col(4 * hh);
      if (c >= F) continue;
      float h[4] = {0.f, 0.f, 0.f, 0.f}, din[4] = {0.f, 0.f, 0.f, 0.f},
            dgate[4] = {0.f, 0.f, 0.f, 0.f};
      if (on) {
        // the pre-activations of this thread's own accumulator elements
        // (never those of a row past the live count)
        const float4 dhq = gp::quad(acc, i, 4 * hh);
        const float dh[4] = {dhq.x, dhq.y, dhq.z, dhq.w};
        float pi[4], pg[4];
        load4(pi, a.hin + row * F + c, F - c, pvec);
        if (GATED) load4(pg, a.gate + row * F + c, F - c, pvec);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (GATED) {
            const float s = rt::moe_act(pg[j], a.act);
            h[j] = s * pi[j];
            din[j] = dh[j] * s;
            dgate[j] = rt::moe_act_grad(pg[j], a.act) * (dh[j] * pi[j]);
          } else {
            h[j] = rt::moe_act(pi[j], a.act);
            din[j] = rt::moe_act_grad(pi[j], a.act) * dh[j];
          }
        }
      }
      gp::store4(a.hpost + row * F + c, F - c, vec, f4(h));
      gp::store4(a.dpan + row * P + c, F - c, vec, f4(din));
      if (GATED) gp::store4(a.dpan + row * P + F + c, F - c, vec, f4(dgate));
    }
  }
}

// Stage B: dW tiles (LX: their copy layout, XC16 or XC), then dX tiles.
template <int LX>
__global__ void __launch_bounds__(256, 2) experts_dxw_kernel(BwdArgs a) {
  using TX = gp::Tile<T, E::NT, LX>;
  static_assert(TX::STAGE == TK::STAGE, "one ring for both layouts");
  extern __shared__ float4 smem_raw[];
  __shared__ Job job;
  float* smem = reinterpret_cast<float*>(smem_raw);
  const int D = a.d, F = a.f, P = a.nw * F;
  const int nfb = (F + T - 1) / T, ndb = (D + T - 1) / T;
  float acc[TM][8];

  if ((int)blockIdx.x < a.n_dw) {
    // dW tile (i0, j0) of expert g: which 0 dW_out (F, D) = h^T dYs,
    // 1 dW_in and 2 dW_gate (D, F) = X^T [dIn | dGate]; rows of the
    // tile over the first operand, its depth the expert's live rows
    const int per = nfb * ndb;
    const int g = blockIdx.x / ((1 + a.nw) * per);
    const int u = blockIdx.x % ((1 + a.nw) * per);
    const int which = u / per, v = u % per;
    if (threadIdx.x == 0) {
      int r0, n;
      segment_of(a, g, r0, n);
      const int nk = (n + gp::BK - 1) / gp::BK;
      if (which == 0) {
        const float* h = a.hpost + (size_t)r0 * F;
        const float* dy = a.dy + (size_t)r0 * D;
        job = {h, h, dy, dy, F, D, (v / ndb) * T, F, (v % ndb) * T, D, n,
               nk};
      } else {
        const float* x = a.x + (size_t)r0 * D;
        const float* dp = a.dpan + (size_t)r0 * P + (which - 1) * F;
        job = {x, x, dp, dp, D, P, (v / nfb) * T, D, (v % nfb) * T, F, n,
               nk};
      }
    }
    __syncthreads();
    run_job<TX, TX>(acc, smem, job, job.nkh);
    float* out = which == 0 ? a.dw_out + (size_t)g * F * D
                 : (which == 1 ? a.dw_in : a.dw_gate) + (size_t)g * D * F;
    gp::store_tile<T, T, TM>(out, job.xlima, job.xlimb, job.x0a, job.x0b,
                             job.xlimb % 4 == 0, acc);
    return;
  }

  // dX tile (row tile, 128-wide D tile) over dIn, then dGate: B's element
  // (d, f) is w[e][d][f], so both operands run along the depth
  const int q = blockIdx.x - a.n_dw;
  const RowTile t = row_tile(a, q / ndb);
  const int d0 = (q % ndb) * T;
  if (threadIdx.x == 0) {
    const float* dp = a.dpan + (size_t)t.row0 * P;
    const size_t woff = (size_t)t.e * D * F;
    const float* wg = a.nw == 2 ? a.w_gate + woff : a.w_in + woff;
    job = {dp, dp + F, a.w_in + woff, wg, P, F, 0, t.live, d0, D, F,
           (F + gp::BK - 1) / gp::BK};
  }
  __syncthreads();
  run_job<TK, TK>(acc, smem, job, t.live > 0 ? a.nw * job.nkh : 0);
  const bool vec = D % 4 == 0;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = E::row(i);
    if (r >= t.rows) continue;
    const bool on = r < t.live;
    float* dxrow = a.dx + (size_t)(t.row0 + r) * D;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int c = d0 + E::col(4 * hh);
      gp::store4(dxrow + c, D - c, vec,
                 on ? gp::quad(acc, i, 4 * hh)
                    : make_float4(0.f, 0.f, 0.f, 0.f));
    }
  }
}

template <class Kernel>
int launch(Kernel kern, unsigned& opted, int grid, const BwdArgs& a,
           cudaStream_t s) {
  if (grid < 1) return (int)cudaSuccess;
  cudaError_t e = gp::opt_in_smem(kern, SMEM, opted);
  if (e != cudaSuccess) return (int)e;
  kern<<<grid, E::NT, SMEM, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// The CTA counts of rt_experts_bwd's two launches: out[0] stage A's,
// out[1] stage B's dW tiles, out[2] its dX tiles (stage B's grid is
// out[1] + out[2]).
extern "C" int rt_experts_bwd_grids(int d, int f, int e, int bm, int mbs,
                                    int gated, int* out) {
  const Grids g = grids(d, f, e, bm, mbs, gated ? 2 : 1);
  out[0] = g.dh;
  out[1] = g.dw;
  out[2] = g.dx;
  return 0;
}

extern "C" int rt_experts_bwd(const void* x, const void* dy, const void* w_in,
                              const void* w_gate, const void* w_out,
                              const void* hin, const void* gate,
                              const void* meta, void* dx, void* dw_in,
                              void* dw_gate, void* dw_out, void* dpan,
                              void* hpost, int rows, int d, int f, int e,
                              int bm, int mbs, int act, void* stream) {
  if (bm < 1 || rows != mbs * bm || e < 1 || d < 1 || f < 1)
    return (int)cudaErrorInvalidValue;
  BwdArgs a;
  a.x = static_cast<const float*>(x);
  a.dy = static_cast<const float*>(dy);
  a.w_in = static_cast<const float*>(w_in);
  a.w_gate = static_cast<const float*>(w_gate);
  a.w_out = static_cast<const float*>(w_out);
  a.hin = static_cast<const float*>(hin);
  a.gate = static_cast<const float*>(gate);
  a.meta = static_cast<const int*>(meta);
  a.dx = static_cast<float*>(dx);
  a.dw_in = static_cast<float*>(dw_in);
  a.dw_gate = static_cast<float*>(dw_gate);
  a.dw_out = static_cast<float*>(dw_out);
  a.dpan = static_cast<float*>(dpan);
  a.hpost = static_cast<float*>(hpost);
  a.d = d;
  a.f = f;
  a.e = e;
  a.bm = bm;
  a.mbs = mbs;
  a.act = act;
  const bool gated = w_gate != nullptr;
  a.nw = gated ? 2 : 1;
  a.pre16 = gp::aligned16(hin, f) && (!gated || gp::aligned16(gate, f));
  const Grids g = grids(d, f, e, bm, mbs, a.nw);
  a.n_dw = g.dw;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  static unsigned o[4] = {0, 0, 0, 0};
  int rc = gated ? launch(experts_dh_kernel<true>, o[0], g.dh, a, s)
                 : launch(experts_dh_kernel<false>, o[1], g.dh, a, s);
  if (rc != 0) return rc;
  // the dW operands: x and dYs (leading dimension D), h and the panel
  // (F; the wrapper allocates both, so their bases are aligned)
  const bool v16 = gp::aligned16(x, d) && gp::aligned16(dy, d) && f % 4 == 0;
  return v16 ? launch(experts_dxw_kernel<gp::XC16>, o[2], g.dw + g.dx, a, s)
             : launch(experts_dxw_kernel<gp::XC>, o[3], g.dw + g.dx, a, s);
}
