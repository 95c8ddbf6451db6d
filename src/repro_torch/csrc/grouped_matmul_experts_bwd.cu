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
// Design.  The TPU kernel walks four phases per M-block in one in-order
// grid and carries each expert's dW tiles in VMEM from its first block
// to its last.  Hopper's CTAs run in no order, so:
//   stage A, one CTA per (row chunk, 64-wide F tile): dH over D, then
//     the activation VJP from the saved pre-activations; the cotangent
//     panel [dIn | dGate] (rows, nw*F) and h (rows, F) go to global
//     scratch, exact zeros past the valid rows;
//   stage B, one launch over one entry per output tile, dW tiles first:
//     a dW_out / dW_in / dW_gate tile is owned by one CTA that loops over
//     all of its expert's rows (its segment, found in the block-meta
//     table: the blocks whose sorted expert id is e, and the sum of
//     their valid rows); a dX tile (row chunk, 64-wide D tile) loops
//     over F for dIn and then dGate.
// Rows past a block's valid count never enter a sum (the dW loops stop
// at the expert's live rows, the dX and dH loads mask them), so garbage
// there adds nothing; a zero-token expert's dW tiles loop zero times and
// store exact zeros.  No atomics: every output element has one owner, so
// results repeat bit for bit.
//
// Bound on this card: at granite-moe-1b-a400m's shapes (16384 routed
// rows, D 1024, F 512) the work is 103 GFLOP, operation-bound on paper
// (1.54 ms at 67 TFLOP/s f32).  This first design runs f32 FMA on the
// CUDA cores (tile_gemm.cuh); a dW tile's loop is one CTA's work over
// about n/E rows, and there are E * 3 * (D/64) * (F/64) of them, enough
// to fill the card.  Tensor cores are later work.
#include "moe_act.cuh"
#include "tile_gemm.cuh"

namespace {

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
  int d, f, e, bm, chunk, mbs, act, nw, nchunks;
};

struct Chunk {
  int row0, e, live;
};

__device__ __forceinline__ Chunk chunk_of(const BwdArgs& a, int q) {
  Chunk c;
  c.row0 = q * a.chunk;
  const int blk = c.row0 / a.bm;
  c.e = a.meta[blk];
  c.live = max(0, min(a.chunk, a.meta[a.mbs + blk] - (c.row0 - blk * a.bm)));
  return c;
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

__device__ __forceinline__ void zero(float (&acc)[rt::TM][rt::TN]) {
#pragma unroll
  for (int i = 0; i < rt::TM; ++i)
#pragma unroll
    for (int j = 0; j < rt::TN; ++j) acc[i][j] = 0.f;
}

// Stage A: dH for one (row chunk, F tile), then the activation VJP.
__global__ void __launch_bounds__(rt::NT) experts_dh_kernel(BwdArgs a) {
  const Chunk ck = chunk_of(a, blockIdx.x);
  const int j0 = blockIdx.y * rt::BN;
  const int D = a.d, F = a.f;
  const float* __restrict__ dy = a.dy + (size_t)ck.row0 * D;
  const float* __restrict__ w = a.w_out + (size_t)ck.e * F * D;
  float acc[rt::TM][rt::TN];
  zero(acc);
  // dYs (row-major) @ W_out[e]^T: the rhs element (k = d, c = f) is
  // w_out[e][f][d], so the loads walk k
  rt::tile_gemm<rt::BM, rt::BN, rt::TM, rt::TN, true, false>(
      acc, ck.live > 0 ? D : 0,
      [&](int r, int k) -> float {
        return (r < ck.live && k < D) ? dy[(size_t)r * D + k] : 0.f;
      },
      [&](int k, int c) -> float {
        const int gc = j0 + c;
        return (k < D && gc < F) ? w[(size_t)gc * D + k] : 0.f;
      });
  const int tx = threadIdx.x % (rt::BN / rt::TN);
  const int ty = threadIdx.x / (rt::BN / rt::TN);
  const bool gated = a.nw == 2;
#pragma unroll
  for (int i = 0; i < rt::TM; ++i) {
    const int r = ty * rt::TM + i;
    if (r >= a.chunk) continue;
    const size_t row = (size_t)(ck.row0 + r);
    const bool live = r < ck.live;
#pragma unroll
    for (int j = 0; j < rt::TN; ++j) {
      const int c = j0 + tx * rt::TN + j;
      if (c >= F) continue;
      float h = 0.f, din = 0.f, dgate = 0.f;
      if (live) {
        const float dh = acc[i][j];
        const float pi = a.hin[row * F + c];
        if (gated) {
          const float pg = a.gate[row * F + c];
          const float s = rt::moe_act(pg, a.act);
          h = s * pi;
          din = dh * s;
          dgate = rt::moe_act_grad(pg, a.act) * (dh * pi);
        } else {
          h = rt::moe_act(pi, a.act);
          din = rt::moe_act_grad(pi, a.act) * dh;
        }
      }
      a.hpost[row * F + c] = h;
      a.dpan[row * a.nw * F + c] = din;
      if (gated) a.dpan[row * a.nw * F + F + c] = dgate;
    }
  }
}

// Stage B: one CTA per output tile: dW_out tiles, dW_in / dW_gate tiles,
// then dX tiles.
__global__ void __launch_bounds__(rt::NT) experts_dxw_kernel(BwdArgs a) {
  const int D = a.d, F = a.f, P = a.nw * F;
  const int nfb = (F + rt::BN - 1) / rt::BN;
  const int ndb = (D + rt::BN - 1) / rt::BN;
  const int n_dwo = a.e * nfb * ndb;
  const int n_dwh = a.e * a.nw * ndb * nfb;
  int t = blockIdx.x;
  const int tx = threadIdx.x % (rt::BN / rt::TN);
  const int ty = threadIdx.x / (rt::BN / rt::TN);
  float acc[rt::TM][rt::TN];
  zero(acc);

  if (t < n_dwo + n_dwh) {
    // a dW tile: rows i0.. and columns j0.. of one expert's weight
    // gradient, its depth all of that expert's rows
    int e, i0, j0, which;  // which: -1 dW_out, 0 dW_in, 1 dW_gate
    if (t < n_dwo) {
      e = t / (nfb * ndb);
      const int rem = t % (nfb * ndb);
      i0 = (rem / ndb) * rt::BM;  // rows over F
      j0 = (rem % ndb) * rt::BN;  // columns over D
      which = -1;
    } else {
      t -= n_dwo;
      const int per = ndb * nfb;
      e = t / (a.nw * per);
      which = (t / per) % a.nw;
      const int rem = t % per;
      i0 = (rem / nfb) * rt::BM;  // rows over D
      j0 = (rem % nfb) * rt::BN;  // columns over F
    }
    int r0, n;
    segment_of(a, e, r0, n);
    int rows_out, cols_out;
    float* out;
    if (which < 0) {
      // h^T (read k-major) @ dYs
      const float* __restrict__ h = a.hpost + (size_t)r0 * F;
      const float* __restrict__ dy = a.dy + (size_t)r0 * D;
      rt::tile_gemm<rt::BM, rt::BN, rt::TM, rt::TN, false, true>(
          acc, n,
          [&](int r, int k) -> float {
            const int gr = i0 + r;
            return (gr < F && k < n) ? h[(size_t)k * F + gr] : 0.f;
          },
          [&](int k, int c) -> float {
            const int gc = j0 + c;
            return (k < n && gc < D) ? dy[(size_t)k * D + gc] : 0.f;
          });
      rows_out = F;
      cols_out = D;
      out = a.dw_out + (size_t)e * F * D;
    } else {
      // X^T (read k-major) @ the dIn or dGate half of the panel
      const float* __restrict__ x = a.x + (size_t)r0 * D;
      const float* __restrict__ dp = a.dpan + (size_t)r0 * P + which * F;
      rt::tile_gemm<rt::BM, rt::BN, rt::TM, rt::TN, false, true>(
          acc, n,
          [&](int r, int k) -> float {
            const int gr = i0 + r;
            return (gr < D && k < n) ? x[(size_t)k * D + gr] : 0.f;
          },
          [&](int k, int c) -> float {
            const int gc = j0 + c;
            return (k < n && gc < F) ? dp[(size_t)k * P + gc] : 0.f;
          });
      rows_out = D;
      cols_out = F;
      out = (which == 0 ? a.dw_in : a.dw_gate) + (size_t)e * D * F;
    }
#pragma unroll
    for (int i = 0; i < rt::TM; ++i) {
      const int r = i0 + ty * rt::TM + i;
      if (r >= rows_out) continue;
#pragma unroll
      for (int j = 0; j < rt::TN; ++j) {
        const int c = j0 + tx * rt::TN + j;
        if (c < cols_out) out[(size_t)r * cols_out + c] = acc[i][j];
      }
    }
    return;
  }

  // a dX tile: (row chunk q, 64-wide D tile), depth F for dIn, then dGate
  t -= n_dwo + n_dwh;
  const Chunk ck = chunk_of(a, t / ndb);
  const int j0 = (t % ndb) * rt::BN;
  const int nk = ck.live > 0 ? F : 0;
  for (int which = 0; which < a.nw; ++which) {
    const float* __restrict__ dp = a.dpan + (size_t)ck.row0 * P + which * F;
    const float* __restrict__ w =
        (which == 0 ? a.w_in : a.w_gate) + (size_t)ck.e * D * F;
    // [dIn | dGate] (row-major) @ W[e]^T: rhs element (k = f, c = d) is
    // w[e][d][f], so the loads walk k
    rt::tile_gemm<rt::BM, rt::BN, rt::TM, rt::TN, true, false>(
        acc, nk,
        [&](int r, int k) -> float {
          return (r < ck.live && k < F) ? dp[(size_t)r * P + k] : 0.f;
        },
        [&](int k, int c) -> float {
          const int gc = j0 + c;
          return (k < F && gc < D) ? w[(size_t)gc * F + k] : 0.f;
        });
  }
#pragma unroll
  for (int i = 0; i < rt::TM; ++i) {
    const int r = ty * rt::TM + i;
    if (r >= a.chunk) continue;
    const size_t row = (size_t)(ck.row0 + r);
#pragma unroll
    for (int j = 0; j < rt::TN; ++j) {
      const int c = j0 + tx * rt::TN + j;
      if (c < D) a.dx[row * D + c] = r < ck.live ? acc[i][j] : 0.f;
    }
  }
}

}  // namespace

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
  a.chunk = bm < rt::BM ? bm : rt::BM;
  a.mbs = mbs;
  a.act = act;
  a.nw = w_gate != nullptr ? 2 : 1;
  a.nchunks = rows / a.chunk;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nfb = (f + rt::BN - 1) / rt::BN;
  const int ndb = (d + rt::BN - 1) / rt::BN;
  experts_dh_kernel<<<dim3(a.nchunks, nfb), rt::NT, 0, s>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int ntiles = e * nfb * ndb * (1 + a.nw) + a.nchunks * ndb;
  experts_dxw_kernel<<<ntiles, rt::NT, 0, s>>>(a);
  return (int)cudaGetLastError();
}
