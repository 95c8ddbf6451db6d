// K11: E expert MLPs over per-expert ragged M (the MoE expert engine's
// forward).
//
// Replaces the TPU kernel
// repro/kernels/grouped_matmul.py::_gmm_experts_kernel (launcher
// grouped_matmul_experts, table _plan_tiles_experts).  Tokens are packed
// into block-aligned per-expert segments of one (rows, D) buffer; M-block
// b (bm rows) belongs to expert meta[0][b] and its first meta[1][b] rows
// are live.  Per live row of expert e:
//   pre_i = x W_in[e],  pre_g = x W_gate[e]           (F wide)
//   h     = act(pre_g) * pre_i       (ungated: act(pre_i))
//   y     = (h W_out[e]) * sw                          (D wide)
// and exact zeros on every row past its block's valid count.  With
// train, pre_i and pre_g are stored too (the backward's residuals).
//
// Design.  The TPU kernel walks one in-order grid per M-block: the H
// phase closes each F tile of h into a (fb, bm, 128) VMEM panel, then
// the Y phase reads the whole panel.  Hopper's CTAs run in no order and a
// (bm, F) f32 panel (256 KB at bm 128, F 512) does not fit a block's
// shared memory, so the chain runs as two launches on the stream, both
// on the pipelined engine of gemm_pipe.cuh (128 x 128 CTA tiles, 8 x 8
// register micro-tiles, a 3-stage cp.async ring):
//   stage A (moe_fwd_in_kernel), one CTA per (row tile, F tile): x W over
//     D and the activation epilogue, h written to a global (rows, F)
//     panel.  Gated, the CTA's 128-wide B tile holds 64 columns of
//     W_in[e] and the same 64 columns of W_gate[e] side by side (two
//     tensors copied into one ring stage), so a thread's accumulator
//     columns j and j + 4 are the in and gate pre-activations of one F
//     column: both products meet in the thread's own registers, with no
//     second accumulator and no shared-memory pairing.  Ungated, the tile
//     is 128 columns of W_in[e].
//   stage B (moe_fwd_out_kernel), one CTA per (row tile, 128-wide D
//     tile): h W_out[e] over F, the sw row scale and the valid-row mask.
// A row tile is min(bm, 128) rows of one M-block (at bm 128 the block
// itself; warps whose rows lie past a smaller block, or past its live
// rows, skip the multiply), so every CTA has one expert, read once from
// the (2, mbs) block-meta table, which the wrapper builds on the device
// from the routed counts (no host read).  The launch table is
// grouped_matmul.py::experts_launch.  A tile with no live row skips its
// GEMM and stores zeros; rows past the live count load as the zero-fill
// form of cp.async, so their h and pre-activations are exact zeros.
//
// Bound on this card: at granite-moe-1b-a400m's shapes (16384 routed
// rows, D 1024, F 512) the work is 51.5 GFLOP against 0.2 GB moved, so it
// is operation-bound on paper (0.77 ms at 67 TFLOP/s f32).  The kernels
// run f32 FMA on the CUDA cores; tensor cores are later work.
#include "gemm_pipe.cuh"
#include "moe_act.cuh"

namespace {

constexpr int T = 128;   // CTA tile rows and columns
constexpr int TM = 8;
using E = gp::Mma<T, T, TM>;
using TA = gp::Tile<T, E::NT, gp::KC>;   // row-major x or h, along depth

struct FwdArgs {
  const float* x;       // (rows, D)
  const float* sw;      // (rows,)
  const float* w_in;    // (E, D, F)
  const float* w_gate;  // (E, D, F); null: ungated
  const float* w_out;   // (E, F, D)
  const int* meta;      // (2, mbs): expert id, valid rows
  float* y;             // (rows, D)
  float* hin;           // (rows, F); null unless train
  float* gate;          // (rows, F); null unless train and gated
  float* hpost;         // (rows, F) scratch: h
  int d, f, bm, mbs, act;
};

// The CTA's rows: packed rows row0 .. row0 + rows - 1 of one M-block, of
// which the first `live` are routed tokens of expert `e`.
struct RowTile {
  int row0, rows, e, live;
};

__device__ __forceinline__ RowTile row_tile(const FwdArgs& a) {
  const int per = (a.bm + T - 1) / T;   // row tiles per M-block
  const int blk = blockIdx.x / per, sub = blockIdx.x % per;
  RowTile t;
  t.row0 = blk * a.bm + sub * T;
  t.rows = min(T, a.bm - sub * T);
  t.e = a.meta[blk];
  t.live = max(0, min(t.rows, a.meta[a.mbs + blk] - sub * T));
  return t;
}

template <bool GATED, int LB>
__global__ void __launch_bounds__(256, 2) moe_fwd_in_kernel(FwdArgs a) {
  constexpr int FW = GATED ? T / 2 : T;   // F columns a CTA
  using TB = gp::Tile<FW, E::NT, LB, T + gp::PAD>;
  extern __shared__ float4 smem_raw[];
  float* sa = reinterpret_cast<float*>(smem_raw);
  float* sb = sa + gp::STAGES * TA::STAGE;
  const RowTile t = row_tile(a);
  const int D = a.d, F = a.f;
  const int f0 = blockIdx.y * FW;
  const float* x = a.x + (size_t)t.row0 * D;
  // the expert's weights, each base re-read from the kernel's parameters
  // at every k-step (one 64-bit offset held, not two pointers)
  const size_t woff = (size_t)t.e * D * F;
  const int nk = t.live > 0 ? (D + gp::BK - 1) / gp::BK : 0;
  float acc[TM][8];
  gp::gemm<T, T, TM>(acc, sa, TA::STAGE, sb, TB::STAGE, nk,
                     E::warp_live(t.live), [&](int st, int kt) {
                       const int k0 = kt * gp::BK;
                       float* b = sb + st * TB::STAGE;
                       TA::issue(sa + st * TA::STAGE, x, D, 0, t.live, k0,
                                 D);
                       TB::issue(b, a.w_in + woff, F, f0, F, k0, D);
                       if (GATED)
                         TB::issue(b + FW, a.w_gate + woff, F, f0, F, k0,
                                   D);
                     });
  // rows at or past live hold exact zeros (zero-filled x, or no GEMM),
  // and so do their act(0) * 0 and act(0)
  const bool vec = F % 4 == 0;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = E::row(i);
    if (r >= t.rows) continue;
    const size_t row = (size_t)(t.row0 + r) * F;
#pragma unroll
    for (int h = 0; h < (GATED ? 1 : 2); ++h) {
      const int c = f0 + E::col(4 * h);
      const float4 pi = gp::quad(acc, i, 4 * h);
      // gated: columns 4 .. 7 are the gate pre-activations of columns
      // 0 .. 3; the reference's order, act(gate preact) * in preact
      const float4 pg = gp::quad(acc, i, 4);
      const float4 hv =
          GATED ? make_float4(rt::moe_act(pg.x, a.act) * pi.x,
                              rt::moe_act(pg.y, a.act) * pi.y,
                              rt::moe_act(pg.z, a.act) * pi.z,
                              rt::moe_act(pg.w, a.act) * pi.w)
                : make_float4(rt::moe_act(pi.x, a.act),
                              rt::moe_act(pi.y, a.act),
                              rt::moe_act(pi.z, a.act),
                              rt::moe_act(pi.w, a.act));
      gp::store4(a.hpost + row + c, F - c, vec, hv);
      if (a.hin != nullptr) gp::store4(a.hin + row + c, F - c, vec, pi);
      if (GATED && a.gate != nullptr)
        gp::store4(a.gate + row + c, F - c, vec, pg);
    }
  }
}

template <int LB>
__global__ void __launch_bounds__(256, 2) moe_fwd_out_kernel(FwdArgs a) {
  using TB = gp::Tile<T, E::NT, LB>;
  extern __shared__ float4 smem_raw[];
  float* sa = reinterpret_cast<float*>(smem_raw);
  float* sb = sa + gp::STAGES * TA::STAGE;
  const RowTile t = row_tile(a);
  const int D = a.d, F = a.f;
  const int d0 = blockIdx.y * T;
  const float* h = a.hpost + (size_t)t.row0 * F;
  const float* w = a.w_out + (size_t)t.e * F * D;
  const int nk = t.live > 0 ? (F + gp::BK - 1) / gp::BK : 0;
  float acc[TM][8];
  gp::gemm<T, T, TM>(acc, sa, TA::STAGE, sb, TB::STAGE, nk,
                     E::warp_live(t.live), [&](int st, int kt) {
                       const int k0 = kt * gp::BK;
                       TA::issue(sa + st * TA::STAGE, h, F, 0, t.live, k0,
                                 F);
                       TB::issue(sb + st * TB::STAGE, w, D, d0, D, k0, F);
                     });
  const bool vec = D % 4 == 0;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = E::row(i);
    if (r >= t.rows) continue;
    const bool on = r < t.live;
    const float s = on ? a.sw[t.row0 + r] : 0.f;
    float* yrow = a.y + (size_t)(t.row0 + r) * D;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int c = d0 + E::col(4 * hh);
      const float4 v = gp::quad(acc, i, 4 * hh);
      gp::store4(yrow + c, D - c, vec,
                 on ? make_float4(v.x * s, v.y * s, v.z * s, v.w * s)
                    : make_float4(0.f, 0.f, 0.f, 0.f));
    }
  }
}

constexpr int SMEM = 2 * gp::STAGES * TA::STAGE * (int)sizeof(float);

template <class Kernel>
int launch(Kernel kern, unsigned& opted, dim3 grid, const FwdArgs& a,
           cudaStream_t s) {
  cudaError_t e = gp::opt_in_smem(kern, SMEM, opted);
  if (e != cudaSuccess) return (int)e;
  kern<<<grid, E::NT, SMEM, s>>>(a);
  return (int)cudaGetLastError();
}

int stage_a(const FwdArgs& a, dim3 grid, cudaStream_t s) {
  const bool gated = a.w_gate != nullptr;
  const bool v16 = gp::aligned16(a.w_in, a.f) &&
                   (!gated || gp::aligned16(a.w_gate, a.f));
  static unsigned o[4] = {0, 0, 0, 0};
  if (gated)
    return v16 ? launch(moe_fwd_in_kernel<true, gp::XC16>, o[0], grid, a, s)
               : launch(moe_fwd_in_kernel<true, gp::XC>, o[1], grid, a, s);
  return v16 ? launch(moe_fwd_in_kernel<false, gp::XC16>, o[2], grid, a, s)
             : launch(moe_fwd_in_kernel<false, gp::XC>, o[3], grid, a, s);
}

int stage_b(const FwdArgs& a, dim3 grid, cudaStream_t s) {
  static unsigned o[2] = {0, 0};
  return gp::aligned16(a.w_out, a.d)
             ? launch(moe_fwd_out_kernel<gp::XC16>, o[0], grid, a, s)
             : launch(moe_fwd_out_kernel<gp::XC>, o[1], grid, a, s);
}

}  // namespace

extern "C" int rt_experts_fwd(const void* x, const void* sw,
                              const void* w_in, const void* w_gate,
                              const void* w_out, const void* meta, void* y,
                              void* hin, void* gate, void* hpost, int rows,
                              int d, int f, int e, int bm, int mbs, int act,
                              void* stream) {
  if (bm < 1 || rows != mbs * bm || e < 1 || d < 1 || f < 1)
    return (int)cudaErrorInvalidValue;
  FwdArgs a;
  a.x = static_cast<const float*>(x);
  a.sw = static_cast<const float*>(sw);
  a.w_in = static_cast<const float*>(w_in);
  a.w_gate = static_cast<const float*>(w_gate);
  a.w_out = static_cast<const float*>(w_out);
  a.meta = static_cast<const int*>(meta);
  a.y = static_cast<float*>(y);
  a.hin = static_cast<float*>(hin);
  a.gate = static_cast<float*>(gate);
  a.hpost = static_cast<float*>(hpost);
  a.d = d;
  a.f = f;
  a.bm = bm;
  a.mbs = mbs;
  a.act = act;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int row_tiles = mbs * ((bm + T - 1) / T);
  const int fw = w_gate != nullptr ? T / 2 : T;
  if (row_tiles < 1) return (int)cudaSuccess;
  int rc = stage_a(a, dim3(row_tiles, (f + fw - 1) / fw), s);
  if (rc != 0) return rc;
  return stage_b(a, dim3(row_tiles, (d + T - 1) / T), s);
}
