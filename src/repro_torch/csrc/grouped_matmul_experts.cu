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
// phase closes each F-tile of h into a (fb, bm, 128) VMEM panel, then
// the Y phase reads the whole panel.  Hopper's CTAs run in no order and a
// (bm, F) f32 panel (256 KB at bm 128, F 512) does not fit a block's
// shared memory, so the chain runs as two launches on the stream:
//   stage A, one CTA per (row chunk, 64-wide F tile): both GEMMs over D
//     and the activation epilogue, h written to a global (rows, F) panel;
//   stage B, one CTA per (row chunk, 64-wide D tile): h W_out[e] over F,
//     the sw row scale and the valid-row mask.
// A row chunk is min(bm, 64) rows of one M-block, so every CTA has one
// expert; the expert id and valid rows come from the block-meta table,
// which the wrapper builds on the device from the routed counts (no
// host read).  A chunk with no live row skips its GEMM and stores zeros;
// rows past valid load as zeros, so their h and pre-activations are
// exact zeros.
//
// Bound on this card: at granite-moe-1b-a400m's shapes (16384 routed
// rows, D 1024, F 512) the work is 51.5 GFLOP against 0.2 GB moved, so it
// is operation-bound on paper (0.77 ms at 67 TFLOP/s f32).  This first
// design runs f32 FMA on the CUDA cores through the shared 64 x 64 tile
// GEMM (tile_gemm.cuh); tensor cores are later work.
#include "moe_act.cuh"
#include "tile_gemm.cuh"

namespace {

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
  int d, f, bm, chunk, mbs, act;
};

// The CTA's rows: packed rows row0 .. row0 + chunk - 1 of one M-block,
// of which the first `live` are routed tokens of expert `e`.
struct Chunk {
  int row0, e, live;
};

__device__ __forceinline__ Chunk chunk_of(const int* meta, int mbs, int bm,
                                          int chunk) {
  Chunk c;
  c.row0 = blockIdx.x * chunk;
  const int blk = c.row0 / bm;
  c.e = meta[blk];
  c.live = max(0, min(chunk, meta[mbs + blk] - (c.row0 - blk * bm)));
  return c;
}

__device__ __forceinline__ void zero(float (&acc)[rt::TM][rt::TN]) {
#pragma unroll
  for (int i = 0; i < rt::TM; ++i)
#pragma unroll
    for (int j = 0; j < rt::TN; ++j) acc[i][j] = 0.f;
}

__global__ void __launch_bounds__(rt::NT) experts_h_kernel(FwdArgs a) {
  const Chunk ck = chunk_of(a.meta, a.mbs, a.bm, a.chunk);
  const int j0 = blockIdx.y * rt::BN;
  const int D = a.d, F = a.f;
  const float* __restrict__ x = a.x + (size_t)ck.row0 * D;
  const size_t woff = (size_t)ck.e * D * F;
  const int nk = ck.live > 0 ? D : 0;
  auto load_x = [&](int r, int k) -> float {
    return (r < ck.live && k < D) ? x[(size_t)r * D + k] : 0.f;
  };
  float acc_i[rt::TM][rt::TN], acc_g[rt::TM][rt::TN];
  zero(acc_i);
  zero(acc_g);
  {
    const float* __restrict__ w = a.w_in + woff;
    rt::tile_gemm(acc_i, nk, load_x, [&](int k, int c) -> float {
      const int gc = j0 + c;
      return (k < D && gc < F) ? w[(size_t)k * F + gc] : 0.f;
    });
  }
  const bool gated = a.w_gate != nullptr;
  if (gated) {
    const float* __restrict__ w = a.w_gate + woff;
    rt::tile_gemm(acc_g, nk, load_x, [&](int k, int c) -> float {
      const int gc = j0 + c;
      return (k < D && gc < F) ? w[(size_t)k * F + gc] : 0.f;
    });
  }
  const int tx = threadIdx.x % (rt::BN / rt::TN);
  const int ty = threadIdx.x / (rt::BN / rt::TN);
#pragma unroll
  for (int i = 0; i < rt::TM; ++i) {
    const int r = ty * rt::TM + i;
    if (r >= a.chunk) continue;
    const size_t row = (size_t)(ck.row0 + r) * F;
#pragma unroll
    for (int j = 0; j < rt::TN; ++j) {
      const int c = j0 + tx * rt::TN + j;
      if (c >= F) continue;
      const float pi = acc_i[i][j], pg = acc_g[i][j];
      // the reference's order: act(gate preact) * in preact
      a.hpost[row + c] = gated ? rt::moe_act(pg, a.act) * pi
                               : rt::moe_act(pi, a.act);
      if (a.hin != nullptr) a.hin[row + c] = pi;
      if (a.gate != nullptr) a.gate[row + c] = pg;
    }
  }
}

__global__ void __launch_bounds__(rt::NT) experts_y_kernel(FwdArgs a) {
  const Chunk ck = chunk_of(a.meta, a.mbs, a.bm, a.chunk);
  const int j0 = blockIdx.y * rt::BN;
  const int D = a.d, F = a.f;
  const float* __restrict__ h = a.hpost + (size_t)ck.row0 * F;
  const float* __restrict__ w = a.w_out + (size_t)ck.e * F * D;
  float acc[rt::TM][rt::TN];
  zero(acc);
  rt::tile_gemm(
      acc, ck.live > 0 ? F : 0,
      [&](int r, int k) -> float {
        return (r < ck.live && k < F) ? h[(size_t)r * F + k] : 0.f;
      },
      [&](int k, int c) -> float {
        const int gc = j0 + c;
        return (k < F && gc < D) ? w[(size_t)k * D + gc] : 0.f;
      });
  const int tx = threadIdx.x % (rt::BN / rt::TN);
  const int ty = threadIdx.x / (rt::BN / rt::TN);
#pragma unroll
  for (int i = 0; i < rt::TM; ++i) {
    const int r = ty * rt::TM + i;
    if (r >= a.chunk) continue;
    const int row = ck.row0 + r;
    const float s = r < ck.live ? a.sw[row] : 0.f;
#pragma unroll
    for (int j = 0; j < rt::TN; ++j) {
      const int c = j0 + tx * rt::TN + j;
      if (c < D) a.y[(size_t)row * D + c] = r < ck.live ? acc[i][j] * s : 0.f;
    }
  }
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
  a.chunk = bm < rt::BM ? bm : rt::BM;
  a.mbs = mbs;
  a.act = act;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nchunks = rows / a.chunk;
  experts_h_kernel<<<dim3(nchunks, (f + rt::BN - 1) / rt::BN), rt::NT, 0,
                     s>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  experts_y_kernel<<<dim3(nchunks, (d + rt::BN - 1) / rt::BN), rt::NT, 0,
                     s>>>(a);
  return (int)cudaGetLastError();
}
