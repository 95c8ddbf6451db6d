// Shared f32 tile GEMM for the port's hand-written Hopper kernels.
//
// One CTA of NT = 256 threads owns one BM x BN = 64 x 64 output tile and
// loops over its own k-steps, BK = 16 at a time, through shared memory;
// each thread keeps a 4 x 4 micro-tile of f32 accumulators in registers.
// The lhs and rhs loaders are passed in, so each kernel decides where an
// lhs element comes from (a packed lhs, a tap stack maxed on the fly, a
// shifted ring tap under a border mask, an implicit-GEMM conv window) and
// the product loop stays one piece of code.
//
// This is the simple first design: plain FMA on the CUDA cores in f32
// (tensor cores, wgmma and TMA are later work), no software pipelining.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace rt {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int NT = 256;
constexpr int TM = 4;
constexpr int TN = 4;
constexpr int PAD = 4;   // shared-memory row padding against bank conflicts

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

// acc[i][j] += sum_k A(r, k) * B(k, c) for the thread's rows
// r = (tid / 16) * TM + i and columns c = (tid % 16) * TN + j of the tile.
// load_a(r, k) gives the lhs element of tile row r (0..BM-1) at depth k,
// load_b(k, c) the rhs element at depth k of tile column c (0..BN-1);
// both return 0 outside their operand.  nk is the depth, any value >= 0.
template <class LoadA, class LoadB>
__device__ __forceinline__ void tile_gemm(float (&acc)[TM][TN], int nk,
                                          LoadA load_a, LoadB load_b) {
  __shared__ float As[BK][BM + PAD];
  __shared__ float Bs[BK][BN + PAD];
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  for (int k0 = 0; k0 < nk; k0 += BK) {
#pragma unroll
    for (int i = 0; i < (BM * BK) / NT; ++i) {
      const int idx = tid + i * NT;
      const int kk = idx % BK;
      const int r = idx / BK;
      As[kk][r] = load_a(r, k0 + kk);
    }
#pragma unroll
    for (int i = 0; i < (BK * BN) / NT; ++i) {
      const int idx = tid + i * NT;
      const int c = idx % BN;
      const int kk = idx / BN;
      Bs[kk][c] = load_b(k0 + kk, c);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[kk][ty * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Bs[kk][tx * TN + j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
}

}  // namespace rt
