// The first f32 tile GEMM of the port, kept for K12
// (grouped_matmul_experts_bwd.cu) alone.
//
// By default one CTA of NT = 256 threads owns one BM x BN = 64 x 64 output
// tile and loops over its own k-steps, BK = 16 at a time, through shared
// memory; each thread keeps a 4 x 4 micro-tile of f32 accumulators in
// registers.  Template arguments give other tile shapes and the thread
// order of the tile loads (see tile_gemm below).  The lhs and rhs loaders
// are passed in, so the kernel decides where an element comes from and
// the product loop stays one piece of code.
//
// This is the simple first design: plain FMA on the CUDA cores in f32, no
// software pipelining, operands loaded element by element.  Every other
// GEMM kernel of the port runs on the pipelined engine of gemm_pipe.cuh.
#pragma once

#include <cuda_runtime.h>

namespace rt {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int NT = 256;
constexpr int TM = 4;
constexpr int TN = 4;
constexpr int PAD = 4;   // shared-memory row padding against bank conflicts

// acc[i][j] += sum_k A(r, k) * B(k, c) for the thread's rows
// r = ty * TM_ + i and columns c = tx * TN_ + j of the BM_ x BN_ tile,
// tx = tid % (BN_ / TN_), ty = tid / (BN_ / TN_); the block has
// (BM_ / TM_) * (BN_ / TN_) threads (NT for the default 64 x 64 tile).
// load_a(r, k) gives the lhs element of tile row r (0..BM_-1) at depth k,
// load_b(k, c) the rhs element at depth k of tile column c (0..BN_-1);
// both return 0 outside their operand.  nk is the depth, any value >= 0.
//
// A_KFAST / B_NFAST choose which index consecutive threads walk while a
// tile loads, so that neighbouring threads read neighbouring addresses:
// A_KFAST (default) walks k, right for an lhs stored row-major (M, K);
// !A_KFAST walks r, right for an lhs stored transposed (K, M).  B_NFAST
// (default) walks c, right for a rhs stored row-major (K, N); !B_NFAST
// walks k, right for a rhs stored transposed (N, K).
template <int BM_ = BM, int BN_ = BN, int TM_ = TM, int TN_ = TN,
          bool A_KFAST = true, bool B_NFAST = true, class LoadA,
          class LoadB>
__device__ __forceinline__ void tile_gemm(float (&acc)[TM_][TN_], int nk,
                                          LoadA load_a, LoadB load_b) {
  constexpr int TX = BN_ / TN_;
  constexpr int NT_ = (BM_ / TM_) * TX;
  static_assert((BM_ * BK) % NT_ == 0 && (BK * BN_) % NT_ == 0,
                "tile loads must divide evenly over the threads");
  __shared__ float As[BK][BM_ + PAD];
  __shared__ float Bs[BK][BN_ + PAD];
  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  for (int k0 = 0; k0 < nk; k0 += BK) {
#pragma unroll
    for (int i = 0; i < (BM_ * BK) / NT_; ++i) {
      const int idx = tid + i * NT_;
      const int kk = A_KFAST ? idx % BK : idx / BM_;
      const int r = A_KFAST ? idx / BK : idx % BM_;
      As[kk][r] = load_a(r, k0 + kk);
    }
#pragma unroll
    for (int i = 0; i < (BK * BN_) / NT_; ++i) {
      const int idx = tid + i * NT_;
      const int c = B_NFAST ? idx % BN_ : idx / BK;
      const int kk = B_NFAST ? idx / BN_ : idx % BK;
      Bs[kk][c] = load_b(k0 + kk, c);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM_], b[TN_];
#pragma unroll
      for (int i = 0; i < TM_; ++i) a[i] = As[kk][ty * TM_ + i];
#pragma unroll
      for (int j = 0; j < TN_; ++j) b[j] = Bs[kk][tx * TN_ + j];
#pragma unroll
      for (int i = 0; i < TM_; ++i)
#pragma unroll
        for (int j = 0; j < TN_; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
}

}  // namespace rt
