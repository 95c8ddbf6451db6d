// K3: zero-workspace direct convolution, NHWC x HWIO -> NHWC, TF-SAME.
//
// Replaces the TPU kernel repro/kernels/conv2d.py::_direct_kernel
// (launcher conv2d_direct): the convolution as KH*KW tap GEMMs over the
// channel dim with an f32 accumulator, no im2col buffer in device memory.
//
// Design.  The TPU cell is one image x 8 output rows with the input row
// window resident in VMEM.  Here each CTA owns a 64-pixel x 64-channel
// output tile of the implicit GEMM (M = N*OH*OW pixels, depth KH*KW*C in
// tap-major, channel-minor order, which is the HWIO weight read as a
// (KH*KW*C, K) matrix) and gathers each lhs element straight from the
// unpadded input: pixel (img, oy, ox) at tap (dh, dw) reads input row
// oy*stride + dh - pad_top and column ox*stride + dw - pad_left, zero
// outside the image.  The padding is TF-SAME, asymmetric (pad_top =
// total // 2, the rest at the bottom), passed in by the wrapper.
// Consecutive threads of a warp load consecutive channels, so the gather
// is coalesced along C.
// Bound on this card: at the serving shapes (14x14, C 192 -> 384 and
// 48 -> 128) the work is operation-bound on paper; this first design runs
// f32 FMA on the CUDA cores with small tiles and so sits far below the
// 67 TFLOP/s f32 rate, and with M = 196 rows it fills only a few of the
// 132 SMs.  Split-K or smaller M tiles, and tensor cores, are later work.
#include "tile_gemm.cuh"

namespace {

struct ConvArgs {
  const float* x;   // (N, H, W, C)
  const float* w;   // (KH, KW, C, K)
  float* y;         // (N, OH, OW, K)
  int n, h, w_, c, k, kh, kw, stride, oh, ow, pad_h, pad_w;
};

__global__ void __launch_bounds__(rt::NT) conv2d_direct_kernel(ConvArgs a) {
  const int m0 = blockIdx.x * rt::BM;
  const int n0 = blockIdx.y * rt::BN;
  const int M = a.n * a.oh * a.ow;
  const int depth = a.kh * a.kw * a.c;
  const int ohw = a.oh * a.ow;
  const float* __restrict__ x = a.x;
  const float* __restrict__ w = a.w;

  auto load_a = [&](int r, int k) -> float {
    const int gr = m0 + r;
    if (gr >= M || k >= depth) return 0.f;
    const int tap = k / a.c;
    const int ci = k - tap * a.c;
    const int dh = tap / a.kw;
    const int dw = tap - dh * a.kw;
    const int img = gr / ohw;
    const int rem = gr - img * ohw;
    const int oy = rem / a.ow;
    const int ox = rem - oy * a.ow;
    const int iy = oy * a.stride + dh - a.pad_h;
    const int ix = ox * a.stride + dw - a.pad_w;
    if (iy < 0 || iy >= a.h || ix < 0 || ix >= a.w_) return 0.f;
    return x[(((size_t)img * a.h + iy) * a.w_ + ix) * a.c + ci];
  };
  auto load_b = [&](int k, int c) -> float {
    const int gc = n0 + c;
    return (k < depth && gc < a.k) ? w[(size_t)k * a.k + gc] : 0.f;
  };

  float acc[rt::TM][rt::TN];
#pragma unroll
  for (int i = 0; i < rt::TM; ++i)
#pragma unroll
    for (int j = 0; j < rt::TN; ++j) acc[i][j] = 0.f;
  rt::tile_gemm(acc, depth, load_a, load_b);

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < rt::TM; ++i) {
    const int r = m0 + ty * rt::TM + i;
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < rt::TN; ++j) {
      const int c = n0 + tx * rt::TN + j;
      if (c < a.k) a.y[(size_t)r * a.k + c] = acc[i][j];
    }
  }
}

}  // namespace

extern "C" int rt_conv2d_direct(const void* x, const void* w, void* y, int n,
                                int h, int wd, int c, int k, int kh, int kw,
                                int stride, int oh, int ow, int pad_h,
                                int pad_w, void* stream) {
  ConvArgs a;
  a.x = static_cast<const float*>(x);
  a.w = static_cast<const float*>(w);
  a.y = static_cast<float*>(y);
  a.n = n;
  a.h = h;
  a.w_ = wd;
  a.c = c;
  a.k = k;
  a.kh = kh;
  a.kw = kw;
  a.stride = stride;
  a.oh = oh;
  a.ow = ow;
  a.pad_h = pad_h;
  a.pad_w = pad_w;
  const int M = n * oh * ow;
  const dim3 grid((M + rt::BM - 1) / rt::BM, (k + rt::BN - 1) / rt::BN);
  if (grid.x == 0 || grid.y == 0) return (int)cudaSuccess;
  conv2d_direct_kernel<<<grid, rt::NT, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
