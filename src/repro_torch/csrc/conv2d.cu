// K3: direct convolution, NHWC x HWIO -> NHWC, TF-SAME or VALID, any
// stride; no im2col buffer (a depth split's partial tiles are its only
// workspace).
//
// Replaces the TPU kernel repro/kernels/conv2d.py::_direct_kernel
// (launcher conv2d_direct): the convolution as KH*KW tap GEMMs over the
// channel dim with an f32 accumulator, no im2col buffer in device memory.
// On the training path it runs stem1 and stem2 of every concurrent and
// stacked step (M = 100352), and all 51 convs but stem0 of a serial step
// (M = 100352 down to 1568); serving at bucket 1 runs inc8's 3x3 and 5x5
// (M = 196).
//
// Bound on this card: operations.  The serial step's 51 convs do 87 GFLOP
// of f32 FMA on a few hundred MB (1.30 ms at 67 TFLOP/s); the kernel stays
// on the CUDA cores in f32, so what it must do is keep the FMA units fed:
// no per-element index arithmetic in the loop, copies in flight while the
// warps multiply, and enough CTAs to fill the SMs at serve bucket 1 (M =
// 196: 6 output tiles over a depth of 1728).
//
// Design.  The TPU cell is one image x 8 output rows with the input row
// window resident in VMEM.  Here the conv is a tap-major implicit GEMM on
// the pipelined engine of gemm_pipe.cuh: M = N*OH*OW output pixels, the
// depth KH*KW*C in tap-major, channel-minor order (the HWIO weight read
// as a (KH*KW*C, K) matrix), 128 x 128 output tiles, two CTAs an SM.  Each
// tap's channel run is cut into k-steps of BK = 16 channels, the last one
// of a tap only as wide as the channels left (its ``live`` width), so no
// k-step straddles two taps; the wrapper's table (kernels/conv2d.py::
// direct_launch) lists each k-step's (dh, dw, first channel, live width).
// A thread copies two output rows of the lhs tile; it decodes their
// (image, oy, ox) once per CTA, and per k-step forms one source address
// and one in-image test per row: rows outside the image (the padding) or
// past M, and channels past the live width, are zero-fill cp.async
// copies, never a branch per element.  With C % 4 == 0 and x 16-byte
// aligned the copies are 16 bytes along the channels, else 4 bytes (the
// stem's C = 3).  The lhs lands row-major and is multiplied with
// Mma::step_rows, as K6's ring taps are; a tile with at most 64 live
// output channels multiplies only its left half.  Unsplit, an output sums
// its depth in one FMA chain in tap-major, channel-minor order.
//
// When the tiles do not fill two CTAs on every SM (serve bucket 1, the
// serial step's 14 x 14 convs and its narrow 1x1s), the wrapper cuts the
// k-steps into splits (a floor on the split depth), the grid gets a third
// axis, and the last split CTA of each tile sums the partials in split
// order (gp::Split): one launch, deterministic.  The concurrent step's
// stem1 and stem2 have 784 and 1568 tiles and take no split.
#include "gemm_pipe.cuh"

namespace {

constexpr int T = 128;             // tile rows and columns
constexpr int BK = gp::BK;
using E = gp::Mma<T, T>;           // 256 threads, 8 x 8 micro-tiles
using Sp = gp::Split<T, T>;
constexpr int A_STAGE = T * BK;    // lhs tile, row-major [T][BK]
constexpr int B_STAGE = gp::Tile<T, E::NT, gp::XC16>::STAGE;
constexpr int SMEM = gp::STAGES * (A_STAGE + B_STAGE) * (int)sizeof(float);
constexpr int FAR = -(1 << 28);    // an image row no tap offset brings back

struct ConvArgs {
  const float* x;    // (N, H, W, C)
  const float* w;    // (KH * KW * C, K) row-major: the HWIO weight
  float* y;          // (M, K) row-major, M = N * OH * OW
  const int* steps;  // per k-step: dh, dw, first channel, live channels
                     // (16-byte aligned)
  float* ws;         // splits > 1: (tiles, splits, T * T) partials
  int* counters;     // splits > 1: one zeroed arrival counter per tile
  int h, w_, c, k, kw, stride, oh, ow, pad_h, pad_w, m, nk, kper, splits;
};

// LB: the weight's copy layout (XC16 or XC); V16: 16-byte lhs copies
template <int LB, bool V16>
__global__ void __launch_bounds__(E::NT, 2) conv2d_direct_kernel(ConvArgs a) {
  using TB = gp::Tile<T, E::NT, LB>;
  extern __shared__ float4 smem_raw[];
  float* sa = reinterpret_cast<float*>(smem_raw);
  float* sb = sa + gp::STAGES * A_STAGE;
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * T, n0 = blockIdx.y * T, split = blockIdx.z;
  const int ks0 = split * a.kper;
  const int nk = min(a.nk, ks0 + a.kper) - ks0;
  const int rows = a.m - m0, cols = a.k - n0;
  const bool half = cols <= T / 2;

  // this thread's lhs copies: tile rows ar and ar + T / 2, channels
  // 4 * aq .. + 3 of each k-step; each row's first input pixel of its
  // image and its top-left input pixel, decoded once (pixel indices, not
  // pointers: two registers fewer)
  const int ar = tid / 4, aq = tid % 4;
  const int ohw = a.oh * a.ow;
  int pix[2], iy0[2], ix0[2];
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int gr = m0 + ar + q * (T / 2);
    pix[q] = 0;
    iy0[q] = FAR;
    ix0[q] = FAR;
    if (gr < a.m) {
      const int b = gr / ohw, rem = gr - b * ohw;
      const int oy = rem / a.ow, ox = rem - oy * a.ow;
      pix[q] = b * a.h * a.w_;
      iy0[q] = oy * a.stride - a.pad_h;
      ix0[q] = ox * a.stride - a.pad_w;
    }
  }

  float acc[8][8];
  gp::gemm<T, T>(
      acc, sa, A_STAGE, sb, B_STAGE, nk, E::warp_live(rows),
      [&](int st, int kt) {
        const int4 sp =
            __ldg(reinterpret_cast<const int4*>(a.steps) + ks0 + kt);
        const int dh = sp.x, dw = sp.y, c0 = sp.z, live = sp.w;
        const int ca = c0 + 4 * aq;
        const int nv = min(max(live - 4 * aq, 0), 4);
        float* dst = sa + st * A_STAGE + ar * BK + 4 * aq;
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int iy = iy0[q] + dh, ix = ix0[q] + dw;
          const bool in = (unsigned)iy < (unsigned)a.h &&
                          (unsigned)ix < (unsigned)a.w_;
          const int nq = in ? nv : 0;
          const float* src =
              nq ? a.x + (size_t)(pix[q] + iy * a.w_ + ix) * a.c + ca : a.x;
          const unsigned d = gp::smem_u32(dst + q * (T / 2) * BK);
          if (V16) {
            gp::cp16(d, src, 4 * nq);
          } else {
#pragma unroll
            for (int e = 0; e < 4; ++e)
              gp::cp4(d + 4 * e, e < nq ? src + e : a.x, e < nq ? 4 : 0);
          }
        }
        const int k0 = (dh * a.kw + dw) * a.c + c0;
        TB::issue(sb + st * B_STAGE, a.w, a.k, n0, a.k, k0, k0 + live);
      },
      gp::NoHook(),
      [&](float (&c)[8][8], const float* As, const float* Bs) {
        if (half)
          E::step_rows<true>(c, As, Bs);
        else
          E::step_rows<false>(c, As, Bs);
      });

  const bool vec = (a.k % 4) == 0;
  if (a.splits == 1) {
    gp::store_tile<T, T, 8>(a.y, a.m, a.k, m0, n0, vec, acc);
    return;
  }
  const int tile = blockIdx.y * gridDim.x + blockIdx.x;
  float* slot0 = a.ws + (size_t)tile * a.splits * Sp::TILE;
  Sp::put(slot0 + (size_t)split * Sp::TILE, acc, rows, cols);
  if (!Sp::arrive(a.counters + tile, a.splits)) return;
  Sp::reduce(slot0, a.splits, rows, cols, [&](int r, int c, float4 v) {
    gp::store4(a.y + (size_t)(m0 + r) * a.k + n0 + c, cols - c, vec, v);
  });
}

template <int LB, bool V16>
int launch(const ConvArgs& a, cudaStream_t s) {
  auto kern = conv2d_direct_kernel<LB, V16>;
  static unsigned opted = 0;
  cudaError_t e = gp::opt_in_smem(kern, SMEM, opted);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((a.m + T - 1) / T, (a.k + T - 1) / T, a.splits);
  kern<<<grid, E::NT, SMEM, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// steps: the int32 k-step table on the device (4 ints a k-step, nk of
// them); splits, kper: the k-steps cut into splits of kper (the last may
// be shorter); splits > 1 needs ws and counters (see ConvArgs).  x16:
// 16-byte lhs copies (C % 4 == 0, x 16-byte aligned); w16: 16-byte weight
// copies (K % 4 == 0, w 16-byte aligned).
extern "C" int rt_conv2d_direct(const void* x, const void* w, void* y,
                                const void* steps, void* ws, void* counters,
                                int n, int h, int wd, int c, int k, int kw,
                                int stride, int oh, int ow, int pad_h,
                                int pad_w, int nk, int kper, int splits,
                                int x16, int w16, void* stream) {
  ConvArgs a;
  a.x = static_cast<const float*>(x);
  a.w = static_cast<const float*>(w);
  a.y = static_cast<float*>(y);
  a.steps = static_cast<const int*>(steps);
  a.ws = static_cast<float*>(ws);
  a.counters = static_cast<int*>(counters);
  a.h = h;
  a.w_ = wd;
  a.c = c;
  a.k = k;
  a.kw = kw;
  a.stride = stride;
  a.oh = oh;
  a.ow = ow;
  a.pad_h = pad_h;
  a.pad_w = pad_w;
  a.m = n * oh * ow;
  a.nk = nk;
  a.kper = kper;
  a.splits = splits;
  if (a.m <= 0 || k <= 0) return (int)cudaSuccess;
  if (splits < 1 || kper < 1 || (splits > 1 && (splits - 1) * kper >= nk))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (w16)
    return x16 ? launch<gp::XC16, true>(a, s) : launch<gp::XC16, false>(a, s);
  return x16 ? launch<gp::XC, true>(a, s) : launch<gp::XC, false>(a, s);
}
