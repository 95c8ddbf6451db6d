// K13: flash attention forward, f32.  For each batch b, query head h
// (kv head h / G, G = Hq / Hkv) and query position i, aligned to key
// position qp = i + (Skv - Sq):
//   s_j   = softcap * tanh((q_i . k_j) * scale / softcap)   (no softcap:
//           (q_i . k_j) * scale)
//   j visible iff j < Skv, j <= qp (causal), j > qp - window (window)
//   o_i   = sum_j softmax(s)_j v_j over the visible keys; 0 if none.
// Inputs q (B, Sq, Hq, D), k, v (B, Skv, Hkv, D); output o like q; all
// contiguous, read and written in place (no transpose, no pad copy).
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::_flash_kernel
// (launcher flash_attention): online-softmax attention with GQA, causal
// and sliding-window masks, a tanh softcap and padded keys masked.  The
// TPU grid (B, Hq, q-blocks, k-blocks) visits every k-block of every
// q-block, re-reads K/V once per query head, and pads and transposes q,
// k and v in HBM first.
//
// Design.  One CTA per (batch, kv head, block of 64 rows), a row being
// one (query position, query head of the group) pair taken in memory
// order (position-major, so the G heads of a position are adjacent), so
// each K/V tile staged in shared memory serves all G heads of its kv
// head.  The CTA loops only over the key blocks its rows can see, from
// the window's first to the diagonal's, masking per element inside the
// block (keys past Skv included).  Per key block of 64:
//   1. K^T and V staged in shared memory (zeros past Skv);
//   2. S = Q K^T, each thread a 4 x 4 micro-tile (rows x keys) from
//      float4 reads of Q^T and K^T;
//   3. scale, softcap (IEEE tanhf), mask to -inf; the row max and sum
//      by warp shuffles over the 16 threads of a row group; running max
//      m from -inf, denominator l and the 4 x (D/16) output accumulator
//      in registers; a key block with nothing visible to a row leaves
//      that row untouched (m stays -inf, alpha 1, p 0);
//   4. P^T written over K^T's room, then O += P V.
// Finally o = acc / l, with l == 0 -> 1, so a row that sees no key is 0.
// CTAs start with the last row blocks (the longest causal ranges).
//
// Bound on this card: 4 D FLOP per visible (query head, key) pair
// against each of q, k, v and o moved once, so at llama3-8b's causal
// 8192 x 8192 (D 128) a call does ~1600 FLOP per byte: operation-bound
// (f32, outside the tensor cores).  This first design runs f32 FMA on
// the CUDA cores from shared memory; tensor cores (3xTF32 for the f32
// contract), TMA staging and a deeper key pipeline are later work.
// Shared memory at D 128: smem_floats<128>() floats (103,424 bytes),
// past the 48 KB default, so the launcher opts in; two CTAs fit an SM.
#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;        // threads: 16 x 16
constexpr int BR = 64;         // rows of a CTA (position, head) pairs
constexpr int BK = 64;         // keys per step
constexpr int PAD = 4;         // row padding of shared arrays
constexpr int LDR = BR + PAD;  // Q^T and P^T rows
constexpr int LDK = BK + PAD;  // K^T rows

struct FlashArgs {
  const float* q;
  const float* k;
  const float* v;
  float* o;
  int B, Sq, Skv, Hq, Hkv, D, G;
  int rows;                    // Sq * G rows per (batch, kv head)
  int causal, window;          // window <= 0: none
  float scale, softcap;        // softcap <= 0: none
};

__device__ __forceinline__ float neg_inf() {
  return __int_as_float(0xff800000);
}

template <int DP>
constexpr int smem_floats() {
  return DP * LDR + (DP * LDK > BK * LDR ? DP * LDK : BK * LDR) +
         BK * (DP + PAD);
}

// Stage a (64 x DP) row-major global tile transposed into dst[d * ld + r]:
// a warp takes 4 rows x 8 consecutive d, so global reads are 32-byte
// segments and the 32 shared writes hit 32 distinct banks (ld = 4 mod 32).
// Rows for which row_ptr gives nullptr, and d >= D, are zeros.
template <int DP, typename RowPtr>
__device__ __forceinline__ void stage_transposed(float* dst, int ld, int D,
                                                 RowPtr row_ptr, int tid) {
  for (int e = tid; e < 64 * DP; e += NT) {
    const int w = e >> 5, l = e & 31;
    const int d = (l & 7) + 8 * (w % (DP / 8));
    const int r = (l >> 3) + 4 * (w / (DP / 8));
    const float* src = row_ptr(r);
    dst[d * ld + r] = (src != nullptr && d < D) ? src[d] : 0.f;
  }
}

template <int DP>
__global__ void __launch_bounds__(NT, 2) flash_fwd_kernel(FlashArgs p) {
  extern __shared__ __align__(16) float smem[];
  constexpr int LDV = DP + PAD;
  constexpr int NH = DP / 64;  // float4 column groups of a thread in O
  float* qs = smem;            // Q^T [d][r]
  float* kps = qs + DP * LDR;  // K^T [d][j], later P^T [j][r]
  float* vs = kps + (DP * LDK > BK * LDR ? DP * LDK : BK * LDR);  // V [j][d]

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int G = p.G, D = p.D;
  const int b = blockIdx.y / p.Hkv, kvh = blockIdx.y % p.Hkv;
  const int f0 = (gridDim.x - 1 - blockIdx.x) * BR;   // longest first
  const int off = p.Skv - p.Sq;
  const size_t qrow = (size_t)p.Hq * D, krow = (size_t)p.Hkv * D;
  const float* qb = p.q + (size_t)b * p.Sq * qrow + (size_t)kvh * G * D;
  const float* kb = p.k + (size_t)b * p.Skv * krow + (size_t)kvh * D;
  const float* vb = p.v + (size_t)b * p.Skv * krow + (size_t)kvh * D;
  float* ob = p.o + (size_t)b * p.Sq * qrow + (size_t)kvh * G * D;

  // Q^T for the CTA's rows
  stage_transposed<DP>(qs, LDR, D, [&](int r) -> const float* {
    const int f = f0 + r;
    return f < p.rows ? qb + (size_t)(f / G) * qrow + (size_t)(f % G) * D
                      : nullptr;
  }, tid);

  const int last = (f0 + BR < p.rows ? f0 + BR : p.rows) - 1;
  const int qlo = f0 / G + off, qhi = last / G + off;
  int kend = p.Skv;
  if (p.causal && qhi + 1 < kend) kend = qhi + 1;
  int kbeg = 0;
  if (p.window > 0 && qlo - p.window + 1 > 0) kbeg = qlo - p.window + 1;

  float m[4], l[4], acc[4][NH * 4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = neg_inf();
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NH * 4; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = (kbeg / BK) * BK; k0 < kend; k0 += BK) {
    __syncthreads();  // the previous step's P^T and V are read
    stage_transposed<DP>(kps, LDK, D, [&](int j) -> const float* {
      const int key = k0 + j;
      return key < p.Skv ? kb + (size_t)key * krow : nullptr;
    }, tid);
    for (int e = tid; e < BK * DP; e += NT) {
      const int j = e / DP, d = e % DP;
      const int key = k0 + j;
      vs[j * LDV + d] =
          (key < p.Skv && d < D) ? vb[(size_t)key * krow + d] : 0.f;
    }
    __syncthreads();

    // 2. S micro-tile: rows ty*4 + i, keys tx*4 + j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    {
      const float* ap = qs + ty * 4;
      const float* bp = kps + tx * 4;
#pragma unroll 4
      for (int d = 0; d < DP; ++d) {
        const float4 av = *reinterpret_cast<const float4*>(ap + d * LDR);
        const float4 bv = *reinterpret_cast<const float4*>(bp + d * LDK);
        const float ar[4] = {av.x, av.y, av.z, av.w};
        const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = fmaf(ar[i], br[j], s[i][j]);
      }
    }

    // 3. scale, softcap, mask; online softmax update of the 4 rows
    // (row ty*4 + i: flattened f, aligned query position qp)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int f = f0 + ty * 4 + i;
      const int qp = f / G + off;
      float mx = neg_inf();
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + tx * 4 + j;
        bool ok = f < p.rows && key < p.Skv;
        if (p.causal) ok = ok && key <= qp;
        if (p.window > 0) ok = ok && key > qp - p.window;
        float x = s[i][j] * p.scale;
        if (p.softcap > 0.f) x = p.softcap * tanhf(x / p.softcap);
        s[i][j] = ok ? x : neg_inf();
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float mnew = fmaxf(m[i], mx);
      float alpha = 1.f, rs = 0.f;
      if (mnew != neg_inf()) {     // else nothing visible yet: a no-op
        alpha = expf(m[i] - mnew);  // m = -inf -> 0
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = expf(s[i][j] - mnew);  // masked -> 0
          rs += s[i][j];
        }
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, o);
      l[i] = l[i] * alpha + rs;
      m[i] = mnew;
#pragma unroll
      for (int c = 0; c < NH * 4; ++c) acc[i][c] *= alpha;
    }

    // 4. P^T over K^T's room, then O += P V
    __syncthreads();  // every thread is done reading K^T
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(kps + (tx * 4 + j) * LDR + ty * 4) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();
    {
      const float* ap = kps + ty * 4;
#pragma unroll 4
      for (int j = 0; j < BK; ++j) {
        const float4 av = *reinterpret_cast<const float4*>(ap + j * LDR);
        const float ar[4] = {av.x, av.y, av.z, av.w};
#pragma unroll
        for (int h = 0; h < NH; ++h) {
          const float4 bv = *reinterpret_cast<const float4*>(
              vs + j * LDV + h * 64 + tx * 4);
          const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int c = 0; c < 4; ++c)
              acc[i][h * 4 + c] = fmaf(ar[i], br[c], acc[i][h * 4 + c]);
        }
      }
    }
  }

  // o = acc / l (l == 0: no visible key, o = 0)
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int f = f0 + ty * 4 + i;
    if (f >= p.rows) continue;
    float* orow = ob + (size_t)(f / G) * qrow + (size_t)(f % G) * D;
    const float inv = 1.f / (l[i] == 0.f ? 1.f : l[i]);
#pragma unroll
    for (int h = 0; h < NH; ++h)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int d = h * 64 + tx * 4 + c;
        if (d < D) orow[d] = acc[i][h * 4 + c] * inv;
      }
  }
}

template <int DP>
int launch(const FlashArgs& p, cudaStream_t s) {
  const size_t smem = sizeof(float) * (size_t)smem_floats<DP>();
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((p.rows + BR - 1) / BR, p.B * p.Hkv);
  flash_fwd_kernel<DP><<<grid, NT, smem, s>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// D <= 128; Hq % Hkv == 0; B * Hkv <= 65535; window <= 0 means none,
// softcap <= 0 means none.
extern "C" int rt_flash_attention(const void* q, const void* k,
                                  const void* v, void* o, int B, int Sq,
                                  int Skv, int Hq, int Hkv, int D,
                                  int causal, int window, float scale,
                                  float softcap, void* stream) {
  if (B <= 0 || Sq <= 0 || Hq <= 0 || D <= 0) return (int)cudaSuccess;
  if (Hkv <= 0 || Hq % Hkv != 0 || D > 128 || B * Hkv > 65535 || Skv < 0)
    return (int)cudaErrorInvalidValue;
  FlashArgs p;
  p.q = static_cast<const float*>(q);
  p.k = static_cast<const float*>(k);
  p.v = static_cast<const float*>(v);
  p.o = static_cast<float*>(o);
  p.B = B;
  p.Sq = Sq;
  p.Skv = Skv;
  p.Hq = Hq;
  p.Hkv = Hkv;
  p.D = D;
  p.G = Hq / Hkv;
  p.rows = Sq * p.G;
  p.causal = causal;
  p.window = window;
  p.scale = scale;
  p.softcap = softcap;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return D <= 64 ? launch<64>(p, s) : launch<128>(p, s);
}
