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
// Bound on this card: 4 D FLOP per visible (query head, key) pair
// against each of q, k, v and o moved once, so at llama3-8b's causal
// 8192 x 8192 (D 128) a call does ~1600 FLOP per byte: operation-bound.
// The f32 products run on the tensor cores in 3xTF32 (three TF32
// products per f32 product, 495 TFLOP/s dense TF32): 3.3 ms for that
// call, against 8.2 ms for f32 FMA on the CUDA cores.
//
// Design.  One CTA of 4 warps per (batch, kv head, block of 64 rows), a
// row being one (query position, query head of the group) pair taken in
// memory order (position-major, so the G heads of a position are
// adjacent), so each K/V tile in shared memory serves all G heads of its
// kv head.  Each warp owns 16 rows.  The CTA loops only over the key
// blocks its rows can see, from the window's first to the diagonal's
// (``kernels/flash_attention.py::flash_launch`` lists the same blocks).
//   * Staging: Q once; K and V blocks of BK keys (32 at D > 64, else 64)
//     on a 2-stage ring of 16-byte ``cp.async.cg`` copies (4-byte copies
//     when D % 4 or an address is not 16-byte aligned), zero-filled past
//     Skv and past D: block j + 1's copies fly while block j is
//     multiplied, one barrier per block.  Q and K rows are padded to DP +
//     16 floats, V's 16-byte chunks are XOR-swizzled by row, so every
//     fragment load below is a conflict-free 16-byte shared load.
//   * S = Q K^T and O += P V on ``mma.sync.m16n8k8`` in 3xTF32: each
//     operand x splits into big = cvt.rna.tf32(x) and small =
//     cvt.rna.tf32(x - big), and the f32 accumulator takes small.big,
//     big.small, then big.big.  The rounding is cvt.rna's (ties away
//     from zero) in two integer operations: PTX's cvt.rna.tf32.f32
//     compiles to a longer sequence on sm_90 (a llama3-8b layer 13.5 ms
//     against 9.9, ``scripts/bench_flash.py --variants``).  A thread's
//     16-byte Q/K load covers two k-steps: d0 + 4t, +1 are k-slots t,
//     t + 4 of the first, +2, +3 of the second (any d order serves a dot
//     product); each 8-key tile of S sums its two k-steps in two
//     accumulators (two product chains).
//   * P stays in registers: S's m16n8 accumulator of an 8-key tile (a
//     thread's columns 2t, 2t + 1) is P's m16n8k8 A fragment in place,
//     taken as k-slots t, t + 4; the B fragment reads V's rows 2t, 2t + 1
//     to match.  Output column n of O's n-tile jn is d = n * DP / 8 + jn,
//     so a thread's V reads and o stores are contiguous runs of d.
//   * Masks only where needed: a block wholly visible to every row of
//     the CTA (below Skv, at or below the first row's diagonal, above the
//     last row's window edge) skips the per-element mask; only blocks
//     that straddle the diagonal, the window's edge or Skv apply it.
//   * Online softmax in base 2: scores are scaled by scale * log2(e)
//     (with a softcap, softcap * tanhf(s * scale / softcap) * log2(e),
//     IEEE tanhf) and exponentiated with ex2.approx.ftz (2^x to about
//     2 ulp; the tolerance is 1e-3 of max|o|).  The row max is reduced
//     over the 4 threads of a row, the denominator kept per thread and
//     reduced once at the end; a block with nothing visible to a row
//     leaves it untouched (max -inf, exponents taken against 0).
// Finally o = acc / l, 0 where l == 0 (a row that sees no key).  CTAs
// start with the last row blocks (the longest causal ranges).
// Shared memory: 106,496 bytes at D 128, 94,208 at D <= 64 (past the
// 48 KB default, so the launcher opts in); two CTAs fit an SM.
#include <cuda_runtime.h>

#include "gemm_pipe.cuh"
#include "mma_tf32.cuh"

namespace {

constexpr int NW = 4;          // warps a CTA
constexpr int NT = NW * 32;    // threads
constexpr int BR = NW * 16;    // rows of a CTA, 16 a warp

template <int DP>
struct Cfg {
  static constexpr int BK = DP > 64 ? 32 : 64;   // keys a block
  static constexpr int LD = DP + 16;             // Q and K rows
  static constexpr int NTL = DP / 8;             // n-tiles of O
  static constexpr int CH = DP / 4;              // 16-byte chunks a row
  static constexpr int Q_FLOATS = BR * LD;
  static constexpr int K_FLOATS = BK * LD;
  static constexpr int STAGE = K_FLOATS + BK * DP;
  static constexpr int SMEM_FLOATS = Q_FLOATS + 2 * STAGE;
};

struct FlashArgs {
  const float* q;
  const float* k;
  const float* v;
  float* o;
  int B, Sq, Skv, Hq, Hkv, D, G;
  int rows;                    // Sq * G rows per (batch, kv head)
  int causal, window;          // window <= 0: none
  int vec;                     // 16-byte copies and stores
  float sc;                    // scale * log2(e); softcap: scale / softcap
  float cap;                   // softcap * log2(e)
};

__device__ __forceinline__ float neg_inf() {
  return __int_as_float(0xff800000);
}

// V's 16-byte chunk c of row r lies at chunk c ^ vsw(r): the B-fragment
// reads of 8 lanes (rows 2t, 2t + 1 of four t, two column runs) then hit
// 8 distinct 16-byte bank groups
template <int DP>
__device__ __forceinline__ int vsw(int r) {
  return DP > 64 ? (r >> 1) & 3 : ((r >> 1) & 1) | (((r >> 2) & 1) << 2);
}

// n floats (<= 0: none) of src into the 16-byte chunk at dst, zero-filled
__device__ __forceinline__ void chunk(float* dst, const float* src, int n,
                                     bool vec) {
  const unsigned s = gp::smem_u32(dst);
  if (vec) {
    gp::cp16(s, src, n > 0 ? 16 : 0);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) gp::cp4(s + 4 * i, src + i, i < n ? 4 : 0);
  }
}

template <int DP, bool SOFTCAP>
__global__ void __launch_bounds__(NT, 2) flash_fwd_kernel(FlashArgs p) {
  using C = Cfg<DP>;
  constexpr int BK = C::BK, LD = C::LD, NTL = C::NTL, CH = C::CH;
  constexpr int NS = BK / 8;   // 8-key tiles of a block
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* ring = smem + C::Q_FLOATS;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int G = p.G, D = p.D;
  const bool vec = p.vec;
  const int b = blockIdx.y / p.Hkv, kvh = blockIdx.y % p.Hkv;
  const int f0 = (gridDim.x - 1 - blockIdx.x) * BR;   // longest first
  const int off = p.Skv - p.Sq;
  const size_t qrow = (size_t)p.Hq * D, krow = (size_t)p.Hkv * D;
  const float* qb = p.q + (size_t)b * p.Sq * qrow + (size_t)kvh * G * D;
  const float* kb = p.k + (size_t)b * p.Skv * krow + (size_t)kvh * D;
  const float* vb = p.v + (size_t)b * p.Skv * krow + (size_t)kvh * D;
  float* ob = p.o + (size_t)b * p.Sq * qrow + (size_t)kvh * G * D;

  // the key blocks [jbeg, jend) some row sees, and [u0, u1) of them that
  // every row sees wholly (kernels/flash_attention.py::flash_launch
  // computes the same for the tests: change the two together)
  const int last = (f0 + BR < p.rows ? f0 + BR : p.rows) - 1;
  const int qlo = f0 / G + off, qhi = last / G + off;
  int kend = p.Skv;
  if (p.causal && qhi + 1 < kend) kend = qhi + 1;
  int kbeg = 0;
  if (p.window > 0 && qlo - p.window + 1 > 0) kbeg = qlo - p.window + 1;
  const int jbeg = kbeg / BK, jend = kend > 0 ? (kend + BK - 1) / BK : 0;
  int u1 = p.Skv / BK, u0 = jbeg;
  if (p.causal) u1 = min(u1, qlo + 1 > 0 ? (qlo + 1) / BK : 0);
  if (p.window > 0 && qhi - p.window + 1 > 0)
    u0 = max(u0, (qhi - p.window + BK) / BK);

  // this thread's two rows (g and g + 8 of its warp's 16) and their
  // aligned query positions
  int qp[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) qp[i] = (f0 + warp * 16 + g + 8 * i) / G + off;

  // a thread copies chunk cc of rows r0, r0 + RP, ... of each block
  constexpr int RP = NT / CH, PASSES = BK / RP;
  const int cc = tid % CH, r0 = tid / CH, nd = D - 4 * cc;
  const float* kt = kb + (size_t)r0 * krow + 4 * cc;
  const float* vt = vb + (size_t)r0 * krow + 4 * cc;
  auto stage_kv = [&](int j, int s) {
    float* ks = ring + s * C::STAGE + r0 * LD + 4 * cc;
    float* vs = ring + s * C::STAGE + C::K_FLOATS + r0 * DP;
    const size_t at = (size_t)j * BK * krow;
    const int left = p.Skv - j * BK - r0;   // rows r0 + i * RP < left
#pragma unroll
    for (int i = 0; i < PASSES; ++i) {
      const bool ok = i * RP < left;
      const size_t a = at + (size_t)i * RP * krow;
      chunk(ks + i * RP * LD, ok ? kt + a : p.k, ok ? nd : 0, vec);
      chunk(vs + i * RP * DP + 4 * (cc ^ vsw<DP>(r0 + i * RP)),
            ok ? vt + a : p.v, ok ? nd : 0, vec);
    }
  };

  if (jbeg < jend) {
    for (int e = tid; e < BR * CH; e += NT) {
      const int r = e / CH, c = e % CH, f = f0 + r;
      const bool ok = f < p.rows;
      chunk(qs + r * LD + 4 * c,
            ok ? qb + (size_t)(f / G) * qrow + (size_t)(f % G) * D + 4 * c
               : p.q,
            ok ? D - 4 * c : 0, vec);
    }
    stage_kv(jbeg, 0);
  }
  gp::commit();

  float o[NTL][4], m[2], l[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    m[i] = neg_inf();
    l[i] = 0.f;
  }
#pragma unroll
  for (int n = 0; n < NTL; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) o[n][c] = 0.f;

  const float* qw = qs + (warp * 16 + g) * LD + 4 * t;
  for (int j = jbeg; j < jend; ++j) {
    const int s = (j - jbeg) & 1;
    gp::wait_group<0>();
    __syncthreads();   // block j landed; every warp is done with j - 1
    if (j + 1 < jend) stage_kv(j + 1, s ^ 1);
    gp::commit();
    const float* ks = ring + s * C::STAGE;
    const float* vs = ks + C::K_FLOATS;

    // S = Q K^T: sacc[n] is the 16 x 8 tile of keys n * 8 .. + 7, the
    // second k-step of each 16-d chunk summed apart (two chains a tile)
    float sacc[NS][4], s2[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) sacc[n][c] = s2[n][c] = 0.f;
#pragma unroll
    for (int d0 = 0; d0 < DP; d0 += 16) {
      const float4 lo = *reinterpret_cast<const float4*>(qw + d0);
      const float4 hi = *reinterpret_cast<const float4*>(qw + 8 * LD + d0);
      const AFrag a0({lo.x, hi.x, lo.y, hi.y});
      const AFrag a1({lo.z, hi.z, lo.w, hi.w});
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        const float4 kv = *reinterpret_cast<const float4*>(
            ks + (n * 8 + g) * LD + d0 + 4 * t);
        mma3(sacc[n], a0, kv.x, kv.y);
        mma3(s2[n], a1, kv.z, kv.w);
      }
    }

    // scores in base 2, masked in blocks that need it; online softmax
    const bool masked = j < u0 || j >= u1;
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float x = (sacc[n][c] + s2[n][c]) * p.sc;
        if (SOFTCAP) x = tanhf(x) * p.cap;
        if (masked) {
          const int key = j * BK + n * 8 + 2 * t + (c & 1);
          const int pos = qp[c >> 1];
          bool ok = key < p.Skv;
          if (p.causal) ok = ok && key <= pos;
          if (p.window > 0) ok = ok && key > pos - p.window;
          if (!ok) x = neg_inf();
        }
        sacc[n][c] = x;
      }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = m[i];
#pragma unroll
      for (int n = 0; n < NS; ++n)
        mx = fmaxf(mx, fmaxf(sacc[n][2 * i], sacc[n][2 * i + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float base = mx == neg_inf() ? 0.f : mx;
      alpha[i] = ex2(m[i] - base);   // m = -inf -> 0
      float rs = 0.f;
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float pv = ex2(sacc[n][2 * i + e] - base);  // -inf -> 0
          sacc[n][2 * i + e] = pv;
          rs += pv;
        }
      l[i] = l[i] * alpha[i] + rs;
      m[i] = mx;
    }
#pragma unroll
    for (int n = 0; n < NTL; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) o[n][c] *= alpha[c >> 1];

    // O += P V, P's A fragment straight from S's accumulator tile
#pragma unroll
    for (int kk = 0; kk < NS; ++kk) {
      const AFrag a({sacc[kk][0], sacc[kk][2], sacc[kk][1], sacc[kk][3]});
      const int r0 = kk * 8 + 2 * t;
      const float* v0 = vs + r0 * DP;
      const float* v1 = v0 + DP;
#pragma unroll
      for (int c = 0; c < NTL / 4; ++c) {
        const int cc = g * (NTL / 4) + c;
        const float4 x = *reinterpret_cast<const float4*>(
            v0 + 4 * (cc ^ vsw<DP>(r0)));
        const float4 y = *reinterpret_cast<const float4*>(
            v1 + 4 * (cc ^ vsw<DP>(r0 + 1)));
        mma3(o[4 * c], a, x.x, y.x);
        mma3(o[4 * c + 1], a, x.y, y.y);
        mma3(o[4 * c + 2], a, x.z, y.z);
        mma3(o[4 * c + 3], a, x.w, y.w);
      }
    }
  }

  // o = acc / l (l == 0: no visible key, o = 0); a thread holds columns
  // 2t * NTL + jn (c0, c2) and (2t + 1) * NTL + jn (c1, c3) of its rows
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float li = l[i];
    li += __shfl_xor_sync(0xffffffffu, li, 1);
    li += __shfl_xor_sync(0xffffffffu, li, 2);
    const int f = f0 + warp * 16 + g + 8 * i;
    if (f >= p.rows) continue;
    const float inv = li == 0.f ? 0.f : 1.f / li;
    float* orow = ob + (size_t)(f / G) * qrow + (size_t)(f % G) * D;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int d0 = (2 * t + h) * NTL;
#pragma unroll
      for (int jn = 0; jn < NTL; jn += 4) {
        const float w[4] = {o[jn][2 * i + h] * inv, o[jn + 1][2 * i + h] * inv,
                            o[jn + 2][2 * i + h] * inv,
                            o[jn + 3][2 * i + h] * inv};
        const int d = d0 + jn;
        if (vec) {
          if (d < D)
            *reinterpret_cast<float4*>(orow + d) =
                make_float4(w[0], w[1], w[2], w[3]);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (d + e < D) orow[d + e] = w[e];
        }
      }
    }
  }
}

template <int DP, bool SOFTCAP>
int launch(const FlashArgs& p, cudaStream_t s) {
  const size_t smem = sizeof(float) * (size_t)Cfg<DP>::SMEM_FLOATS;
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_kernel<DP, SOFTCAP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((p.rows + BR - 1) / BR, p.B * p.Hkv);
  flash_fwd_kernel<DP, SOFTCAP><<<grid, NT, smem, s>>>(p);
  return (int)cudaGetLastError();
}

template <int DP>
int launch_dp(const FlashArgs& p, bool softcap, cudaStream_t s) {
  return softcap ? launch<DP, true>(p, s) : launch<DP, false>(p, s);
}

bool aligned16(const void* x) {
  return (reinterpret_cast<size_t>(x) & 15) == 0;
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
  const float log2e = 1.4426950408889634f;
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
  p.vec = D % 4 == 0 && aligned16(q) && aligned16(k) && aligned16(v) &&
          aligned16(o);
  const bool capped = softcap > 0.f;
  p.sc = capped ? scale / softcap : scale * log2e;
  p.cap = capped ? softcap * log2e : 0.f;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return D <= 64 ? launch_dp<64>(p, capped, s) : launch_dp<128>(p, capped, s);
}
