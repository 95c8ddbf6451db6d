// K14: the Mamba-2 SSD chunk cell, f32.  For each (batch, chunk) cell
// and head h, with g = h / (H / G) its state group:
//   cum[t]      = sum_{r<=t} a[r, h]
//   y_diag[t,:] = sum_{s<=t} exp(cum[t] - cum[s]) (c[t, g] . b[s, g]) x[s, h, :]
//   state[:, :] = sum_s exp(cum[L-1] - cum[s]) b[s, g] (x) x[s, h, :]
// Inputs x (cells, L, H, P), a (cells, L, H), b, c (cells, L, G, N);
// outputs y_diag (cells, L, H, P), states (cells, H, N, P), cum
// (cells, L, H), all contiguous.
//
// Replaces the TPU kernel repro/kernels/ssd.py::_ssd_chunk_kernel
// (launcher ssd_chunked): the intra-chunk quadratic output and the
// end-of-chunk state of the SSD chunked algorithm; the inter-chunk
// recurrence and the off-diagonal term stay outside the kernel, as in
// the reference.  Like the TPU kernel, it forms C B^T once for the heads
// that share it.
//
// Bound on this card: three products a cell, S = C B^T (L^2 N / 2 MAC a
// group, the causal half), y = (S o decay) x and state = B^T (w o x)
// (L^2 P / 2 and L N P MAC a head).  At mamba2-370m's prefill (L 128,
// H 32, P 64, G 1, N 128, 64 cells) a call needs 6.66 GFLOP and moves
// 211.8 MB (x, y_diag and states 67 MB each): 0.099 ms of f32 FMA on the
// CUDA cores, but 0.040 ms in 3xTF32 on the tensor cores (three TF32
// products per f32 product, 495 TFLOP/s), under the bytes' 0.063 ms at
// 3.35 TB/s.  So the products run in 3xTF32 (mma_tf32.cuh) and the
// design keeps the bytes moving: x on a cp.async ring, every store a
// 16-byte run.
//
// Design.  One CTA of NW warps (4 for L <= 64, else 8) per (cell, block
// of HB heads of one group); HB divides H / G and comes from the wrapper
// (kernels/ssd.py::ssd_launch: from the SM count, the fewest waves times
// a CTA's work), CTA i taking cell i / (H / HB) and heads (i % (H / HB))
// * HB on.  Each warp owns 16 rows t of the chunk (warps w and w + NW / 2
// take row tiles w and NW - 1 - w, so the two warps of a scheduler share
// the causal work evenly).
//   1. Staging: C and B (each L x N, zero past L and N) in one cp.async
//      group, head 0's x in a second; cum for the CTA's heads by a warp
//      scan each (4 steps a lane, then the lanes' totals by shuffles)
//      while they fly.
//   2. S = C B^T on mma.sync.m16n8k8 in 3xTF32, once for all HB heads,
//      kept in registers (16 rows a warp, 8-column tiles of s).  Tiles
//      right of the warp's last row are not formed (the causal skip): the
//      warp of row tile m takes tiles 0 .. 2m + 1.  A thread's 8-byte
//      loads of C and B take k-slots t and t + 4 as d_state 2t and 2t + 1.
//   3. Per head j, a ring of two x stages: head j + 1's copies fly while
//      head j multiplies.  Once head j has landed, the CTA splits it in
//      place (big = cvt.rna.tf32(x) over the raw value, small beside it),
//      so no fragment load splits x again, and writes w[s] = exp(cum[L-1]
//      - cum[s]) for the head.
//   4. y_h = P x_h with P = S o decay_h formed in registers: S's m16n8
//      accumulator tile is P's A fragment in place (columns 2t, 2t + 1 as
//      k-slots t, t + 4, K13's rule), the decay exp(where(s <= t, cum[t] -
//      cum[s], -1e30)) taken as ex2 of the difference times log2(e), the
//      mask inside the exponent and applied only on the two tiles that
//      straddle the warp's diagonal.  x rows 2t, 2t + 1 match it.
//   5. state_h = B^T (w_h o x_h): warps over 16-row tiles of d_state, B
//      (staged once for every head) as the A operand, w_h multiplied into
//      its values as each A fragment loads (the same sum as weighting x's
//      rows, at 4 products an 8 x 8 k-tile instead of 2 an n-tile).
//   Output column n of n-tile jn is p = n * PP / 8 + jn (K13's rule), so
//   a thread's x reads and its y and state stores are 16-byte runs of p.
//   x's 16-byte chunks are XOR-swizzled by row (xsw) so that both fragment
//   reads, rows {2t, 2t + 1} and rows {t, t + 4}, are conflict-free; B
//   and C rows are padded to ldb = 8 mod 16 floats, which makes their
//   8-byte reads (step 2) and 4-byte reads (step 5) conflict-free.
// Shared memory (floats): B LP x ldb; x stage 0 LP x PP; C LP x ldb,
// later x stage 1 and the small parts (2 LP x PP); cum HB x LP; w LP.
// 180,736 bytes at the full width (LP 128, PP 64, ldb 136, HB 16): one
// CTA an SM at 8 warps, two at 4.
#include <cuda_runtime.h>

#include "gemm_pipe.cuh"
#include "mma_tf32.cuh"

namespace {

constexpr int SMEM_LIMIT = 232448;   // dynamic shared memory a CTA may use
constexpr int HEADS_MAX = 16;        // heads a CTA, at most
constexpr float LOG2E = 1.4426950408889634f;
constexpr float NEG = -1e30f;

struct SsdArgs {
  const float* x;
  const float* a;
  const float* b;
  const float* c;
  float* y;
  float* st;
  float* cum;
  int L, H, P, G, N;
  int hb;                      // heads a CTA
  int nb, ldb;                 // N rounded up to 16; B and C row pitch
  int vec;                     // 16-byte copies and stores
};

template <int NW, int PP>
struct Cfg {
  static constexpr int NT = NW * 32;
  static constexpr int LP = NW * 16;    // rows of the chunk, padded
  static constexpr int NPT = PP / 8;    // n-tiles of y and of a state
  static constexpr int CH = PP / 4;     // 16-byte chunks of an x row
  static constexpr int XS = LP * PP;    // floats of an x stage
};

// floats of dynamic shared memory (kernels/ssd.py::ssd_launch computes
// the same: change the two together)
__host__ __device__ inline int bc_room(int lp, int ldb, int xs) {
  return lp * ldb > 2 * xs ? lp * ldb : 2 * xs;
}
__host__ __device__ inline int smem_floats(int lp, int ldb, int xs, int hb) {
  return lp * ldb + xs + bc_room(lp, ldb, xs) + hb * lp + lp;
}

// x's 16-byte chunk q of row r lies at chunk q ^ xsw(r).  A lane reads
// chunk g * PP / 32 + i, so the 8 lanes of a 16-byte phase (two g, four
// rows) differ in bit 0 (PP 32) or bit 1 (PP 64) of it by g; the swizzle
// fills the two other bits of the bank group with a value that differs
// between any two of the rows {0, 2, 4, 6}, {1, 3, 5, 7}, {0, 1, 2, 3} or
// {4, 5, 6, 7} (mod 8)
template <int PP>
__device__ __forceinline__ int xsw(int r) {
  const int lo = ((r >> 1) ^ r) & 1, hi = ((r >> 2) ^ (r >> 1)) & 1;
  return PP == 32 ? (lo << 1) | (hi << 2) : lo | (hi << 2);
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

// rows r (< L) of a 16-row tile, columns (2t + e) * NPT + jn (< P): the
// accumulators acc[jn][2i + e] of rows r0 + g + 8i, as 16-byte runs
template <int NPT>
__device__ __forceinline__ void store_tile(const float (&acc)[NPT][4],
                                           float* base, size_t ld, int r0,
                                           int rows, int P, bool vec) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + g + 8 * i;
    if (r >= rows) continue;
    float* row = base + (size_t)r * ld;
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int q = 0; q < NPT; q += 4) {
        const int p = (2 * t + e) * NPT + q;
        const float w[4] = {acc[q][2 * i + e], acc[q + 1][2 * i + e],
                            acc[q + 2][2 * i + e], acc[q + 3][2 * i + e]};
        if (vec) {
          if (p < P)
            *reinterpret_cast<float4*>(row + p) =
                make_float4(w[0], w[1], w[2], w[3]);
        } else {
#pragma unroll
          for (int k = 0; k < 4; ++k)
            if (p + k < P) row[p + k] = w[k];
        }
      }
  }
}

// acc[4q + k] += a . x over the 8 rows ra (k-slot t) and rb (k-slot
// t + 4) of a split x stage (big parts xb, small parts xs), n-tiles 4q ..
// 4q + 3 in 3xTF32
template <int PP>
__device__ __forceinline__ void mma_x(float (&acc)[PP / 8][4], const AFrag& a,
                                      const float* xb, const float* xs,
                                      int ra, int rb) {
  constexpr int NPT = PP / 8;
  const int g = (threadIdx.x & 31) >> 2;
  const int oa = ra * PP, ob = rb * PP;
  const int sa = xsw<PP>(ra), sb = xsw<PP>(rb);
#pragma unroll
  for (int q = 0; q < NPT / 4; ++q) {
    const int cc = g * (NPT / 4) + q;
    const int ca = oa + 4 * (cc ^ sa), cb = ob + 4 * (cc ^ sb);
    const uint4 ba = *reinterpret_cast<const uint4*>(xb + ca);
    const uint4 bb = *reinterpret_cast<const uint4*>(xb + cb);
    const uint4 ta = *reinterpret_cast<const uint4*>(xs + ca);
    const uint4 tb = *reinterpret_cast<const uint4*>(xs + cb);
    mma3s(acc[4 * q], a, {ba.x, bb.x}, {ta.x, tb.x});
    mma3s(acc[4 * q + 1], a, {ba.y, bb.y}, {ta.y, tb.y});
    mma3s(acc[4 * q + 2], a, {ba.z, bb.z}, {ta.z, tb.z});
    mma3s(acc[4 * q + 3], a, {ba.w, bb.w}, {ta.w, tb.w});
  }
}

template <int NW, int PP>
__global__ void __launch_bounds__(NW * 32, 8 / NW) ssd_chunk_kernel(
    SsdArgs p) {
  using C = Cfg<NW, PP>;
  constexpr int NT = C::NT, LP = C::LP, NPT = C::NPT, CH = C::CH;
  constexpr int ST = 2 * NW;            // 8-column tiles of S a warp holds
  extern __shared__ __align__(16) float smem[];
  const int L = p.L, H = p.H, P = p.P, N = p.N, HB = p.hb, LDB = p.ldb;
  const bool vec = p.vec;
  float* bsm = smem;                                // B[s][n]
  float* slot0 = bsm + LP * LDB;                    // x stage 0
  float* room = slot0 + C::XS;                      // C, later:
  float* csm = room;                                //   C[t][n]
  float* slot1 = room;                              //   x stage 1
  float* xsm = room + C::XS;                        //   small parts
  float* cums = room + bc_room(LP, LDB, C::XS);     // cum[j][s]
  float* wsm = cums + HB * LP;                      // w[s] of a head

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int blocks = H / HB;
  const size_t cell = blockIdx.x / blocks;
  const int h0 = (blockIdx.x % blocks) * HB;
  const int grp = h0 / (H / p.G);
  const size_t brow = (size_t)p.G * N, xrow = (size_t)H * P;
  const float* bcell = p.b + cell * L * brow + (size_t)grp * N;
  const float* ccell = p.c + cell * L * brow + (size_t)grp * N;
  const float* xcell = p.x + cell * L * xrow;

  // 1. C and B, then head 0's x, on cp.async; cum while they fly
  {
    const int chs = p.nb / 4;
    for (int e = tid; e < LP * chs; e += NT) {
      const int s = e / chs, q = e % chs;
      const bool ok = s < L;
      const size_t at = s * brow + 4 * q;
      chunk(bsm + s * LDB + 4 * q, ok ? bcell + at : p.b, ok ? N - 4 * q : 0,
            vec);
      chunk(csm + s * LDB + 4 * q, ok ? ccell + at : p.c, ok ? N - 4 * q : 0,
            vec);
    }
  }
  gp::commit();
  auto stage_x = [&](int j, float* dst) {
    const float* xh = xcell + (size_t)(h0 + j) * P;
#pragma unroll
    for (int i = 0; i < LP * CH / NT; ++i) {
      const int e = tid + i * NT, s = e / CH, q = e % CH;
      const bool ok = s < L;
      chunk(dst + s * PP + 4 * (q ^ xsw<PP>(s)),
            ok ? xh + s * xrow + 4 * q : p.x, ok ? P - 4 * q : 0, vec);
    }
  };
  stage_x(0, slot0);
  gp::commit();
  for (int j = warp; j < HB; j += NW) {
    const int h = h0 + j;
    float v[4], run = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int s = 4 * lane + i;
      run += s < L ? p.a[(cell * L + s) * H + h] : 0.f;
      v[i] = run;
    }
    float tot = run;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, tot, off);
      if (lane >= off) tot += u;
    }
    const float pre = tot - run;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int s = 4 * lane + i;
      if (s < LP) cums[j * LP + s] = pre + v[i];
      if (s < L) p.cum[(cell * L + s) * H + h] = pre + v[i];
    }
  }
  gp::wait_group<1>();
  __syncthreads();   // C, B and cum in place

  // 2. S = C B^T on the warp's rows r0 .. r0 + 15, tiles 0 .. smax
  const int mt = warp < NW / 2 ? warp : 3 * NW / 2 - 1 - warp;
  const int r0 = 16 * mt;
  const int kt = (L + 7) / 8;           // 8-row k-tiles of s
  const int smax = r0 < L ? min(2 * mt + 1, kt - 1) : -1;
  float sacc[ST][4];
#pragma unroll
  for (int n = 0; n < ST; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) sacc[n][c] = 0.f;
  if (smax >= 0) {
    const float* c0 = csm + (r0 + g) * LDB + 2 * t;
    const float* c1 = c0 + 8 * LDB;
    const float* bt = bsm + g * LDB + 2 * t;
    for (int n0 = 0; n0 < N; n0 += 8) {
      const float2 u = *reinterpret_cast<const float2*>(c0 + n0);
      const float2 v = *reinterpret_cast<const float2*>(c1 + n0);
      const AFrag a({u.x, v.x, u.y, v.y});
#pragma unroll
      for (int n = 0; n < ST; ++n)
        if (n <= smax) {
          const float2 w =
              *reinterpret_cast<const float2*>(bt + 8 * n * LDB + n0);
          mma3(sacc[n], a, w.x, w.y);
        }
    }
  }

  const int mts = (N + 15) / 16;        // 16-row tiles of a state
  for (int j = 0; j < HB; ++j) {
    const int h = h0 + j;
    float* xb = j & 1 ? slot1 : slot0;
    gp::wait_group<0>();
    __syncthreads();   // head j landed; every warp is done with head j - 1
    if (j + 1 < HB) stage_x(j + 1, j & 1 ? slot0 : slot1);
    gp::commit();

    // 3. split head j in place; w of head j
    const float* cj = cums + j * LP;
#pragma unroll
    for (int i = 0; i < C::XS / 4 / NT; ++i) {
      const int e = 4 * (tid + i * NT);
      const float4 v = *reinterpret_cast<const float4*>(xb + e);
      uint4 big, small;
      split(v.x, big.x, small.x);
      split(v.y, big.y, small.y);
      split(v.z, big.z, small.z);
      split(v.w, big.w, small.w);
      *reinterpret_cast<uint4*>(xb + e) = big;
      *reinterpret_cast<uint4*>(xsm + e) = small;
    }
    {
      const float last = cj[L - 1];
      for (int s = tid; s < LP; s += NT) wsm[s] = ex2((last - cj[s]) * LOG2E);
    }
    __syncthreads();

    // 4. y_h = (S o decay_h) x_h on tiles 0 .. smax
    if (smax >= 0) {
      float acc[NPT][4];
#pragma unroll
      for (int n = 0; n < NPT; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[n][c] = 0.f;
      const float ct[2] = {cj[r0 + g], cj[r0 + g + 8]};
#pragma unroll
      for (int kk = 0; kk < ST; ++kk)
        if (kk <= smax) {
          const float2 cs = *reinterpret_cast<const float2*>(cj + 8 * kk
                                                               + 2 * t);
          const bool diag = kk >= 2 * mt;
          float pv[4];
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            float d = ct[c >> 1] - (c & 1 ? cs.y : cs.x);
            if (diag && 8 * kk + 2 * t + (c & 1) > r0 + g + 8 * (c >> 1))
              d = NEG;
            pv[c] = sacc[kk][c] * ex2(d * LOG2E);
          }
          const AFrag a({pv[0], pv[2], pv[1], pv[3]});
          mma_x<PP>(acc, a, xb, xsm, 8 * kk + 2 * t, 8 * kk + 2 * t + 1);
        }
      store_tile<NPT>(acc, p.y + (cell * L * H + h) * (size_t)P, xrow, r0,
                      L, P, vec);
    }

    // 5. state_h = B^T (w_h o x_h), 16 rows of d_state a warp at a time
    float* sth = p.st + (cell * H + h) * (size_t)N * P;
    for (int m = warp; m < mts; m += NW) {
      const int n0 = 16 * m;
      float acc[NPT][4];
#pragma unroll
      for (int n = 0; n < NPT; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[n][c] = 0.f;
      const float* bt = bsm + t * LDB + n0 + g;
      for (int s0 = 0; s0 < 8 * kt; s0 += 8) {
        const float w0 = wsm[s0 + t], w1 = wsm[s0 + t + 4];
        const float* b0 = bt + s0 * LDB;
        const float* b1 = b0 + 4 * LDB;
        const AFrag a({b0[0] * w0, b0[8] * w0, b1[0] * w1, b1[8] * w1});
        mma_x<PP>(acc, a, xb, xsm, s0 + t, s0 + t + 4);
      }
      store_tile<NPT>(acc, sth, P, n0, N, P, vec);
    }
  }
}

template <int NW, int PP>
int launch(const SsdArgs& p, int cells, cudaStream_t s) {
  using C = Cfg<NW, PP>;
  const size_t smem =
      sizeof(float) * (size_t)smem_floats(C::LP, p.ldb, C::XS, p.hb);
  if (smem > (size_t)SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  // once per instantiation: the most any launch of it may ask for
  static const cudaError_t attr = cudaFuncSetAttribute(
      ssd_chunk_kernel<NW, PP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_LIMIT);
  if (attr != cudaSuccess) return (int)attr;
  ssd_chunk_kernel<NW, PP><<<cells * (p.H / p.hb), C::NT, smem, s>>>(p);
  return (int)cudaGetLastError();
}

bool aligned16(const void* x) {
  return (reinterpret_cast<size_t>(x) & 15) == 0;
}

}  // namespace

// cells = batch * chunks; L <= 128; P <= 64; H % G == 0; hb <= 16 divides
// H / G (kernels/ssd.py::ssd_launch chooses it).
extern "C" int rt_ssd_chunk(const void* x, const void* a, const void* b,
                            const void* c, void* y, void* st, void* cum,
                            int cells, int L, int H, int P, int G, int N,
                            int hb, void* stream) {
  if (cells <= 0 || H <= 0 || P <= 0 || N <= 0) return (int)cudaSuccess;
  if (L <= 0 || L > 128 || P > 64 || G <= 0 || H % G != 0 || hb <= 0 ||
      hb > HEADS_MAX || (H / G) % hb != 0 ||
      (long long)cells * (H / hb) > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  SsdArgs p;
  p.x = static_cast<const float*>(x);
  p.a = static_cast<const float*>(a);
  p.b = static_cast<const float*>(b);
  p.c = static_cast<const float*>(c);
  p.y = static_cast<float*>(y);
  p.st = static_cast<float*>(st);
  p.cum = static_cast<float*>(cum);
  p.L = L;
  p.H = H;
  p.P = P;
  p.G = G;
  p.N = N;
  p.hb = hb;
  p.nb = (N + 15) / 16 * 16;
  p.ldb = p.nb + 8;
  p.vec = P % 4 == 0 && N % 4 == 0 && aligned16(x) && aligned16(b) &&
          aligned16(c) && aligned16(y) && aligned16(st);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (L <= 64) return P <= 32 ? launch<4, 32>(p, cells, s)
                              : launch<4, 64>(p, cells, s);
  return P <= 32 ? launch<8, 32>(p, cells, s) : launch<8, 64>(p, cells, s);
}
