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
// the reference.
//
// Design.  The TPU kernel runs one grid cell per (batch, chunk) over all
// heads at once, with the (L, L, H) decay tensor in VMEM.  Here one CTA
// owns one (cell, head), so a full-width prefill (64 cells x 32 heads)
// launches 2048 CTAs and no state passes between them.  In shared
// memory, in order:
//   1. cum by a warp-shuffle scan of a[:, h];
//   2. (B C^T)[s][t] over d_state in slices of 32 (C and B staged
//      k-major), each thread a 4 x 4 micro-tile of every 64 x 64 tile
//      with s-tile <= t-tile (a tile with s-tile > t-tile is all masked:
//      not computed, not stored, not read); the epilogue multiplies by
//      exp(where(s <= t, cum[t] - cum[s], -1e30)) -- the mask inside the
//      exponent, as the TPU kernel takes it, so no exponent of a positive
//      difference is ever taken -- and keeps the L x L result;
//   3. y_diag = M^T x over s <= t, x[:, h, :] staged in the slices' room;
//   4. the decayed B (B[s] exp(cum[L-1] - cum[s])) in M's room, then
//      state = B_decayed^T x.
// With G = 1 every head of a cell recomputes the same C B^T: 2 L^2 N
// FLOP against the head's 2 L^2 P + 2 L N P, about 3% more work.
//
// Bound on this card: at the full-width prefill (L 128, H 32, P 64,
// N 128) a cell moves ~3.3 MB and needs ~0.1 GFLOP, so the call is
// operation-bound on paper (f32, outside the tensor cores).  This first
// design runs f32 FMA on the CUDA cores from shared memory (two 16-byte
// shared loads per 16 FMA); tensor cores (TF32 would lose the f32
// contract, so 3xTF32 or a split) and TMA staging are later work.
// Shared memory: ~103 KB at the full width, past the 48 KB default, so
// the launcher opts in; two CTAs fit an SM.
#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;     // threads: 16 x 16, each a 4 x 4 micro-tile
constexpr int TILE = 64;    // output tile edge
constexpr int NK = 32;      // d_state slice staged per step of B C^T
constexpr int PAD = 4;      // row padding of shared arrays (16-byte rows)
constexpr float NEG = -1e30f;

struct SsdArgs {
  const float* x;
  const float* a;
  const float* b;
  const float* c;
  float* y;
  float* st;
  float* cum;
  int L, H, P, G, N;        // chunk length, heads, head dim, groups, d_state
  int Pp, Np;               // P and N rounded up to TILE
};

__host__ __device__ inline int round_tile(int v) {
  return (v + TILE - 1) / TILE * TILE;
}

__host__ __device__ inline int imax(int u, int v) { return u > v ? u : v; }

// Floats of dynamic shared memory: the M / decayed-B room, the staged
// C/B slices / x room, cum.
__host__ __device__ inline int region_m(int lp, int np) {
  return imax(lp * (lp + PAD), lp * (np + PAD));
}
__host__ __device__ inline int region_x(int lp, int pp) {
  return imax(lp * (pp + PAD), 2 * NK * (lp + PAD));
}

// acc += A-tile^T B-tile over k in [0, kend): both operands k-major in
// shared memory, A[k * lda + r] (rows r0 + 4 ty ..) and B[k * ldb + c]
// (columns c0 + 4 tx ..), each read as one float4 per k.
__device__ __forceinline__ void tile_fma(float (&acc)[4][4], const float* A,
                                         int lda, int r0, const float* B,
                                         int ldb, int c0, int kend, int ty,
                                         int tx) {
  const float* ap = A + r0 + ty * 4;
  const float* bp = B + c0 + tx * 4;
#pragma unroll 4
  for (int k = 0; k < kend; ++k) {
    const float4 av = *reinterpret_cast<const float4*>(ap + k * lda);
    const float4 bv = *reinterpret_cast<const float4*>(bp + k * ldb);
    const float ar[4] = {av.x, av.y, av.z, av.w};
    const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
  }
}

template <int LT>
__global__ void __launch_bounds__(NT, 2) ssd_chunk_kernel(SsdArgs p) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float wsum[NT / 32];
  constexpr int Lp = LT * TILE;
  const int L = p.L, H = p.H, P = p.P, G = p.G, N = p.N;
  const int Pp = p.Pp, Np = p.Np;
  const int ldl = Lp + PAD, ldp = Pp + PAD, ldn = Np + PAD;
  float* ms = smem;                        // M[s][t], later Bd[s][n]
  float* xs = ms + region_m(Lp, Np);       // B/C slices, later x[s][p]
  float* cs = xs + region_x(Lp, Pp);       // cum[t]

  const size_t cell = blockIdx.x;
  const int h = blockIdx.y;
  const int g = h / (H / G);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;

  // 1. cum: a warp-inclusive scan per 32 steps, then the warp totals
  {
    float v = tid < L ? p.a[(cell * L + tid) * H + h] : 0.f;
    const int lane = tid & 31, warp = tid >> 5;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, v, off);
      if (lane >= off) v += u;
    }
    if (lane == 31) wsum[warp] = v;
    __syncthreads();
    for (int w = 0; w < warp; ++w) v += wsum[w];
    if (tid < Lp) cs[tid] = v;
    if (tid < L) p.cum[(cell * L + tid) * H + h] = v;
  }

  // 2. M[s][t] = (B C^T)[s][t] * exp(masked cum[t] - cum[s]) on the
  // tiles with s-tile <= t-tile, accumulators in that order; phase 3
  // reads no other tile
  constexpr int NTILE = LT * (LT + 1) / 2;
  float acc[NTILE][4][4];
#pragma unroll
  for (int q = 0; q < NTILE; ++q)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[q][i][j] = 0.f;
  float* bst = xs;                         // B[s][n0 + k] at k * ldl + s
  float* cst = xs + NK * ldl;              // C likewise
  const size_t row = (size_t)G * N;        // a row s of b or c
  const float* bcell = p.b + cell * L * row + (size_t)g * N;
  const float* ccell = p.c + cell * L * row + (size_t)g * N;
  for (int n0 = 0; n0 < N; n0 += NK) {
    __syncthreads();
    // a warp stages 4 rows s x 8 consecutive n: 32-byte global segments,
    // 32 distinct shared banks (ldl = 4 mod 32)
    for (int e = tid; e < Lp * NK; e += NT) {
      const int w = e >> 5, l = e & 31;
      const int k = (l & 7) + 8 * (w % (NK / 8));
      const int s = (l >> 3) + 4 * (w / (NK / 8));
      const int n = n0 + k;
      const bool ok = s < L && n < N;
      bst[k * ldl + s] = ok ? bcell[s * row + n] : 0.f;
      cst[k * ldl + s] = ok ? ccell[s * row + n] : 0.f;
    }
    __syncthreads();
    int q = 0;
#pragma unroll
    for (int si = 0; si < LT; ++si)
#pragma unroll
      for (int tj = si; tj < LT; ++tj, ++q)
        tile_fma(acc[q], bst, ldl, si * TILE, cst, ldl, tj * TILE, NK, ty,
                 tx);
  }
  int q = 0;
#pragma unroll
  for (int si = 0; si < LT; ++si)
#pragma unroll
    for (int tj = si; tj < LT; ++tj, ++q)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int s = si * TILE + ty * 4 + i;
        const int t0 = tj * TILE + tx * 4;
        float v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int t = t0 + j;
          v[j] = 0.f;
          if (s < L && t < L) {
            const float d = s <= t ? cs[t] - cs[s] : NEG;
            v[j] = acc[q][i][j] * expf(d);
          }
        }
        *reinterpret_cast<float4*>(ms + s * ldl + t0) =
            make_float4(v[0], v[1], v[2], v[3]);
      }
  __syncthreads();

  // 3. y_diag[t][p] = sum_{s <= t} M[s][t] x[s][p]
  const float* xh = p.x + cell * L * H * P + (size_t)h * P;
  for (int e = tid; e < Lp * Pp; e += NT) {
    const int s = e / Pp, pp = e % Pp;
    xs[s * ldp + pp] = s < L && pp < P ? xh[(size_t)s * H * P + pp] : 0.f;
  }
  __syncthreads();
  float* yh = p.y + cell * L * H * P + (size_t)h * P;
  for (int ti = 0; ti < LT; ++ti)
    for (int pj = 0; pj < Pp / TILE; ++pj) {
      float o[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) o[i][j] = 0.f;
      const int kend = L < (ti + 1) * TILE ? L : (ti + 1) * TILE;
      tile_fma(o, ms, ldl, ti * TILE, xs, ldp, pj * TILE, kend, ty, tx);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = ti * TILE + ty * 4 + i;
        if (t >= L) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int pp = pj * TILE + tx * 4 + j;
          if (pp < P) yh[(size_t)t * H * P + pp] = o[i][j];
        }
      }
    }
  __syncthreads();

  // 4. state[n][p] = sum_s B[s][n] exp(cum[L-1] - cum[s]) x[s][p]
  const float last = cs[L - 1];
  for (int e = tid; e < Lp * Np; e += NT) {
    const int s = e / Np, n = e % Np;
    ms[s * ldn + n] =
        s < L && n < N ? bcell[s * row + n] * expf(last - cs[s]) : 0.f;
  }
  __syncthreads();
  float* sth = p.st + (cell * H + h) * (size_t)N * P;
  for (int ni = 0; ni < Np / TILE; ++ni)
    for (int pj = 0; pj < Pp / TILE; ++pj) {
      float o[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) o[i][j] = 0.f;
      tile_fma(o, ms, ldn, ni * TILE, xs, ldp, pj * TILE, L, ty, tx);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int n = ni * TILE + ty * 4 + i;
        if (n >= N) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int pp = pj * TILE + tx * 4 + j;
          if (pp < P) sth[(size_t)n * P + pp] = o[i][j];
        }
      }
    }
}

template <int LT>
int launch(const SsdArgs& p, int cells, cudaStream_t s) {
  const int lp = LT * TILE;
  const size_t smem = sizeof(float) *
      (size_t)(region_m(lp, p.Np) + region_x(lp, p.Pp) + lp);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      ssd_chunk_kernel<LT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  ssd_chunk_kernel<LT><<<dim3(cells, p.H), NT, smem, s>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// cells = batch * chunks; L <= 128; H % G == 0.
extern "C" int rt_ssd_chunk(const void* x, const void* a, const void* b,
                            const void* c, void* y, void* st, void* cum,
                            int cells, int L, int H, int P, int G, int N,
                            void* stream) {
  if (cells <= 0 || H <= 0 || P <= 0 || N <= 0) return (int)cudaSuccess;
  if (L <= 0 || L > 2 * TILE || G <= 0 || H % G != 0 || H > 65535)
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
  p.Pp = round_tile(P);
  p.Np = round_tile(N);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return L <= TILE ? launch<1>(p, cells, s) : launch<2>(p, cells, s);
}
