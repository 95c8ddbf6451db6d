// K10: a compute-bound GEMM and a memory-bound reduction in ONE launch,
//   c (M, N) = x (M, K) @ y (K, N)
//   r (C,)   = sum over the R rows of silu(z (R, C)), in f32
//
// Replaces the TPU kernel repro/kernels/fused_branches.py::_fused_kernel
// (launcher fused_gemm_reduce): the ``fused`` plan mode, the paper's
// intra-SM co-location of a compute-bound kernel with a memory-bound one
// (Table 1), where the reduction's bytes ride under the GEMM's
// arithmetic.
//
// Bound on this card: the reference's co-execution shape (2048^3 GEMM
// beside a 65536 x 128 reduction) is operation-bound (17.2 GFLOP against
// 84 MB); the GEMM runs f32 FMA on the CUDA cores, as K4 does.
//
// Design.  The TPU kernel walks a (M/bm, N/bn, K/bk) grid in order on one
// core, carries the GEMM accumulator across the K axis, and hands each
// grid step the next slice of z, whose per-slice column sums its wrapper
// adds.  Here the launch is P CTAs (kernels/fused_branches.py::
// fused_launch):
//   - CTAs 0 .. T - 1 are K4's ``mxu128`` CTAs (gp::matmul_cta: 128 x
//     128 tiles, 8 x 8 micro-tiles, two CTAs an SM, K split over the SMs
//     from the SM count when the tiles do not cover them, the splits
//     summed in split order inside the launch), on the same copy layouts
//     K4's wrapper picks, so c equals K4's c bit for bit;
//   - every CTA, T and up included, owns an equal contiguous share of z's
//     rows, so a tall z beside a one-tile GEMM spreads over the whole
//     card (P = max(T, min(2 * SMs, ceil(R / rows_floor)))).
// z rides the GEMM's cp.async ring: with each k-step's operand copies a
// GEMM CTA issues copies of its next rows of z into a z region of the
// same stage (the same commit group), and once they land each thread
// adds the silu of the elements it copied itself to its own column sums
// (gemm's landed hook: no extra barrier, no z value held in registers
// across a k-step).  A thread always copies the same columns (16-byte
// copies where C % 4 == 0 and z is 16-byte aligned, else 4-byte ones),
// so its sums, kept in shared memory, need no atomics.  A k-step takes a
// multiple of the CTA's row lanes, so every warp carries the same share
// of z and no warp holds the block's barrier up (the rows go in the
// first k-steps).  The rows the k-steps leave (all of them in a CTA with
// no GEMM work) stream through the same ring after the loop.  Each CTA
// then adds its row lanes' sums in lane order into its row of a (P, C)
// f32 workspace, and the last CTA to arrive (an arrival counter) sums
// the P rows in CTA order, in segments of consecutive rows whose sums it
// adds in segment order (last_cta_sum), and writes r: one launch, no
// atomics on values, results repeat bit for bit.  Rows past R are never
// read (the reference pads z with zeros: silu(0) = 0).  C is at most
// 1024.
#include "gemm_pipe.cuh"

namespace {

constexpr int T = 128;                 // c tile (K4's mxu128)
constexpr int TM = 8;
constexpr int NT = gp::Mma<T, T, TM>::NT;   // 256 threads
constexpr int ZS = 2048;               // floats of z a ring stage holds
constexpr int SLOTS = 4;               // z column sums a thread keeps
constexpr int MAXC = SLOTS * NT;       // z columns: 1024
// the GEMM's ring (the same for every copy layout), then z's, then the
// column sums
constexpr int RING = gp::matmul_smem_floats<T, T, TM, gp::KC, gp::XC>();
constexpr int SMEM =
    (RING + gp::STAGES * ZS + SLOTS * NT) * (int)sizeof(float);
// after the GEMM loop the GEMM's ring is free: the rows it left stream
// through stages of both rings together
constexpr int TAIL = (RING + gp::STAGES * ZS) / gp::STAGES;
static_assert(ZS >= MAXC && RING % 4 == 0 && TAIL % 4 == 0,
              "a z stage holds a whole row, 16-byte aligned");

struct FusedArgs {
  gp::MatmulArgs g;    // the GEMM, as K4 takes it
  const float* z;      // (R, C) row-major
  float* r;            // (C,)
  float* zws;          // (P, C): each CTA's column sums
  int* zcounter;       // a zeroed arrival counter
  int tiles_m, tiles;  // m-blocks and tiles of c (tiles * splits GEMM CTAs)
  int rows, cz, share; // R, C, z rows per CTA
};

// this CTA's z geometry, put in shared memory by thread 0 and read again
// after every barrier instead of held in registers through the GEMM
struct ZJob {
  int lo, hi;       // rows [lo, hi) of z
  int per;          // rows per GEMM k-step, a multiple of lanes
  int chunk;        // rows a stage of the tail holds, a multiple of lanes
  int g, gc, lanes; // column groups, groups a row lane spans, row lanes
};

__device__ __forceinline__ float silu(float v) {
  return v / (1.f + expf(-v));
}

// The copies one thread owns.  Columns fall into G groups of ZV (ZV = 4:
// one 16-byte copy, ZV = 1: one 4-byte copy).  With G <= NT, thread t
// takes group t % G of every (NT / G)-th row (its row lane t / G); with
// G > NT (4-byte copies, C > 256) every thread takes groups t, t + NT, ...
// of every row (one lane).  Sum slot q * ZV + e holds column (g0 + q *
// NT) * ZV + e.  Threads past lanes * G (NT not a multiple of G) copy
// nothing.  A k-step's rows are a multiple of the lanes, so every lane
// copies and sums as many as the others.  Computed once a CTA: own =
// lane | g0 << 16 (lane 0xffff: copies nothing).
template <int ZV>
__device__ __forceinline__ void z_owner(int c, ZJob& j, int& own) {
  const int g = ZV == 4 ? c / 4 : c;
  const int gc = min(g, NT);
  const int lanes = NT / gc;
  const int lane = threadIdx.x / gc;
  own = (lane < lanes ? lane : 0xffff) | (threadIdx.x % gc) << 16;
  if (threadIdx.x == 0) {
    j.g = g;
    j.gc = gc;
    j.lanes = lanes;
  }
}

// issue this thread's copies of z rows [row0, row0 + nr) into stage zst
template <int ZV>
__device__ __forceinline__ void z_issue(float* zst, const float* z, int c,
                                        const ZJob& j, int own, int row0,
                                        int nr) {
  const int g0 = own >> 16;
  for (int i = own & 0xffff; i < nr; i += j.lanes) {
    const float* src = z + (size_t)(row0 + i) * c;
    const unsigned dst = gp::smem_u32(zst + i * c);
#pragma unroll
    for (int q = 0; q < SLOTS / ZV; ++q) {
      const int grp = g0 + q * NT;
      if (grp >= j.g) break;
      if constexpr (ZV == 4)
        gp::cp16(dst + 16 * grp, src + 4 * grp, 16);
      else
        gp::cp4(dst + 4 * grp, src + grp, 4);
    }
  }
}

// add silu of this thread's landed copies of nr rows in stage zst to its
// column sums
template <int ZV>
__device__ __forceinline__ void z_add(const float* zst, int c, const ZJob& j,
                                      int own, int nr, float* zsum) {
  const int lane = own & 0xffff, g0 = own >> 16;
  if (lane >= nr) return;
  float4* mine = reinterpret_cast<float4*>(zsum) + threadIdx.x;
  float4 s4 = *mine;
  float s[SLOTS] = {s4.x, s4.y, s4.z, s4.w};
  for (int i = lane; i < nr; i += j.lanes) {
    const float* row = zst + i * c;
    if constexpr (ZV == 4) {
      const float4 v = reinterpret_cast<const float4*>(row)[g0];
      s[0] += silu(v.x);
      s[1] += silu(v.y);
      s[2] += silu(v.z);
      s[3] += silu(v.w);
    } else {
#pragma unroll
      for (int q = 0; q < SLOTS; ++q) {
        const int grp = g0 + q * NT;
        if (grp >= j.g) break;
        s[q] += silu(row[grp]);
      }
    }
  }
  *mine = make_float4(s[0], s[1], s[2], s[3]);
}

// n chunks through the ring, no product: load(stage, i) issues chunk i's
// copies, landed(stage, i) consumes this thread's own once they land
template <class Load, class Landed>
__device__ __forceinline__ void z_stream(int n, Load load, Landed landed) {
#pragma unroll
  for (int s = 0; s < gp::STAGES - 1; ++s) {
    if (s < n) load(s, s);
    gp::commit();
  }
  for (int i = 0; i < n; ++i) {
    const int st = i % gp::STAGES;
    gp::wait_group<gp::STAGES - 2>();
    landed(st, i);
    __syncthreads();
    const int nx = i + gp::STAGES - 1;
    if (nx < n) load(nx % gp::STAGES, nx);
    gp::commit();
  }
  gp::wait_group<0>();
}

// The last CTA: r = the sum of the P workspace rows in CTA order.  Each
// thread takes one column unit (4 columns when ZV == 4, else one) of a
// segment of consecutive rows, summed in CTA order U rows at a time in
// flight; the segments' sums are then added in segment order (part: NT
// float4 of shared memory), so the order is fixed and r repeats bit for
// bit.  With more units than threads (C > 256, 4-byte copies) each thread
// takes units t, t + NT, ... over all P rows.
template <int ZV>
__device__ __forceinline__ void last_cta_sum(const float* zws, float* r,
                                             int c, int ctas, float4* part) {
  constexpr int U = 16;
  const int units = c / ZV;
  const int uc = min(units, NT);
  const int segs = NT / uc;
  const int len = (ctas + segs - 1) / segs;
  const int sg = threadIdx.x / uc;
  auto unit = [&](int q, int u) -> float4 {
    if constexpr (ZV == 4)
      return __ldcg(reinterpret_cast<const float4*>(zws + (size_t)q * c) +
                    u);
    else
      return make_float4(__ldcg(zws + (size_t)q * c + u), 0.f, 0.f, 0.f);
  };
  auto add = [](float4& s, const float4& v) {
    s.x += v.x;
    s.y += v.y;
    s.z += v.z;
    s.w += v.w;
  };
  auto put = [&](int u, const float4& v) {
    if constexpr (ZV == 4)
      reinterpret_cast<float4*>(r)[u] = v;
    else
      r[u] = v.x;
  };
  for (int u = threadIdx.x % uc; u < units; u += NT) {
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    if (sg < segs) {
      const int hi = min(ctas, (sg + 1) * len);
      int q = sg * len;
      for (; q + U <= hi; q += U) {
        float4 v[U];
#pragma unroll
        for (int j = 0; j < U; ++j) v[j] = unit(q + j, u);
#pragma unroll
        for (int j = 0; j < U; ++j) add(s, v[j]);
      }
      for (; q < hi; ++q) add(s, unit(q, u));
    }
    if (segs == 1)
      put(u, s);
    else
      part[threadIdx.x] = s;
  }
  if (segs == 1) return;
  __syncthreads();
  if (threadIdx.x < units) {
    float4 s = part[threadIdx.x];
    for (int q = 1; q < segs; ++q) add(s, part[q * uc + threadIdx.x]);
    put(threadIdx.x, s);
  }
}

// LB: y's copy layout (XC or XC16; x, row-major, copies KC); ZV: z's
// copy width in floats (4: 16-byte copies, 1: 4-byte)
template <int LB, int ZV>
__global__ void __launch_bounds__(NT, 2) fused_kernel(FusedArgs p) {
  extern __shared__ float4 smem_raw[];
  __shared__ ZJob zj;
  __shared__ int zown[NT];
  float* smem = reinterpret_cast<float*>(smem_raw);
  float* zring = smem + RING;
  float* zsum = zring + gp::STAGES * ZS;
  const int b = blockIdx.x;
  const int c = p.cz;
  const int gemm_ctas = p.tiles * p.g.splits;
  const int split = b / p.tiles;
  int nk = 0;
  if (b < gemm_ctas) {
    const int k_lo = split * p.g.kper;
    nk = (min(p.g.k, k_lo + p.g.kper) - k_lo + gp::BK - 1) / gp::BK;
  }
  z_owner<ZV>(c, zj, zown[threadIdx.x]);
  reinterpret_cast<float4*>(zsum)[threadIdx.x] =
      make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();
  if (threadIdx.x == 0) {
    const long long lo = (long long)b * p.share;
    zj.lo = (int)min((long long)p.rows, lo);
    zj.hi = (int)min((long long)p.rows, lo + p.share);
    const int lanes = zj.lanes;
    zj.chunk = TAIL / c / lanes * lanes;
    const int n = zj.hi - zj.lo;
    const int per = nk > 0 ? (n + nk - 1) / nk : 0;
    zj.per = min(ZS / c / lanes * lanes, (per + lanes - 1) / lanes * lanes);
  }
  __syncthreads();

  if (b < gemm_ctas) {
    const int tile = b - split * p.tiles;
    gp::matmul_cta<T, T, TM, gp::KC, LB>(
        p.g, smem, tile % p.tiles_m, tile / p.tiles_m, split, tile,
        [&](int st, int kt) {
          const int row0 = zj.lo + kt * zj.per;
          const int nr = min(zj.per, zj.hi - row0);
          if (nr > 0)
            z_issue<ZV>(zring + st * ZS, p.z, c, zj, zown[threadIdx.x],
                        row0, nr);
        },
        [&](int st, int kt) {
          const int row0 = zj.lo + kt * zj.per;
          const int nr = min(zj.per, zj.hi - row0);
          if (nr > 0)
            z_add<ZV>(zring + st * ZS, c, zj, zown[threadIdx.x], nr, zsum);
        });
  }
  // the rows the k-steps left (all of them in a CTA with no GEMM work),
  // through the whole of shared memory but the sums
  const int from = min(zj.hi, zj.lo + nk * zj.per);
  const int chunk = zj.chunk;
  z_stream(
      (zj.hi - from + chunk - 1) / chunk,
      [&](int st, int i) {
        const int row0 = from + i * chunk;
        z_issue<ZV>(smem + st * TAIL, p.z, c, zj, zown[threadIdx.x], row0,
                    min(chunk, zj.hi - row0));
      },
      [&](int st, int i) {
        const int row0 = from + i * chunk;
        z_add<ZV>(smem + st * TAIL, c, zj, zown[threadIdx.x],
                  min(chunk, zj.hi - row0), zsum);
      });
  __syncthreads();

  // this CTA's column sums: the row lanes' sums of each column in lane
  // order, into its row of the workspace
  for (int col = threadIdx.x; col < c; col += NT) {
    const int grp = col / ZV, e = col % ZV;
    const int slot = (grp / NT) * ZV + e, g0 = grp % NT;
    float v = 0.f;
    for (int l = 0; l < zj.lanes; ++l)
      v += zsum[(l * zj.gc + g0) * SLOTS + slot];
    __stcg(p.zws + (size_t)b * c + col, v);
  }
  if (!gp::Split<T, T, TM>::arrive(p.zcounter, gridDim.x)) return;
  last_cta_sum<ZV>(p.zws, p.r, c, gridDim.x,
                   reinterpret_cast<float4*>(zsum));
}

template <int LB, int ZV>
int launch(const FusedArgs& p, int ctas, cudaStream_t s) {
  auto kern = fused_kernel<LB, ZV>;
  static unsigned opted = 0;
  cudaError_t e = gp::opt_in_smem(kern, SMEM, opted);
  if (e != cudaSuccess) return (int)e;
  kern<<<ctas, NT, SMEM, s>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// x (m, k) and y (k, n) read in place with leading dimensions lda, ldb in
// K4's copy layouts la, lb (gp::Layout; x row-major takes KC); c (m, n)
// row-major; z (rows, cz) row-major, 16-byte copies when z16; r (cz,).
// The GEMM: K cut into splits of kper (splits > 1 needs ws's first
// tiles * splits * 128 * 128 floats and counters[0 .. tiles)), tiles =
// ceil(m / 128) * ceil(n / 128).  z: ctas >= tiles * splits CTAs, each
// taking share rows; ws then holds ctas * cz floats of column sums and
// counters[tiles] is z's arrival counter (zeroed).
extern "C" int rt_fused_gemm_reduce(const void* x, const void* y,
                                    const void* z, void* c, void* r,
                                    void* ws, void* counters, int m, int n,
                                    int k, int lda, int ldb, int la, int lb,
                                    int splits, int kper, int rows, int cz,
                                    int ctas, int share, int z16,
                                    void* stream) {
  if (m <= 0 || n <= 0 || cz < 1 || cz > MAXC || splits < 1 ||
      la != gp::KC || (lb != gp::XC && lb != gp::XC16) ||
      (z16 && cz % 4 != 0))
    return (int)cudaErrorInvalidValue;
  FusedArgs p;
  const int tiles_m = (m + T - 1) / T;
  const int tiles = tiles_m * ((n + T - 1) / T);
  if (ctas < tiles * splits) return (int)cudaErrorInvalidValue;
  float* wsf = static_cast<float*>(ws);
  int* cnt = static_cast<int*>(counters);
  p.g.a = static_cast<const float*>(x);
  p.g.b = static_cast<const float*>(y);
  p.g.c = static_cast<float*>(c);
  p.g.ws = wsf;
  p.g.counters = cnt;
  p.g.m = m;
  p.g.n = n;
  p.g.k = k;
  p.g.lda = lda;
  p.g.ldb = ldb;
  p.g.kper = kper;
  p.g.splits = splits;
  p.z = static_cast<const float*>(z);
  p.r = static_cast<float*>(r);
  p.zws = wsf + (splits > 1 ? (size_t)tiles * splits * T * T : 0);
  p.zcounter = cnt + tiles;
  p.tiles_m = tiles_m;
  p.tiles = tiles;
  p.rows = rows;
  p.cz = cz;
  p.share = share;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (lb == gp::XC16)
    return z16 ? launch<gp::XC16, 4>(p, ctas, s)
               : launch<gp::XC16, 1>(p, ctas, s);
  return z16 ? launch<gp::XC, 4>(p, ctas, s) : launch<gp::XC, 1>(p, ctas, s);
}
