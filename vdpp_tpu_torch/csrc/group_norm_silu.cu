// Fused GroupNorm (+ SiLU) for Hopper (sm_90a) over a channels-last
// (N, S, C) tensor: statistics per (n, group) over all S rows and the group's
// C / G channels, in fp32.
//
// Replaces the TPU kernel vdpp_tpu/ops/norm_kernel.py::_gn_silu_kernel
// (pallas_call in group_norm_silu_fused) and computes what it computes:
//   * fp32 statistics from chunks of rows, merged with the parallel (Chan)
//     formula -- never the one-pass E[x^2] - mean^2 shortcut;
//   * the affine folded into one multiply-add, y = x * a + b with
//     a = rsqrt(var + eps) * weight and b = bias - mean * a, weight and bias
//     read in their stored dtype (bf16 or fp32) and widened to fp32 here, as
//     the reference widens them;
//   * SiLU applied to the fp32 y before the one rounding to the output dtype.
//
// What bounds it on an H100: bytes. A few operations per element against
// x read twice and y written once (at the SVD-XT level-0 temporal site,
// 230,400 x 320 bf16: 442 MB, 0.13 ms at 3.35 TB/s; the bound counts x once,
// 0.088 ms). The TPU kernel walks its chunks in order on one core, carrying
// the running statistics in scratch; here the rows are cut into one
// contiguous range per block, N * bx blocks in all, at most two an SM so that
// they run in one wave, and a call is two launches:
//   1. gn_stats: a thread owns up to 8 channels (one 16-byte vector of them,
//      or single elements when C is not a whole number of vectors) in one of
//      `rs` row lanes, and walks the block's range in chunks of rs x 2 rows
//      (bf16; 1 row in fp32). It holds its rows of a chunk in registers, the
//      next chunk's loads issued before this one is used, takes their exact
//      two-pass (mean, M2) per channel and merges them into its running
//      statistics (Chan). The block merges its row lanes per channel (Chan,
//      in order), then its channels per group: all of them count the block's
//      rows, so that is Chan's formula for equal parts, the mean of the
//      channel means and the channels' M2 plus rows x their squared distance
//      to it, each summed by a team of lanes with xor shuffles. It writes one
//      (mean, M2) per group to the scratch.
//   2. gn_apply: each block first merges the bx partials of every group of
//      its batch row (Chan: each lane of a team over blocks in index order,
//      then a shuffle tree in a fixed order), so all blocks of a row get the
//      same (mean, rstd) bits, and repeated calls too; there are no atomics.
//      It keeps gn_stats' blocks and thread mapping, so a thread holds its
//      columns' (a, b) in registers (no shared memory, no channel arithmetic
//      per element), and streams its range once more in chunks, the next
//      one's loads in flight, from the LAST chunk to the first: the end of
//      every range, read last by gn_stats, is what L2 (50 MB) still holds,
//      so it is read first.
//      The merge costs every block of a row the same partials: at N = 1
//      (253 blocks, all reading one 8,096-partial table) it was as slow as
//      the serial merge by the last gn_stats block that it replaced, and
//      faster at N = 25; both measured on an H100, 700 W.
// Any C, G and N. A thread owns at most 8 channels of 512 threads, so the
// channels are cut into tiles of at most 4096: C itself up to there (the
// models' widths, one tile, as above); else the most whole groups that fit a
// tile, or, for a group wider than 4096, the largest divisor of the group
// that fits. A block then owns (n, tile, rows) and writes one partial per
// "segment" of its tile (a whole group, or the group's share of the tile);
// gn_apply merges a group's partials over blocks and then over its segments,
// in that fixed order, and holds only its tile's groups' statistics (dynamic
// shared memory, so G has no cap). The grid is one axis, (n, tile, row
// range) with the row ranges fastest, N * tiles * blocks a unit filling one
// wave; N is not held to grid y's 65,535.
// Registers: gn_stats is capped at 64 a thread (two blocks of up to 512
// threads an SM); ptxas' counts are printed by chip_smoke.py (PERF.md).
//
// C interface (bound with ctypes, see vdpp_tpu_torch/ops/norm_kernel.py):
// returns the first CUDA error of the two launches, launches on the given
// stream, allocates nothing (the caller passes the fp32 scratch) and does not
// synchronise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int MAX_THREADS = 512;
constexpr int BLOCKS_PER_SM = 2;
constexpr int CH = 8;            // channels a thread owns, at most
constexpr int MERGE_UNROLL = 8;  // partials a merging thread loads at once
constexpr int MAX_CT = CH * MAX_THREADS;  // channels of a tile: 4096

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// How a call is cut; the same for both launches. The channels are cut into
// ntiles tiles of ct (C itself up to 4096), and a tile's statistics into
// segments of sw channels: whole groups (sw = C / G) when a group fits a
// tile, else a group's share of one tile (sw = ct). A block owns (n, tile,
// a range of rows) and writes one partial (mean, M2) per segment of its tile.
struct Plan {
  int ct;        // channels of a tile
  int ntiles;    // C / ct
  int sw;        // channels of a segment
  int segs;      // segments of a tile: ct / sw
  int vec;       // elements of a column: a 16-byte vector, or 1
  int cols;      // ct / vec
  int cw;        // column threads; thread column j owns columns j, j + cw, ...
  int cpt;       // columns a thread: ceil(cols / cw) <= CH / vec
  int rs;        // row lanes
  int threads;   // rs * cw, rounded up to whole warps
  int rows_blk;  // rows a block (a multiple of rs * RPT, but the last block's)
  int bx;        // blocks per (n, tile)
};

// Channels of a tile: C up to MAX_CT; else the most whole groups that divide
// G and fit, or, for a group wider than MAX_CT, the largest divisor of the
// group that fits (a tile then holds part of one group).
int tile_channels(int C, int G) {
  if (C <= MAX_CT) return C;
  const int gsize = C / G;
  if (gsize <= MAX_CT) {
    int k = MAX_CT / gsize;
    while (G % k != 0) --k;
    return k * gsize;
  }
  int ct = MAX_CT;
  while (gsize % ct != 0) --ct;
  return ct;
}

// Rows a thread holds per chunk: 32 bytes of each of its columns (2 rows of
// a bf16 vector). 64 bytes measured slower in both kernels on an H100
// (register pressure: gn_stats spilled under its 64-register cap).
template <typename T>
__host__ __device__ constexpr int chunk_rows() {
  return 4 / (int)sizeof(T);
}

int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) {
    return 0;
  }
  return sms;
}

// bx for `units` (n, tile) pairs: units * bx blocks fill the SMs in one wave.
int blocks_per_unit(long long units, int S, int sms) {
  const long long bx = BLOCKS_PER_SM * (long long)sms / units;
  return bx < 1 ? 1 : bx < S ? (int)bx : S;
}

Plan make_plan(int N, int S, int C, int G, int elem, bool vectors, int sms) {
  Plan p;
  p.ct = tile_channels(C, G);
  p.ntiles = C / p.ct;
  p.sw = C / G < p.ct ? C / G : p.ct;
  p.segs = p.ct / p.sw;
  p.vec = vectors && p.ct % (16 / elem) == 0 ? 16 / elem : 1;
  p.cols = p.ct / p.vec;
  p.cpt = (p.cols + MAX_THREADS - 1) / MAX_THREADS;
  p.cw = (p.cols + p.cpt - 1) / p.cpt;
  p.rs = MAX_THREADS / p.cw > 1 ? MAX_THREADS / p.cw : 1;
  p.threads = (p.rs * p.cw + 31) / 32 * 32;
  const int chunk = p.rs * (4 / elem);  // rows of a chunk: rs x chunk_rows
  const int bx = blocks_per_unit((long long)N * p.ntiles, S, sms);
  const int rows = (S + bx - 1) / bx;
  p.rows_blk = (rows + chunk - 1) / chunk * chunk;
  p.bx = (S + p.rows_blk - 1) / p.rows_blk;
  return p;
}

// (na, ma, qa) <- (na, ma, qa) merged with (nb, mb, qb): Chan's parallel
// formula for (count, mean, M2).
__device__ __forceinline__ void chan_merge(float& na, float& ma, float& qa, float nb, float mb,
                                           float qb) {
  if (nb == 0.f) return;
  if (na == 0.f) {
    na = nb;
    ma = mb;
    qa = qb;
    return;
  }
  const float tot = na + nb;
  const float delta = mb - ma;
  ma = ma + delta * (nb / tot);
  qa = qa + qb + delta * delta * (na * nb / tot);
  na = tot;
}

// Raw 16-byte (or single-element) loads of a thread's RPT rows of a chunk, so
// that they are in flight while the previous chunk is used.
template <typename T, int VEC, int ROWS>
struct Chunk {
  static constexpr int RPT = ROWS;
  static constexpr int CPT = CH / VEC;
  using Raw = typename std::conditional<VEC * sizeof(T) == 16, uint4, T>::type;
  Raw v[RPT][CPT];
};

// Rows row0, row0 + rs, ... (below r_end) of the thread's columns.
template <typename T, int VEC, int ROWS>
__device__ __forceinline__ void load_chunk(Chunk<T, VEC, ROWS>& c, const T* xn, int row0,
                                           int r_end, const Plan& p, int col0, int C) {
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int row = row0 + r * p.rs;
#pragma unroll
    for (int q = 0; q < Chunk<T, VEC, ROWS>::CPT; ++q) {
      const int col = col0 + q * p.cw;
      if (row < r_end && q < p.cpt && col < p.cols) {
        c.v[r][q] = *reinterpret_cast<const typename Chunk<T, VEC, ROWS>::Raw*>(
            xn + (long)row * C + col * VEC);
      }
    }
  }
}

template <typename T, int VEC, int ROWS>
__device__ __forceinline__ float elem(const Chunk<T, VEC, ROWS>& c, int r, int q, int i) {
  if constexpr (VEC * sizeof(T) == 16) {
    return to_f(reinterpret_cast<const T*>(&c.v[r][q])[i]);
  } else {
    return to_f(c.v[r][q]);
  }
}

// The block's (n, tile, row range): the grid is one axis, the row ranges of
// one (n, tile) after each other, then the next tile, then the next n (so N
// is not held to grid y's 65,535).
struct Unit {
  int n, tile, blk;
};
__device__ __forceinline__ Unit unit_of(const Plan& p) {
  const int t = blockIdx.x / p.bx;
  const int n = t / p.ntiles;
  return {n, t - n * p.ntiles, (int)blockIdx.x - t * p.bx};
}

// Statistics: per block a (mean, M2) per segment of its tile, over its rows.
// Shared memory: rs x ct means, rs x ct M2s and rs counts.
template <typename T, int VEC>
__global__ void __launch_bounds__(MAX_THREADS, BLOCKS_PER_SM)
gn_stats(const T* __restrict__ x, float* __restrict__ part, int S, int C, Plan p) {
  using Ck = Chunk<T, VEC, chunk_rows<T>()>;
  constexpr int RPT = Ck::RPT;
  constexpr int CPT = Ck::CPT;
  const int CT = p.ct;
  extern __shared__ float red[];
  float* rmean = red;
  float* rm2 = red + p.rs * CT;
  float* rcnt = red + 2 * p.rs * CT;

  const int tid = threadIdx.x;
  const Unit u = unit_of(p);
  const int blk = u.blk;
  const int rl = tid / p.cw;
  const int col0 = tid - rl * p.cw;
  const int r_begin = blk * p.rows_blk;
  const int r_end = min(S, r_begin + p.rows_blk);
  const T* xn = x + (long)u.n * S * C + (long)u.tile * CT;

  if (rl < p.rs) {
    float cnt = 0.f;
    float mean[CPT][VEC], m2[CPT][VEC];
#pragma unroll
    for (int q = 0; q < CPT; ++q) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) mean[q][i] = m2[q][i] = 0.f;
    }
    const int step = p.rs * RPT;
    Ck cur, nxt;
    load_chunk(cur, xn, r_begin + rl, r_end, p, col0, C);
    for (int r0 = r_begin; r0 < r_end; r0 += step) {
      if (r0 + step < r_end) {
        load_chunk(nxt, xn, r0 + step + rl, r_end, p, col0, C);
      }
      // Rows of this chunk the thread holds: rl, rl + rs, ... below r_end.
      const int left = r_end - (r0 + rl);
      const int nr = left <= 0 ? 0 : min(RPT, (left + p.rs - 1) / p.rs);
      if (nr > 0) {
        const float fn = (float)nr;
        const float inv = 1.f / fn;
        const float tot = cnt + fn;
        const float f_new = fn / tot;
        const float w = cnt * fn / tot;
#pragma unroll
        for (int q = 0; q < CPT; ++q) {
#pragma unroll
          for (int i = 0; i < VEC; ++i) {
            float s = 0.f;
#pragma unroll
            for (int r = 0; r < RPT; ++r) {
              if (r < nr) s += elem(cur, r, q, i);
            }
            const float mu = s * inv;
            float d2 = 0.f;
#pragma unroll
            for (int r = 0; r < RPT; ++r) {
              if (r < nr) {
                const float d = elem(cur, r, q, i) - mu;
                d2 = fmaf(d, d, d2);
              }
            }
            const float delta = mu - mean[q][i];  // Chan: the chunk into the running stats
            mean[q][i] += delta * f_new;
            m2[q][i] += d2 + delta * delta * w;
          }
        }
        cnt = tot;
      }
      cur = nxt;
    }
#pragma unroll
    for (int q = 0; q < CPT; ++q) {
      const int col = col0 + q * p.cw;
      if (q < p.cpt && col < p.cols) {
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          rmean[rl * CT + col * VEC + i] = mean[q][i];
          rm2[rl * CT + col * VEC + i] = m2[q][i];
        }
      }
    }
    if (col0 == 0) rcnt[rl] = cnt;
  }
  __syncthreads();

  // Row lanes per channel, in index order.
  for (int c = tid; c < CT; c += blockDim.x) {
    float na = 0.f, ma = 0.f, qa = 0.f;
    for (int r = 0; r < p.rs; ++r) {
      chan_merge(na, ma, qa, rcnt[r], rmean[r * CT + c], rm2[r * CT + c]);
    }
    rmean[c] = ma;
    rm2[c] = qa;
  }
  __syncthreads();
  // Every channel of the block has the same count (its rows), so a segment's
  // (mean, M2) is Chan's formula for equal parts: the mean of the channel
  // means, and the channels' M2 plus rows x their squared distances to it.
  // A team of lanes sums each, with xor shuffles that give every lane the
  // same bits.
  const int G = p.segs;
  const int gsize = p.sw;
  const float rows = (float)(r_end - r_begin);
  int gteam = 1;
  while (gteam < 32 && gteam * 2 * G <= (int)blockDim.x) gteam *= 2;
  const int gteams = blockDim.x / gteam;
  for (int g0 = 0; g0 < G; g0 += gteams) {
    const int g = g0 + tid / gteam;
    const int tl = tid % gteam;
    const bool ok = g < G;
    float sm = 0.f;
    for (int j = tl; ok && j < gsize; j += gteam) sm += rmean[g * gsize + j];
    for (int off = 1; off < gteam; off <<= 1) {
      sm += __shfl_xor_sync(0xffffffffu, sm, off, gteam);
    }
    const float mean = sm / (float)gsize;
    float sq = 0.f;
    for (int j = tl; ok && j < gsize; j += gteam) {
      const float d = rmean[g * gsize + j] - mean;
      sq += rm2[g * gsize + j] + rows * d * d;
    }
    for (int off = 1; off < gteam; off <<= 1) {
      sq += __shfl_xor_sync(0xffffffffu, sq, off, gteam);
    }
    if (ok && tl == 0) {
      const long nseg = (long)p.ntiles * p.segs;
      float* out = part + (((long)u.n * p.bx + blk) * nseg + (long)u.tile * p.segs + g) * 2;
      out[0] = mean;
      out[1] = sq;
    }
  }
}

// x * a + b in fp32, then SiLU on that fp32 value: y * sigmoid(y).
template <bool SILU>
__device__ __forceinline__ float norm_act(float x, float a, float b) {
  const float v = fmaf(x, a, b);
  return SILU ? v / (1.f + expf(-v)) : v;
}

// y = x * a + b (+ SiLU) over the block's rows of batch n, chunk by chunk
// from the last. A thread owns the same columns as in gn_stats and keeps their
// (a, b) in registers.
template <typename T, int VEC, typename WT, bool SILU>
__global__ void __launch_bounds__(MAX_THREADS, BLOCKS_PER_SM)
gn_apply(const T* __restrict__ x, T* __restrict__ y, const float* __restrict__ part,
         const WT* __restrict__ weight, const WT* __restrict__ bias, int S, int C, int G,
         Plan p, float eps) {
  using Ck = Chunk<T, VEC, chunk_rows<T>()>;
  constexpr int RPT = Ck::RPT;
  constexpr int CPT = Ck::CPT;
  extern __shared__ float g_stat[];  // the tile's groups' means, then their rstds
  const int tid = threadIdx.x;
  const Unit un = unit_of(p);
  const int n = un.n;
  const int gsize = C / G;
  // The tile's groups: gt of them from group g_first; each has spg segments,
  // its partials (b, segment) in the order b-major.
  const int gt = gsize <= p.ct ? p.segs : 1;
  const int g_first = (int)((long)un.tile * p.ct / gsize);
  const int spg = gsize / p.sw;
  const int np = p.bx * spg;
  const long nseg = (long)p.ntiles * p.segs;
  float* g_mean = g_stat;
  float* g_rstd = g_stat + gt;

  // Merge the partials of each group of the tile in batch row n (Chan: each
  // lane of a team over the partials in index order, then a shuffle tree in a
  // fixed order). Every block of (n, tile) does the same merge and gets the
  // same bits.
  int team = 1;
  while (team < 32 && team * 2 * gt <= (int)blockDim.x) team *= 2;
  const int teams = blockDim.x / team;
  const int tl = tid % team;
  for (int g0 = 0; g0 < gt; g0 += teams) {
    const int g = g0 + tid / team;
    const long seg0 = (long)(g_first + g) * spg;
    float na = 0.f, ma = 0.f, qa = 0.f;
    for (int i0 = tl; g < gt && i0 < np; i0 += MERGE_UNROLL * team) {  // loads in flight together
      float nb[MERGE_UNROLL], mb[MERGE_UNROLL], qb[MERGE_UNROLL];
#pragma unroll
      for (int u = 0; u < MERGE_UNROLL; ++u) {
        const int i = i0 + u * team;
        nb[u] = 0.f;
        if (i < np) {
          const int b = i / spg;
          const float* in = part + (((long)n * p.bx + b) * nseg + seg0 + (i - b * spg)) * 2;
          nb[u] = (float)(min(S, (b + 1) * p.rows_blk) - b * p.rows_blk) * (float)p.sw;
          mb[u] = in[0];
          qb[u] = in[1];
        }
      }
#pragma unroll
      for (int u = 0; u < MERGE_UNROLL; ++u) chan_merge(na, ma, qa, nb[u], mb[u], qb[u]);
    }
    for (int off = team / 2; off > 0; off >>= 1) {
      const float nb = __shfl_down_sync(0xffffffffu, na, off, team);
      const float mb = __shfl_down_sync(0xffffffffu, ma, off, team);
      const float qb = __shfl_down_sync(0xffffffffu, qa, off, team);
      if (tl < off) chan_merge(na, ma, qa, nb, mb, qb);
    }
    if (g < gt && tl == 0) {
      g_mean[g] = ma;
      g_rstd[g] = 1.f / sqrtf(qa / na + eps);
    }
  }
  __syncthreads();

  const int rl = tid / p.cw;
  const int col0 = tid - rl * p.cw;
  if (rl >= p.rs) return;
  float a[CPT][VEC], b[CPT][VEC];
#pragma unroll
  for (int q = 0; q < CPT; ++q) {
    const int col = col0 + q * p.cw;
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      a[q][i] = b[q][i] = 0.f;
      if (q < p.cpt && col < p.cols) {
        const int c = un.tile * p.ct + col * VEC + i;
        const int g = c / gsize - g_first;
        a[q][i] = g_rstd[g] * to_f(weight[c]);
        b[q][i] = to_f(bias[c]) - g_mean[g] * a[q][i];
      }
    }
  }
  const int r_begin = un.blk * p.rows_blk;
  const int r_end = min(S, r_begin + p.rows_blk);
  const int step = p.rs * RPT;
  const long base = (long)n * S * C + (long)un.tile * p.ct;
  const T* xn = x + base;
  T* yn = y + base;
  int r0 = r_begin + (r_end - 1 - r_begin) / step * step;  // the last chunk
  Ck cur, nxt;
  load_chunk(cur, xn, r0 + rl, r_end, p, col0, C);
  for (; r0 >= r_begin; r0 -= step) {
    if (r0 > r_begin) load_chunk(nxt, xn, r0 - step + rl, r_end, p, col0, C);
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int row = r0 + rl + r * p.rs;
#pragma unroll
      for (int q = 0; q < CPT; ++q) {
        const int col = col0 + q * p.cw;
        if (row >= r_end || q >= p.cpt || col >= p.cols) continue;
        T* out = yn + (long)row * C + col * VEC;
        if constexpr (VEC * sizeof(T) == 16) {
          uint4 res;
          T* e = reinterpret_cast<T*>(&res);
#pragma unroll
          for (int i = 0; i < VEC; ++i) {
            e[i] = from_f<T>(norm_act<SILU>(elem(cur, r, q, i), a[q][i], b[q][i]));
          }
          *reinterpret_cast<uint4*>(out) = res;
        } else {
          *out = from_f<T>(norm_act<SILU>(elem(cur, r, q, 0), a[q][0], b[q][0]));
        }
      }
    }
    cur = nxt;
  }
}

// The tile's groups' (mean, rstd) in gn_apply's dynamic shared memory: at
// most 2 x 4096 floats (segs <= ct <= MAX_CT), 32 KB, under the 48 KB a
// launch may take without cudaFuncSetAttribute, so none is made.
int apply_smem(int C, int G, const Plan& p) {
  return 2 * (C / G <= p.ct ? p.segs : 1) * (int)sizeof(float);
}

template <typename T, int VEC, typename WT>
int launch_apply(const T* x, T* y, const float* part, const void* w, const void* b,
                 unsigned grid, int S, int C, int G, const Plan& p, float eps, int silu,
                 cudaStream_t st) {
  const WT* wt = static_cast<const WT*>(w);
  const WT* bt = static_cast<const WT*>(b);
  const int smem = apply_smem(C, G, p);
  const auto kernel = silu ? gn_apply<T, VEC, WT, true> : gn_apply<T, VEC, WT, false>;
  kernel<<<grid, p.threads, smem, st>>>(x, y, part, wt, bt, S, C, G, p, eps);
  return (int)cudaGetLastError();
}

template <typename T, int VEC>
int run(const T* x, T* y, const void* w, const void* b, int w_is_bf16, float* part, int N, int S,
        int C, int G, const Plan& p, float eps, int silu, cudaStream_t st) {
  const long long blocks = (long long)N * p.ntiles * p.bx;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const unsigned grid = (unsigned)blocks;
  const int smem = (2 * p.rs * p.ct + p.rs) * (int)sizeof(float);
  cudaError_t err =
      cudaFuncSetAttribute(gn_stats<T, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  gn_stats<T, VEC><<<grid, p.threads, smem, st>>>(x, part, S, C, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return w_is_bf16
             ? launch_apply<T, VEC, __nv_bfloat16>(x, y, part, w, b, grid, S, C, G, p, eps, silu,
                                                   st)
             : launch_apply<T, VEC, float>(x, y, part, w, b, grid, S, C, G, p, eps, silu, st);
}

template <typename T>
int dispatch(const void* x, void* y, const void* w, const void* b, int w_is_bf16, float* part,
             int N, int S, int C, int G, float eps, int silu, int sms, cudaStream_t st) {
  constexpr int V = 16 / sizeof(T);
  const bool aligned =
      (reinterpret_cast<uintptr_t>(x) & 15) == 0 && (reinterpret_cast<uintptr_t>(y) & 15) == 0;
  const Plan p = make_plan(N, S, C, G, (int)sizeof(T), aligned, sms);
  if ((long)p.rows_blk * C > 0x7fffffffL) return (int)cudaErrorInvalidValue;
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  return p.vec == V ? run<T, V>(xt, yt, w, b, w_is_bf16, part, N, S, C, G, p, eps, silu, st)
                    : run<T, 1>(xt, yt, w, b, w_is_bf16, part, N, S, C, G, p, eps, silu, st);
}

}  // namespace

// fp32 scratch the caller passes for this shape on the current device: a
// (mean, M2) per (n, block, segment), for any plan of the shape.
extern "C" long vdpp_gn_scratch_floats(int N, int S, int C, int G) {
  const int sms = sm_count();
  if (N <= 0 || S <= 0 || C <= 0 || G <= 0 || C % G != 0 || sms <= 0) return 0;
  const int ct = tile_channels(C, G);
  const int sw = C / G < ct ? C / G : ct;
  return (long)N * (C / sw) * 2 * blocks_per_unit((long long)N * (C / ct), S, sms);
}

// x, y: (N, S, C) contiguous, both bf16 (is_bf16 = 1) or both fp32; weight,
// bias: (C,), both bf16 (w_is_bf16 = 1) or both fp32; scratch:
// vdpp_gn_scratch_floats(N, S, C, G) fp32. Any C % G == 0.
extern "C" int vdpp_group_norm_silu_fwd(const void* x, void* y, const void* weight,
                                        const void* bias, int w_is_bf16, float* scratch,
                                        int is_bf16, int N, int S, int C, int G, float eps,
                                        int silu, void* stream) {
  if (N <= 0 || S <= 0 || C <= 0 || G <= 0 || C % G != 0) return (int)cudaErrorInvalidValue;
  const int sms = sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  return is_bf16 ? dispatch<__nv_bfloat16>(x, y, weight, bias, w_is_bf16, scratch, N, S, C, G,
                                           eps, silu, sms, st)
                 : dispatch<float>(x, y, weight, bias, w_is_bf16, scratch, N, S, C, G, eps,
                                   silu, sms, st);
}
