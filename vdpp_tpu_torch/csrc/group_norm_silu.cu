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
constexpr int MAX_C = 4096;
constexpr int MAX_G = 256;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// How a call is cut; the same for both launches.
struct Plan {
  int vec;       // elements of a column: a 16-byte vector, or 1
  int cols;      // C / vec
  int cw;        // column threads; thread column j owns columns j, j + cw, ...
  int cpt;       // columns a thread: ceil(cols / cw) <= CH / vec
  int rs;        // row lanes
  int threads;   // rs * cw, rounded up to whole warps
  int rows_blk;  // rows a block (a multiple of rs * RPT, but the last block's)
  int bx;        // blocks per n
};

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

// Upper bound of bx for any plan of this shape: N * bx blocks fill the SMs
// in one wave.
int max_blocks_per_n(int N, int S, int sms) {
  const int bx = BLOCKS_PER_SM * sms / N;
  return bx < 1 ? 1 : bx < S ? bx : S;
}

Plan make_plan(int N, int S, int C, int elem, bool vectors, int sms) {
  Plan p;
  p.vec = vectors && C % (16 / elem) == 0 ? 16 / elem : 1;
  p.cols = C / p.vec;
  p.cpt = (p.cols + MAX_THREADS - 1) / MAX_THREADS;
  p.cw = (p.cols + p.cpt - 1) / p.cpt;
  p.rs = MAX_THREADS / p.cw > 1 ? MAX_THREADS / p.cw : 1;
  p.threads = (p.rs * p.cw + 31) / 32 * 32;
  const int chunk = p.rs * (4 / elem);  // rows of a chunk: rs x chunk_rows
  const int bx = max_blocks_per_n(N, S, sms);
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

// Statistics: per block a (mean, M2) per group of its rows. Shared memory:
// rs x C means, rs x C M2s and rs counts.
template <typename T, int VEC>
__global__ void __launch_bounds__(MAX_THREADS, BLOCKS_PER_SM)
gn_stats(const T* __restrict__ x, float* __restrict__ part, int S, int C, int G, Plan p) {
  using Ck = Chunk<T, VEC, chunk_rows<T>()>;
  constexpr int RPT = Ck::RPT;
  constexpr int CPT = Ck::CPT;
  extern __shared__ float red[];
  float* rmean = red;
  float* rm2 = red + p.rs * C;
  float* rcnt = red + 2 * p.rs * C;

  const int tid = threadIdx.x;
  const int n = blockIdx.y;
  const int blk = blockIdx.x;
  const int rl = tid / p.cw;
  const int col0 = tid - rl * p.cw;
  const int r_begin = blk * p.rows_blk;
  const int r_end = min(S, r_begin + p.rows_blk);
  const T* xn = x + (long)n * S * C;

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
          rmean[rl * C + col * VEC + i] = mean[q][i];
          rm2[rl * C + col * VEC + i] = m2[q][i];
        }
      }
    }
    if (col0 == 0) rcnt[rl] = cnt;
  }
  __syncthreads();

  // Row lanes per channel, in index order.
  for (int c = tid; c < C; c += blockDim.x) {
    float na = 0.f, ma = 0.f, qa = 0.f;
    for (int r = 0; r < p.rs; ++r) {
      chan_merge(na, ma, qa, rcnt[r], rmean[r * C + c], rm2[r * C + c]);
    }
    rmean[c] = ma;
    rm2[c] = qa;
  }
  __syncthreads();
  // Every channel of the block has the same count (its rows), so a group's
  // (mean, M2) is Chan's formula for equal parts: the mean of the channel
  // means, and the channels' M2 plus rows x their squared distances to it.
  // A team of lanes sums each, with xor shuffles that give every lane the
  // same bits.
  const int gsize = C / G;
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
      float* out = part + (((long)n * p.bx + blk) * G + g) * 2;
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
  __shared__ float g_mean[MAX_G];
  __shared__ float g_rstd[MAX_G];
  const int tid = threadIdx.x;
  const int n = blockIdx.y;
  const int gsize = C / G;

  // Merge the bx partials of each group of batch row n (Chan: each lane of a
  // team over blocks in index order, then a shuffle tree in a fixed order).
  // Every block of row n does the same merge and gets the same bits.
  int team = 1;
  while (team < 32 && team * 2 * G <= (int)blockDim.x) team *= 2;
  const int teams = blockDim.x / team;
  const int tl = tid % team;
  for (int g0 = 0; g0 < G; g0 += teams) {
    const int g = g0 + tid / team;
    float na = 0.f, ma = 0.f, qa = 0.f;
    for (int b0 = tl; g < G && b0 < p.bx; b0 += MERGE_UNROLL * team) {  // loads in flight together
      float nb[MERGE_UNROLL], mb[MERGE_UNROLL], qb[MERGE_UNROLL];
#pragma unroll
      for (int u = 0; u < MERGE_UNROLL; ++u) {
        const int b = b0 + u * team;
        nb[u] = 0.f;
        if (b < p.bx) {
          const float* in = part + (((long)n * p.bx + b) * G + g) * 2;
          nb[u] = (float)(min(S, (b + 1) * p.rows_blk) - b * p.rows_blk) * (float)gsize;
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
    if (g < G && tl == 0) {
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
        const int c = col * VEC + i;
        a[q][i] = g_rstd[c / gsize] * to_f(weight[c]);
        b[q][i] = to_f(bias[c]) - g_mean[c / gsize] * a[q][i];
      }
    }
  }
  const int r_begin = blockIdx.x * p.rows_blk;
  const int r_end = min(S, r_begin + p.rows_blk);
  const int step = p.rs * RPT;
  const long base = (long)n * S * C;
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

template <typename T, int VEC, typename WT>
int launch_apply(const T* x, T* y, const float* part, const void* w, const void* b, int N, int S,
                 int C, int G, const Plan& p, float eps, int silu, cudaStream_t st) {
  const dim3 grid(p.bx, N);
  const WT* wt = static_cast<const WT*>(w);
  const WT* bt = static_cast<const WT*>(b);
  if (silu) {
    gn_apply<T, VEC, WT, true><<<grid, p.threads, 0, st>>>(x, y, part, wt, bt, S, C, G, p, eps);
  } else {
    gn_apply<T, VEC, WT, false><<<grid, p.threads, 0, st>>>(x, y, part, wt, bt, S, C, G, p, eps);
  }
  return (int)cudaGetLastError();
}

template <typename T, int VEC>
int run(const T* x, T* y, const void* w, const void* b, int w_is_bf16, float* part, int N, int S,
        int C, int G, const Plan& p, float eps, int silu, cudaStream_t st) {
  const int smem = (2 * p.rs * C + p.rs) * (int)sizeof(float);
  cudaError_t err =
      cudaFuncSetAttribute(gn_stats<T, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  gn_stats<T, VEC><<<dim3(p.bx, N), p.threads, smem, st>>>(x, part, S, C, G, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return w_is_bf16
             ? launch_apply<T, VEC, __nv_bfloat16>(x, y, part, w, b, N, S, C, G, p, eps, silu, st)
             : launch_apply<T, VEC, float>(x, y, part, w, b, N, S, C, G, p, eps, silu, st);
}

template <typename T>
int dispatch(const void* x, void* y, const void* w, const void* b, int w_is_bf16, float* part,
             int N, int S, int C, int G, float eps, int silu, int sms, cudaStream_t st) {
  constexpr int V = 16 / sizeof(T);
  const bool aligned =
      (reinterpret_cast<uintptr_t>(x) & 15) == 0 && (reinterpret_cast<uintptr_t>(y) & 15) == 0;
  const Plan p = make_plan(N, S, C, (int)sizeof(T), aligned, sms);
  if ((long)p.rows_blk * C > 0x7fffffffL) return (int)cudaErrorInvalidValue;
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  return p.vec == V ? run<T, V>(xt, yt, w, b, w_is_bf16, part, N, S, C, G, p, eps, silu, st)
                    : run<T, 1>(xt, yt, w, b, w_is_bf16, part, N, S, C, G, p, eps, silu, st);
}

}  // namespace

// fp32 scratch the caller passes for this shape on the current device: a
// (mean, M2) per (n, block, group).
extern "C" long vdpp_gn_scratch_floats(int N, int S, int C, int G) {
  const int sms = sm_count();
  if (N <= 0 || S <= 0 || C <= 0 || G <= 0 || sms <= 0) return 0;
  return (long)N * G * 2 * max_blocks_per_n(N, S, sms);
}

// x, y: (N, S, C) contiguous, both bf16 (is_bf16 = 1) or both fp32; weight,
// bias: (C,), both bf16 (w_is_bf16 = 1) or both fp32; scratch:
// vdpp_gn_scratch_floats(N, S, C, G) fp32. C % G == 0, C <= 4096, G <= 256.
extern "C" int vdpp_group_norm_silu_fwd(const void* x, void* y, const void* weight,
                                        const void* bias, int w_is_bf16, float* scratch,
                                        int is_bf16, int N, int S, int C, int G, float eps,
                                        int silu, void* stream) {
  if (N <= 0 || S <= 0 || C <= 0 || G <= 0 || C % G != 0 || C > MAX_C || G > MAX_G ||
      N > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const int sms = sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  return is_bf16 ? dispatch<__nv_bfloat16>(x, y, weight, bias, w_is_bf16, scratch, N, S, C, G,
                                           eps, silu, sms, st)
                 : dispatch<float>(x, y, weight, bias, w_is_bf16, scratch, N, S, C, G, eps,
                                   silu, sms, st);
}
