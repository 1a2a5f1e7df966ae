// Fused GroupNorm (+ SiLU) for Hopper (sm_90a) over a channels-last
// (N, S, C) tensor: statistics per (n, group) over all S rows and the group's
// C / G channels, in fp32.
//
// Replaces the TPU kernel vdpp_tpu/ops/norm_kernel.py::_gn_silu_kernel
// (pallas_call in group_norm_silu_fused) and computes what it computes:
//   * fp32 statistics from chunks of rows, merged with the parallel (Chan)
//     formula -- never the one-pass E[x^2] - mean^2 shortcut;
//   * the affine folded into one multiply-add, y = x * a + b with
//     a = rsqrt(var + eps) * weight and b = bias - mean * a;
//   * SiLU applied to the fp32 y before the one rounding to the output dtype.
//
// What bounds it on an H100: a few operations per element against 2 reads
// and 1 write of x (at the SVD-XT level-0 temporal site, 230,400 x 320 bf16:
// 442 MB at 3.35 TB/s, 0.13 ms), so bytes. The TPU kernel walks its chunks in
// order on one core, carrying the running statistics in scratch; here the
// temporal sites have N = 1 and only 32 (n, group) pairs, so the rows are
// split over many blocks instead. Three launches:
//   1. gn_partials: each block stages a chunk of rows (<= 24 KB) in shared
//      memory, takes per-group (mean, M2) of the chunk in two exact passes
//      over it, and writes them out;
//   2. gn_merge: one block per (n, group) merges the chunk partials with
//      Chan's formula and writes (mean, rstd);
//   3. gn_apply: folds the statistics and the affine into per-channel (a, b)
//      in shared memory and streams x once more, 16 bytes per thread.
// x is read twice from device memory (passes 1 and 3) and y written once.
//
// C interface (bound with ctypes, see vdpp_tpu_torch/ops/norm_kernel.py):
// returns the first CUDA error of the three launches, launches on the given
// stream, allocates nothing (the caller passes the fp32 scratch) and does not
// synchronise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int TILE_BYTES = 24 * 1024;  // a stats block's staged rows
constexpr int MAX_C = 4096;
constexpr int MAX_G = 256;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Per (n, chunk of rows_blk rows): per-group (mean, M2) of the chunk, as
// part[((n * nblk + blk) * G + g) * 2 + {0, 1}].
template <typename T>
__global__ void __launch_bounds__(THREADS)
gn_partials(const T* __restrict__ x, float* __restrict__ part, int S, int C, int G,
            int rows_blk) {
  __shared__ __align__(16) unsigned char tile_raw[TILE_BYTES];
  __shared__ float chan[MAX_C];
  __shared__ float gmean[MAX_G];
  T* tile = reinterpret_cast<T*>(tile_raw);

  const int tid = threadIdx.x;
  const int blk = blockIdx.x;
  const int nblk = gridDim.x;
  const int n = blockIdx.y;
  const int r0 = blk * rows_blk;
  const int nr = min(rows_blk, S - r0);
  const int gsize = C / G;
  const long count = (long)nr * C;
  const T* src = x + ((long)n * S + r0) * C;

  constexpr int VEC = 16 / sizeof(T);
  if (count % VEC == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const uint4* s4 = reinterpret_cast<const uint4*>(src);
    uint4* t4 = reinterpret_cast<uint4*>(tile);
    for (long i = tid; i < count / VEC; i += THREADS) t4[i] = s4[i];
  } else {
    for (long i = tid; i < count; i += THREADS) tile[i] = src[i];
  }
  __syncthreads();

  for (int c = tid; c < C; c += THREADS) {  // pass A: channel sums
    float s = 0.f;
    for (int r = 0; r < nr; ++r) s += to_f(tile[r * C + c]);
    chan[c] = s;
  }
  __syncthreads();
  const float n_chunk = (float)nr * (float)gsize;
  for (int g = tid; g < G; g += THREADS) {
    float s = 0.f;
    for (int j = 0; j < gsize; ++j) s += chan[g * gsize + j];
    gmean[g] = s / n_chunk;
  }
  __syncthreads();
  for (int c = tid; c < C; c += THREADS) {  // pass B: squared deviations from the chunk mean
    const float mu = gmean[c / gsize];
    float s = 0.f;
    for (int r = 0; r < nr; ++r) {
      const float d = to_f(tile[r * C + c]) - mu;
      s = fmaf(d, d, s);
    }
    chan[c] = s;
  }
  __syncthreads();
  for (int g = tid; g < G; g += THREADS) {
    float s = 0.f;
    for (int j = 0; j < gsize; ++j) s += chan[g * gsize + j];
    float* out = part + (((long)n * nblk + blk) * G + g) * 2;
    out[0] = gmean[g];
    out[1] = s;
  }
}

// (na, ma, qa) <- (na, ma, qa) merged with (nb, mb, qb): Chan's parallel
// formula for (count, mean, M2), the merge the TPU kernel applies chunk by
// chunk.
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

// One block per (g, n): merge the nblk chunk partials, write (mean, rstd).
__global__ void __launch_bounds__(THREADS)
gn_merge(const float* __restrict__ part, float* __restrict__ stats, int S, int G, int gsize,
         int rows_blk, int nblk, float eps) {
  __shared__ float sn[THREADS];
  __shared__ float sm[THREADS];
  __shared__ float sq[THREADS];
  const int tid = threadIdx.x;
  const int g = blockIdx.x;
  const int n = blockIdx.y;
  float na = 0.f, ma = 0.f, qa = 0.f;
  for (int blk = tid; blk < nblk; blk += THREADS) {
    const float* p = part + (((long)n * nblk + blk) * G + g) * 2;
    const float nb = (float)min(rows_blk, S - blk * rows_blk) * (float)gsize;
    chan_merge(na, ma, qa, nb, p[0], p[1]);
  }
  sn[tid] = na;
  sm[tid] = ma;
  sq[tid] = qa;
  __syncthreads();
  for (int stride = THREADS / 2; stride > 0; stride >>= 1) {
    if (tid < stride) {
      chan_merge(na, ma, qa, sn[tid + stride], sm[tid + stride], sq[tid + stride]);
      sn[tid] = na;
      sm[tid] = ma;
      sq[tid] = qa;
    }
    __syncthreads();
  }
  if (tid == 0) {
    stats[((long)n * G + g) * 2] = ma;
    stats[((long)n * G + g) * 2 + 1] = 1.f / sqrtf(qa / na + eps);
  }
}

// x * a + b in fp32, then SiLU on that fp32 value: y * sigmoid(y).
template <bool SILU, typename T>
__device__ __forceinline__ float norm_act(T x, float a, float b) {
  const float v = fmaf(to_f(x), a, b);
  return SILU ? v / (1.f + expf(-v)) : v;
}

// y = x * a + b (+ SiLU) over rows [blockIdx.x * rows_blk, ...) of batch n.
template <typename T, int VEC, bool SILU>
__global__ void __launch_bounds__(THREADS)
gn_apply(const T* __restrict__ x, T* __restrict__ y, const float* __restrict__ stats,
         const float* __restrict__ weight, const float* __restrict__ bias, int S, int C, int G,
         int rows_blk) {
  __shared__ float a_s[MAX_C];
  __shared__ float b_s[MAX_C];
  const int tid = threadIdx.x;
  const int n = blockIdx.y;
  const int gsize = C / G;
  for (int c = tid; c < C; c += THREADS) {
    const int g = c / gsize;
    const float mean = stats[((long)n * G + g) * 2];
    const float rstd = stats[((long)n * G + g) * 2 + 1];
    const float a = rstd * weight[c];
    a_s[c] = a;
    b_s[c] = bias[c] - mean * a;
  }
  __syncthreads();
  const int r0 = blockIdx.x * rows_blk;
  const int nr = min(rows_blk, S - r0);
  const int cv = C / VEC;
  const long base = ((long)n * S + r0) * C;
  for (int i = tid; i < nr * cv; i += THREADS) {
    const int r = i / cv;
    const int c0 = (i - r * cv) * VEC;
    const long off = base + (long)r * C + c0;
    if constexpr (VEC * sizeof(T) == 16) {
      const uint4 raw = *reinterpret_cast<const uint4*>(x + off);
      uint4 res;
      const T* in = reinterpret_cast<const T*>(&raw);
      T* out = reinterpret_cast<T*>(&res);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        out[e] = from_f<T>(norm_act<SILU>(in[e], a_s[c0 + e], b_s[c0 + e]));
      }
      *reinterpret_cast<uint4*>(y + off) = res;
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        y[off + e] = from_f<T>(norm_act<SILU>(x[off + e], a_s[c0 + e], b_s[c0 + e]));
      }
    }
  }
}

template <typename T, int VEC>
void launch_apply(const T* x, T* y, const float* stats, const float* w, const float* b, int N,
                  int S, int C, int G, int silu, cudaStream_t st) {
  // ~8K elements a block: enough blocks to fill the card at every UNet site.
  const int rows = max(1, min(S, 8192 / C));
  const dim3 grid((S + rows - 1) / rows, N);
  if (silu) {
    gn_apply<T, VEC, true><<<grid, THREADS, 0, st>>>(x, y, stats, w, b, S, C, G, rows);
  } else {
    gn_apply<T, VEC, false><<<grid, THREADS, 0, st>>>(x, y, stats, w, b, S, C, G, rows);
  }
}

template <typename T>
int run(const T* x, T* y, const float* w, const float* b, float* part, float* stats, int N,
        int S, int C, int G, int rows_blk, float eps, int silu, cudaStream_t st) {
  const int nblk = (S + rows_blk - 1) / rows_blk;
  gn_partials<T><<<dim3(nblk, N), THREADS, 0, st>>>(x, part, S, C, G, rows_blk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  gn_merge<<<dim3(G, N), THREADS, 0, st>>>(part, stats, S, G, C / G, rows_blk, nblk, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  constexpr int VEC = 16 / sizeof(T);
  const bool aligned = (reinterpret_cast<uintptr_t>(x) & 15) == 0 &&
                       (reinterpret_cast<uintptr_t>(y) & 15) == 0;
  if (C % VEC == 0 && aligned) {
    launch_apply<T, VEC>(x, y, stats, w, b, N, S, C, G, silu, st);
  } else {
    launch_apply<T, 1>(x, y, stats, w, b, N, S, C, G, silu, st);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Rows a stats block takes for C channels of elem_bytes each (the caller sizes
// the partials scratch, N * ceil(S / rows) * G * 2 floats, from it).
extern "C" int vdpp_gn_rows_per_block(int C, int elem_bytes) {
  return C <= 0 ? 0 : TILE_BYTES / (C * elem_bytes);
}

// x, y: (N, S, C) contiguous, both bf16 (is_bf16 = 1) or both fp32; weight,
// bias: (C,) fp32; part: N * ceil(S / rows_blk) * G * 2 fp32; stats: N * G * 2
// fp32 (written: mean, rstd). C % G == 0, C <= 4096, G <= 256.
extern "C" int vdpp_group_norm_silu_fwd(const void* x, void* y, const float* weight,
                                        const float* bias, float* part, float* stats,
                                        int is_bf16, int N, int S, int C, int G, float eps,
                                        int silu, void* stream) {
  if (N <= 0 || S <= 0 || C <= 0 || G <= 0 || C % G != 0 || C > MAX_C || G > MAX_G ||
      N > 65535 || G > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const int rows_blk = vdpp_gn_rows_per_block(C, is_bf16 ? 2 : 4);
  if (rows_blk < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return run<__nv_bfloat16>(static_cast<const __nv_bfloat16*>(x),
                              static_cast<__nv_bfloat16*>(y), weight, bias, part, stats, N, S,
                              C, G, rows_blk, eps, silu, st);
  }
  return run<float>(static_cast<const float*>(x), static_cast<float*>(y), weight, bias, part,
                    stats, N, S, C, G, rows_blk, eps, silu, st);
}
