// Attention over the frame axis for Hopper (sm_90a): q, k, v, o of shape
// (B, F, L, H, D), and for every (b, l, h) an F x F softmax attention over
// the frames. F is small (25 for SVD-XT), B * L * H large (46,080 at the
// UNet's level 0).
//
// Replaces the TPU kernel
// vdpp_tpu/ops/temporal_attention_kernel.py::_frame_attn_kernel (pallas_call
// in _frame_attention_bhfld) and computes what it computes, in fp32 whatever
// the input dtype: q * (1 / sqrt(d)) before the dot products, the row max
// over the key frames, exp(s - max) summed into the denominator and, weighted,
// into the output in key-frame order, out / denom, one rounding to the dtype.
//
// What bounds it on an H100: at level 0 (L = 9216, H = 5, F = 25, d = 64,
// bf16) q, k, v and o are 4 * 25 * 9216 * 320 * 2 B = 590 MB, 0.18 ms at
// 3.35 TB/s, and the 2 * 2 * F^2 * d FLOP per (b, l, h) are 7.4 GFLOP,
// 0.11 ms at 67 TFLOP/s fp32: bytes first, but close. The TPU version
// transposes to (B*H, F, L, D) and pads L to its tile; here a warp reads its
// (b, l, h)'s F rows of q, k and v where the projections left them (each a
// d-long run of 128 B in bf16, F runs L * H * d apart), so there is no copy.
// It stages them in shared memory; lane f < F owns query frame f, keeps its
// scaled q row, its F scores and its d outputs in registers, and reads the k
// and v rows as broadcasts. The output goes back through shared memory so the
// stores are whole rows.
//
// C interface (bound with ctypes, see
// vdpp_tpu_torch/ops/temporal_attention_kernel.py): returns cudaGetLastError()
// after the launch, launches on the given stream, allocates nothing and does
// not synchronise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int D = 64;         // head dim
constexpr int FMAX = 32;      // frames: one per lane
constexpr int WARPS = 4;      // (b, l, h) items per block, one per warp
constexpr int PAD = 16;       // bytes of padding per staged q row (lanes' reads: distinct banks)

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T>
__host__ __device__ constexpr int q_row() { return D + PAD / (int)sizeof(T); }  // elements

template <typename T>
__host__ __device__ constexpr size_t warp_smem(int frames) {
  return sizeof(T) * (size_t)frames * (q_row<T>() + 2 * D);
}

// Copy F rows of D elements (row f at src + f * fstride) into dst rows of
// dst_row elements, 16 bytes per lane and step.
template <typename T>
__device__ __forceinline__ void load_rows(T* dst, int dst_row, const T* src, long fstride, int F,
                                          int lane) {
  constexpr int V = 16 / sizeof(T);
  constexpr int PER_ROW = D / V;
  for (int i = lane; i < F * PER_ROW; i += 32) {
    const int f = i / PER_ROW;
    const int c = (i - f * PER_ROW) * V;
    *reinterpret_cast<uint4*>(dst + f * dst_row + c) =
        *reinterpret_cast<const uint4*>(src + f * fstride + c);
  }
}

template <typename T>
__global__ void __launch_bounds__(WARPS * 32)
frame_attn(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
           T* __restrict__ o, long items, int F, int L, int H, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long item = (long)blockIdx.x * WARPS + warp;
  if (item >= items) return;  // whole warps only: no block-wide barrier below

  T* qs = reinterpret_cast<T*>(smem_raw + warp * warp_smem<T>(F));
  T* ks = qs + F * q_row<T>();
  T* vs = ks + F * D;

  const long lh = (long)L * H;
  const long b = item / lh;
  const long rem = item - b * lh;  // = l * H + h
  const long base = (b * F * lh + rem) * D;
  const long fstride = lh * D;
  load_rows(qs, q_row<T>(), q + base, fstride, F, lane);
  load_rows(ks, D, k + base, fstride, F, lane);
  load_rows(vs, D, v + base, fstride, F, lane);
  __syncwarp();

  // Shared rows are read 16 bytes at a time (V elements): k and v rows as
  // broadcasts, one load feeding V FMAs.
  constexpr int V = 16 / sizeof(T);
  const int f = lane < F ? lane : 0;  // lanes past F shadow frame 0 and store nothing
  float qf[D];
#pragma unroll
  for (int j = 0; j < D / V; ++j) {
    const uint4 raw = reinterpret_cast<const uint4*>(qs + f * q_row<T>())[j];
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int t = 0; t < V; ++t) qf[j * V + t] = to_f(e[t]) * scale;
  }

  float s[FMAX];
  float m = -CUDART_INF_F;
#pragma unroll
  for (int g = 0; g < FMAX; ++g) {
    if (g < F) {
      const uint4* kg = reinterpret_cast<const uint4*>(ks + g * D);
      float a = 0.f;
#pragma unroll
      for (int j = 0; j < D / V; ++j) {
        const uint4 raw = kg[j];
        const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int t = 0; t < V; ++t) a = fmaf(qf[j * V + t], to_f(e[t]), a);
      }
      s[g] = a;
      m = fmaxf(m, a);
    }
  }

  float acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.f;
  float denom = 0.f;
#pragma unroll
  for (int g = 0; g < FMAX; ++g) {
    if (g < F) {
      const float p = expf(s[g] - m);
      denom += p;
      const uint4* vg = reinterpret_cast<const uint4*>(vs + g * D);
#pragma unroll
      for (int j = 0; j < D / V; ++j) {
        const uint4 raw = vg[j];
        const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int t = 0; t < V; ++t) acc[j * V + t] = fmaf(p, to_f(e[t]), acc[j * V + t]);
      }
    }
  }

  __syncwarp();  // every lane has read its q row before the rows are overwritten
  if (lane < F) {
#pragma unroll
    for (int d = 0; d < D; ++d) qs[lane * q_row<T>() + d] = from_f<T>(acc[d] / denom);
  }
  __syncwarp();
  constexpr int PER_ROW = D / V;
  for (int i = lane; i < F * PER_ROW; i += 32) {
    const int fr = i / PER_ROW;
    const int c = (i - fr * PER_ROW) * V;
    *reinterpret_cast<uint4*>(o + base + fr * fstride + c) =
        *reinterpret_cast<const uint4*>(qs + fr * q_row<T>() + c);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, long items, int F, int L, int H,
           float scale, cudaStream_t st) {
  const size_t smem = WARPS * warp_smem<T>(F);
  const cudaError_t err = cudaFuncSetAttribute(
      frame_attn<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long blocks = (items + WARPS - 1) / WARPS;
  frame_attn<T><<<(unsigned)blocks, WARPS * 32, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), items, F, L, H, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, o: (batch, frames, L, heads, head_dim) contiguous, 16-byte aligned,
// all bf16 (is_bf16 = 1) or all fp32; head_dim 64, 1 <= frames <= 32.
// scale = 1 / sqrt(head_dim).
extern "C" int vdpp_frame_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                        int is_bf16, int batch, int frames, int L, int heads,
                                        int head_dim, float scale, void* stream) {
  const long items = (long)batch * L * heads;
  if (head_dim != D || frames < 1 || frames > FMAX || batch <= 0 || L <= 0 || heads <= 0 ||
      (items + WARPS - 1) / WARPS > 0x7fffffffL) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (is_bf16) return launch<__nv_bfloat16>(q, k, v, o, items, frames, L, heads, scale, st);
  return launch<float>(q, k, v, o, items, frames, L, heads, scale, st);
}
