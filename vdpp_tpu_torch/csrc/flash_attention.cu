// Flash attention forward for Hopper (sm_90a): non-causal, unmasked multi-head
// attention over (B, L, H, D) tensors without an L x L score matrix in memory.
//
// Replaces the TPU kernel vdpp_tpu/ops/flash_attention.py::_flash_kernel
// (pallas_call in _flash_bhld) and computes what it computes:
//   * q is pre-scaled by log2(e)/sqrt(d) in fp32 and rounded back to the input
//     dtype before the product, and the softmax is base 2 (exp2);
//   * static-max mode (the default) clips the log2-logits to [-100, 100] and
//     takes exp2 directly; running-max mode is the classic online softmax with
//     the running max starting at -0.7 * FLT_MAX;
//   * P is rounded to the input dtype before P.V and the denominator l is the
//     fp32 sum of those rounded values (the reference gets l from a ones column
//     appended to V, so it sums exactly these numbers);
//   * accumulation is fp32 and a row with l == 0 divides by 1.
// The reference pads keys to its block size and gives padded keys the logit
// -126 after the clip (static) or -0.7 * FLT_MAX (running); a padded key meets
// an all-zero row of the ones-augmented V there, so it adds exactly 0 to both
// O and l. Here keys past L_k get p = 0, which is the same sum.
//
// What bounds it on an H100: at the SVD-XT level-0 site (L = 9216, d = 64,
// 125 heads x frames) one call is 4 * 125 * 9216^2 * 64 = 2.72 TFLOP against
// 989 TFLOP/s dense bf16, about 2.7 ms, while its bytes (q, k, v, o once:
// 4 * 125 * 9216 * 64 * 2 B = 0.59 GB at 3.35 TB/s, 0.18 ms) are fifteen times
// cheaper: the kernel is bound by the tensor cores. The design therefore keeps
// both products on the tensor cores (mma.sync m16n8k16 bf16 -> fp32), keeps
// Q, S/P and the fp32 accumulator in registers so the score tile never leaves
// the SM, and reuses each K/V tile staged in shared memory for 64 query rows.
// The TPU grid's sequential key axis is the loop over K/V tiles inside a block.
// Not yet done (later work): wgmma, TMA and a multi-stage copy pipeline.
//
// fp32 inputs take a plain SIMT kernel (one query row per thread): the tensor
// cores would round fp32 operands to TF32, and fp32 is off the UNet's path.
//
// Head dim 72 (DiT-XL: hidden 1152 over 16 heads) runs the same two kernels:
// the head dim is a template parameter. 72 = 4 * 16 + 8, so S = Q'K^T takes
// four m16n8k16 steps and one m16n8k8 step for columns 64-71; nothing past
// column 71 of Q, K or V is read, so no unset shared memory enters a product.
// P.V has 72 / 8 = 9 n-tiles (36 fp32 accumulators a thread). The padded
// shared row is 88 bf16 (44 words): the eight row groups g of a fragment load
// then start at banks 12g mod 32, all distinct (80 would give 8g mod 32, a
// 2-way conflict). At the joint3d site (B = 1, L = 8 * 640 = 5120, 16 heads)
// one call is 4 * 16 * 5120^2 * 72 = 121 GFLOP, 0.12 ms at 989 TFLOP/s, against
// 4 * 5120 * 16 * 72 * 2 B = 47 MB of q, k, v, o (0.014 ms): operations again.
//
// Head dim 512, fp32 (the VAE decoder's mid-block attention: one head,
// L = 72 * 128 = 9216, B = the frames of a decode chunk) takes its own SIMT
// kernel, flash_fwd_f32_d512. One call at B = 4 is 4 * 4 * 9216^2 * 512 =
// 696 GFLOP against 67 TFLOP/s fp32 outside the tensor cores, about 10.4 ms,
// while its bytes (302 MB at 3.35 TB/s) take 0.09 ms: it is bound by fp32
// FMA throughput. A 64-row x 512 fp32 accumulator would be 128 KB, so a block
// owns only 32 query rows: 8 warps, 4 rows each, every lane holding a 4 x 16
// slice of the accumulator (64 registers). Q (32 x 512), a K tile and a V
// tile (32 keys each) sit in 198 KB of dynamic shared memory. In S = Q'K^T a
// lane owns one key and its warp's 4 rows (Q rows read as broadcasts, K rows
// padded to 516 floats so the lanes' float4 reads hit distinct banks); P goes
// through a padded 32 x 36 shared tile, transposed so a warp reads its 4
// rows' p for one key as one broadcast float4, and P.V reads each V row once
// per warp as conflict-free float4s. No TF32: the check is 1e-5 x max|plain|.
//
// C interface (bound with ctypes, see vdpp_tpu_torch/ops/flash_attention.py):
// returns cudaGetLastError() after the launch, launches on the given stream,
// allocates nothing and does not synchronise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BK = 64;          // keys per shared-memory tile
constexpr int THREADS = 128;    // 4 warps
constexpr int BQ_MMA = 64;      // query rows per block, bf16 kernel (16 per warp)
constexpr int BQ_F32 = THREADS; // query rows per block, fp32 kernel (1 per thread)

// Padded shared row of a bf16 K/V tile, in elements. Lane (g, t) of a fragment
// load reads word g * SROW / 2 + t, so the eight g hit distinct banks when
// SROW / 2 is 4 mod 8: 72 (36 words) at D = 64, 88 (44 words) at D = 72.
template <int D>
__host__ __device__ constexpr int srow() {
  return ((D + 8) / 2) % 8 == 4 ? D + 8 : D + 16;
}

constexpr float S_CLAMP = 100.f;
constexpr float S_CLAMP_LO = -100.f;
constexpr float MASK_VALUE = -0.7f * 3.40282346638528859812e+38f;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (lo) in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// D(16x8, fp32) += A(16x8, bf16, row) * B(8x8, bf16, col); fragments as the
// first half of m16n8k16's: A {(g, 2t..2t+1), (g+8, 2t..)}, B (k 2t..2t+1, n g).
__device__ __forceinline__ void mma_1688(float c[4], const uint32_t a[2], uint32_t b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(b0));
}

// D(16x8, fp32) += A(16x16, bf16, row) * B(16x8, bf16, col)
__device__ __forceinline__ void mma_16816(float c[4], const uint32_t a[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Fragment layout of m16n8k16 (g = lane / 4, t = lane % 4):
//   A regs: {(g, 2t..2t+1), (g+8, 2t..), (g, 2t+8..), (g+8, 2t+8..)}
//   B regs: {(k 2t..2t+1, n g), (k 2t+8..2t+9, n g)}
//   C: c0,c1 = (g, 2t..2t+1), c2,c3 = (g+8, 2t..2t+1)
// so the C fragments of two neighbouring 8-key tiles of S are, element for
// element, the A fragment of one 16-key step of P.V (no shuffles needed).
template <int D, bool STATIC_MAX>
__global__ void __launch_bounds__(THREADS)
flash_fwd_bf16(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, int H,
               int Lq, int Lk, float qscale) {
  static_assert(D % 8 == 0, "whole 8-column tiles");
  constexpr int SROW = srow<D>();
  constexpr int KS = D / 16;           // m16n8k16 steps of S = Q'K^T
  constexpr bool TAIL = D % 16 != 0;   // and one m16n8k8 step for the last 8 columns
  constexpr int ROW_CHUNKS = D / 8;    // 16-byte chunks of a row
  __shared__ __align__(16) __nv_bfloat16 Ks[BK * SROW];
  __shared__ __align__(16) __nv_bfloat16 Vs[BK * SROW];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const long rs = (long)H * D;  // elements from one token to the next
  const __nv_bfloat16* qb = q + ((long)b * Lq * H + h) * D;
  const __nv_bfloat16* kb = k + ((long)b * Lk * H + h) * D;
  const __nv_bfloat16* vb = v + ((long)b * Lk * H + h) * D;
  __nv_bfloat16* ob = o + ((long)b * Lq * H + h) * D;
  const int r0 = blockIdx.x * BQ_MMA + warp * 16 + g;  // this thread's rows: r0, r0 + 8

  uint32_t qa[KS][4];
  uint32_t qt[2];  // the k8 tail step's A fragment (unused when D % 16 == 0)
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = r0 + (i & 1) * 8;
      const int c = ks * 16 + 2 * t + (i >> 1) * 8;
      float2 f = make_float2(0.f, 0.f);
      if (r < Lq) {
        f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(qb + r * rs + c));
      }
      qa[ks][i] = pack_bf16(f.x * qscale, f.y * qscale);
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + i * 8;
    float2 f = make_float2(0.f, 0.f);
    if (TAIL && r < Lq) {
      const __nv_bfloat16* qp = qb + r * rs + KS * 16 + 2 * t;
      f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(qp));
    }
    qt[i] = pack_bf16(f.x * qscale, f.y * qscale);
  }

  float acc[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[dt][i] = 0.f;
  }
  float m[2] = {MASK_VALUE, MASK_VALUE};
  float l[2] = {0.f, 0.f};
  const unsigned short* vraw = reinterpret_cast<const unsigned short*>(Vs);

  for (int k0 = 0; k0 < Lk; k0 += BK) {
    __syncthreads();  // every warp is done with the previous tile
#pragma unroll
    for (int i = 0; i < (BK * ROW_CHUNKS + THREADS - 1) / THREADS; ++i) {
      const int c = tid + i * THREADS;
      if ((BK * ROW_CHUNKS) % THREADS != 0 && c >= BK * ROW_CHUNKS) break;  // D = 72: 4.5 rounds
      const int row = c / ROW_CHUNKS;
      const int col = (c % ROW_CHUNKS) * 8;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u);
      uint4 vv = make_uint4(0u, 0u, 0u, 0u);
      if (k0 + row < Lk) {
        kv = *reinterpret_cast<const uint4*>(kb + (k0 + row) * rs + col);
        vv = *reinterpret_cast<const uint4*>(vb + (k0 + row) * rs + col);
      }
      *reinterpret_cast<uint4*>(Ks + row * SROW + col) = kv;
      *reinterpret_cast<uint4*>(Vs + row * SROW + col) = vv;
    }
    __syncthreads();

    // S = Q' K^T for this warp's 16 rows and the tile's 64 keys (log2 domain).
    float s[BK / 8][4];
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) s[nt][i] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        const __nv_bfloat16* kp = Ks + (nt * 8 + g) * SROW + ks * 16 + 2 * t;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(kp);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(kp + 8);
        mma_16816(s[nt], qa[ks], b0, b1);
      }
      if (TAIL) {
        const __nv_bfloat16* kp = Ks + (nt * 8 + g) * SROW + KS * 16 + 2 * t;
        mma_1688(s[nt], qt, *reinterpret_cast<const uint32_t*>(kp));
      }
    }

    const bool full = k0 + BK <= Lk;
    if (STATIC_MAX) {
#pragma unroll
      for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int key = k0 + nt * 8 + 2 * t + (i & 1);
          const float x = fminf(fmaxf(s[nt][i], S_CLAMP_LO), S_CLAMP);
          const float p = (full || key < Lk) ? round_bf16(exp2f(x)) : 0.f;
          l[i >> 1] += p;
          s[nt][i] = p;
        }
      }
    } else {
      float mt[2] = {MASK_VALUE, MASK_VALUE};
#pragma unroll
      for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int key = k0 + nt * 8 + 2 * t + (i & 1);
          if (full || key < Lk) mt[i >> 1] = fmaxf(mt[i >> 1], s[nt][i]);
        }
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {  // a row's 64 keys are spread over the 4 lanes of a quad
        mt[j] = fmaxf(mt[j], __shfl_xor_sync(0xffffffffu, mt[j], 1));
        mt[j] = fmaxf(mt[j], __shfl_xor_sync(0xffffffffu, mt[j], 2));
        const float m_new = fmaxf(m[j], mt[j]);
        const float alpha = exp2f(m[j] - m_new);
        m[j] = m_new;
        l[j] *= alpha;
#pragma unroll
        for (int dt = 0; dt < D / 8; ++dt) {
          acc[dt][2 * j] *= alpha;
          acc[dt][2 * j + 1] *= alpha;
        }
      }
#pragma unroll
      for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int key = k0 + nt * 8 + 2 * t + (i & 1);
          const float p = (full || key < Lk) ? round_bf16(exp2f(s[nt][i] - m[i >> 1])) : 0.f;
          l[i >> 1] += p;
          s[nt][i] = p;
        }
      }
    }

    // O += P V, P from registers, V as the col-major B operand.
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
      const uint32_t pa[4] = {pack_bf16(s[2 * j][0], s[2 * j][1]),
                              pack_bf16(s[2 * j][2], s[2 * j][3]),
                              pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]),
                              pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3])};
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        const int e = (j * 16 + 2 * t) * SROW + dt * 8 + g;
        const uint32_t b0 = (uint32_t)vraw[e] | ((uint32_t)vraw[e + SROW] << 16);
        const uint32_t b1 =
            (uint32_t)vraw[e + 8 * SROW] | ((uint32_t)vraw[e + 9 * SROW] << 16);
        mma_16816(acc[dt], pa, b0, b1);
      }
    }
  }

  float inv[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    l[j] += __shfl_xor_sync(0xffffffffu, l[j], 1);
    l[j] += __shfl_xor_sync(0xffffffffu, l[j], 2);
    inv[j] = l[j] == 0.f ? 1.f : 1.f / l[j];
  }
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int c = dt * 8 + 2 * t;
    if (r0 < Lq) {
      *reinterpret_cast<uint32_t*>(ob + r0 * rs + c) =
          pack_bf16(acc[dt][0] * inv[0], acc[dt][1] * inv[0]);
    }
    if (r0 + 8 < Lq) {
      *reinterpret_cast<uint32_t*>(ob + (r0 + 8) * rs + c) =
          pack_bf16(acc[dt][2] * inv[1], acc[dt][3] * inv[1]);
    }
  }
}

template <int D, bool STATIC_MAX>
__global__ void __launch_bounds__(THREADS)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o, int H, int Lq, int Lk,
              float qscale) {
  __shared__ __align__(16) float Ks[BK * D];
  __shared__ __align__(16) float Vs[BK * D];

  const int tid = threadIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const long rs = (long)H * D;
  const float* qb = q + ((long)b * Lq * H + h) * D;
  const float* kb = k + ((long)b * Lk * H + h) * D;
  const float* vb = v + ((long)b * Lk * H + h) * D;
  float* ob = o + ((long)b * Lq * H + h) * D;
  const int r = blockIdx.x * BQ_F32 + tid;

  float qr[D];
  float acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qr[d] = r < Lq ? qb[r * rs + d] * qscale : 0.f;
    acc[d] = 0.f;
  }
  float m = MASK_VALUE;
  float l = 0.f;

  for (int k0 = 0; k0 < Lk; k0 += BK) {
    __syncthreads();
    static_assert((BK * D / 4) % THREADS == 0, "whole float4 rounds");
#pragma unroll
    for (int i = 0; i < (BK * D / 4) / THREADS; ++i) {
      const int c = tid + i * THREADS;
      const int row = c / (D / 4);
      const int col = (c % (D / 4)) * 4;
      float4 kv = make_float4(0.f, 0.f, 0.f, 0.f);
      float4 vv = make_float4(0.f, 0.f, 0.f, 0.f);
      if (k0 + row < Lk) {
        kv = *reinterpret_cast<const float4*>(kb + (k0 + row) * rs + col);
        vv = *reinterpret_cast<const float4*>(vb + (k0 + row) * rs + col);
      }
      *reinterpret_cast<float4*>(Ks + row * D + col) = kv;
      *reinterpret_cast<float4*>(Vs + row * D + col) = vv;
    }
    __syncthreads();

    const int nk = min(BK, Lk - k0);
    if (!STATIC_MAX) {
      float mt = MASK_VALUE;
      for (int j = 0; j < nk; ++j) {
        float s = 0.f;
#pragma unroll
        for (int d = 0; d < D; ++d) s = fmaf(qr[d], Ks[j * D + d], s);
        mt = fmaxf(mt, s);
      }
      const float m_new = fmaxf(m, mt);
      const float alpha = exp2f(m - m_new);
      m = m_new;
      l *= alpha;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] *= alpha;
    }
    for (int j = 0; j < nk; ++j) {
      float s = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) s = fmaf(qr[d], Ks[j * D + d], s);
      const float p = STATIC_MAX ? exp2f(fminf(fmaxf(s, S_CLAMP_LO), S_CLAMP)) : exp2f(s - m);
      l += p;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] = fmaf(p, Vs[j * D + d], acc[d]);
    }
  }

  if (r < Lq) {
    const float inv = l == 0.f ? 1.f : 1.f / l;
#pragma unroll
    for (int d = 0; d < D; ++d) ob[r * rs + d] = acc[d] * inv;
  }
}

constexpr int D512 = 512;
constexpr int BQ_512 = 32;             // query rows per block
constexpr int BK_512 = 32;             // keys per tile (one per lane)
constexpr int THREADS_512 = 256;       // 8 warps x 4 query rows
constexpr int ROWS_PER_WARP = BQ_512 / (THREADS_512 / 32);
constexpr int QK_ROW = D512 + 4;       // padded Q/K row: lanes' float4 reads hit distinct banks
constexpr int P_ROW = BQ_512 + 4;      // padded transposed P row
constexpr int COLS_PER_LANE = D512 / 32;  // 16 accumulator columns per lane, as 4 float4
constexpr size_t SMEM_512 =
    sizeof(float) * (2 * BQ_512 * QK_ROW + BK_512 * D512 + BK_512 * P_ROW);
static_assert(ROWS_PER_WARP == 4, "P is moved as one float4 per key and warp");
static_assert(BK_512 == 32, "one key per lane");

template <bool STATIC_MAX>
__global__ void __launch_bounds__(THREADS_512)
flash_fwd_f32_d512(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, float* __restrict__ o, int H, int Lq, int Lk,
                   float qscale) {
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                      // [BQ_512][QK_ROW]
  float* Ks = Qs + BQ_512 * QK_ROW;      // [BK_512][QK_ROW]
  float* Vs = Ks + BK_512 * QK_ROW;      // [BK_512][D512]
  float* Ps = Vs + BK_512 * D512;        // [BK_512][P_ROW], P transposed: key-major

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const long rs = (long)H * D512;
  const float* qb = q + ((long)b * Lq * H + h) * D512;
  const float* kb = k + ((long)b * Lk * H + h) * D512;
  const float* vb = v + ((long)b * Lk * H + h) * D512;
  float* ob = o + ((long)b * Lq * H + h) * D512;
  const int q0 = blockIdx.x * BQ_512;
  const int row0 = warp * ROWS_PER_WARP;  // this warp's rows within the block

  constexpr int F4_PER_ROW = D512 / 4;
  constexpr int TILE_F4 = BQ_512 * F4_PER_ROW;
#pragma unroll 4
  for (int i = tid; i < TILE_F4; i += THREADS_512) {
    const int row = i / F4_PER_ROW;
    const int col = (i % F4_PER_ROW) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + row < Lq) {
      x = *reinterpret_cast<const float4*>(qb + (q0 + row) * rs + col);
      x.x *= qscale;
      x.y *= qscale;
      x.z *= qscale;
      x.w *= qscale;
    }
    *reinterpret_cast<float4*>(Qs + row * QK_ROW + col) = x;
  }

  float acc[ROWS_PER_WARP][COLS_PER_LANE];
#pragma unroll
  for (int i = 0; i < ROWS_PER_WARP; ++i) {
#pragma unroll
    for (int c = 0; c < COLS_PER_LANE; ++c) acc[i][c] = 0.f;
  }
  float m[ROWS_PER_WARP];
  float lpart[ROWS_PER_WARP];  // this lane's keys' share of l; summed over the warp at the end
#pragma unroll
  for (int i = 0; i < ROWS_PER_WARP; ++i) {
    m[i] = MASK_VALUE;
    lpart[i] = 0.f;
  }

  for (int k0 = 0; k0 < Lk; k0 += BK_512) {
    __syncthreads();  // Q is staged; every warp is done with the previous K/V tile
#pragma unroll 4
    for (int i = tid; i < BK_512 * F4_PER_ROW; i += THREADS_512) {
      const int row = i / F4_PER_ROW;
      const int col = (i % F4_PER_ROW) * 4;
      float4 kv = make_float4(0.f, 0.f, 0.f, 0.f);
      float4 vv = make_float4(0.f, 0.f, 0.f, 0.f);
      if (k0 + row < Lk) {
        kv = *reinterpret_cast<const float4*>(kb + (k0 + row) * rs + col);
        vv = *reinterpret_cast<const float4*>(vb + (k0 + row) * rs + col);
      }
      *reinterpret_cast<float4*>(Ks + row * QK_ROW + col) = kv;
      *reinterpret_cast<float4*>(Vs + row * D512 + col) = vv;
    }
    __syncthreads();

    // s[i] = q'(row0 + i) . k(k0 + lane), log2 domain.
    float s[ROWS_PER_WARP];
#pragma unroll
    for (int i = 0; i < ROWS_PER_WARP; ++i) s[i] = 0.f;
    const float* kr = Ks + lane * QK_ROW;
#pragma unroll 4
    for (int d = 0; d < D512; d += 4) {
      const float4 kk = *reinterpret_cast<const float4*>(kr + d);
#pragma unroll
      for (int i = 0; i < ROWS_PER_WARP; ++i) {
        const float4 qq = *reinterpret_cast<const float4*>(Qs + (row0 + i) * QK_ROW + d);
        s[i] = fmaf(qq.x, kk.x, s[i]);
        s[i] = fmaf(qq.y, kk.y, s[i]);
        s[i] = fmaf(qq.z, kk.z, s[i]);
        s[i] = fmaf(qq.w, kk.w, s[i]);
      }
    }

    const bool valid = k0 + lane < Lk;
    float p[ROWS_PER_WARP];
    if (STATIC_MAX) {
#pragma unroll
      for (int i = 0; i < ROWS_PER_WARP; ++i) {
        p[i] = valid ? exp2f(fminf(fmaxf(s[i], S_CLAMP_LO), S_CLAMP)) : 0.f;
      }
    } else {
#pragma unroll
      for (int i = 0; i < ROWS_PER_WARP; ++i) {
        float mt = valid ? s[i] : MASK_VALUE;  // a row's 32 keys are the warp's 32 lanes
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
        }
        const float m_new = fmaxf(m[i], mt);
        const float alpha = exp2f(m[i] - m_new);
        m[i] = m_new;
        lpart[i] *= alpha;
#pragma unroll
        for (int c = 0; c < COLS_PER_LANE; ++c) acc[i][c] *= alpha;
        p[i] = valid ? exp2f(s[i] - m_new) : 0.f;
      }
    }
#pragma unroll
    for (int i = 0; i < ROWS_PER_WARP; ++i) lpart[i] += p[i];
    *reinterpret_cast<float4*>(Ps + lane * P_ROW + row0) = make_float4(p[0], p[1], p[2], p[3]);
    __syncwarp();  // a warp reads back only the P rows it wrote

    // O += P V: lane's columns lane*4 + 128*c, c = 0..3.
#pragma unroll 2
    for (int j = 0; j < BK_512; ++j) {
      const float4 pj = *reinterpret_cast<const float4*>(Ps + j * P_ROW + row0);
      const float pr[ROWS_PER_WARP] = {pj.x, pj.y, pj.z, pj.w};
#pragma unroll
      for (int c = 0; c < COLS_PER_LANE / 4; ++c) {
        const float4 vv = *reinterpret_cast<const float4*>(Vs + j * D512 + c * 128 + lane * 4);
#pragma unroll
        for (int i = 0; i < ROWS_PER_WARP; ++i) {
          acc[i][4 * c + 0] = fmaf(pr[i], vv.x, acc[i][4 * c + 0]);
          acc[i][4 * c + 1] = fmaf(pr[i], vv.y, acc[i][4 * c + 1]);
          acc[i][4 * c + 2] = fmaf(pr[i], vv.z, acc[i][4 * c + 2]);
          acc[i][4 * c + 3] = fmaf(pr[i], vv.w, acc[i][4 * c + 3]);
        }
      }
    }
    __syncwarp();  // P is read before the next tile overwrites it
  }

#pragma unroll
  for (int i = 0; i < ROWS_PER_WARP; ++i) {
    float l = lpart[i];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) l += __shfl_xor_sync(0xffffffffu, l, off);
    const float inv = l == 0.f ? 1.f : 1.f / l;
    const int r = q0 + row0 + i;
    if (r < Lq) {
#pragma unroll
      for (int c = 0; c < COLS_PER_LANE / 4; ++c) {
        *reinterpret_cast<float4*>(ob + r * rs + c * 128 + lane * 4) =
            make_float4(acc[i][4 * c] * inv, acc[i][4 * c + 1] * inv, acc[i][4 * c + 2] * inv,
                        acc[i][4 * c + 3] * inv);
      }
    }
  }
}

template <bool STATIC_MAX>
cudaError_t launch_f32_d512(const float* q, const float* k, const float* v, float* o, int bh,
                            int H, int Lq, int Lk, float qscale, cudaStream_t st) {
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_f32_d512<STATIC_MAX>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_512);
  if (err != cudaSuccess) return err;
  const dim3 grid((Lq + BQ_512 - 1) / BQ_512, bh);
  flash_fwd_f32_d512<STATIC_MAX>
      <<<grid, THREADS_512, SMEM_512, st>>>(q, k, v, o, H, Lq, Lk, qscale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_d(const void* q, const void* k, const void* v, void* o, int is_bf16, int bh,
                     int H, int Lq, int Lk, int static_max, float qscale, cudaStream_t st) {
  if (is_bf16) {
    const dim3 grid((Lq + BQ_MMA - 1) / BQ_MMA, bh);
    const auto* qp = static_cast<const __nv_bfloat16*>(q);
    const auto* kp = static_cast<const __nv_bfloat16*>(k);
    const auto* vp = static_cast<const __nv_bfloat16*>(v);
    auto* op = static_cast<__nv_bfloat16*>(o);
    if (static_max) {
      flash_fwd_bf16<D, true><<<grid, THREADS, 0, st>>>(qp, kp, vp, op, H, Lq, Lk, qscale);
    } else {
      flash_fwd_bf16<D, false><<<grid, THREADS, 0, st>>>(qp, kp, vp, op, H, Lq, Lk, qscale);
    }
  } else {
    const dim3 grid((Lq + BQ_F32 - 1) / BQ_F32, bh);
    const auto* qp = static_cast<const float*>(q);
    const auto* kp = static_cast<const float*>(k);
    const auto* vp = static_cast<const float*>(v);
    auto* op = static_cast<float*>(o);
    if (static_max) {
      flash_fwd_f32<D, true><<<grid, THREADS, 0, st>>>(qp, kp, vp, op, H, Lq, Lk, qscale);
    } else {
      flash_fwd_f32<D, false><<<grid, THREADS, 0, st>>>(qp, kp, vp, op, H, Lq, Lk, qscale);
    }
  }
  return cudaGetLastError();
}

}  // namespace

// q, o: (batch, lq, heads, head_dim); k, v: (batch, lk, heads, head_dim); all
// contiguous and 16-byte aligned. head_dim 64 and 72: all bf16 (is_bf16 = 1) or
// all fp32; head_dim 512: fp32 only. qscale = log2(e) / sqrt(head_dim).
extern "C" int vdpp_flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                        int is_bf16, int batch, int heads, int lq, int lk,
                                        int head_dim, int static_max, float qscale,
                                        void* stream) {
  if (batch <= 0 || heads <= 0 || lq <= 0 || lk <= 0 || (long)batch * heads > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int bh = batch * heads;
  if (head_dim == D512 && !is_bf16) {
    const auto* qp = static_cast<const float*>(q);
    const auto* kp = static_cast<const float*>(k);
    const auto* vp = static_cast<const float*>(v);
    auto* op = static_cast<float*>(o);
    return (int)(static_max
                     ? launch_f32_d512<true>(qp, kp, vp, op, bh, heads, lq, lk, qscale, st)
                     : launch_f32_d512<false>(qp, kp, vp, op, bh, heads, lq, lk, qscale, st));
  }
  if (head_dim == 64) {
    return (int)launch_d<64>(q, k, v, o, is_bf16, bh, heads, lq, lk, static_max, qscale, st);
  }
  if (head_dim == 72) {
    return (int)launch_d<72>(q, k, v, o, is_bf16, bh, heads, lq, lk, static_max, qscale, st);
  }
  return (int)cudaErrorInvalidValue;
}
