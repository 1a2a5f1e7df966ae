// Attention over the frame axis for Hopper (sm_90a): q, k, v, o of shape
// (B, F, L, H, D), and for every (b, l, h) "item" an F x F softmax attention
// over the frames. F is small (25 for SVD-XT, 8 for the factorized DiT-XL),
// B * L * H large (46,080 at the SVD-XT UNet's level 0).
//
// Replaces the TPU kernel
// vdpp_tpu/ops/temporal_attention_kernel.py::_frame_attn_kernel (pallas_call
// in _frame_attention_bhfld) and computes what it computes, in fp32 whatever
// the input dtype: fp32 scores of (q / sqrt(d)) . k, the row max over the key
// frames, exp(s - max) summed into the denominator and, weighted, into the
// output, out / denom, one rounding to the dtype.
//
// What bounds it on an H100: bytes. At level 0 (L = 9216, H = 5, F = 25,
// d = 64, bf16) q, k, v and o are 4 * 25 * 9216 * 320 * 2 B = 590 MB, 0.176 ms
// at 3.35 TB/s, against 2 * 2 * F^2 * d FLOP per item = 7.4 GFLOP, under
// 0.01 ms on the tensor cores. So the design is about keeping bytes in
// flight, and the arithmetic only has to stay out of the way.
//
// bf16, head dims 64 and 72: frame_attn_tma<D, FP, MERGED>.
//   * Loads by TMA, with no copy of the tensors: q, k, v and o are each a
//     tensor map with the tensor's own byte strides, 4-D over (D, L*H, F, B)
//     where the token and head axes merge (MERGED: every contiguous operand,
//     and o always), else 5-D over (D, H, L, F, B) (the fused QKV
//     projection's chunks, VDPP_FUSE_QKV=1, token stride 3 H D), at the cost
//     of an item's (l, h) from a divide; a box is one item's FP frames: D
//     columns, one item, FP rows. FP is
//     F rounded up to 16 (16 or 32), and TMA fills the frames from F to FP
//     with zeros, so every row a product reads is finite. A tile is
//     T = 128 / FP consecutive items of one batch (4 at F = 25, 8 at F = 8):
//     128 rows each of q, k and v, 48 KB at d = 64 and 54 KB at d = 72.
//   * A ring of FA_STAGES tiles, each with a "full" mbarrier (TMA bytes
//     landed) and a "done" mbarrier (the four consumer warps have written
//     their outputs). One producer warp (one thread) walks the CTA's tiles:
//     it waits for a slot's previous tile to be done, stores that tile's
//     output with TMA (from the slot's q rows, where the consumers wrote it),
//     waits until the store has read shared memory, and loads the next tile
//     into the slot. The grid is persistent, as many CTAs as fit on the SMs,
//     each walking tiles blockIdx.x, + gridDim.x, ... Items past L*H in a
//     batch's last tile are neither loaded, computed nor stored.
//   * Both products on mma.sync m16n8k16 (bf16 in, fp32 accumulate). A
//     consumer warp takes one m16 tile of an item's query frames at a time
//     (two an item at FP = 32): S = Q K^T over 16 x FP with A and B from
//     ldmatrix (d = 72: a fifth k-step on m16n8k8 over columns 64..71), then
//     P V with V from ldmatrix.trans. At d = 64 the rows are 128 B and the
//     maps use TMA's 128-byte swizzle (16-byte chunk c of row r at c ^ (r & 7)),
//     so the eight rows of every ldmatrix land in distinct banks; at d = 72
//     the 144-byte pitch already does that, with no swizzle.
//   * Numerics stay the reference's. The products are exact bf16 products
//     summed in fp32; the fp32 scores are then scaled by 1/sqrt(d) (at d = 64
//     a power of two, so the same as scaling q first; at d = 72 it differs by
//     fp32 rounding). Keys >= F get -inf before the row max (a quad of lanes
//     shares a row: two shuffles). p = expf(s - max) and the denominator are
//     fp32. P is not rounded to one bf16 for P V: it is split as P = hi + lo,
//     hi = bf16(p), lo = bf16(p - hi), and P V = hi V + lo V on two mmas with
//     fp32 accumulation, so P carries about 16 significant bits (relative
//     error near 2^-16), against one bf16 ulp (2^-8) allowed at the output;
//     TF32 would keep 11. The output is out / denom in fp32, rounded once to bf16,
//     written into the unit's own q rows (which only its S read) and stored
//     by TMA, which clips the rows past F.
//   * Budget: a ring of 2 tiles, 99,360 B of dynamic shared memory a CTA at
//     d = 64 and 111,648 B at d = 72 (with the barriers and 1 KB of alignment
//     slack), so two CTAs (ten warps) an SM; ptxas (CUDA 12.9, sm_90a): 96
//     registers a thread at <64, 32>, 119 at <72, 32>, 64 at FP = 16, no
//     spills. What bounds it is the bytes in flight: a ring of 3 tiles (one
//     CTA an SM) measured slower at every shape than two CTAs of 2 tiles.
//
// fp32 (off the models' paths; the small agreement configs use it):
// frame_attn<float, D>, SIMT. A warp reads its item's F rows of q, k and v
// where the projections left them and stages them in shared memory; lane
// f < F owns query frame f, keeps its scaled q row, its F scores and its d
// outputs in registers, and reads the k and v rows as broadcasts. The output
// goes back through shared memory so the stores are whole rows.
//
// Any other head dim or frame count (the tiny UNet's and DiT's d = 16, F > 32;
// the reference pads only L and takes any d and F), bf16 and fp32:
// frame_attn_any<T>, a simple SIMT kernel (making it fast is later work). A
// warp per item, lane c holding columns c, c + 32, ... of d. The item's F rows
// of q, k and v are staged in the warp's shared memory when four warps' worth
// fits a CTA, else read where they lie. For each query frame f, two passes over
// the key frames, as the reference's kernel makes them: pass 1 takes s_g =
// (q_f / sqrt(d)) . k_g in fp32 (each lane's columns, then the warp's sum by
// a butterfly of shuffles, so every lane holds the same bits), keeps it in the
// warp's F scores in shared memory and takes the max; pass 2 sums p = exp(s_g
// - max) into the denominator and p v_g into O, in blocks of 256 columns, and
// stores O / denom rounded once. Only the scores must fit: F up to 14,524.
//
// C interface (bound with ctypes, see
// vdpp_tpu_torch/ops/temporal_attention_kernel.py): returns a cudaError_t
// after the launch, launches on the given stream, allocates nothing and does
// not synchronise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "hopper.cuh"  // smem_u32, mbarriers, tma_load_4d/5d, Strides, encode_tiled

namespace {

constexpr int FMAX = 32;  // frames of the d = 64/72 kernels

// Where item (b, l, h) of a (B, F, L, H, D) operand with strides s starts,
// given rem = l * H + h (below L * H, which the launcher holds to an int).
__device__ __forceinline__ long long item_base(const Strides& s, long long b, int rem, int H) {
  const int l = rem / H;
  return b * s.b + (long long)l * s.l + (long long)(rem - l * H) * s.h;
}

// Whether an operand's token and head axes merge into one axis of L * H
// items with the head stride (a contiguous tensor's do; the fused QKV
// projection's chunks, token stride 3 H D, do not).
inline bool merges(const Strides& s, int H) { return s.l == (long long)H * s.h; }
constexpr int ANY_MAX_SMEM = 232448;  // dynamic shared memory a CTA may have

// ---------------------------------------------------------------------------
// bf16: TMA ring + mma.sync.

constexpr int FA_CONSUMERS = 4;                      // consumer warps
constexpr int FA_THREADS = 32 * (FA_CONSUMERS + 1);  // and one producer warp
constexpr int FA_ROWS = 128;                         // rows of q (k, v) a tile: T items x FP
constexpr int FA_STAGES = 2;                         // tiles in the ring

template <int D>
struct FrameLayout {
  static_assert(D == 64 || D == 72, "head dims 64 and 72");
  static constexpr int ROW = 2 * D;             // bytes of a row: 128 or 144
  static constexpr int TENSOR = FA_ROWS * ROW;  // q, k or v of one tile
  static constexpr int STAGE = 3 * TENSOR;      // q (then o), k, v
  static constexpr int BARS = FA_STAGES * STAGE;           // full[], done[]
  static constexpr int SMEM = BARS + 16 * FA_STAGES + 1024;  // + alignment slack
};

// Shared address of 16-byte chunk `chunk` of row `row` in a tile at `base`
// (1024-byte aligned): TMA's 128-byte swizzle at d = 64, plain rows at 72.
template <int D>
__device__ __forceinline__ uint32_t tile_addr(uint32_t base, int row, int chunk) {
  if constexpr (D == 64) {
    return base + row * 128 + ((chunk ^ (row & 7)) << 4);
  } else {
    return base + row * 144 + (chunk << 4);
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr)
               : "memory");
}

// d += a b: m16n8k16, bf16 in, fp32 accumulate.
__device__ __forceinline__ void mma_k16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                        uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b: m16n8k8 (the d = 72 tail).
__device__ __forceinline__ void mma_k8(float (&d)[4], const uint32_t (&a)[2], uint32_t b0) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5}, {%6}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(b0));
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// (x, y) = hi + lo with hi = bf16(x, y) and lo = bf16 of the remainders
// (x in the low half, the lower column, as mma's fragments want).
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = as_u32(h);
  lo = as_u32(__floats2bfloat162_rn(x - hf.x, y - hf.y));
}

__device__ __forceinline__ void st_shared_u32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;" ::"r"(addr), "r"(v) : "memory");
}

// One m16 tile of query frames (rows r0 .. r0 + 15 of q, item rows from
// `item` in k and v): scores, softmax, P V, out / denom, written over its own
// q rows. Lane 4g + t4 holds rows g and g + 8 of every accumulator tile.
template <int D, int FP>
__device__ __forceinline__ void frame_unit(uint32_t qs, uint32_t ks, uint32_t vs, int item,
                                           int r0, int F, float scale, int lane) {
  constexpr int NT = FP / 8;  // n8 tiles of keys in S
  constexpr int DT = D / 8;   // n8 tiles of columns in O (8, or 9 at d = 72)
  const int g = lane >> 2;
  const int t4 = lane & 3;

  float s[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
  }
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) {  // columns 16 kc .. 16 kc + 15
    uint32_t a[4];
    ldsm_x4(a, tile_addr<D>(qs, r0 + (lane & 15), 2 * kc + (lane >> 4)));
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
      uint32_t b[4];
      ldsm_x4(b, tile_addr<D>(ks, item + 8 * j + (lane & 7) + ((lane >> 4) << 3),
                              2 * kc + ((lane >> 3) & 1)));
      mma_k16(s[j], a, b[0], b[1]);
      mma_k16(s[j + 1], a, b[2], b[3]);
    }
  }
  if constexpr (D == 72) {  // columns 64 .. 71
    uint32_t a[2];
    ldsm_x2(a, tile_addr<D>(qs, r0 + (lane & 15), 8));
    if constexpr (NT == 4) {
      uint32_t b[4];
      ldsm_x4(b, tile_addr<D>(ks, item + lane, 8));
#pragma unroll
      for (int j = 0; j < 4; ++j) mma_k8(s[j], a, b[j]);
    } else {
      uint32_t b[2];
      ldsm_x2(b, tile_addr<D>(ks, item + (lane & 15), 8));
      mma_k8(s[0], a, b[0]);
      mma_k8(s[1], a, b[1]);
    }
  }

  // Scale, mask the keys past F, row max over the quad, exp, row sums.
  float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = 8 * j + 2 * t4 + (e & 1);
      const float v = key < F ? s[j][e] * scale : -CUDART_INF_F;
      s[j][e] = v;
      if (e < 2) {
        m0 = fmaxf(m0, v);
      } else {
        m1 = fmaxf(m1, v);
      }
    }
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, off));
    m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, off));
  }
  float l0 = 0.f, l1 = 0.f;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = expf(s[j][e] - (e < 2 ? m0 : m1));
      s[j][e] = p;
      if (e < 2) {
        l0 += p;
      } else {
        l1 += p;
      }
    }
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }

  // O = P V with P = hi + lo. The A fragment of keys 16 kc .. 16 kc + 15 is
  // S's n8 tiles 2 kc and 2 kc + 1 as they lie in the accumulators.
  float o[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  }
#pragma unroll
  for (int kc = 0; kc < FP / 16; ++kc) {
    uint32_t hi[4], lo[4];
    split_bf16(s[2 * kc][0], s[2 * kc][1], hi[0], lo[0]);
    split_bf16(s[2 * kc][2], s[2 * kc][3], hi[1], lo[1]);
    split_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1], hi[2], lo[2]);
    split_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3], hi[3], lo[3]);
    const int key = item + 16 * kc;
#pragma unroll
    for (int j = 0; j < 8; j += 2) {
      uint32_t b[4];
      ldsm_x4_t(b, tile_addr<D>(vs, key + (lane & 7) + (((lane >> 3) & 1) << 3), j + (lane >> 4)));
      mma_k16(o[j], lo, b[0], b[1]);
      mma_k16(o[j], hi, b[0], b[1]);
      mma_k16(o[j + 1], lo, b[2], b[3]);
      mma_k16(o[j + 1], hi, b[2], b[3]);
    }
    if constexpr (D == 72) {
      uint32_t b[2];
      ldsm_x2_t(b, tile_addr<D>(vs, key + (lane & 15), 8));
      mma_k16(o[8], lo, b[0], b[1]);
      mma_k16(o[8], hi, b[0], b[1]);
    }
  }

#pragma unroll
  for (int j = 0; j < DT; ++j) {
    st_shared_u32(tile_addr<D>(qs, r0 + g, j) + 4 * t4,
                  as_u32(__floats2bfloat162_rn(o[j][0] / l0, o[j][1] / l0)));
    st_shared_u32(tile_addr<D>(qs, r0 + g + 8, j) + 4 * t4,
                  as_u32(__floats2bfloat162_rn(o[j][2] / l1, o[j][3] / l1)));
  }
}

// One box of a 4-D tensor map from shared memory to global (bulk group).
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// The output of tile `tile` (in its slot's q rows) to global, one box an item.
template <int D, int FP>
__device__ __forceinline__ void store_tile(const CUtensorMap* o_map, uint32_t slot, int tile,
                                           int LH, int tiles_per_batch) {
  constexpr int T = FA_ROWS / FP;
  const int b = tile / tiles_per_batch;
  const int t0 = (tile - b * tiles_per_batch) * T;
  const int n = min(T, LH - t0);
  for (int t = 0; t < n; ++t) {
    tma_store_4d(o_map, slot + t * FP * FrameLayout<D>::ROW, 0, t0 + t, 0, b);
  }
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

template <int D, int FP, bool MERGED>
__global__ void __launch_bounds__(FA_THREADS)
frame_attn_tma(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
               const __grid_constant__ CUtensorMap v_map, const __grid_constant__ CUtensorMap o_map,
               int F, int H, int LH, int tiles_per_batch, int ntiles, float scale) {
  using Lay = FrameLayout<D>;
  constexpr int T = FA_ROWS / FP;        // items a tile
  constexpr int ITEM = FP * Lay::ROW;    // bytes of one item's rows in q, k or v
  constexpr int UNITS = T * (FP / 16);   // m16 tiles of query frames a tile
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;  // swizzle atoms: 1024 B
  const uint32_t full0 = base + Lay::BARS;
  const uint32_t done0 = full0 + 8 * FA_STAGES;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < FA_STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);              // the producer's arrive, plus the TMA bytes
      mbar_init(done0 + 8 * s, FA_CONSUMERS);   // one arrive per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == FA_CONSUMERS) {  // the producer: one thread
    if (lane != 0) return;
    int i = 0;
    for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x, ++i) {
      const int s = i % FA_STAGES;
      const uint32_t slot = base + s * Lay::STAGE;
      if (i >= FA_STAGES) {  // the slot's previous tile: store its output, then reuse
        mbar_wait(done0 + 8 * s, (i / FA_STAGES - 1) & 1);
        store_tile<D, FP>(&o_map, slot, tile - FA_STAGES * (int)gridDim.x, LH, tiles_per_batch);
        asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
      }
      const int b = tile / tiles_per_batch;
      const int t0 = (tile - b * tiles_per_batch) * T;
      const int n = min(T, LH - t0);
      const uint32_t full = full0 + 8 * s;
      mbar_expect_tx(full, 3 * n * ITEM);
      for (int t = 0; t < n; ++t) {
        if (MERGED) {  // 4-D maps over (D, L*H, F, B)
          tma_load_4d(slot + t * ITEM, &q_map, full, 0, t0 + t, 0, b);
          tma_load_4d(slot + Lay::TENSOR + t * ITEM, &k_map, full, 0, t0 + t, 0, b);
          tma_load_4d(slot + 2 * Lay::TENSOR + t * ITEM, &v_map, full, 0, t0 + t, 0, b);
        } else {  // 5-D maps over (D, H, L, F, B)
          const int l = (t0 + t) / H;
          const int h = t0 + t - l * H;
          tma_load_5d(slot + t * ITEM, &q_map, full, 0, h, l, 0, b);
          tma_load_5d(slot + Lay::TENSOR + t * ITEM, &k_map, full, 0, h, l, 0, b);
          tma_load_5d(slot + 2 * Lay::TENSOR + t * ITEM, &v_map, full, 0, h, l, 0, b);
        }
      }
    }
    for (int j = i > FA_STAGES ? i - FA_STAGES : 0; j < i; ++j) {  // the last tiles' outputs
      const int s = j % FA_STAGES;
      mbar_wait(done0 + 8 * s, (j / FA_STAGES) & 1);
      store_tile<D, FP>(&o_map, base + s * Lay::STAGE, blockIdx.x + j * (int)gridDim.x, LH,
                        tiles_per_batch);
    }
    asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
    return;
  }

  int i = 0;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x, ++i) {
    const int s = i % FA_STAGES;
    const uint32_t slot = base + s * Lay::STAGE;
    const int b = tile / tiles_per_batch;
    const int n = min(T, LH - (tile - b * tiles_per_batch) * T);
    mbar_wait(full0 + 8 * s, (i / FA_STAGES) & 1);
    for (int u = warp; u < UNITS; u += FA_CONSUMERS) {
      const int t = u / (FP / 16);
      if (t < n) {
        frame_unit<D, FP>(slot, slot + Lay::TENSOR, slot + 2 * Lay::TENSOR, t * FP,
                          t * FP + 16 * (u - t * (FP / 16)), F, scale, lane);
      }
    }
    // The outputs were written through the generic proxy; the TMA store that
    // reads them runs in the async proxy.
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncwarp();
    if (lane == 0) mbar_arrive(done0 + 8 * s);
  }
}

// A bf16 (B, F, L, H, D) tensor with strides `s` (D dense) as a tensor map
// whose box is one item's FP frames: 4-D over (D, L*H, F, B) where `merged`
// (its token and head axes merge, see merges()), else 5-D over
// (D, H, L, F, B). TMA takes byte strides that are multiples of 16, which the
// wrapper sees to.
bool operand_map(EncodeTiledFn encode, CUtensorMap* map, const void* ptr, const Strides& s,
                 bool merged, int D, int H, int L, int F, int B, int FP) {
  const cuuint64_t d5[5] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)L, (cuuint64_t)F,
                            (cuuint64_t)B};
  const cuuint64_t s5[4] = {(cuuint64_t)s.h * 2, (cuuint64_t)s.l * 2, (cuuint64_t)s.f * 2,
                            (cuuint64_t)s.b * 2};
  const cuuint64_t d4[4] = {(cuuint64_t)D, (cuuint64_t)L * H, (cuuint64_t)F, (cuuint64_t)B};
  const cuuint64_t s4[3] = {(cuuint64_t)s.h * 2, (cuuint64_t)s.f * 2, (cuuint64_t)s.b * 2};
  const cuuint32_t box5[5] = {(cuuint32_t)D, 1, 1, (cuuint32_t)FP, 1};
  const cuuint32_t box4[4] = {(cuuint32_t)D, 1, (cuuint32_t)FP, 1};
  const cuuint32_t elem_strides[5] = {1, 1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, merged ? 4 : 5, const_cast<void*>(ptr),
                merged ? d4 : d5, merged ? s4 : s5, merged ? box4 : box5, elem_strides,
                CU_TENSOR_MAP_INTERLEAVE_NONE,
                D == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D, int FP, bool MERGED>
int launch_tma(const Operands& x, int B, int F, int L, int H, float scale, cudaStream_t st) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
  const long LH = (long)L * H;
  CUtensorMap maps[4];
  const void* ptrs[3] = {x.q, x.k, x.v};
  const Strides* strides[3] = {&x.qs, &x.ks, &x.vs};
  for (int i = 0; i < 3; ++i) {
    if (!operand_map(encode, &maps[i], ptrs[i], *strides[i], MERGED, D, H, L, F, B, FP)) {
      return (int)cudaErrorInvalidValue;
    }
  }
  const Strides os = {F * LH * D, LH * D, (long long)H * D, D};  // the contiguous output's
  if (!operand_map(encode, &maps[3], x.o, os, true, D, H, L, F, B, FP)) {
    return (int)cudaErrorInvalidValue;
  }
  constexpr int smem = FrameLayout<D>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(frame_attn_tma<D, FP, MERGED>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, frame_attn_tma<D, FP, MERGED>,
                                                        FA_THREADS, smem);
  }
  if (err != cudaSuccess) return (int)err;
  constexpr int T = FA_ROWS / FP;
  const long tiles_per_batch = (LH + T - 1) / T;
  const long ntiles = tiles_per_batch * B;
  if (ntiles > 0x7fffffffL || per_sm < 1) return (int)cudaErrorInvalidValue;
  const int grid = (int)(ntiles < (long)sms * per_sm ? ntiles : (long)sms * per_sm);
  frame_attn_tma<D, FP, MERGED><<<grid, FA_THREADS, smem, st>>>(
      maps[0], maps[1], maps[2], maps[3], F, H, (int)LH, (int)tiles_per_batch, (int)ntiles, scale);
  return (int)cudaGetLastError();
}

// The 4-D maps where q, k and v all merge (any contiguous operands), else 5-D
// maps for all three.
template <int D, int FP>
int launch_fp(const Operands& x, int B, int F, int L, int H, float scale, cudaStream_t st) {
  return merges(x.qs, H) && merges(x.ks, H) && merges(x.vs, H)
             ? launch_tma<D, FP, true>(x, B, F, L, H, scale, st)
             : launch_tma<D, FP, false>(x, B, F, L, H, scale, st);
}

template <int D>
int launch_bf16(const Operands& x, int B, int F, int L, int H, float scale, cudaStream_t st) {
  return F <= 16 ? launch_fp<D, 16>(x, B, F, L, H, scale, st)
                 : launch_fp<D, 32>(x, B, F, L, H, scale, st);
}

// ---------------------------------------------------------------------------
// fp32: SIMT, a warp per item.

constexpr int WARPS = 4;      // (b, l, h) items per block, one per warp
constexpr int PAD = 16;       // bytes of padding per staged q row (lanes' reads: distinct banks)

__device__ __forceinline__ float to_f(float x) { return x; }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }

template <typename T, int D>
__host__ __device__ constexpr int q_row() { return D + PAD / (int)sizeof(T); }  // elements

template <typename T, int D>
__host__ __device__ constexpr size_t warp_smem(int frames) {
  return sizeof(T) * (size_t)frames * (q_row<T, D>() + 2 * D);
}

// Copy F rows of D elements (row f at src + f * fstride) into dst rows of
// dst_row elements, 16 bytes per lane and step.
template <typename T, int D>
__device__ __forceinline__ void load_rows(T* dst, int dst_row, const T* src, long fstride, int F,
                                          int lane) {
  constexpr int V = 16 / sizeof(T);
  constexpr int PER_ROW = D / V;
  static_assert(D % V == 0, "rows of whole 16-byte vectors");
  for (int i = lane; i < F * PER_ROW; i += 32) {
    const int f = i / PER_ROW;
    const int c = (i - f * PER_ROW) * V;
    *reinterpret_cast<uint4*>(dst + f * dst_row + c) =
        *reinterpret_cast<const uint4*>(src + f * fstride + c);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(WARPS * 32)
frame_attn(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
           T* __restrict__ o, Strides qs, Strides ks, Strides vs, long items, int F, int L, int H,
           float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long item = (long)blockIdx.x * WARPS + warp;
  if (item >= items) return;  // whole warps only: no block-wide barrier below

  constexpr int QROW = q_row<T, D>();
  T* qsm = reinterpret_cast<T*>(smem_raw + warp * warp_smem<T, D>(F));
  T* ksm = qsm + F * QROW;
  T* vsm = ksm + F * D;

  const long lh = (long)L * H;
  const long b = item / lh;
  const long rem = item - b * lh;  // = l * H + h
  const long base = (b * F * lh + rem) * D;  // the contiguous output's
  const long fstride = lh * D;
  load_rows<T, D>(qsm, QROW, q + item_base(qs, b, (int)rem, H), qs.f, F, lane);
  load_rows<T, D>(ksm, D, k + item_base(ks, b, (int)rem, H), ks.f, F, lane);
  load_rows<T, D>(vsm, D, v + item_base(vs, b, (int)rem, H), vs.f, F, lane);
  __syncwarp();

  // Shared rows are read 16 bytes at a time (V elements): k and v rows as
  // broadcasts, one load feeding V FMAs.
  constexpr int V = 16 / sizeof(T);
  const int f = lane < F ? lane : 0;  // lanes past F shadow frame 0 and store nothing
  float qf[D];
#pragma unroll
  for (int j = 0; j < D / V; ++j) {
    const uint4 raw = reinterpret_cast<const uint4*>(qsm + f * QROW)[j];
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int t = 0; t < V; ++t) qf[j * V + t] = to_f(e[t]) * scale;
  }

  float s[FMAX];
  float m = -CUDART_INF_F;
#pragma unroll
  for (int g = 0; g < FMAX; ++g) {
    if (g < F) {
      const uint4* kg = reinterpret_cast<const uint4*>(ksm + g * D);
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
      const uint4* vg = reinterpret_cast<const uint4*>(vsm + g * D);
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
    for (int d = 0; d < D; ++d) qsm[lane * QROW + d] = from_f<T>(acc[d] / denom);
  }
  __syncwarp();
  constexpr int PER_ROW = D / V;
  for (int i = lane; i < F * PER_ROW; i += 32) {
    const int fr = i / PER_ROW;
    const int c = (i - fr * PER_ROW) * V;
    *reinterpret_cast<uint4*>(o + base + fr * fstride + c) =
        *reinterpret_cast<const uint4*>(qsm + fr * QROW + c);
  }
}

template <typename T, int D>
int launch(const Operands& x, long items, int F, int L, int H, float scale, cudaStream_t st) {
  const size_t smem = WARPS * warp_smem<T, D>(F);
  const cudaError_t err = cudaFuncSetAttribute(
      frame_attn<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long blocks = (items + WARPS - 1) / WARPS;
  frame_attn<T, D><<<(unsigned)blocks, WARPS * 32, smem, st>>>(
      static_cast<const T*>(x.q), static_cast<const T*>(x.k), static_cast<const T*>(x.v),
      static_cast<T*>(x.o), x.qs, x.ks, x.vs, items, F, L, H, scale);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Any other head dim or frame count, bf16 or fp32: frame_attn_any<T>, SIMT, a
// warp per item. (The design is in the note at the top of the file.)

constexpr int ANY_WARPS = 4;  // items a CTA, one a warp
constexpr int ANY_COLS = 8;   // columns of O a lane holds in one pass: 256 a warp

__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Shared memory of a warp, in bytes: the F scores (rounded up to 16 bytes),
// then, staged, the item's q, k and v rows (3 F D elements); the whole rounded
// up to 16 bytes, so that every warp's scores start 16-byte aligned (a bf16
// item with F D odd stages 6 F D = 2 mod 4 bytes).
template <typename T>
__host__ __device__ constexpr size_t any_scores_bytes(int F) {
  return ((size_t)F * sizeof(float) + 15) / 16 * 16;
}
template <typename T>
__host__ __device__ constexpr size_t any_warp_smem(int F, int D, bool staged) {
  return (any_scores_bytes<T>(F) + (staged ? 3 * (size_t)F * D * sizeof(T) : 0) + 15) / 16 * 16;
}

template <typename T>
__global__ void __launch_bounds__(ANY_WARPS * 32)
frame_attn_any(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
               T* __restrict__ o, Strides qs, Strides ks, Strides vs, long items, int F, int L,
               int H, int D, float scale, int staged) {
  extern __shared__ __align__(16) unsigned char any_raw[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long item = (long)blockIdx.x * ANY_WARPS + warp;
  if (item >= items) return;  // whole warps only: no block-wide barrier below

  unsigned char* mine = any_raw + warp * any_warp_smem<T>(F, D, staged != 0);
  float* sc = reinterpret_cast<float*>(mine);
  const long lh = (long)L * H;
  const long b = item / lh;
  const long rem = item - b * lh;  // = l * H + h
  const long base = (b * F * lh + rem) * D;  // the contiguous output's
  const long fstride = lh * D;
  const T* qr = q + item_base(qs, b, (int)rem, H);  // row f of the item at qr + f * qrows
  const T* kr = k + item_base(ks, b, (int)rem, H);
  const T* vr = v + item_base(vs, b, (int)rem, H);
  long long qrows = qs.f, krows = ks.f, vrows = vs.f;
  if (staged) {
    T* st = reinterpret_cast<T*>(mine + any_scores_bytes<T>(F));
    for (long i = lane; i < (long)F * D; i += 32) {
      const long f = i / D;
      const long c = i - f * D;
      st[i] = qr[f * qrows + c];
      st[(long)F * D + i] = kr[f * krows + c];
      st[2 * (long)F * D + i] = vr[f * vrows + c];
    }
    __syncwarp();
    qr = st;
    kr = st + (long)F * D;
    vr = st + 2 * (long)F * D;
    qrows = krows = vrows = D;
  }

  for (int f = 0; f < F; ++f) {
    // Pass 1: s_g = (q_f / sqrt(d)) . k_g in fp32, each lane's columns then
    // the warp's sum (a butterfly: every lane gets the same bits), and the max.
    const T* qf = qr + f * qrows;
    float m = -CUDART_INF_F;
    for (int g = 0; g < F; ++g) {
      const T* kg = kr + g * krows;
      float a = 0.f;
      for (int c = lane; c < D; c += 32) a = fmaf(to_f(qf[c]) * scale, to_f(kg[c]), a);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) a += __shfl_xor_sync(0xffffffffu, a, off);
      if (lane == 0) sc[g] = a;
      m = fmaxf(m, a);
    }
    __syncwarp();
    // Pass 2, over blocks of 32 * ANY_COLS columns: p = exp(s_g - max), the
    // denominator, O += p v_g, all fp32; out = O / denom, rounded once.
    for (int c0 = 0; c0 < D; c0 += 32 * ANY_COLS) {
      float acc[ANY_COLS];
#pragma unroll
      for (int i = 0; i < ANY_COLS; ++i) acc[i] = 0.f;
      float denom = 0.f;
      for (int g = 0; g < F; ++g) {
        const float p = expf(sc[g] - m);
        denom += p;
        const T* vg = vr + g * vrows;
#pragma unroll
        for (int i = 0; i < ANY_COLS; ++i) {
          const int c = c0 + lane + 32 * i;
          if (c < D) acc[i] = fmaf(p, to_f(vg[c]), acc[i]);
        }
      }
      T* of = o + base + f * fstride;
#pragma unroll
      for (int i = 0; i < ANY_COLS; ++i) {
        const int c = c0 + lane + 32 * i;
        if (c < D) of[c] = from_f<T>(acc[i] / denom);
      }
    }
    __syncwarp();  // the scores are read before the next query frame's pass 1
  }
}

template <typename T>
int launch_any(const Operands& x, long items, int F, int L, int H, int D, float scale,
               cudaStream_t st) {
  // Stage the items' rows when four warps' worth fits an SM's shared memory.
  int staged = ANY_WARPS * any_warp_smem<T>(F, D, true) <= (size_t)ANY_MAX_SMEM;
  const size_t smem = ANY_WARPS * any_warp_smem<T>(F, D, staged != 0);
  if (smem > (size_t)ANY_MAX_SMEM) return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      frame_attn_any<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long blocks = (items + ANY_WARPS - 1) / ANY_WARPS;
  frame_attn_any<T><<<(unsigned)blocks, ANY_WARPS * 32, smem, st>>>(
      static_cast<const T*>(x.q), static_cast<const T*>(x.k), static_cast<const T*>(x.v),
      static_cast<T*>(x.o), x.qs, x.ks, x.vs, items, F, L, H, D, scale, staged);
  return (int)cudaGetLastError();
}

}  // namespace

// Dynamic shared memory of a bf16 CTA at head_dim 64 or 72 (0 otherwise).
extern "C" int vdpp_frame_attention_smem(int head_dim) {
  return head_dim == 64 ? FrameLayout<64>::SMEM : head_dim == 72 ? FrameLayout<72>::SMEM : 0;
}

// q, k, v: (batch, frames, L, heads, head_dim), each with head_dim dense and
// the element strides strides[4i .. 4i + 3] = (batch, frame, token, head) of
// q, k, v (i = 0, 1, 2): multiples of 16 bytes, and 16-byte aligned pointers,
// wherever a kernel loads 16-byte vectors or TMA boxes (the wrapper passes
// nothing else). o: the same shape, contiguous and 16-byte aligned. All bf16
// (is_bf16 = 1) or all fp32; any head_dim and frame count whose scores fit
// shared memory. scale = 1 / sqrt(head_dim).
extern "C" int vdpp_frame_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                        const long long* strides, int is_bf16, int batch,
                                        int frames, int L, int heads, int head_dim, float scale,
                                        void* stream) {
  const long lh = (long)L * heads;
  const long items = lh * batch;
  if (head_dim < 1 || frames < 1 || batch <= 0 || L <= 0 || heads <= 0 || lh > 0x7fffffffL ||
      (items + WARPS - 1) / WARPS > 0x7fffffffL) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const Operands x = {q, k, v, o, {strides[0], strides[1], strides[2], strides[3]},
                      {strides[4], strides[5], strides[6], strides[7]},
                      {strides[8], strides[9], strides[10], strides[11]}};
  if ((head_dim != 64 && head_dim != 72) || frames > FMAX) {
    return is_bf16 ? launch_any<__nv_bfloat16>(x, items, frames, L, heads, head_dim, scale, st)
                   : launch_any<float>(x, items, frames, L, heads, head_dim, scale, st);
  }
  if (is_bf16) {
    return head_dim == 72 ? launch_bf16<72>(x, batch, frames, L, heads, scale, st)
                          : launch_bf16<64>(x, batch, frames, L, heads, scale, st);
  }
  return head_dim == 72 ? launch<float, 72>(x, items, frames, L, heads, scale, st)
                        : launch<float, 64>(x, items, frames, L, heads, scale, st);
}

// The largest frame count the kernels take (the generic kernel's scores must
// fit one CTA's shared memory), for the wrapper's check.
extern "C" int vdpp_frame_attention_max_frames() {
  return (int)(ANY_MAX_SMEM / ANY_WARPS / sizeof(float)) - 4;
}
