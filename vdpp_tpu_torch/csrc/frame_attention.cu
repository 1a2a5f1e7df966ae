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
// bf16, head dims 64 and 72: frame_attn_tma<D, FP>.
//   * Loads by TMA, with no copy of the tensors: q, k, v and o are each a 4-D
//     tensor map over (D, L*H, F, B), with byte strides 2 D, 2 D L H and
//     2 D L H F, whose box is one item's FP frames: D columns, one item, FP
//     rows. FP is
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
// C interface (bound with ctypes, see
// vdpp_tpu_torch/ops/temporal_attention_kernel.py): returns a cudaError_t
// after the launch, launches on the given stream, allocates nothing and does
// not synchronise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "hopper.cuh"  // smem_u32, mbarriers, tma_load_4d, encode_tiled

namespace {

constexpr int FMAX = 32;  // frames

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

template <int D, int FP>
__global__ void __launch_bounds__(FA_THREADS)
frame_attn_tma(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
               const __grid_constant__ CUtensorMap v_map, const __grid_constant__ CUtensorMap o_map,
               int F, int LH, int tiles_per_batch, int ntiles, float scale) {
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
        tma_load_4d(slot + t * ITEM, &q_map, full, 0, t0 + t, 0, b);
        tma_load_4d(slot + Lay::TENSOR + t * ITEM, &k_map, full, 0, t0 + t, 0, b);
        tma_load_4d(slot + 2 * Lay::TENSOR + t * ITEM, &v_map, full, 0, t0 + t, 0, b);
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

// A bf16 (B, F, L*H, D) tensor as a 4-D map over (D, L*H, F, B) whose box is
// one item's FP frames.
bool frame_map(EncodeTiledFn encode, CUtensorMap* map, const void* ptr, int D, long LH, int F,
               int B, int FP) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)LH, (cuuint64_t)F, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)LH * D * 2,
                                 (cuuint64_t)F * LH * D * 2};
  const cuuint32_t box[4] = {(cuuint32_t)D, 1, (cuuint32_t)FP, 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
                box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                D == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D, int FP>
int launch_tma(const void* q, const void* k, const void* v, void* o, int B, int F, long LH,
               float scale, cudaStream_t st) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
  CUtensorMap maps[4];
  const void* ptrs[4] = {q, k, v, o};
  for (int i = 0; i < 4; ++i) {
    if (!frame_map(encode, &maps[i], ptrs[i], D, LH, F, B, FP)) return (int)cudaErrorInvalidValue;
  }
  constexpr int smem = FrameLayout<D>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(frame_attn_tma<D, FP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, frame_attn_tma<D, FP>,
                                                        FA_THREADS, smem);
  }
  if (err != cudaSuccess) return (int)err;
  constexpr int T = FA_ROWS / FP;
  const long tiles_per_batch = (LH + T - 1) / T;
  const long ntiles = tiles_per_batch * B;
  if (ntiles > 0x7fffffffL || per_sm < 1) return (int)cudaErrorInvalidValue;
  const int grid = (int)(ntiles < (long)sms * per_sm ? ntiles : (long)sms * per_sm);
  frame_attn_tma<D, FP><<<grid, FA_THREADS, smem, st>>>(maps[0], maps[1], maps[2], maps[3], F,
                                                         (int)LH, (int)tiles_per_batch,
                                                         (int)ntiles, scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* o, int B, int F, long LH,
                float scale, cudaStream_t st) {
  return F <= 16 ? launch_tma<D, 16>(q, k, v, o, B, F, LH, scale, st)
                 : launch_tma<D, 32>(q, k, v, o, B, F, LH, scale, st);
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
           T* __restrict__ o, long items, int F, int L, int H, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long item = (long)blockIdx.x * WARPS + warp;
  if (item >= items) return;  // whole warps only: no block-wide barrier below

  constexpr int QROW = q_row<T, D>();
  T* qs = reinterpret_cast<T*>(smem_raw + warp * warp_smem<T, D>(F));
  T* ks = qs + F * QROW;
  T* vs = ks + F * D;

  const long lh = (long)L * H;
  const long b = item / lh;
  const long rem = item - b * lh;  // = l * H + h
  const long base = (b * F * lh + rem) * D;
  const long fstride = lh * D;
  load_rows<T, D>(qs, QROW, q + base, fstride, F, lane);
  load_rows<T, D>(ks, D, k + base, fstride, F, lane);
  load_rows<T, D>(vs, D, v + base, fstride, F, lane);
  __syncwarp();

  // Shared rows are read 16 bytes at a time (V elements): k and v rows as
  // broadcasts, one load feeding V FMAs.
  constexpr int V = 16 / sizeof(T);
  const int f = lane < F ? lane : 0;  // lanes past F shadow frame 0 and store nothing
  float qf[D];
#pragma unroll
  for (int j = 0; j < D / V; ++j) {
    const uint4 raw = reinterpret_cast<const uint4*>(qs + f * QROW)[j];
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
    for (int d = 0; d < D; ++d) qs[lane * QROW + d] = from_f<T>(acc[d] / denom);
  }
  __syncwarp();
  constexpr int PER_ROW = D / V;
  for (int i = lane; i < F * PER_ROW; i += 32) {
    const int fr = i / PER_ROW;
    const int c = (i - fr * PER_ROW) * V;
    *reinterpret_cast<uint4*>(o + base + fr * fstride + c) =
        *reinterpret_cast<const uint4*>(qs + fr * QROW + c);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, long items, int F, int L, int H,
           float scale, cudaStream_t st) {
  const size_t smem = WARPS * warp_smem<T, D>(F);
  const cudaError_t err = cudaFuncSetAttribute(
      frame_attn<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long blocks = (items + WARPS - 1) / WARPS;
  frame_attn<T, D><<<(unsigned)blocks, WARPS * 32, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), items, F, L, H, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Dynamic shared memory of a bf16 CTA at head_dim 64 or 72 (0 otherwise).
extern "C" int vdpp_frame_attention_smem(int head_dim) {
  return head_dim == 64 ? FrameLayout<64>::SMEM : head_dim == 72 ? FrameLayout<72>::SMEM : 0;
}

// q, k, v, o: (batch, frames, L, heads, head_dim) contiguous, 16-byte aligned,
// all bf16 (is_bf16 = 1) or all fp32; head_dim 64 or 72, 1 <= frames <= 32.
// scale = 1 / sqrt(head_dim).
extern "C" int vdpp_frame_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                        int is_bf16, int batch, int frames, int L, int heads,
                                        int head_dim, float scale, void* stream) {
  const long lh = (long)L * heads;
  const long items = lh * batch;
  if ((head_dim != 64 && head_dim != 72) || frames < 1 || frames > FMAX || batch <= 0 ||
      L <= 0 || heads <= 0 || lh > 0x7fffffffL || (items + WARPS - 1) / WARPS > 0x7fffffffL) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return head_dim == 72 ? launch_bf16<72>(q, k, v, o, batch, frames, lh, scale, st)
                          : launch_bf16<64>(q, k, v, o, batch, frames, lh, scale, st);
  }
  return head_dim == 72 ? launch<float, 72>(q, k, v, o, items, frames, L, heads, scale, st)
                        : launch<float, 64>(q, k, v, o, items, frames, L, heads, scale, st);
}
