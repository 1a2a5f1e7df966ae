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
// bf16, head dims 64 (the SVD UNet) and 72 (DiT-XL): flash_fwd_bf16<D, STATIC_MAX>.
// What bounds it: operations at every site. 4 * B*H * Lq * Lk * D flops against
// 989 TFLOP/s dense bf16, beside 4 * B*H * L * D * 2 bytes of q, k, v, o at
// 3.35 TB/s: at L = 9216 (d = 64, B*H = 125) 2.748 ms of operations against
// 0.18 ms of bytes; at L = 2304 0.344 vs 0.044; at DiT's joint3d site (d = 72,
// L = 5120, 16 heads) 0.122 vs 0.014; at its factorized site (L = 640, B*H =
// 128) 0.0153 vs 0.0141; only at L = 576 (B*H = 500) are the bytes larger
// (0.044 vs 0.039 ms). So both products run on wgmma, the only route to the
// tensor cores' full rate, and the design keeps them fed:
//   * a CTA owns (b*h, 128 query rows) and has three warpgroups: two consumer
//     warpgroups of 64 query rows each and one producer warpgroup, of which one
//     thread issues every TMA load; setmaxnreg gives the producer 24 registers
//     and the consumers 240;
//   * Q is loaded once by TMA. K and V tiles of 128 keys come through a ring of
//     3 stages in dynamic shared memory with an mbarrier pair per stage (full:
//     TMA bytes landed; empty: all 8 consumer warps are done with it), so the
//     next two tiles are in flight while the consumers compute;
//   * the tensor maps are 4-D over (D, H, L, B), built on the host for each
//     call with cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint
//     (no -lcuda), and passed as __grid_constant__ parameters. TMA fills rows
//     past L (and columns past D) with zeros;
//   * once Q has landed each consumer warpgroup scales its 64 rows by qscale
//     in fp32 and rounds them to bf16 in place (elementwise, so the swizzle does
//     not matter), then fence.proxy.async.shared::cta makes the generic-proxy
//     writes visible to wgmma's async proxy before a named barrier of the
//     warpgroup: without the fence wgmma may read stale Q;
//   * S = Q'K^T is wgmma m64n128k16 with both operands in shared memory, both
//     K-major, fp32 accumulators (64 a thread);
//   * O += P V is wgmma m64nDk16 with A = P from registers and B = the V tile
//     as stored, (keys x D) with D contiguous, i.e. the N-major ("transposed")
//     B that wgmma allows for 16-bit types. The accumulator layout of S gives
//     thread (warp w, lane 4g + t) of the warpgroup the elements
//       s[4j + e] = S(16w + g + 8 * (e >> 1), 8j + 2t + (e & 1)),  j = 0..15,
//     and the A fragment of a k16 step kk of P V wants, per thread, the bf16
//     pairs {(16w+g, 16kk+2t..), (16w+g+8, 16kk+2t..), (16w+g, 16kk+8+2t..),
//     (16w+g+8, 16kk+8+2t..)} - which are exactly s[8kk + 0..1], s[8kk + 2..3],
//     s[8kk + 4..5], s[8kk + 6..7]. So p[u] = bf16x2(s[2u], s[2u + 1]) is the
//     A operand with no shuffle (the FlashAttention-3 layout identity);
//   * the next tile's S product is issued together with this tile's P V,
//     and the next tile's softmax runs while P V is in flight
//     (wgmma.wait_group 1), so exp2 and the row bookkeeping overlap the
//     tensor cores. At d = 72 the two consumer warpgroups also take turns
//     issuing their products (FA3's ping-pong, two named barriers); at d = 64
//     the turns cost more than they gave (see WgLayout::PINGPONG);
//   * ptxas keeps the wgmma pipeline (no wait after each product) only when
//     no other instruction writes a product's input registers while it runs:
//     the warpgroup index is read through a shuffle so that the descriptors
//     are warp-uniform; P's registers are pinned (empty asm operands) before
//     the products start and until they have landed; the first k-step of S
//     writes its accumulators without reading them; and at d = 64 the last
//     P V's P comes from the loop alone. Each of these, left out, brought back
//     ptxas' advisories C7511-C7513 and a wait after every wgmma;
//   * static max: clamp, exp2, round, sum - nothing is rescaled. Running max:
//     the row max reduces over the 4 threads of a quad (shuffles) and O is
//     rescaled after the P V in flight has landed;
//   * keys >= L_k in the last tile read as zero rows (S = 0, exp2(0) = 1), so
//     they are masked explicitly: p = 0, and left out of the running max;
//     query rows >= L_q are never stored (predicated stores); L_q != L_k works.
// Shared-memory layouts and wgmma descriptors. A 128-byte swizzle takes at
// most 64 bf16 in a box row, so columns 0-63 of Q, K and V are loaded as
// 128-row boxes of 64 columns with CU_TENSOR_MAP_SWIZZLE_128B (a row is 128 B,
// an 8-row swizzle atom 1024 B), described to wgmma as layout B128 with the
// 8-row-group stride SBO = 1024 B. Advancing Q or K one k16 step adds 32 B to
// the descriptor's start address inside the atom; advancing V (N-major, K =
// keys) one k16 step adds 16 rows = 2048 B. At d = 72 = 4 * 16 + 8 columns
// 64-79 come as a second box of 16 columns with CU_TENSOR_MAP_SWIZZLE_32B
// (32-byte rows, layout B32, SBO = 256 B); columns 72-79 lie past D, so TMA
// writes zeros there and no uninitialised shared memory enters a product.
// S takes a fifth k16 step over that tail (zeros times zeros add 0); P V takes
// one m64n16k16 per k-step over it, whose columns 72-79 are dropped. Dynamic
// shared memory per CTA: 115,768 B at d = 64, 144,440 B at d = 72 (with 1 KB
// of alignment slack), so one CTA an SM. ptxas (CUDA 12.9, sm_90a): 168
// registers a thread at launch (384 threads, one CTA an SM), raised to 240 for
// the consumers by setmaxnreg; no spills, except 20 B of spill stores and
// loads in the running-max kernel at d = 72.
//
// fp32 inputs at d = 64 and 72 take a plain SIMT kernel (one query row per
// thread): the tensor cores would round fp32 operands to TF32, and fp32 is off
// the models' paths (the small agreement configs use it).
//
// Head dim 512 (the VAE decoder's mid-block attention: one head, L = 72 * 128 =
// 9216, B = the frames of a decode chunk), fp32 or bf16, takes its own SIMT
// kernel, flash_fwd_d512<T>. One call at B = 4 is 4 * 4 * 9216^2 * 512 = 696
// GFLOP against 67 TFLOP/s fp32 outside the tensor cores, about 10.4 ms, while
// its bytes (302 MB at 3.35 TB/s in fp32) take 0.09 ms: it is bound by fp32 FMA
// throughput. A 64-row x 512 fp32 accumulator would be 128 KB, so a block owns
// only 32 query rows: 8 warps, 4 rows each, every lane holding a 4 x 16 slice
// of the accumulator (64 registers). Q (32 x 512), a K tile and a V tile (32
// keys each) sit in 198 KB of dynamic shared memory as fp32; bf16 inputs are
// converted as they are staged, q' is rounded to bf16, P is rounded to bf16
// before P.V and summed into l as rounded, and the output is rounded to bf16:
// the reference's rounding points. In S = Q'K^T a lane owns one key and its
// warp's 4 rows (Q rows read as broadcasts, K rows padded to 516 floats so the
// lanes' float4 reads hit distinct banks); P goes through a padded 32 x 36
// shared tile, transposed so a warp reads its 4 rows' p for one key as one
// broadcast float4, and P.V reads each V row once per warp as conflict-free
// float4s. No TF32: the fp32 check is 1e-5 x max|plain|. In bf16 the same
// work could run on the tensor cores (0.70 ms at B = 4); this simple kernel
// does not, and takes about as long as in fp32 (its rework is queued).
//
// C interface (bound with ctypes, see vdpp_tpu_torch/ops/flash_attention.py):
// returns a cudaError_t after the launch, launches on the given stream,
// allocates nothing and does not synchronise.

#include <cuda.h>  // CUtensorMap and its enums only: the encode is reached at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

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

// ---------------------------------------------------------------------------
// bf16, d = 64 and 72: TMA + mbarrier ring + wgmma, warp-specialised.

constexpr int WG_NC = 2;          // consumer warpgroups, 64 query rows each
constexpr int WG_BQ = 64 * WG_NC;  // query rows a CTA
constexpr int WG_BK = 128;         // keys a K/V tile
constexpr int WG_STAGES = 3;       // K/V tiles in the ring
constexpr int WG_THREADS = 128 * (WG_NC + 1);  // consumers first, the producer last
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = ((65536 - 128 * PRODUCER_REGS) / (128 * WG_NC)) & ~7;
constexpr int MAIN_COLS = 64;     // columns of the 128-byte-swizzled box
constexpr int TAIL_COLS = 16;     // columns 64..79 of the 32-byte-swizzled box (d = 72)
constexpr int MAIN_ROW = MAIN_COLS * 2;  // bytes of a row in a main box
constexpr int TAIL_ROW = TAIL_COLS * 2;
constexpr int MAIN_TILE = WG_BK * MAIN_ROW;  // 16 KB
constexpr int TAIL_TILE = WG_BK * TAIL_ROW;  // 4 KB

template <int D>
struct WgLayout {
  static_assert(D == 64 || D == 72, "head dims 64 and 72");
  static constexpr bool TAIL = D > MAIN_COLS;
  // The consumer warpgroups take turns issuing their products at d = 72,
  // where that was faster on an H100; at d = 64 the turns cost more than they
  // gave (PERF.md).
  static constexpr bool PINGPONG = TAIL;
  static constexpr int Q_MAIN = 0;
  static constexpr int Q_TAIL = WG_BQ * MAIN_ROW;
  static constexpr int Q_BYTES = WG_BQ * (MAIN_ROW + (TAIL ? TAIL_ROW : 0));
  // A stage: K main, V main, then (d = 72) K tail, V tail.
  static constexpr int K_MAIN = 0;
  static constexpr int V_MAIN = MAIN_TILE;
  static constexpr int K_TAIL = 2 * MAIN_TILE;
  static constexpr int V_TAIL = 2 * MAIN_TILE + TAIL_TILE;
  static constexpr int STAGE_BYTES = 2 * (MAIN_TILE + (TAIL ? TAIL_TILE : 0));
  static constexpr int STAGE0 = Q_BYTES;
  static constexpr int BARS = STAGE0 + WG_STAGES * STAGE_BYTES;  // full[], empty[], q
  static constexpr int SMEM = BARS + 8 * (2 * WG_STAGES + 1) + 1024;  // + alignment slack
  static_assert(Q_BYTES % 1024 == 0 && STAGE_BYTES % 1024 == 0, "1024-byte swizzle atoms");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Returns once the phase of parity `parity` has completed. A wait of more
// than about 10 s (2^34 cycles) traps: a launch that would deadlock fails
// with an error instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long start = clock64();
  while (!mbar_try_wait(bar, parity)) {
    if (clock64() - start > (1ll << 34)) __trap();
  }
}

// One box of a 4-D tensor map (coordinates innermost first: column, head,
// row, batch) into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor: start address >> 4 (bits 0-13), leading
// byte offset >> 4 (16-29; unused by the layouts here, which span one swizzle
// atom in the leading direction), stride byte offset >> 4 (32-45: the stride
// between 8-row groups), layout (62-63: 1 = 128-byte swizzle, 3 = 32-byte).
__device__ __forceinline__ uint64_t wg_desc(uint32_t saddr, uint32_t sbo, uint64_t layout) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (layout << 62);
}
constexpr uint64_t SW128 = 1;
constexpr uint64_t SW32 = 3;

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}
// Ping-pong of the two consumer warpgroups (named barriers 3 and 4, 256
// threads each): warpgroup w waits on its own barrier before it issues
// products and arrives on the other's after, so one warpgroup's products run
// while the other does its softmax.
template <bool ON>
__device__ __forceinline__ void pingpong_wait(int wg) {
  if (ON) asm volatile("bar.sync %0, 256;" ::"r"(3 + wg) : "memory");
}
template <bool ON>
__device__ __forceinline__ void pingpong_pass(int wg) {
  if (ON) asm volatile("bar.arrive %0, 256;" ::"r"(4 - wg) : "memory");
}

// Keeps the compiler from moving accumulator registers across an async wgmma.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
// Keeps P's registers (the A operand of P V) from being reused before the
// product has read them: ptxas would otherwise serialize the wgmmas.
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// S(64 x 128, fp32) (+)= A(64 x 16, bf16, shared) * B(128 x 16, bf16, shared)^T, both K-major.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// S(64 x 128, fp32) = A(64 x 16) * B(128 x 16)^T, the first k16 step: the
// accumulators are written, not read (scale-d 0), so the compiler keeps no
// earlier value of them alive across the asynchronous product.
__device__ __forceinline__ void wgmma_ss_n128_first(float (&d)[64], uint64_t da,
                                                    uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]),
        "=f"(d[6]), "=f"(d[7]), "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]),
        "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]), "=f"(d[16]), "=f"(d[17]),
        "=f"(d[18]), "=f"(d[19]), "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]),
        "=f"(d[30]), "=f"(d[31]), "=f"(d[32]), "=f"(d[33]), "=f"(d[34]), "=f"(d[35]),
        "=f"(d[36]), "=f"(d[37]), "=f"(d[38]), "=f"(d[39]), "=f"(d[40]), "=f"(d[41]),
        "=f"(d[42]), "=f"(d[43]), "=f"(d[44]), "=f"(d[45]), "=f"(d[46]), "=f"(d[47]),
        "=f"(d[48]), "=f"(d[49]), "=f"(d[50]), "=f"(d[51]), "=f"(d[52]), "=f"(d[53]),
        "=f"(d[54]), "=f"(d[55]), "=f"(d[56]), "=f"(d[57]), "=f"(d[58]), "=f"(d[59]),
        "=f"(d[60]), "=f"(d[61]), "=f"(d[62]), "=f"(d[63])
      : "l"(da), "l"(db), "r"(0));
}

// O(64 x 64, fp32) += P(64 x 16, bf16, registers) * V(16 x 64, bf16, shared, N-major).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// O(64 x 16, fp32) += P(64 x 16, bf16, registers) * V(16 x 16, bf16, shared, N-major).
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// Both products of one key tile for one consumer warpgroup. `stage` is the
// tile's shared address; dq / dqt the warpgroup's Q descriptors.
template <int D>
__device__ __forceinline__ void issue_s(float (&s)[64], uint64_t dq, uint64_t dqt,
                                        uint32_t stage) {
  using L = WgLayout<D>;
  const uint64_t dk = wg_desc(stage + L::K_MAIN, 1024, SW128);
#pragma unroll
  for (int kk = 0; kk < MAIN_COLS / 16; ++kk) {
    if (kk == 0) {
      wgmma_ss_n128_first(s, dq, dk);
    } else {
      wgmma_ss_n128(s, dq + 2 * kk, dk + 2 * kk, 1);  // +32 B a k16 step
    }
  }
  if (L::TAIL) wgmma_ss_n128(s, dqt, wg_desc(stage + L::K_TAIL, 256, SW32), 1);
}

template <int D>
__device__ __forceinline__ void issue_pv(float (&o)[32], float (&ot)[8], const uint32_t (&p)[32],
                                         uint32_t stage) {
  using L = WgLayout<D>;
  const uint64_t dv = wg_desc(stage + L::V_MAIN, 1024, SW128);
  const uint64_t dvt = wg_desc(stage + L::V_TAIL, 256, SW32);
#pragma unroll
  for (int kk = 0; kk < WG_BK / 16; ++kk) {
    const uint32_t a[4] = {p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3]};
    wgmma_rs_n64(o, a, dv + kk * (2048 >> 4));  // +16 keys = 2048 B
    if (L::TAIL) wgmma_rs_n16(ot, a, dvt + kk * (512 >> 4));  // +16 keys = 512 B
  }
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// One tile's P from its S, in place: s[u] (u < 32) becomes the bf16 pair
// (s[2u], s[2u+1]) rounded to nearest, which is p[u] of P V's A operand (u
// ascending, so no pair is overwritten before it is read).
// lp[u & 3] sums the rounded values of row u & 1 (two partial sums a row).
// Running max: the new row max goes into m and the factor l and O are to be
// rescaled by into alpha (l is rescaled here, O by the caller once the P V in
// flight has landed). Keys >= Lk get p = 0 and stay out of the max.
template <bool STATIC_MAX, bool MASKED>
__device__ __forceinline__ void softmax_tile(float (&s)[64], float (&m)[2], float (&lp)[4],
                                             float (&alpha)[2], int k0, int Lk, int t) {
  float mr[2] = {0.f, 0.f};  // the row max subtracted (running max only)
  if (!STATIC_MAX) {
    float mt[2] = {MASK_VALUE, MASK_VALUE};
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const int key = k0 + 8 * (i >> 2) + 2 * t + (i & 1);
      if (!MASKED || key < Lk) mt[(i >> 1) & 1] = fmaxf(mt[(i >> 1) & 1], s[i]);
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {  // a row's 128 keys are spread over the 4 threads of a quad
      mt[j] = fmaxf(mt[j], __shfl_xor_sync(0xffffffffu, mt[j], 1));
      mt[j] = fmaxf(mt[j], __shfl_xor_sync(0xffffffffu, mt[j], 2));
      const float m_new = fmaxf(m[j], mt[j]);
      alpha[j] = ex2(m[j] - m_new);
      m[j] = m_new;
      mr[j] = m_new;
      lp[j] *= alpha[j];
      lp[j + 2] *= alpha[j];
    }
  }
#pragma unroll
  for (int u = 0; u < 32; ++u) {
    float e[2];
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int i = 2 * u + c;
      const float x = STATIC_MAX ? fminf(fmaxf(s[i], S_CLAMP_LO), S_CLAMP) : s[i] - mr[u & 1];
      e[c] = ex2(x);
      if (MASKED && k0 + 8 * (i >> 2) + 2 * t + c >= Lk) e[c] = 0.f;
    }
    const uint32_t w = pack_bf16(e[0], e[1]);
    lp[u & 3] += __uint_as_float(w << 16) + __uint_as_float(w & 0xffff0000u);
    s[u] = __uint_as_float(w);
  }
}

template <bool STATIC_MAX>
__device__ __forceinline__ void softmax(float (&s)[64], float (&m)[2], float (&lp)[4],
                                        float (&alpha)[2], int k0, int Lk, int t) {
  if (k0 + WG_BK <= Lk) {
    softmax_tile<STATIC_MAX, false>(s, m, lp, alpha, k0, Lk, t);
  } else {
    softmax_tile<STATIC_MAX, true>(s, m, lp, alpha, k0, Lk, t);
  }
}

// P V's A operand from the packed words softmax left in s[0..31].
__device__ __forceinline__ void take_p(uint32_t (&p)[32], const float (&s)[64]) {
#pragma unroll
  for (int u = 0; u < 32; ++u) p[u] = __float_as_uint(s[u]);
}

// q' = bf16(q * qscale) for 8 bf16 values.
__device__ __forceinline__ void scale_q8(uint4& x, float qscale) {
  uint32_t* w = reinterpret_cast<uint32_t*>(&x);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    w[i] = pack_bf16(f.x * qscale, f.y * qscale);
  }
}

// Tile j of a consumer warpgroup: S of tile j and P V of tile j - 1 (P in p)
// are issued together; the softmax of tile j runs while P V does; once P V
// has landed O is rescaled (running max), stage j - 1 is freed and p takes
// tile j's P.
template <int D, bool STATIC_MAX>
__device__ __forceinline__ void tile_step(int j, float (&s)[64], uint32_t (&pa)[32],
                                          float (&acc)[32], float (&acct)[8],
                                          float (&m)[2], float (&lp)[4], float (&alpha)[2],
                                          uint32_t stage0, uint64_t dq, uint64_t dqt,
                                          uint32_t full0, uint32_t empty0, int Lk, int wg) {
  using L = WgLayout<D>;
  const int sj = j % WG_STAGES;
  const int sp = (j - 1) % WG_STAGES;
  mbar_wait(full0 + 8 * sj, (j / WG_STAGES) & 1);
  pingpong_wait<L::PINGPONG>(wg);
  fence_regs(pa);  // P and O are final before the products start
  fence_regs(acc);
  fence_regs(acct);
  wg_fence();
  issue_s<D>(s, dq, dqt, stage0 + sj * L::STAGE_BYTES);
  wg_commit();
  issue_pv<D>(acc, acct, pa, stage0 + sp * L::STAGE_BYTES);
  wg_commit();
  pingpong_pass<L::PINGPONG>(wg);
  wg_wait<1>();  // S of tile j has landed; P V of tile j - 1 may still run
  fence_regs(s);
  softmax<STATIC_MAX>(s, m, lp, alpha, j * WG_BK, Lk, threadIdx.x & 3);
  fence_regs(s);  // the softmax stays ahead of the wait below
  wg_wait<0>();
  fence_regs(acc);
  fence_regs(acct);
  fence_regs(pa);
  if ((threadIdx.x & 31) == 0) mbar_arrive(empty0 + 8 * sp);  // tile j - 1 is done with
  if (!STATIC_MAX) {
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] *= alpha[(i >> 1) & 1];
#pragma unroll
    for (int i = 0; i < 8; ++i) acct[i] *= alpha[(i >> 1) & 1];
  }
  take_p(pa, s);
}

// P V of the last tile.
template <int D>
__device__ __forceinline__ void last_pv(float (&acc)[32], float (&acct)[8], uint32_t (&p)[32],
                                        uint32_t stage, int wg) {
  using L = WgLayout<D>;
  pingpong_wait<L::PINGPONG>(wg);
  fence_regs(p);
  fence_regs(acc);
  fence_regs(acct);
  wg_fence();
  issue_pv<D>(acc, acct, p, stage);
  wg_commit();
  if (wg == 0) pingpong_pass<L::PINGPONG>(wg);  // for warpgroup 1's last issue
  wg_wait<0>();
  fence_regs(acc);
  fence_regs(acct);
  fence_regs(p);
}

template <int D, bool STATIC_MAX>
__global__ void __launch_bounds__(WG_THREADS, 1)
flash_fwd_bf16(const __grid_constant__ CUtensorMap q_map,
               const __grid_constant__ CUtensorMap k_map,
               const __grid_constant__ CUtensorMap v_map,
               const __grid_constant__ CUtensorMap qt_map,  // columns 64..79 (d = 72)
               const __grid_constant__ CUtensorMap kt_map,
               const __grid_constant__ CUtensorMap vt_map, __nv_bfloat16* __restrict__ o, int H,
               int Lq, int Lk, float qscale) {
  using L = WgLayout<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // swizzle atoms sit on 1024-byte boundaries
  uint8_t* smem = smem_raw + (base - raw);
  const uint32_t full0 = base + L::BARS;
  const uint32_t empty0 = full0 + 8 * WG_STAGES;
  const uint32_t qbar = empty0 + 8 * WG_STAGES;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = blockIdx.x * WG_BQ;
  const int nk = (Lk + WG_BK - 1) / WG_BK;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < WG_STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);              // the producer's arrive, plus the TMA bytes
      mbar_init(empty0 + 8 * s, 4 * WG_NC);     // one arrive per consumer warp
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp >= 4 * WG_NC) {
    // Producer warpgroup: one thread keeps the ring full.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS) : "memory");
    if (threadIdx.x == 128 * WG_NC) {
      mbar_expect_tx(qbar, L::Q_BYTES);
      tma_load_4d(base + L::Q_MAIN, &q_map, qbar, 0, h, q0, b);
      if (L::TAIL) tma_load_4d(base + L::Q_TAIL, &qt_map, qbar, MAIN_COLS, h, q0, b);
      for (int j = 0; j < nk; ++j) {
        const int s = j % WG_STAGES;
        mbar_wait(empty0 + 8 * s, ((j / WG_STAGES) & 1) ^ 1);  // the first round passes
        const uint32_t full = full0 + 8 * s;
        const uint32_t st = base + L::STAGE0 + s * L::STAGE_BYTES;
        mbar_expect_tx(full, L::STAGE_BYTES);
        tma_load_4d(st + L::K_MAIN, &k_map, full, 0, h, j * WG_BK, b);
        tma_load_4d(st + L::V_MAIN, &v_map, full, 0, h, j * WG_BK, b);
        if (L::TAIL) {
          tma_load_4d(st + L::K_TAIL, &kt_map, full, MAIN_COLS, h, j * WG_BK, b);
          tma_load_4d(st + L::V_TAIL, &vt_map, full, MAIN_COLS, h, j * WG_BK, b);
        }
      }
    }
  } else {
    // Consumer warpgroup wg: query rows q0 + 64 * wg ... + 63.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS) : "memory");
    // The warpgroup index from lane 0, so that the compiler sees it uniform
    // and keeps the wgmma descriptors in uniform registers.
    const int wg = __shfl_sync(0xffffffffu, warp >> 2, 0);
    const int tw = threadIdx.x & 127;
    const int g = lane >> 2;
    const int t = lane & 3;
    const uint32_t qm_off = L::Q_MAIN + wg * 64 * MAIN_ROW;
    const uint32_t qt_off = L::Q_TAIL + wg * 64 * TAIL_ROW;

    mbar_wait(qbar, 0);
    {
      uint4* qm = reinterpret_cast<uint4*>(smem + qm_off);
#pragma unroll
      for (int i = 0; i < 64 * MAIN_ROW / 16 / 128; ++i) scale_q8(qm[tw + 128 * i], qscale);
      if (L::TAIL) scale_q8(reinterpret_cast<uint4*>(smem + qt_off)[tw], qscale);
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // before wgmma reads Q'
      asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");
    }
    const uint64_t dq = wg_desc(base + qm_off, 8 * MAIN_ROW, SW128);
    const uint64_t dqt = wg_desc(base + qt_off, 8 * TAIL_ROW, SW32);

    float s[64];
    uint32_t p[32];  // P of the tile whose P V is issued next
    float acc[32];
    float acct[8];  // columns 64..79 at d = 72 (72..79 dropped)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) acct[i] = 0.f;
    float m[2] = {MASK_VALUE, MASK_VALUE};
    float lp[4] = {0.f, 0.f, 0.f, 0.f};
    float alpha[2];

    if (wg == 1) pingpong_pass<L::PINGPONG>(wg);  // warpgroup 0 issues first
    mbar_wait(full0, 0);
    pingpong_wait<L::PINGPONG>(wg);
    wg_fence();
    issue_s<D>(s, dq, dqt, base + L::STAGE0);
    wg_commit();
    pingpong_pass<L::PINGPONG>(wg);
    wg_wait<0>();
    fence_regs(s);
    softmax<STATIC_MAX>(s, m, lp, alpha, 0, Lk, t);
    take_p(p, s);

    const uint32_t stage0 = base + L::STAGE0;
    // Tiles 1 .. nk - 1. ptxas keeps the wgmma pipeline only where it can
    // prove the registers of P and O free of other writes: at d = 64 that
    // takes a last P V whose P comes from the loop alone (nk == 1 apart, a
    // loop that runs at least once); at d = 72 the plain loop, since the
    // split costs the registers the pipeline needs (ptxas C7511 / C7513
    // otherwise, and every wgmma then waits for the one before it).
    if (L::TAIL) {
      for (int j = 1; j < nk; ++j) {
        tile_step<D, STATIC_MAX>(j, s, p, acc, acct, m, lp, alpha, stage0, dq, dqt, full0,
                                 empty0, Lk, wg);
      }
      last_pv<D>(acc, acct, p, stage0 + ((nk - 1) % WG_STAGES) * L::STAGE_BYTES, wg);
    } else if (nk == 1) {
      last_pv<D>(acc, acct, p, stage0, wg);
    } else {
      int j = 1;
      do {
        tile_step<D, STATIC_MAX>(j, s, p, acc, acct, m, lp, alpha, stage0, dq, dqt, full0,
                                 empty0, Lk, wg);
      } while (++j < nk);
      last_pv<D>(acc, acct, p, stage0 + ((nk - 1) % WG_STAGES) * L::STAGE_BYTES, wg);
    }

    float inv[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float l = lp[j] + lp[j + 2];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      inv[j] = l == 0.f ? 1.f : 1.f / l;
    }
    const long rs = (long)H * D;
    const int r0 = q0 + wg * 64 + (warp & 3) * 16 + g;  // this thread's rows: r0, r0 + 8
    __nv_bfloat16* ob = o + ((long)b * Lq * H + h) * D;
#pragma unroll
    for (int j = 0; j < MAIN_COLS / 8; ++j) {
      const int c = 8 * j + 2 * t;
      if (r0 < Lq) {
        *reinterpret_cast<uint32_t*>(ob + r0 * rs + c) =
            pack_bf16(acc[4 * j] * inv[0], acc[4 * j + 1] * inv[0]);
      }
      if (r0 + 8 < Lq) {
        *reinterpret_cast<uint32_t*>(ob + (r0 + 8) * rs + c) =
            pack_bf16(acc[4 * j + 2] * inv[1], acc[4 * j + 3] * inv[1]);
      }
    }
    if (L::TAIL) {
      const int c = MAIN_COLS + 2 * t;
      if (r0 < Lq) {
        *reinterpret_cast<uint32_t*>(ob + r0 * rs + c) = pack_bf16(acct[0] * inv[0],
                                                                   acct[1] * inv[0]);
      }
      if (r0 + 8 < Lq) {
        *reinterpret_cast<uint32_t*>(ob + (r0 + 8) * rs + c) = pack_bf16(acct[2] * inv[1],
                                                                         acct[3] * inv[1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// fp32, d = 64 and 72: SIMT, one query row a thread.

constexpr int BK = 64;          // keys per shared-memory tile
constexpr int THREADS = 128;    // 4 warps
constexpr int BQ_F32 = THREADS; // query rows per block (1 per thread)

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

// ---------------------------------------------------------------------------
// d = 512, fp32 or bf16: SIMT, 32 query rows a block.

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

// 4 consecutive elements as fp32 (8- or 16-byte aligned), and back.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ void store4(float* p, float4 x) { *reinterpret_cast<float4*>(p) = x; }
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 x) {
  *reinterpret_cast<uint2*>(p) = make_uint2(pack_bf16(x.x, x.y), pack_bf16(x.z, x.w));
}

// T = float or __nv_bfloat16 in global memory; fp32 in shared memory and in
// every product. For bf16, q' and P are rounded to bf16 as the reference does.
template <typename T, bool STATIC_MAX>
__global__ void __launch_bounds__(THREADS_512)
flash_fwd_d512(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
               T* __restrict__ o, int H, int Lq, int Lk, float qscale) {
  constexpr bool BF16 = std::is_same<T, __nv_bfloat16>::value;
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
  const T* qb = q + ((long)b * Lq * H + h) * D512;
  const T* kb = k + ((long)b * Lk * H + h) * D512;
  const T* vb = v + ((long)b * Lk * H + h) * D512;
  T* ob = o + ((long)b * Lq * H + h) * D512;
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
      x = load4(qb + (q0 + row) * rs + col);
      x.x *= qscale;
      x.y *= qscale;
      x.z *= qscale;
      x.w *= qscale;
      if (BF16) x = make_float4(round_bf16(x.x), round_bf16(x.y), round_bf16(x.z), round_bf16(x.w));
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
        kv = load4(kb + (k0 + row) * rs + col);
        vv = load4(vb + (k0 + row) * rs + col);
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
    for (int i = 0; i < ROWS_PER_WARP; ++i) {
      if (BF16) p[i] = round_bf16(p[i]);
      lpart[i] += p[i];
    }
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
        store4(ob + r * rs + c * 128 + lane * 4,
               make_float4(acc[i][4 * c] * inv, acc[i][4 * c + 1] * inv, acc[i][4 * c + 2] * inv,
                           acc[i][4 * c + 3] * inv));
      }
    }
  }
}

template <typename T, bool STATIC_MAX>
cudaError_t launch_d512(const void* q, const void* k, const void* v, void* o, int bh, int H,
                        int Lq, int Lk, float qscale, cudaStream_t st) {
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_d512<T, STATIC_MAX>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_512);
  if (err != cudaSuccess) return err;
  const dim3 grid((Lq + BQ_512 - 1) / BQ_512, bh);
  flash_fwd_d512<T, STATIC_MAX><<<grid, THREADS_512, SMEM_512, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), H, Lq, Lk, qscale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o, int bh, int H,
                       int Lq, int Lk, int static_max, float qscale, cudaStream_t st) {
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
  return cudaGetLastError();
}

// cuTensorMapEncodeTiled, looked up by name at first use so that the library
// links against the CUDA runtime alone (no -lcuda).
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiledFn>(p);
    }
  }
  return fn;
}

// A bf16 (B, L, H, D) tensor as a 4-D map over (D, H, L, B), whose box is
// `cols` columns from the coordinate the kernel gives, one head, `rows` rows.
bool tensor_map(EncodeTiledFn encode, CUtensorMap* map, const void* ptr, int D, int H, int L,
                int B, int cols, int rows, CUtensorMapSwizzle swizzle) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)L, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)H * D * 2,
                                 (cuuint64_t)L * H * D * 2};
  const cuuint32_t box[4] = {(cuuint32_t)cols, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
                box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D, bool STATIC_MAX>
cudaError_t launch_bf16(const CUtensorMap (&maps)[6], void* o, int bh, int H, int Lq, int Lk,
                        float qscale, cudaStream_t st) {
  constexpr int smem = WgLayout<D>::SMEM;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_bf16<D, STATIC_MAX>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Lq + WG_BQ - 1) / WG_BQ, bh);
  flash_fwd_bf16<D, STATIC_MAX><<<grid, WG_THREADS, smem, st>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], maps[5], static_cast<__nv_bfloat16*>(o), H,
      Lq, Lk, qscale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_d_bf16(const void* q, const void* k, const void* v, void* o, int batch, int H,
                          int Lq, int Lk, int static_max, float qscale, cudaStream_t st) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  // q, k, v main boxes (columns 0-63), then their tails (columns 64-79, d = 72).
  CUtensorMap maps[6];
  const void* ptrs[3] = {q, k, v};
  const int lens[3] = {Lq, Lk, Lk};
  for (int i = 0; i < 3; ++i) {
    const int rows = i == 0 ? WG_BQ : WG_BK;
    if (!tensor_map(encode, &maps[i], ptrs[i], D, H, lens[i], batch, MAIN_COLS, rows,
                    CU_TENSOR_MAP_SWIZZLE_128B)) {
      return cudaErrorInvalidValue;
    }
    if (!WgLayout<D>::TAIL) {
      maps[i + 3] = maps[i];  // not read
    } else if (!tensor_map(encode, &maps[i + 3], ptrs[i], D, H, lens[i], batch, TAIL_COLS, rows,
                           CU_TENSOR_MAP_SWIZZLE_32B)) {
      return cudaErrorInvalidValue;
    }
  }
  const int bh = batch * H;
  return static_max ? launch_bf16<D, true>(maps, o, bh, H, Lq, Lk, qscale, st)
                    : launch_bf16<D, false>(maps, o, bh, H, Lq, Lk, qscale, st);
}

}  // namespace

// q, o: (batch, lq, heads, head_dim); k, v: (batch, lk, heads, head_dim); all
// contiguous and 16-byte aligned, all bf16 (is_bf16 = 1) or all fp32; head_dim
// 64, 72 or 512. qscale = log2(e) / sqrt(head_dim).
extern "C" int vdpp_flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                        int is_bf16, int batch, int heads, int lq, int lk,
                                        int head_dim, int static_max, float qscale,
                                        void* stream) {
  if (batch <= 0 || heads <= 0 || lq <= 0 || lk <= 0 || (long)batch * heads > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int bh = batch * heads;
  if (head_dim == D512) {
    if (is_bf16) {
      return (int)(static_max
                       ? launch_d512<__nv_bfloat16, true>(q, k, v, o, bh, heads, lq, lk, qscale, st)
                       : launch_d512<__nv_bfloat16, false>(q, k, v, o, bh, heads, lq, lk, qscale,
                                                           st));
    }
    return (int)(static_max ? launch_d512<float, true>(q, k, v, o, bh, heads, lq, lk, qscale, st)
                            : launch_d512<float, false>(q, k, v, o, bh, heads, lq, lk, qscale, st));
  }
  if (head_dim == 64) {
    return (int)(is_bf16 ? launch_d_bf16<64>(q, k, v, o, batch, heads, lq, lk, static_max, qscale,
                                             st)
                         : launch_f32<64>(q, k, v, o, bh, heads, lq, lk, static_max, qscale, st));
  }
  if (head_dim == 72) {
    return (int)(is_bf16 ? launch_d_bf16<72>(q, k, v, o, batch, heads, lq, lk, static_max, qscale,
                                             st)
                         : launch_f32<72>(q, k, v, o, bh, heads, lq, lk, static_max, qscale, st));
  }
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory of one CTA of the bf16 kernel at head_dim 64 or 72
// (0 for other head dims), for reports.
extern "C" int vdpp_flash_attention_bf16_smem(int head_dim) {
  return head_dim == 64 ? WgLayout<64>::SMEM : head_dim == 72 ? WgLayout<72>::SMEM : 0;
}
