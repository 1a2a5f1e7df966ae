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
// bf16, head dims 64 (the SVD UNet) and 72 (DiT-XL): flash_fwd_bf16<D, STATIC_MAX, EXP_BF16>.
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
// thread) in static max, and the generic kernel below in running max, where
// it measured 26-31 % faster (it was 14-16 % slower in static max; PERF.md):
// the tensor cores would round fp32 operands to TF32, and fp32 is off the
// models' paths (the small agreement configs use it).
//
// Head dim 512 (the VAE decoder's mid-block attention: one head, L = 72 * 128 =
// 9216 for SVD and 40 * 64 = 2560 for DiT, B = the frames of a decode chunk,
// 4, or 1 for the last chunk of 25 frames) has a kernel for each dtype.
//
// bf16: flash_fwd_d512_bf16<STATIC_MAX, EXP_BF16>. One call at B = 4, L = 9216 is
// 4 * 4 * 9216^2 * 512 = 696 GFLOP, 0.70 ms at 989 TFLOP/s, against 0.05 ms
// of bytes: bound by operations, so both products run on wgmma, with the
// parts of flash_fwd_bf16 (4-D tensor maps, mbarriers with TMA byte counts,
// B128 descriptors, the in-place q' scale behind fence.proxy.async, P from
// S's accumulators by the FA3 layout identity). What is new is the budget:
//   * registers: a 64-row x 512 fp32 O is 256 registers a thread for one
//     warpgroup, and wgmma's N is at most 256. So two warpgroups own the same
//     64 query rows and split d: warpgroup wg holds O(:, 256wg ... 256wg +
//     255), 128 fp32 registers a thread, and P V is m64n256k16 with B = the
//     V tile's 4 boxes of its columns (N-major, LBO = 8 KB from box to box,
//     SBO = 1 KB from one 8-key group to the next). With S (64 x 64: 32
//     registers) and P (16) that is more than 168, and ptxas caps a thread at
//     168 whenever one of the SM's four register-file quarters holds three
//     warps, as it does with a producer warp or warpgroup beside the two,
//     setmaxnreg or not (it then spilled O and serialised every wgmma). So
//     the CTA is the two warpgroups alone, 8 warps, 255 registers a thread
//     (ptxas: 208 in static-max mode, 211 in running-max, no spills), and
//     thread 0 issues the TMA loads between its own work;
//   * S: each warpgroup computes the partial S over its own 256 columns of d
//     (16 k16 steps of m64n64k16, A = Q', B = K, both K-major from shared
//     memory), writes it to shared memory, and after one named barrier of
//     both warpgroups adds the other's partial to its own. fp32 addition is
//     commutative, so both hold a bitwise-equal S, run the same softmax and
//     get the same P and l with no further exchange; in running-max mode
//     each rescales its own half of O. The two 16 KB exchange buffers swap
//     roles each tile, so one barrier a tile suffices;
//   * shared memory (230,432 B of the 232,448 a CTA may have): Q' 64 x 512
//     bf16 = 64 KB as 8 TMA boxes of 64 columns (one 128-byte swizzle row
//     each), a K tile of 64 keys = 64 KB and a V tile = 64 KB (8 boxes each),
//     the exchange 2 x 16 KB, 4 mbarriers and 1 KB of alignment slack. That
//     leaves room for one K and one V tile, each with its own barrier: thread
//     0 loads K(j + 1) right after the exchange barrier of tile j (both S(j)
//     are done with K), under the softmax and P V(j), and V(j + 1) once both
//     warpgroups' P V(j) have arrived on the V-empty barrier, under S(j + 1)
//     and its softmax;
//   * a tile runs S(j), the exchange and softmax, then P V(j): the products
//     do not overlap the softmax. Issuing S(j + 1) beside P V(j), as
//     flash_fwd_bf16 does, needs O, S and P live at once and measured slower
//     here (PERF.md);
//   * what bounds it in practice: a CTA of 64 rows streams all of K and V
//     from L2 (64 FLOP a byte, 10.9 GB of L2 reads at B = 4, L = 9216), and
//     576 CTAs are 4.36 waves of 132 SMs (144 CTAs at B = 1, 1.09 waves).
//
// fp32: flash_fwd_d512_f32<STATIC_MAX, EXP_BF16>, exact fp32 on the SIMT cores (the
// tensor cores would round to TF32; the check is 1e-5 x max|plain|): the same
// 696 GFLOP take 10.4 ms at 67 TFLOP/s, against 0.09 ms of bytes. The SM
// issues 4 warp FMAs a clock against one 128-byte shared-memory wavefront, so
// the design reads operands so that every wavefront feeds at least 4 warp
// FMAs (the SGEMM layout). A CTA owns 48 query rows with 256 threads:
//   * S = Q'K^T (48 x 64 a tile): warp w owns rows 6w ... 6w + 5, each lane a
//     3 x 4 micro-tile (rows 6w + sy + 2r, keys sx + 16c). A step of 4
//     columns reads 3 Q' float4s (two rows a warp instruction, 1 wavefront
//     each) and 4 K float4s (16 keys, 2 wavefronts each) for 48 FMAs: 4.4
//     FMAs a wavefront. Q' rows are padded to 516 floats and K rows to 132, so
//     rows 1 apart start 4 banks apart and those reads do not conflict;
//   * O += P V: warp w owns columns 64w ... 64w + 63, each lane a 6 x 16
//     micro-tile (rows 4oy + r and 32 + 2oy + r, columns 64w + 4ox + 16c + e),
//     96 fp32 registers. A key reads a P float4 and a P float2 (from P^T,
//     key-major: 1 wavefront each) and 4 V float4s (4 columns: 1 wavefront
//     each) for 96 FMAs: 16 FMAs a wavefront;
//   * softmax in the S layout (a row's 64 keys are the 16 lanes of equal sy:
//     shuffles), P written transposed to shared memory; running max passes
//     the rescale factors, and at the end l, to the O layout through shared
//     memory;
//   * shared memory (180,352 B): Q' 48 x 516 fp32 (99 KB, loaded and scaled
//     once), two chunk buffers of 33 KB through which a key tile streams as 4
//     chunks of K (64 keys x 128 columns) and then 4 of V (16 keys x 512
//     columns), each loaded by cp.async while the one before is used (keys
//     past L_k zero-filled), P^T 64 x 52, and 2 x 48 floats of row factors;
//   * why 48 rows: one CTA an SM (ptxas: 246 registers static, 254 running,
//     no spills), and the grid is what fills the card. 64-row CTAs (128
//     accumulators) were 4.36 waves of 132 SMs at B = 4, L = 9216 (576 CTAs)
//     and 1.09 at B = 1; 48-row CTAs are 5.82 and 1.45, and measured faster
//     at all three path shapes (PERF.md).

// Every other head dim up to 512 (the tiny SVD UNet's and DiT's 16, 40, 80,
// 128, 256; the reference pads V to _aug_width(d) and takes any d), bf16 and
// fp32, and fp32 running max at d = 64 and 72: flash_fwd_any<T, DPL,
// STATIC_MAX, EXP_BF16>, a simple SIMT kernel (making it fast is later
// work). A warp owns 4 query rows, a CTA 4 warps; K
// and V come through shared memory in tiles of 32 keys, converted to fp32 as
// they are staged, with q' = q * qscale rounded to T staged once:
//   * S: lane j scores key j of the tile against the warp's rows, a dot
//     product over d from K's row (pitch d | 1 floats: odd, so the 32 lanes'
//     rows start in distinct banks) against q' rows read as broadcasts;
//   * softmax per row: static max clamps and takes exp2; running max reduces
//     the tile's max over the lanes by shuffles and rescales O and l. P is
//     rounded to T and each lane sums its share of l from those values;
//   * O += P V: lane c holds columns c, c + 32, ... (DPL = ceil(d / 32)
//     rounded up to a power of two, so d = 512 takes 16 registers a row),
//     takes key j's p from lane j by a shuffle and V's row j from shared
//     memory; keys past L_k have p = 0, rows past L_q are not stored.
//
// Head dims above 512 (no model of either package; the reference pads V to
// _aug_width(d) and shrinks its tiles to a VMEM budget), bf16 and fp32:
// flash_fwd_wide<T, STATIC_MAX, EXP_BF16>, a simple SIMT kernel in
// flash_fwd_any's layout (a warp owns 4 query rows, a CTA 4 warps, tiles of
// 32 keys). O is cut into column slabs of 512, a CTA a slab:
//   * every slab's CTA computes the full-width S = q'K^T, staging q' and K
//     128 columns at a time (24.5 KB), summing each score over d in one
//     order, so all slabs hold the same S bits; static max makes P a
//     function of S alone, running max its m and alpha too, so every slab
//     rounds the same P and sums the same l, and the slabs together are one
//     CTA's result;
//   * it then stages only its slab's 512 columns of the value tile (64 KB)
//     for O += P V; 90,240 B of dynamic shared memory at any d, so d is
//     bounded by nothing but the card's memory;
//   * what bounds it: the S product is repeated in each of the ceil(d / 512)
//     slabs, and every tile restages q' (making it fast is later work);
//   * why it is not flash_fwd_any with a slab axis: flash_fwd_any stages q'
//     over all of d once a CTA and K and V tiles over all of d, and a lane
//     holds d / 32 columns of each of its 4 rows of O. At d <= 512 that is
//     at most 160 KB of shared memory and 64 accumulators a thread; at
//     d = 1024 it would be 320 KB (more than a CTA may have) and 128. Giving
//     flash_fwd_any the slabs and the chunked score loop would make its
//     d <= 512 rows restage q' every key tile, or carry both stagings behind
//     a branch: two kernels in one body. The two share tile_p, tile_pv and
//     store_rows, where the arithmetic lives.
//
// Operands. q, k and v come with element strides (batch, token, head), their
// head dim dense: the fused QKV projection's chunks (VDPP_FUSE_QKV=1) are
// views of a (B, L, 3, H, D) tensor with token stride 3 H D. The TMA kernels
// put those strides in their tensor maps, the SIMT kernels index with them;
// the output is contiguous. Every launcher's grid is one axis (query tiles
// fastest, then b * h), so B * H is not held to grid y's 65,535.
//
// VDPP_FLASH_EXP=bf16 (the reference's exp_bf16, running max only) is the
// EXP_BF16 flag of every kernel beside STATIC_MAX: s - m is rounded to bf16
// before exp2 and the exponential to bf16 after it (the reference's exp2 of a
// bf16 array is a bf16 array).
//
// C interface (bound with ctypes, see vdpp_tpu_torch/ops/flash_attention.py):
// returns a cudaError_t after the launch, launches on the given stream,
// allocates nothing and does not synchronise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"  // smem_u32, mbarriers, tma_load_4d, Strides, encode_tiled

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

// VDPP_FLASH_EXP=bf16 (running max only, as in the reference): s - m is
// rounded to bf16 before exp2, and the exponential comes out as a bf16 value
// (the reference's exp2 of a bf16 array is bf16; the bf16 kernels round P to
// bf16 anyway, the fp32 ones do it here).
template <bool EXP_BF16>
__device__ __forceinline__ float exp_arg(float x) { return EXP_BF16 ? round_bf16(x) : x; }
template <bool EXP_BF16>
__device__ __forceinline__ float exp_val(float e) { return EXP_BF16 ? round_bf16(e) : e; }

// Where head h of batch row b of a (B, L, H, D) operand with strides s starts.
template <typename T>
__device__ __forceinline__ const T* head_of(const T* p, const Strides& s, int b, int h) {
  return p + b * s.b + h * s.h;
}

// Every launcher's grid is one axis, the query tiles of one (b, h) after
// each other, then the next (b, h), so that B * H has no 65,535 limit; the
// launch order is the one a (query tiles, B * H) grid had.
struct Work {
  int bh, q0;
};
__device__ __forceinline__ Work work_of(int Lq, int bq) {
  const int nq = (Lq + bq - 1) / bq;
  const int bh = blockIdx.x / nq;
  return {bh, ((int)blockIdx.x - bh * nq) * bq};
}
// The grid of `tiles` CTAs for each of bh (b, h) pairs, or 0 past 2^31 - 1.
inline unsigned grid_x(long long tiles, long long bh) {
  const long long n = tiles * bh;
  return n > 0x7fffffffLL ? 0u : (unsigned)n;
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
template <bool STATIC_MAX, bool EXP_BF16, bool MASKED, int NS>
__device__ __forceinline__ void softmax_tile(float (&s)[NS], float (&m)[2], float (&lp)[4],
                                             float (&alpha)[2], int k0, int Lk, int t) {
  float mr[2] = {0.f, 0.f};  // the row max subtracted (running max only)
  if (!STATIC_MAX) {
    float mt[2] = {MASK_VALUE, MASK_VALUE};
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const int key = k0 + 8 * (i >> 2) + 2 * t + (i & 1);
      if (!MASKED || key < Lk) mt[(i >> 1) & 1] = fmaxf(mt[(i >> 1) & 1], s[i]);
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {  // a row's keys are spread over the 4 threads of a quad
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
  for (int u = 0; u < NS / 2; ++u) {
    float e[2];
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int i = 2 * u + c;
      const float x = STATIC_MAX ? fminf(fmaxf(s[i], S_CLAMP_LO), S_CLAMP)
                                 : exp_arg<EXP_BF16>(s[i] - mr[u & 1]);
      e[c] = ex2(x);
      if (MASKED && k0 + 8 * (i >> 2) + 2 * t + c >= Lk) e[c] = 0.f;
    }
    const uint32_t w = pack_bf16(e[0], e[1]);
    lp[u & 3] += __uint_as_float(w << 16) + __uint_as_float(w & 0xffff0000u);
    s[u] = __uint_as_float(w);
  }
}

// A tile of 2 * NS keys (NS accumulators of S a thread: 128 keys at d = 64/72,
// 64 at d = 512).
template <bool STATIC_MAX, bool EXP_BF16, int NS>
__device__ __forceinline__ void softmax(float (&s)[NS], float (&m)[2], float (&lp)[4],
                                        float (&alpha)[2], int k0, int Lk, int t) {
  if (k0 + 2 * NS <= Lk) {
    softmax_tile<STATIC_MAX, EXP_BF16, false>(s, m, lp, alpha, k0, Lk, t);
  } else {
    softmax_tile<STATIC_MAX, EXP_BF16, true>(s, m, lp, alpha, k0, Lk, t);
  }
}

// P V's A operand from the packed words softmax left in s[0 .. NS/2 - 1].
template <int NS>
__device__ __forceinline__ void take_p(uint32_t (&p)[NS / 2], const float (&s)[NS]) {
#pragma unroll
  for (int u = 0; u < NS / 2; ++u) p[u] = __float_as_uint(s[u]);
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
template <int D, bool STATIC_MAX, bool EXP_BF16>
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
  softmax<STATIC_MAX, EXP_BF16>(s, m, lp, alpha, j * WG_BK, Lk, threadIdx.x & 3);
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

template <int D, bool STATIC_MAX, bool EXP_BF16>
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
  const Work w = work_of(Lq, WG_BQ);
  const int b = w.bh / H;
  const int h = w.bh - b * H;
  const int q0 = w.q0;
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
    softmax<STATIC_MAX, EXP_BF16>(s, m, lp, alpha, 0, Lk, t);
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
        tile_step<D, STATIC_MAX, EXP_BF16>(j, s, p, acc, acct, m, lp, alpha, stage0, dq, dqt, full0,
                                 empty0, Lk, wg);
      }
      last_pv<D>(acc, acct, p, stage0 + ((nk - 1) % WG_STAGES) * L::STAGE_BYTES, wg);
    } else if (nk == 1) {
      last_pv<D>(acc, acct, p, stage0, wg);
    } else {
      int j = 1;
      do {
        tile_step<D, STATIC_MAX, EXP_BF16>(j, s, p, acc, acct, m, lp, alpha, stage0, dq, dqt, full0,
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
// fp32, d = 64 and 72, static max: SIMT, one query row a thread.

constexpr int BK = 64;          // keys per shared-memory tile
constexpr int THREADS = 128;    // 4 warps
constexpr int BQ_F32 = THREADS; // query rows per block (1 per thread)

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o, Strides qs, Strides ks,
              Strides vs, int H, int Lq, int Lk, float qscale) {
  __shared__ __align__(16) float Ks[BK * D];
  __shared__ __align__(16) float Vs[BK * D];

  const int tid = threadIdx.x;
  const Work w = work_of(Lq, BQ_F32);
  const int b = w.bh / H;
  const int h = w.bh - b * H;
  const long rs = (long)H * D;
  const float* qb = head_of(q, qs, b, h);
  const float* kb = head_of(k, ks, b, h);
  const float* vb = head_of(v, vs, b, h);
  float* ob = o + ((long)b * Lq * H + h) * D;
  const int r = w.q0 + tid;

  float qr[D];
  float acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qr[d] = r < Lq ? qb[r * qs.l + d] * qscale : 0.f;
    acc[d] = 0.f;
  }
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
        kv = *reinterpret_cast<const float4*>(kb + (k0 + row) * ks.l + col);
        vv = *reinterpret_cast<const float4*>(vb + (k0 + row) * vs.l + col);
      }
      *reinterpret_cast<float4*>(Ks + row * D + col) = kv;
      *reinterpret_cast<float4*>(Vs + row * D + col) = vv;
    }
    __syncthreads();

    const int nk = min(BK, Lk - k0);
    for (int j = 0; j < nk; ++j) {
      float s = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) s = fmaf(qr[d], Ks[j * D + d], s);
      const float p = exp2f(fminf(fmaxf(s, S_CLAMP_LO), S_CLAMP));
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
// d = 512, bf16: TMA + wgmma, the head dim split over two warpgroups.
// (The design and its budgets are in the note at the top of the file.)

constexpr int X_D = 512;
constexpr int X_BQ = 64;                  // query rows a CTA, shared by both warpgroups
constexpr int X_BK = 64;                  // keys a K or V tile
constexpr int X_BOX = 64 * MAIN_ROW;      // a 64-row box of 64 columns: 8 KB
constexpr int X_BOXES = X_D / MAIN_COLS;  // 8 boxes a 64-row tile
constexpr int X_TILE = X_BOXES * X_BOX;   // 64 KB
constexpr int X_HALF = X_TILE / 2;        // a warpgroup's 256 columns: boxes 4wg .. 4wg + 3
constexpr int X_Q = 0;
constexpr int X_K = X_TILE;
constexpr int X_V = 2 * X_TILE;
constexpr int X_XCH = 3 * X_TILE;         // two 64 x 64 fp32 buffers of partial S
constexpr int X_XCH_BYTES = X_BQ * X_BK * 4;
constexpr int X_BARS = X_XCH + 2 * X_XCH_BYTES;  // full K, full V, empty V, Q
constexpr int X_SMEM = X_BARS + 8 * 4 + 1024;   // + alignment slack
// Two warpgroups and no producer warp: each of the SM's four register-file
// quarters then holds two warps, so a thread may have 255 registers. With a
// ninth warp (or a producer warpgroup) one quarter holds three and ptxas caps
// every thread at 168, setmaxnreg or not; O, S and P do not fit in 168.
constexpr int X_THREADS = 128 * WG_NC;
static_assert(X_SMEM <= 232448, "one CTA's dynamic shared memory on an H100");
static_assert(X_BQ == 64 && X_BK == 64, "S is one m64n64 product a k16 step");

__device__ __forceinline__ uint64_t wg_desc_lbo(uint32_t saddr, uint32_t lbo, uint32_t sbo,
                                                uint64_t layout) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (layout << 62);
}

// S(64 x 64, fp32) = A(64 x 16, bf16, shared) * B(64 x 16, bf16, shared)^T, both K-major:
// the first k16 step, which writes the accumulators without reading them.
__device__ __forceinline__ void wgmma_ss_n64_first(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]),
        "=f"(d[6]), "=f"(d[7]), "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]),
        "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]), "=f"(d[16]), "=f"(d[17]),
        "=f"(d[18]), "=f"(d[19]), "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]),
        "=f"(d[30]), "=f"(d[31])
      : "l"(da), "l"(db), "r"(0));
}

// S(64 x 64, fp32) += A(64 x 16) * B(64 x 16)^T, the later k16 steps.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// O(64 x 256, fp32) += P(64 x 16, bf16, registers) * V(16 x 256, bf16, shared, N-major).
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// This warpgroup's partial S over its 256 columns of d: 16 k16 steps, four
// in each of its Q and K boxes (+32 B a step inside a box, +8 KB a box).
__device__ __forceinline__ void issue_s512(float (&s)[32], uint64_t dq, uint64_t dk) {
#pragma unroll
  for (int kk = 0; kk < X_D / 2 / 16; ++kk) {
    const uint64_t off = (kk >> 2) * (X_BOX >> 4) + (kk & 3) * 2;
    if (kk == 0) {
      wgmma_ss_n64_first(s, dq, dk);
    } else {
      wgmma_ss_n64(s, dq + off, dk + off);
    }
  }
}

// O(:, this warpgroup's 256 columns) += P V: 4 k16 steps of 16 keys (+2 KB).
__device__ __forceinline__ void issue_pv512(float (&o)[128], const uint32_t (&p)[16],
                                            uint64_t dv) {
#pragma unroll
  for (int kk = 0; kk < X_BK / 16; ++kk) {
    const uint32_t a[4] = {p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3]};
    wgmma_rs_n256(o, a, dv + kk * (2048 >> 4));
  }
}

// S = (the other warpgroup's partial) + (this one's), through shared memory.
// Both warpgroups hold the same elements in the same registers, and fp32
// addition is commutative, so both end with a bitwise-equal S. Tile j's
// buffers swap each tile: a warpgroup writes the buffer it read the tile
// before, which no one else reads, so one barrier a tile suffices.
__device__ __forceinline__ void exchange_s(float (&s)[32], uint8_t* xch, int wg, int j, int tw) {
  float4* mine = reinterpret_cast<float4*>(xch + ((wg + j) & 1) * X_XCH_BYTES);
  const float4* other = reinterpret_cast<const float4*>(xch + ((wg + j + 1) & 1) * X_XCH_BYTES);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    mine[i * 128 + tw] = make_float4(s[4 * i], s[4 * i + 1], s[4 * i + 2], s[4 * i + 3]);
  }
  asm volatile("bar.sync 3, 256;" ::: "memory");
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float4 x = other[i * 128 + tw];
    s[4 * i] += x.x;
    s[4 * i + 1] += x.y;
    s[4 * i + 2] += x.z;
    s[4 * i + 3] += x.w;
  }
}

// The TMA loads of a 64-row tile (rows `row` ... row + 63 of batch b, head h)
// into `dst`, 8 boxes of 64 columns, completing on `bar`; issued by thread 0.
__device__ __forceinline__ void load_tile512(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                             int h, int row, int b) {
  mbar_expect_tx(bar, X_TILE);
  for (int c = 0; c < X_BOXES; ++c) {
    tma_load_4d(dst + c * X_BOX, map, bar, c * MAIN_COLS, h, row, b);
  }
}

template <bool STATIC_MAX, bool EXP_BF16>
__global__ void __launch_bounds__(X_THREADS, 1)
flash_fwd_d512_bf16(const __grid_constant__ CUtensorMap q_map,
                    const __grid_constant__ CUtensorMap k_map,
                    const __grid_constant__ CUtensorMap v_map, __nv_bfloat16* __restrict__ o,
                    int H, int Lq, int Lk, float qscale) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // swizzle atoms sit on 1024-byte boundaries
  uint8_t* smem = smem_raw + (base - raw);
  const uint32_t full_k = base + X_BARS;
  const uint32_t full_v = full_k + 8;
  const uint32_t empty_v = full_k + 16;
  const uint32_t qbar = full_k + 24;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const Work w = work_of(Lq, X_BQ);
  const int b = w.bh / H;
  const int h = w.bh - b * H;
  const int q0 = w.q0;
  const int nk = (Lk + X_BK - 1) / X_BK;
  const bool leader = threadIdx.x == 0;  // issues every TMA load

  if (leader) {
    mbar_init(full_k, 1);  // the leader's arrive, plus the TMA bytes
    mbar_init(full_v, 1);
    mbar_init(empty_v, 4 * WG_NC);  // one arrive per warp
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (leader) {
    load_tile512(base + X_Q, &q_map, qbar, h, q0, b);
    load_tile512(base + X_K, &k_map, full_k, h, 0, b);
    load_tile512(base + X_V, &v_map, full_v, h, 0, b);
  }

  // Warpgroup wg: all 64 query rows, columns 256 * wg ... + 255 of d.
  const int wg = __shfl_sync(0xffffffffu, warp >> 2, 0);  // warp-uniform descriptors
  const int tw = threadIdx.x & 127;
  const int g = lane >> 2;
  const int t = lane & 3;
  uint8_t* xch = smem + X_XCH;

  mbar_wait(qbar, 0);
  {
    uint4* qm = reinterpret_cast<uint4*>(smem + X_Q + wg * X_HALF);
#pragma unroll
    for (int i = 0; i < X_HALF / 16 / 128; ++i) scale_q8(qm[tw + 128 * i], qscale);
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // before wgmma reads Q'
    asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");
  }
  const uint64_t dq = wg_desc(base + X_Q + wg * X_HALF, 1024, SW128);
  const uint64_t dk = wg_desc(base + X_K + wg * X_HALF, 1024, SW128);
  // V as stored is (keys x d), d contiguous: the N-major B of P V. Its 256
  // columns span 4 boxes, LBO = 8 KB apart; 8-key groups SBO = 1 KB apart.
  const uint64_t dv = wg_desc_lbo(base + X_V + wg * X_HALF, X_BOX, 1024, SW128);

  float s[32];
  uint32_t p[16];
  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  float m[2] = {MASK_VALUE, MASK_VALUE};
  float lp[4] = {0.f, 0.f, 0.f, 0.f};
  float alpha[2];

  // Tile j: S(j), the exchange and the softmax, then P V(j). K(j + 1) loads
  // from the exchange's barrier on (both warpgroups' S(j) are done with K)
  // through the softmax and P V(j); V(j + 1) from the end of both P V(j)
  // through S(j + 1) and its softmax.
  for (int j = 0; j < nk; ++j) {
    mbar_wait(full_k, j & 1);
    fence_regs(acc);
    wg_fence();
    issue_s512(s, dq, dk);
    wg_commit();
    wg_wait<0>();
    fence_regs(s);
    exchange_s(s, xch, wg, j, tw);
    if (leader && j + 1 < nk) load_tile512(base + X_K, &k_map, full_k, h, (j + 1) * X_BK, b);
    softmax<STATIC_MAX, EXP_BF16>(s, m, lp, alpha, j * X_BK, Lk, t);
    if (!STATIC_MAX) {
#pragma unroll
      for (int i = 0; i < 128; ++i) acc[i] *= alpha[(i >> 1) & 1];
    }
    take_p(p, s);
    mbar_wait(full_v, j & 1);
    fence_regs(p);
    fence_regs(acc);
    wg_fence();
    issue_pv512(acc, p, dv);
    wg_commit();
    wg_wait<0>();
    fence_regs(acc);
    fence_regs(p);
    if (lane == 0) mbar_arrive(empty_v);
    if (leader && j + 1 < nk) {
      mbar_wait(empty_v, j & 1);  // both warpgroups' P V(j) are done with V
      load_tile512(base + X_V, &v_map, full_v, h, (j + 1) * X_BK, b);
    }
  }

  float inv[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    float l = lp[j] + lp[j + 2];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv[j] = l == 0.f ? 1.f : 1.f / l;
  }
  const long rs = (long)H * X_D;
  const int r0 = q0 + (warp & 3) * 16 + g;  // this thread's rows: r0, r0 + 8
  __nv_bfloat16* ob = o + ((long)b * Lq * H + h) * X_D + wg * (X_D / 2);
#pragma unroll
  for (int j = 0; j < 32; ++j) {
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
}

// ---------------------------------------------------------------------------
// d = 512, fp32: register-tiled SIMT (the SGEMM layout), 48 query rows a CTA.
// (The design is in the note at the top of the file.)

constexpr int F_BQ = 48;               // query rows a CTA (6 waves of 132 SMs at B = 4)
constexpr int F_BK = 64;               // keys a tile
constexpr int F_THREADS = 256;         // 8 warps
constexpr int F_QROW = X_D + 4;        // padded Q' row: rows 1 apart start 4 banks apart
constexpr int F_DC = 128;              // columns of d a K chunk
constexpr int F_KROW = F_DC + 4;       // padded K chunk row: keys 1 apart start 4 banks apart
constexpr int F_VKEYS = 16;            // keys a V chunk (all 512 columns)
constexpr int F_PROW = F_BQ + 4;       // P^T row (one key, the query rows), padded
constexpr int F_CHUNKS = X_D / F_DC + F_BK / F_VKEYS;  // chunks a tile: 4 of K, then 4 of V
constexpr int F_BUF = F_BK * F_KROW;   // floats a chunk buffer holds
constexpr int F_NBUF = 2;              // chunk buffers: one loads while the other is read
constexpr int F_Q = 0;                 // shared-memory offsets, in floats
constexpr int F_B0 = F_Q + F_BQ * F_QROW;
constexpr int F_PT = F_B0 + F_NBUF * F_BUF;
constexpr int F_ALPHA = F_PT + F_BK * F_PROW;
constexpr int F_L = F_ALPHA + F_BQ;
constexpr size_t F_SMEM = sizeof(float) * (F_L + F_BQ);
static_assert(F_VKEYS * X_D <= F_BUF, "a V chunk fits a chunk buffer");
static_assert(F_SMEM <= 232448, "one CTA's dynamic shared memory on an H100");

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
// Returns once at most N of this thread's committed copy groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Chunk n of key tile `tile` into `buf`: n < X_D / F_DC is K(keys, columns
// F_DC * n ... + F_DC - 1) as [key][F_KROW]; the later ones are V(F_VKEYS keys,
// all columns) as [key][512]. Keys past Lk are filled with zeros (their rows
// are not read from memory). 16-byte copies, the same number a thread.
constexpr int F_K_COPIES = F_BK * F_DC / 4 / F_THREADS;
constexpr int F_V_COPIES = F_VKEYS * X_D / 4 / F_THREADS;
static_assert(F_K_COPIES * 4 * F_THREADS == F_BK * F_DC, "whole rounds of K copies");
static_assert(F_V_COPIES * 4 * F_THREADS == F_VKEYS * X_D, "whole rounds of V copies");

__device__ __forceinline__ void load_chunk(float* buf, const float* kb, const float* vb,
                                           long long krs, long long vrs, int tile, int n, int Lk,
                                           int tid) {
  const int k0 = tile * F_BK;
  if (n < X_D / F_DC) {
#pragma unroll
    for (int i = 0; i < F_K_COPIES; ++i) {
      const int idx = tid + F_THREADS * i;
      const int key = idx / (F_DC / 4);
      const int c4 = (idx % (F_DC / 4)) * 4;
      const bool ok = k0 + key < Lk;
      cp_async16(buf + key * F_KROW + c4, kb + (ok ? (k0 + key) * krs : 0) + n * F_DC + c4, ok);
    }
  } else {
#pragma unroll
    for (int i = 0; i < F_V_COPIES; ++i) {
      const int idx = tid + F_THREADS * i;
      const int key = idx / (X_D / 4);
      const int c4 = (idx % (X_D / 4)) * 4;
      const int row = k0 + (n - X_D / F_DC) * F_VKEYS + key;
      const bool ok = row < Lk;
      cp_async16(buf + key * X_D + c4, vb + (ok ? row * vrs : 0) + c4, ok);
    }
  }
}

// Waits for chunk `step` and starts the load of chunk step + F_NBUF - 1 into
// the buffer that chunk step - 1 used, which every thread is done with once
// all have passed the barrier.
__device__ __forceinline__ void next_chunk(float* fsm, const float* kb, const float* vb,
                                           long long krs, long long vrs, int step, int total,
                                           int Lk, int tid) {
  cp_async_wait<F_NBUF - 2>();
  __syncthreads();
  const int c = step + F_NBUF - 1;
  if (c < total) {
    load_chunk(fsm + F_B0 + (c % F_NBUF) * F_BUF, kb, vb, krs, vrs, c / F_CHUNKS, c % F_CHUNKS,
               Lk, tid);
  }
  cp_async_commit();  // empty past the last chunk, so the group count stays one a step
}

constexpr int F_RA = 4;          // rows of O a lane holds among the first 32
constexpr int F_RB = 2;          // and among the last 16
constexpr int F_SR = F_BQ / 16;  // rows of S a lane holds
constexpr int F_SC = F_BK / 16;  // keys of S a lane holds
static_assert(F_BQ == 32 + 8 * F_RB, "the O layout covers the CTA's rows");

// One row of O: 16 columns of a lane, divided by the row's l (l == 0 -> 1).
__device__ __forceinline__ void store_row(float* ob, long rs, int q0, int Lq, int row, int ocol,
                                          const float* l_s, const float (&a)[4][4]) {
  const float l = l_s[row];
  const float inv = l == 0.f ? 1.f : 1.f / l;
  if (q0 + row >= Lq) return;
  float* orow = ob + (q0 + row) * rs + ocol;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    *reinterpret_cast<float4*>(orow + 16 * c) =
        make_float4(a[c][0] * inv, a[c][1] * inv, a[c][2] * inv, a[c][3] * inv);
  }
}

template <bool STATIC_MAX, bool EXP_BF16>
__global__ void __launch_bounds__(F_THREADS, 1)
flash_fwd_d512_f32(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, float* __restrict__ o, Strides qs, Strides ks,
                   Strides vs, int H, int Lq, int Lk, float qscale) {
  extern __shared__ __align__(16) float fsm[];
  float* Qs = fsm + F_Q;
  float* PT = fsm + F_PT;
  float* alpha_s = fsm + F_ALPHA;
  float* l_s = fsm + F_L;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const Work w = work_of(Lq, F_BQ);
  const int b = w.bh / H;
  const int h = w.bh - b * H;
  const long rs = (long)H * X_D;
  const float* qb = head_of(q, qs, b, h);
  const float* kb = head_of(k, ks, b, h);
  const float* vb = head_of(v, vs, b, h);
  float* ob = o + ((long)b * Lq * H + h) * X_D;
  const int q0 = w.q0;
  const int nk = (Lk + F_BK - 1) / F_BK;
  const int total = nk * F_CHUNKS;

  for (int c = 0; c < F_NBUF - 1; ++c) {  // chunks 0 .. F_NBUF - 2 in flight
    if (c < total) {
      load_chunk(fsm + F_B0 + c * F_BUF, kb, vb, ks.l, vs.l, c / F_CHUNKS, c % F_CHUNKS, Lk, tid);
    }
    cp_async_commit();
  }
  // Q' = q * qscale in fp32; rows past Lq are zeros.
  for (int i = tid; i < F_BQ * X_D / 4; i += F_THREADS) {
    const int row = i >> 7;
    const int c4 = (i & 127) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + row < Lq) {
      x = *reinterpret_cast<const float4*>(qb + (q0 + row) * qs.l + c4);
      x = make_float4(x.x * qscale, x.y * qscale, x.z * qscale, x.w * qscale);
    }
    *reinterpret_cast<float4*>(Qs + row * F_QROW + c4) = x;
  }

  // S layout: warp w owns rows 6w ... 6w + 5; lane (sy, sx) = (lane & 1,
  // lane >> 1) rows 6w + sy + 2r (r < 3), keys sx + 16c (c < 4): a 3 x 4
  // micro-tile.
  const int sy = lane & 1;
  const int sx = lane >> 1;
  const int srow = (F_BQ / 8) * warp + sy;
  // O layout: warp w owns columns 64w ... 64w + 63; lane (oy, ox) = (lane >> 2,
  // lane & 3) rows 4oy + r (r < 4) and 32 + 2oy + r (r < 2), columns 64w + 4ox +
  // 16c + e (c, e < 4): a 6 x 16 micro-tile, 96 accumulators.
  const int oy = lane >> 2;
  const int ox = lane & 3;
  const int ocol = 64 * warp + 4 * ox;

  float acc_a[F_RA][4][4];
  float acc_b[F_RB][4][4];
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
#pragma unroll
      for (int r = 0; r < F_RA; ++r) acc_a[r][c][e] = 0.f;
#pragma unroll
      for (int r = 0; r < F_RB; ++r) acc_b[r][c][e] = 0.f;
    }
  float m[F_SR], lpart[F_SR];
#pragma unroll
  for (int r = 0; r < F_SR; ++r) {
    m[r] = MASK_VALUE;
    lpart[r] = 0.f;
  }

  int step = 0;  // chunks consumed so far; chunk `step` lies in buffer step % F_NBUF
  for (int tile = 0; tile < nk; ++tile) {
    // S = Q' K^T over X_D / F_DC chunks of columns.
    float s[F_SR][F_SC];
#pragma unroll
    for (int r = 0; r < F_SR; ++r)
#pragma unroll
      for (int c = 0; c < F_SC; ++c) s[r][c] = 0.f;
    for (int n = 0; n < X_D / F_DC; ++n, ++step) {
      next_chunk(fsm, kb, vb, ks.l, vs.l, step, total, Lk, tid);
      const float* kc = fsm + F_B0 + (step % F_NBUF) * F_BUF;
      const float* qc = Qs + srow * F_QROW + n * F_DC;
#pragma unroll
      for (int d = 0; d < F_DC; d += 4) {
        float4 qv[F_SR], kv[F_SC];
#pragma unroll
        for (int r = 0; r < F_SR; ++r) {
          qv[r] = *reinterpret_cast<const float4*>(qc + 2 * r * F_QROW + d);
        }
#pragma unroll
        for (int c = 0; c < F_SC; ++c) {
          kv[c] = *reinterpret_cast<const float4*>(kc + (sx + 16 * c) * F_KROW + d);
        }
#pragma unroll
        for (int r = 0; r < F_SR; ++r) {
#pragma unroll
          for (int c = 0; c < F_SC; ++c) {
            s[r][c] = fmaf(qv[r].x, kv[c].x, s[r][c]);
            s[r][c] = fmaf(qv[r].y, kv[c].y, s[r][c]);
            s[r][c] = fmaf(qv[r].z, kv[c].z, s[r][c]);
            s[r][c] = fmaf(qv[r].w, kv[c].w, s[r][c]);
          }
        }
      }
    }

    // Softmax in the S layout; a row's 64 keys are the 16 lanes of equal sy.
    const int k0 = tile * F_BK;
#pragma unroll
    for (int r = 0; r < F_SR; ++r) {
      float mr = 0.f;
      if (!STATIC_MAX) {
        float mt = MASK_VALUE;
#pragma unroll
        for (int c = 0; c < F_SC; ++c) {
          if (k0 + sx + 16 * c < Lk) mt = fmaxf(mt, s[r][c]);
        }
#pragma unroll
        for (int off = 2; off < 32; off <<= 1) {
          mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
        }
        const float m_new = fmaxf(m[r], mt);
        const float a = exp2f(m[r] - m_new);
        m[r] = m_new;
        mr = m_new;
        lpart[r] *= a;
        if (sx == 0) alpha_s[srow + 2 * r] = a;
      }
#pragma unroll
      for (int c = 0; c < F_SC; ++c) {
        const int key = sx + 16 * c;
        float pv = STATIC_MAX ? exp2f(fminf(fmaxf(s[r][c], S_CLAMP_LO), S_CLAMP))
                              : exp_val<EXP_BF16>(exp2f(exp_arg<EXP_BF16>(s[r][c] - mr)));
        if (k0 + key >= Lk) pv = 0.f;
        lpart[r] += pv;
        PT[key * F_PROW + srow + 2 * r] = pv;
      }
    }

    // O += P V over F_BK / F_VKEYS chunks of keys; the barrier of the first also
    // makes P^T and the rescale factors visible.
    for (int n = 0; n < F_BK / F_VKEYS; ++n, ++step) {
      next_chunk(fsm, kb, vb, ks.l, vs.l, step, total, Lk, tid);
      if (!STATIC_MAX && n == 0) {
        const float4 a = *reinterpret_cast<const float4*>(alpha_s + 4 * oy);
        const float ar[4] = {a.x, a.y, a.z, a.w};
        const float2 b2 = *reinterpret_cast<const float2*>(alpha_s + 32 + F_RB * oy);
        const float br[F_RB] = {b2.x, b2.y};
#pragma unroll
        for (int c = 0; c < 4; ++c)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
#pragma unroll
            for (int r = 0; r < F_RA; ++r) acc_a[r][c][e] *= ar[r];
#pragma unroll
            for (int r = 0; r < F_RB; ++r) acc_b[r][c][e] *= br[r];
          }
      }
      const float* vc = fsm + F_B0 + (step % F_NBUF) * F_BUF + ocol;
      const float* pc = PT + n * F_VKEYS * F_PROW;
#pragma unroll
      for (int kk = 0; kk < F_VKEYS; ++kk) {
        const float4 pa4 = *reinterpret_cast<const float4*>(pc + kk * F_PROW + 4 * oy);
        const float pa[4] = {pa4.x, pa4.y, pa4.z, pa4.w};
        const float2 pb2 = *reinterpret_cast<const float2*>(pc + kk * F_PROW + 32 + F_RB * oy);
        const float pb[F_RB] = {pb2.x, pb2.y};
        float4 vv[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          vv[c] = *reinterpret_cast<const float4*>(vc + kk * X_D + 16 * c);
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) {
#pragma unroll
          for (int r = 0; r < F_RA; ++r) {
            acc_a[r][c][0] = fmaf(pa[r], vv[c].x, acc_a[r][c][0]);
            acc_a[r][c][1] = fmaf(pa[r], vv[c].y, acc_a[r][c][1]);
            acc_a[r][c][2] = fmaf(pa[r], vv[c].z, acc_a[r][c][2]);
            acc_a[r][c][3] = fmaf(pa[r], vv[c].w, acc_a[r][c][3]);
          }
#pragma unroll
          for (int r = 0; r < F_RB; ++r) {
            acc_b[r][c][0] = fmaf(pb[r], vv[c].x, acc_b[r][c][0]);
            acc_b[r][c][1] = fmaf(pb[r], vv[c].y, acc_b[r][c][1]);
            acc_b[r][c][2] = fmaf(pb[r], vv[c].z, acc_b[r][c][2]);
            acc_b[r][c][3] = fmaf(pb[r], vv[c].w, acc_b[r][c][3]);
          }
        }
      }
    }
  }

  // l per row from the S layout's partial sums, to the O layout through l_s.
#pragma unroll
  for (int r = 0; r < F_SR; ++r) {
    float l = lpart[r];
#pragma unroll
    for (int off = 2; off < 32; off <<= 1) l += __shfl_xor_sync(0xffffffffu, l, off);
    if (sx == 0) l_s[srow + 2 * r] = l;
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < F_RA; ++r) store_row(ob, rs, q0, Lq, 4 * oy + r, ocol, l_s, acc_a[r]);
#pragma unroll
  for (int r = 0; r < F_RB; ++r) store_row(ob, rs, q0, Lq, 32 + F_RB * oy + r, ocol, l_s, acc_b[r]);
}

// The softmax forms each kernel is instantiated for: static max, running max,
// and running max with VDPP_FLASH_EXP=bf16. Static max ignores the exponent
// switch, as the reference does. f(std::bool_constant<STATIC_MAX>,
// std::bool_constant<EXP_BF16>) launches one of them.
template <typename F>
cudaError_t by_softmax(int static_max, int exp_bf16, F&& f) {
  if (static_max) return f(std::true_type{}, std::false_type{});
  if (exp_bf16) return f(std::false_type{}, std::true_type{});
  return f(std::false_type{}, std::false_type{});
}

template <bool STATIC_MAX, bool EXP_BF16>
cudaError_t launch_d512_f32(const Operands& x, int bh, int H, int Lq, int Lk, float qscale,
                            cudaStream_t st) {
  const cudaError_t err = cudaFuncSetAttribute(flash_fwd_d512_f32<STATIC_MAX, EXP_BF16>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)F_SMEM);
  if (err != cudaSuccess) return err;
  const unsigned grid = grid_x((Lq + F_BQ - 1) / F_BQ, bh);
  if (grid == 0) return cudaErrorInvalidValue;
  flash_fwd_d512_f32<STATIC_MAX, EXP_BF16><<<grid, F_THREADS, F_SMEM, st>>>(
      static_cast<const float*>(x.q), static_cast<const float*>(x.k),
      static_cast<const float*>(x.v), static_cast<float*>(x.o), x.qs, x.ks, x.vs, H, Lq, Lk,
      qscale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_f32(const Operands& x, int bh, int H, int Lq, int Lk, float qscale,
                       cudaStream_t st) {
  const unsigned grid = grid_x((Lq + BQ_F32 - 1) / BQ_F32, bh);
  if (grid == 0) return cudaErrorInvalidValue;
  flash_fwd_f32<D><<<grid, THREADS, 0, st>>>(
      static_cast<const float*>(x.q), static_cast<const float*>(x.k),
      static_cast<const float*>(x.v), static_cast<float*>(x.o), x.qs, x.ks, x.vs, H, Lq, Lk,
      qscale);
  return cudaGetLastError();
}

// A bf16 (B, L, H, D) operand with strides `s` (D dense) as a 4-D map over
// (D, H, L, B), whose box is `cols` columns from the coordinate the kernel
// gives, one head, `rows` rows. TMA takes byte strides that are multiples of
// 16, which the wrapper sees to.
bool tensor_map(EncodeTiledFn encode, CUtensorMap* map, const void* ptr, const Strides& s, int D,
                int H, int L, int B, int cols, int rows, CUtensorMapSwizzle swizzle) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)L, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)s.h * 2, (cuuint64_t)s.l * 2, (cuuint64_t)s.b * 2};
  const cuuint32_t box[4] = {(cuuint32_t)cols, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
                box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D, bool STATIC_MAX, bool EXP_BF16>
cudaError_t launch_bf16(const CUtensorMap (&maps)[6], void* o, int bh, int H, int Lq, int Lk,
                        float qscale, cudaStream_t st) {
  constexpr int smem = WgLayout<D>::SMEM;
  const cudaError_t err = cudaFuncSetAttribute(flash_fwd_bf16<D, STATIC_MAX, EXP_BF16>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const unsigned grid = grid_x((Lq + WG_BQ - 1) / WG_BQ, bh);
  if (grid == 0) return cudaErrorInvalidValue;
  flash_fwd_bf16<D, STATIC_MAX, EXP_BF16><<<grid, WG_THREADS, smem, st>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], maps[5], static_cast<__nv_bfloat16*>(o), H,
      Lq, Lk, qscale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_d_bf16(const Operands& x, int batch, int H, int Lq, int Lk, int static_max,
                          int exp_bf16, float qscale, cudaStream_t st) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  // q, k, v main boxes (columns 0-63), then their tails (columns 64-79, d = 72).
  CUtensorMap maps[6];
  const void* ptrs[3] = {x.q, x.k, x.v};
  const Strides* strides[3] = {&x.qs, &x.ks, &x.vs};
  const int lens[3] = {Lq, Lk, Lk};
  for (int i = 0; i < 3; ++i) {
    const int rows = i == 0 ? WG_BQ : WG_BK;
    if (!tensor_map(encode, &maps[i], ptrs[i], *strides[i], D, H, lens[i], batch, MAIN_COLS, rows,
                    CU_TENSOR_MAP_SWIZZLE_128B)) {
      return cudaErrorInvalidValue;
    }
    if (!WgLayout<D>::TAIL) {
      maps[i + 3] = maps[i];  // not read
    } else if (!tensor_map(encode, &maps[i + 3], ptrs[i], *strides[i], D, H, lens[i], batch,
                           TAIL_COLS, rows, CU_TENSOR_MAP_SWIZZLE_32B)) {
      return cudaErrorInvalidValue;
    }
  }
  const int bh = batch * H;
  return by_softmax(static_max, exp_bf16, [&](auto sm, auto eb) {
    return launch_bf16<D, decltype(sm)::value, decltype(eb)::value>(maps, x.o, bh, H, Lq, Lk,
                                                                     qscale, st);
  });
}

template <bool STATIC_MAX, bool EXP_BF16>
cudaError_t launch_d512_bf16_maps(const CUtensorMap (&maps)[3], void* o, int bh, int H, int Lq,
                                  int Lk, float qscale, cudaStream_t st) {
  const cudaError_t err = cudaFuncSetAttribute(flash_fwd_d512_bf16<STATIC_MAX, EXP_BF16>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               X_SMEM);
  if (err != cudaSuccess) return err;
  const unsigned grid = grid_x((Lq + X_BQ - 1) / X_BQ, bh);
  if (grid == 0) return cudaErrorInvalidValue;
  flash_fwd_d512_bf16<STATIC_MAX, EXP_BF16><<<grid, X_THREADS, X_SMEM, st>>>(
      maps[0], maps[1], maps[2], static_cast<__nv_bfloat16*>(o), H, Lq, Lk, qscale);
  return cudaGetLastError();
}

cudaError_t launch_d512_bf16(const Operands& x, int batch, int H, int Lq, int Lk, int static_max,
                             int exp_bf16, float qscale, cudaStream_t st) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  // q, k, v as boxes of 64 columns x 64 rows (X_BQ = X_BK = 64), 128-byte swizzle.
  CUtensorMap maps[3];
  const void* ptrs[3] = {x.q, x.k, x.v};
  const Strides* strides[3] = {&x.qs, &x.ks, &x.vs};
  const int lens[3] = {Lq, Lk, Lk};
  for (int i = 0; i < 3; ++i) {
    if (!tensor_map(encode, &maps[i], ptrs[i], *strides[i], X_D, H, lens[i], batch, MAIN_COLS, 64,
                    CU_TENSOR_MAP_SWIZZLE_128B)) {
      return cudaErrorInvalidValue;
    }
  }
  const int bh = batch * H;
  return by_softmax(static_max, exp_bf16, [&](auto sm, auto eb) {
    return launch_d512_bf16_maps<decltype(sm)::value, decltype(eb)::value>(maps, x.o, bh, H, Lq,
                                                                           Lk, qscale, st);
  });
}

// ---------------------------------------------------------------------------
// Any other head dim d <= 512, bf16 or fp32, and fp32 running max at d = 64
// and 72: flash_fwd_any<T, DPL, STATIC_MAX, EXP_BF16>, SIMT. (The design is
// in the note at the top of the file.)

constexpr int ANY_R = 4;                    // query rows a warp
constexpr int ANY_WARPS = 4;                // warps a CTA
constexpr int ANY_BQ = ANY_R * ANY_WARPS;   // query rows a CTA
constexpr int ANY_BK = 32;                  // keys a tile: one a lane for S
constexpr int ANY_THREADS = 32 * ANY_WARPS;
constexpr int ANY_MAX_D = 512;

// Row pitch of a staged K tile, in floats: odd, so that the 32 lanes' rows
// start in 32 distinct banks.
__host__ __device__ constexpr int any_kpitch(int d) { return d | 1; }

// Dynamic shared memory of a CTA at head dim d: Q' (ANY_BQ rows), a K tile
// (padded rows) and a V tile, all fp32.
__host__ __device__ constexpr int any_smem(int d) {
  return (int)sizeof(float) * (ANY_BQ * d + ANY_BK * any_kpitch(d) + ANY_BK * d);
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f32(float x, float* out) { *out = x; }
__device__ __forceinline__ void from_f32(float x, __nv_bfloat16* out) {
  *out = __float2bfloat16_rn(x);
}
// x rounded to T's precision, as an fp32 value.
template <typename T>
__device__ __forceinline__ float in_dtype(float x) {
  return std::is_same<T, float>::value ? x : round_bf16(x);
}

// A tile's P for the warp's ANY_R rows from their scores s (lane j: key j,
// live when it is below L_k), rounded to T, with this lane's share of l
// summed from the rounded values; running max: the tile's max over the
// lanes, and O and l rescaled first.
template <typename T, int DPL, bool STATIC_MAX, bool EXP_BF16>
__device__ __forceinline__ void tile_p(const float (&s)[ANY_R], bool live, float (&m)[ANY_R],
                                       float (&l)[ANY_R], float (&acc)[ANY_R][DPL],
                                       float (&p)[ANY_R]) {
#pragma unroll
  for (int r = 0; r < ANY_R; ++r) {
    float e;
    if (STATIC_MAX) {
      e = exp2f(fminf(fmaxf(s[r], S_CLAMP_LO), S_CLAMP));
    } else {
      float mt = live ? s[r] : MASK_VALUE;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      }
      const float m_new = fmaxf(m[r], mt);
      const float alpha = exp2f(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha;
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[r][i] *= alpha;
      e = exp_val<EXP_BF16>(exp2f(exp_arg<EXP_BF16>(s[r] - m_new)));
    }
    p[r] = live ? in_dtype<T>(e) : 0.f;
    l[r] += p[r];
  }
}

// O += P V over a tile's nk keys: key j's p from lane j, V's row j at
// vs + j * pitch in shared memory; lane c holds columns c, c + 32, ... below
// `width`.
template <int DPL>
__device__ __forceinline__ void tile_pv(float (&acc)[ANY_R][DPL], const float (&p)[ANY_R],
                                        const float* vs, int pitch, int width, int nk, int lane) {
  for (int j = 0; j < nk; ++j) {
    float pj[ANY_R];
#pragma unroll
    for (int r = 0; r < ANY_R; ++r) pj[r] = __shfl_sync(0xffffffffu, p[r], j);
    const float* vr = vs + j * pitch;
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int c = lane + 32 * i;
      const float vc = c < width ? vr[c] : 0.f;
#pragma unroll
      for (int r = 0; r < ANY_R; ++r) acc[r][i] = fmaf(pj[r], vc, acc[r][i]);
    }
  }
}

// The warp's rows row0 ... row0 + ANY_R - 1 of O divided by their l (l == 0
// -> 1), those below L_q, at ob + row * rs, columns below `width`.
template <typename T, int DPL>
__device__ __forceinline__ void store_rows(const float (&acc)[ANY_R][DPL],
                                           const float (&l)[ANY_R], T* ob, long rs, int row0,
                                           int Lq, int width, int lane) {
#pragma unroll
  for (int r = 0; r < ANY_R; ++r) {
    float lr = l[r];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) lr += __shfl_xor_sync(0xffffffffu, lr, off);
    const float inv = lr == 0.f ? 1.f : 1.f / lr;
    const int row = row0 + r;
    if (row < Lq) {
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        const int c = lane + 32 * i;
        if (c < width) from_f32(acc[r][i] * inv, ob + row * rs + c);
      }
    }
  }
}

template <typename T, int DPL, bool STATIC_MAX, bool EXP_BF16>
__global__ void __launch_bounds__(ANY_THREADS)
flash_fwd_any(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              T* __restrict__ o, Strides qs, Strides ks, Strides vs, int H, int D, int Lq, int Lk,
              float qscale) {
  extern __shared__ __align__(16) float any_smem_f[];
  const int kp = any_kpitch(D);
  float* Qs = any_smem_f;          // ANY_BQ x D: q' = q * qscale rounded to T
  float* Ks = Qs + ANY_BQ * D;     // ANY_BK x kp
  float* Vs = Ks + ANY_BK * kp;    // ANY_BK x D

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const Work w = work_of(Lq, ANY_BQ);
  const int b = w.bh / H;
  const int h = w.bh - b * H;
  const long rs = (long)H * D;
  const T* qb = head_of(q, qs, b, h);
  const T* kb = head_of(k, ks, b, h);
  const T* vb = head_of(v, vs, b, h);
  T* ob = o + ((long)b * Lq * H + h) * D;
  const int q0 = w.q0;

  for (int i = tid; i < ANY_BQ * D; i += ANY_THREADS) {
    const int r = i / D;
    const int c = i - r * D;
    Qs[i] = q0 + r < Lq ? in_dtype<T>(to_f32(qb[(q0 + r) * qs.l + c]) * qscale) : 0.f;
  }
  const float* qw = Qs + warp * ANY_R * D;  // this warp's rows

  float acc[ANY_R][DPL];  // O(row, lane + 32 i)
  float m[ANY_R];
  float l[ANY_R];         // this lane's share of the row's l
#pragma unroll
  for (int r = 0; r < ANY_R; ++r) {
    m[r] = MASK_VALUE;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[r][i] = 0.f;
  }

  for (int k0 = 0; k0 < Lk; k0 += ANY_BK) {
    __syncthreads();  // the last tile has been read (and Q' staged, the first time)
    for (int i = tid; i < ANY_BK * D; i += ANY_THREADS) {
      const int j = i / D;
      const int c = i - j * D;
      const bool in = k0 + j < Lk;
      Ks[j * kp + c] = in ? to_f32(kb[(k0 + j) * ks.l + c]) : 0.f;
      Vs[i] = in ? to_f32(vb[(k0 + j) * vs.l + c]) : 0.f;
    }
    __syncthreads();

    // S: lane j scores key k0 + j against the warp's rows.
    float s[ANY_R];
#pragma unroll
    for (int r = 0; r < ANY_R; ++r) s[r] = 0.f;
    const float* kr = Ks + lane * kp;
    for (int c = 0; c < D; ++c) {
      const float kc = kr[c];
#pragma unroll
      for (int r = 0; r < ANY_R; ++r) s[r] = fmaf(qw[r * D + c], kc, s[r]);
    }
    float p[ANY_R];
    tile_p<T, DPL, STATIC_MAX, EXP_BF16>(s, k0 + lane < Lk, m, l, acc, p);
    tile_pv(acc, p, Vs, D, D, min(ANY_BK, Lk - k0), lane);
  }
  store_rows(acc, l, ob, rs, q0 + warp * ANY_R, Lq, D, lane);
}

// ---------------------------------------------------------------------------
// Head dims above 512, bf16 or fp32: flash_fwd_wide<T, STATIC_MAX, EXP_BF16>,
// SIMT. (The design is in the note at the top of the file.)

constexpr int W_SLAB = 512;             // columns of O a CTA: its slab
constexpr int W_DPL = W_SLAB / 32;      // columns of O a lane holds
constexpr int W_DC = 128;               // columns of q' and K a score chunk stages
constexpr int W_KP = any_kpitch(W_DC);  // odd pitch of a staged K chunk row
constexpr int W_SMEM =
    (int)sizeof(float) * (ANY_BQ * W_DC + ANY_BK * W_KP + ANY_BK * W_SLAB);  // 90,240 B

template <typename T, bool STATIC_MAX, bool EXP_BF16>
__global__ void __launch_bounds__(ANY_THREADS)
flash_fwd_wide(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
               T* __restrict__ o, Strides qs, Strides ks, Strides vs, int H, int D, int Lq,
               int Lk, float qscale) {
  extern __shared__ __align__(16) float wide_smem_f[];
  float* Qc = wide_smem_f;          // ANY_BQ x W_DC: a chunk of q' = q * qscale rounded to T
  float* Kc = Qc + ANY_BQ * W_DC;   // ANY_BK x W_KP: the same columns of a key tile
  float* Vs = Kc + ANY_BK * W_KP;   // ANY_BK x W_SLAB: the slab's columns of the value tile

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  // The slabs of one query tile are neighbours on the grid (they read the
  // same q and K); then the query tiles of one (b, h), then the next (b, h).
  const int nslab = (D + W_SLAB - 1) / W_SLAB;
  const int slab = blockIdx.x % nslab;
  const int nq = (Lq + ANY_BQ - 1) / ANY_BQ;
  const int tile = blockIdx.x / nslab;
  const int bh = tile / nq;
  const int q0 = (tile - bh * nq) * ANY_BQ;
  const int b = bh / H;
  const int h = bh - b * H;
  const int c0 = slab * W_SLAB;
  const int dw = min(W_SLAB, D - c0);  // the slab's width
  const T* qb = head_of(q, qs, b, h);
  const T* kb = head_of(k, ks, b, h);
  const T* vb = head_of(v, vs, b, h);
  T* ob = o + ((long)b * Lq * H + h) * D + c0;
  const long rs = (long)H * D;
  const float* qw = Qc + warp * ANY_R * W_DC;  // this warp's rows

  float acc[ANY_R][W_DPL];  // O(row, c0 + lane + 32 i)
  float m[ANY_R];
  float l[ANY_R];  // this lane's share of the row's l
#pragma unroll
  for (int r = 0; r < ANY_R; ++r) {
    m[r] = MASK_VALUE;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < W_DPL; ++i) acc[r][i] = 0.f;
  }

  for (int k0 = 0; k0 < Lk; k0 += ANY_BK) {
    // S over every column of d, W_DC at a time, in the same order in every
    // slab's CTA: lane j scores key k0 + j against the warp's rows.
    float s[ANY_R];
#pragma unroll
    for (int r = 0; r < ANY_R; ++r) s[r] = 0.f;
    for (int d0 = 0; d0 < D; d0 += W_DC) {
      const int dc = min(W_DC, D - d0);
      __syncthreads();  // the last chunk, and the last tile's V, have been read
      for (int i = tid; i < ANY_BQ * dc; i += ANY_THREADS) {
        const int r = i / dc;
        const int c = i - r * dc;
        Qc[r * W_DC + c] =
            q0 + r < Lq ? in_dtype<T>(to_f32(qb[(q0 + r) * qs.l + d0 + c]) * qscale) : 0.f;
      }
      for (int i = tid; i < ANY_BK * dc; i += ANY_THREADS) {
        const int j = i / dc;
        const int c = i - j * dc;
        Kc[j * W_KP + c] = k0 + j < Lk ? to_f32(kb[(k0 + j) * ks.l + d0 + c]) : 0.f;
      }
      __syncthreads();
      const float* kr = Kc + lane * W_KP;
      for (int c = 0; c < dc; ++c) {
        const float kc = kr[c];
#pragma unroll
        for (int r = 0; r < ANY_R; ++r) s[r] = fmaf(qw[r * W_DC + c], kc, s[r]);
      }
    }
    // The slab's columns of the value tile; every thread is past this tile's
    // first chunk barrier, so the last tile's P V is done with Vs.
    for (int i = tid; i < ANY_BK * dw; i += ANY_THREADS) {
      const int j = i / dw;
      const int c = i - j * dw;
      Vs[j * W_SLAB + c] = k0 + j < Lk ? to_f32(vb[(k0 + j) * vs.l + c0 + c]) : 0.f;
    }
    // P as flash_fwd_any takes it: the same bits in every slab.
    float p[ANY_R];
    tile_p<T, W_DPL, STATIC_MAX, EXP_BF16>(s, k0 + lane < Lk, m, l, acc, p);
    __syncthreads();  // V staged
    tile_pv(acc, p, Vs, W_SLAB, dw, min(ANY_BK, Lk - k0), lane);
  }
  store_rows(acc, l, ob, rs, q0 + warp * ANY_R, Lq, dw, lane);
}

template <typename T, int DPL>
cudaError_t launch_any_dpl(const Operands& x, int bh, int H, int D, int Lq, int Lk,
                           int static_max, int exp_bf16, float qscale, cudaStream_t st) {
  const int smem = any_smem(D);
  const unsigned grid = grid_x((Lq + ANY_BQ - 1) / ANY_BQ, bh);
  if (grid == 0) return cudaErrorInvalidValue;
  return by_softmax(static_max, exp_bf16, [&](auto sm, auto eb) {
    const auto kernel = flash_fwd_any<T, DPL, decltype(sm)::value, decltype(eb)::value>;
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, ANY_THREADS, smem, st>>>(static_cast<const T*>(x.q), static_cast<const T*>(x.k),
                                            static_cast<const T*>(x.v), static_cast<T*>(x.o),
                                            x.qs, x.ks, x.vs, H, D, Lq, Lk, qscale);
    return cudaGetLastError();
  });
}

// DPL, the columns of O a lane holds: ceil(d / 32) rounded up to a power of two.
template <typename T>
cudaError_t launch_any(const Operands& x, int bh, int H, int D, int Lq, int Lk, int static_max,
                       int exp_bf16, float qscale, cudaStream_t st) {
  const auto go = [&](auto dpl) {
    return launch_any_dpl<T, decltype(dpl)::value>(x, bh, H, D, Lq, Lk, static_max, exp_bf16,
                                                   qscale, st);
  };
  if (D <= 32) return go(std::integral_constant<int, 1>{});
  if (D <= 64) return go(std::integral_constant<int, 2>{});
  if (D <= 128) return go(std::integral_constant<int, 4>{});
  if (D <= 256) return go(std::integral_constant<int, 8>{});
  return go(std::integral_constant<int, 16>{});
}

template <typename T>
cudaError_t launch_wide(const Operands& x, int bh, int H, int D, int Lq, int Lk, int static_max,
                        int exp_bf16, float qscale, cudaStream_t st) {
  const long long nslab = (D + W_SLAB - 1) / W_SLAB;
  const unsigned grid = grid_x((Lq + ANY_BQ - 1) / ANY_BQ * nslab, bh);
  if (grid == 0) return cudaErrorInvalidValue;
  return by_softmax(static_max, exp_bf16, [&](auto sm, auto eb) {
    const auto kernel = flash_fwd_wide<T, decltype(sm)::value, decltype(eb)::value>;
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, W_SMEM);
    if (err != cudaSuccess) return err;
    kernel<<<grid, ANY_THREADS, W_SMEM, st>>>(
        static_cast<const T*>(x.q), static_cast<const T*>(x.k), static_cast<const T*>(x.v),
        static_cast<T*>(x.o), x.qs, x.ks, x.vs, H, D, Lq, Lk, qscale);
    return cudaGetLastError();
  });
}

}  // namespace

// q: (batch, lq, heads, head_dim); k, v: (batch, lk, heads, head_dim), each
// with head_dim dense and the element strides strides[3i .. 3i + 2] = (batch,
// token, head) of q, k, v (i = 0, 1, 2): multiples of 16 bytes, and 16-byte
// aligned pointers, wherever a kernel loads 16-byte vectors or TMA boxes (the
// wrapper passes nothing else). o: (batch, lq, heads, head_dim), contiguous.
// All bf16 (is_bf16 = 1) or all fp32; any head_dim from 1 up. static_max
// selects static max; otherwise exp_bf16 rounds s - m to bf16 before exp2
// (VDPP_FLASH_EXP=bf16). qscale = log2(e) / sqrt(head_dim).
extern "C" int vdpp_flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                        const long long* strides, int is_bf16, int batch,
                                        int heads, int lq, int lk, int head_dim, int static_max,
                                        int exp_bf16, float qscale, void* stream) {
  if (batch <= 0 || heads <= 0 || lq <= 0 || lk <= 0 || head_dim <= 0 ||
      (long long)batch * heads > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const Operands x = {q, k, v, o, {strides[0], 0, strides[1], strides[2]},
                      {strides[3], 0, strides[4], strides[5]},
                      {strides[6], 0, strides[7], strides[8]}};
  const int bh = batch * heads;
  if (head_dim > ANY_MAX_D) {
    return (int)(is_bf16 ? launch_wide<__nv_bfloat16>(x, bh, heads, head_dim, lq, lk, static_max,
                                                      exp_bf16, qscale, st)
                         : launch_wide<float>(x, bh, heads, head_dim, lq, lk, static_max,
                                              exp_bf16, qscale, st));
  }
  if (head_dim == X_D) {
    if (is_bf16) {
      return (int)launch_d512_bf16(x, batch, heads, lq, lk, static_max, exp_bf16, qscale, st);
    }
    return (int)by_softmax(static_max, exp_bf16, [&](auto sm, auto eb) {
      return launch_d512_f32<decltype(sm)::value, decltype(eb)::value>(x, bh, heads, lq, lk,
                                                                       qscale, st);
    });
  }
  if (is_bf16 && head_dim == 64) {
    return (int)launch_d_bf16<64>(x, batch, heads, lq, lk, static_max, exp_bf16, qscale, st);
  }
  if (is_bf16 && head_dim == 72) {
    return (int)launch_d_bf16<72>(x, batch, heads, lq, lk, static_max, exp_bf16, qscale, st);
  }
  if (static_max && head_dim == 64) return (int)launch_f32<64>(x, bh, heads, lq, lk, qscale, st);
  if (static_max && head_dim == 72) return (int)launch_f32<72>(x, bh, heads, lq, lk, qscale, st);
  return (int)(is_bf16 ? launch_any<__nv_bfloat16>(x, bh, heads, head_dim, lq, lk, static_max,
                                                   exp_bf16, qscale, st)
                       : launch_any<float>(x, bh, heads, head_dim, lq, lk, static_max, exp_bf16,
                                           qscale, st));
}

// Dynamic shared memory of one CTA of the kernel that takes head_dim in bf16
// (is_bf16 = 1) or fp32, for reports: 0 for the fp32 kernel at d = 64/72
// (static max), which has only static shared memory.
extern "C" int vdpp_flash_attention_smem(int head_dim, int is_bf16) {
  if (head_dim > ANY_MAX_D) return W_SMEM;
  if (head_dim == X_D) return is_bf16 ? X_SMEM : (int)F_SMEM;
  if (head_dim == 64 || head_dim == 72) {
    if (!is_bf16) return 0;
    return head_dim == 64 ? WgLayout<64>::SMEM : WgLayout<72>::SMEM;
  }
  return head_dim > 0 ? any_smem(head_dim) : 0;
}
