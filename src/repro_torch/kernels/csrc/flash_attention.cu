// Flash-attention forward for Hopper (sm_90a), GQA, causal, optional softcap.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (_fa_kernel / flash_attention), which the JAX model reaches through its
// jnp twin _flash_attention_qchunked for self-attention with S > 2048. It
// computes what _fa_kernel computes: scaled Q K^T, optional tanh softcap,
// the causal mask with the -1e30 fill, an online softmax, P V, and the
// division by the row sum clamped at 1e-30.
//
// What bounds it: at the prefill shape (qwen3-1.7b, B=2, S=4096, 16 heads,
// D=128, causal) one call does 4*B*H*S*S*D/2 = 1.37e11 FLOP on ~100 MB of
// q/k/v/o, so it is bound by operations (the tensor cores), not bytes: the
// design is about keeping wgmma busy. At D 64 the exponentials of a tile
// (16 a clock an SM) take as long as its products, so there the design is
// about running the two at once.
//
// The model layout (B, S, KV, G, D) is read in place: q is seen as
// (B, S, H, D) with H = KV*G, k/v as (B, S, KV, D), and q head h reads kv
// head h / G (no repeat of K/V). The last dimension is contiguous and every
// stride a multiple of 16 bytes, as TMA needs.
//
//   * bf16 (the serving path), FlashAttention-3's shape. A CTA of one
//     producer and WG consumer warpgroups works on q tiles of 64 * WG rows
//     of one (batch, head) each. Tiles are numbered heaviest first (causal
//     q tiles from the last), and causal kv tiles wholly above the
//     diagonal are never loaded. The grid is persistent: one CTA per SM
//     walks a snake through the numbered tiles (even rounds left to right,
//     odd ones right to left), which evens out the causal tiles' sizes,
//     lets the producer load the next tile's Q, K and V while the
//     consumers finish this one, and lifts any limit on B * H.
//     - Producer warpgroup (registers lowered by setmaxnreg): one thread
//       issues TMA loads. Tensor maps over the strided model layout (rank
//       4: D, heads, S, B; built on the host with cuTensorMapEncodeTiled,
//       reached through cudaGetDriverEntryPoint, so no -lcuda) copy boxes
//       into shared memory under a swizzle: 64 columns (one 128-byte row,
//       the 128-byte swizzle) where 64 divides D, else 32 (the 64-byte
//       swizzle); rows past Sq or Sk come in as zeros. Q has a full and an
//       empty mbarrier (released after the tile's last Q K^T); K and V
//       stream through 2 stages of 128 keys, each with a full and an empty
//       mbarrier, K and V on separate barriers so Q K^T starts before V
//       has landed.
//     - Consumer warpgroups (registers raised by setmaxnreg), 64 q rows
//       each. S = Q K^T is wgmma m64n128k16 with both operands in shared
//       memory, K-major, through swizzled descriptors; O += P V is wgmma
//       m64nDk16 with A = P in registers (the S accumulator's fragment
//       layout is the register A operand's, so P is S converted to bf16 in
//       place) and B = V in shared memory, MN-major (the descriptor's
//       transpose bit; its leading offset steps from box to box). Both
//       accumulate in f32 registers. The softmax runs on the accumulator
//       fragments (a row's 128 keys sit in one quad of lanes; max and sum
//       by halving trees, not serial chains), with scale * log2(e) folded
//       into one FFMA before ex2. Only tiles that cross the diagonal or the
//       ragged end of Sk are masked; the others run a mask-free body.
//     - Softcap: the tile takes t = tanh(s * scale / softcap) with one
//       tanh.approx.f32 (a MUFU operation) and softcap * log2(e) goes into
//       the FFMA before ex2 (the row max commutes with the positive factor;
//       the mask's -1e30 times 43 stays finite): two MUFU operations a
//       score, as many cycles as the tile's products take at D 128, so the
//       capped tile runs near the products' pace. tanh.approx's relative
//       error (at most 2^-10.987) is held to the same tolerances as the
//       rest: with q scaled by 8 (|s| up to about 44, past the cap) at
//       grok-1's shape, rel 1.74e-3 and row 3.18e-3 against 1.73e-3 and
//       3.16e-3 for the exact tanhf (scripts/bench_flash.py).
//     - Epilogue: normalise in registers, write bf16 through the output's
//       strides, rows past Sq skipped; with TMA_STORE, into shared memory
//       (stmatrix) and out with TMA.
//     Per head dim (kernel-alone times from scripts/bench_flash.py on an
//     NVIDIA H100 80GB HBM3 at 700 W, beside F.scaled_dot_product_attention
//     in the same call; PERF.md has every run):
//     - D 128 (qwen3, the dense archs, grok-1): two consumer warpgroups
//       (232 registers; producer 40) on 128-row tiles, Q 32 KB + 2 x (K 32
//       KB + V 32 KB) + O 2 x 16 KB = 192 KB. In turns, as at D 64 below,
//       and with a TMA store of the output. 0.2280 ms against SDPA's 0.2493
//       at the prefill shape, 0.985x and 0.970x SDPA at the archs' G 4 and
//       G 16 (the design before, with neither: 0.2412, 1.04x, 1.03x);
//       grok-1's softcap 0.825 ms (1.337 with tanhf). Probes at the prefill
//       shape, against the design without the TMA store: the global stores
//       skipped 5.0 % faster (the TMA store took 2.6 % of it), K/V loaded
//       once 3.5 % faster (so L2 -> shared memory traffic is a limit; 3
//       stages are 0.2 % slower, so it is not latency), the masked body on
//       every tile 9 % slower.
//     - D 96 (phi-3-vision): three 32-column boxes a row, so Q K^T runs 6
//       k-steps and P V one wgmma n96 a k-step, with no work on padding
//       columns; three consumer warpgroups (160 registers; producer 32) on
//       192-row tiles, Q 36 KB + 2 x (24 + 24) KB = 132 KB. Where causal
//       masking leaves a warpgroup's rows no key of a K/V tile, it only
//       frees the stage. 0.6449 ms against SDPA's 0.6716 at B 2, S 5,120,
//       32 heads (in the D 128 layout, zero-filled past column 96: 0.7472).
//     - D 64 (granite-moe, seamless): three consumer warpgroups on 192-row
//       tiles, Q 24 KB + 2 x (16 + 16) KB = 88 KB. A warpgroup issues
//       Q K_j^T together with P_{j-1} V_{j-1}, in turns that named barriers
//       pass round the warpgroups, and runs tile j's exponentials while its
//       own and the others' products run. 0.1631 ms against SDPA's 0.1772
//       at seamless's encoder (B 2, S 3,072, 16 heads, full; the D 128
//       design 0.1799). With softcap (no model at D 64 has one) it spills
//       188 bytes.
//   * f32 (any model run with compute_dtype float32, and the card-against-
//     CPU checks), held to 2e-5 (allclose) against the plain version: both
//     products on the tensor cores in 3xTF32. Each operand x is split into
//     hi = tf32(x) and lo = tf32(x - hi), rounded to nearest (ties away, as
//     cvt.rna) with the low 13 bits cleared, and a product is lo.hi + hi.lo
//     + hi.hi with f32 sums (each product's error about 2^-21). What bounds
//     it: operations, FLOP / (495 / 3 TFLOP/s), 0.833 ms at the prefill
//     shape in f32. mma.sync m16n8k8 (tf32 wgmma takes both shared operands
//     K-major only, and Q, K and V split in shared memory for one 64-row
//     warpgroup do not fit in 227 KB beside a staging buffer at useful
//     tile sizes). A CTA of NW warps, 16 q rows each, per q tile of one
//     (batch, head), in a flat grid numbered heaviest first (causal: the
//     last q tiles first), so B * H has no limit.
//     - K/V: cp.async lands tile j + 1's raw f32 rows (zeros past Sk) while
//       the warps compute on tile j; then one pass of all threads splits
//       every element once, into 16-byte {hi, hi, lo, lo} words in fragment
//       order (K by column pairs, V by key pairs), so a B fragment is one
//       conflict-free 16-byte load. Causal K/V tiles wholly above the
//       diagonal are never loaded, and a warp skips those above its rows.
//     - Q: D 64 split once into registers; D 96 and 128 raw in shared
//       memory and split for every K/V tile (registers are the limit: at
//       D 128, Q in registers spilled and ran 1.4x slower).
//     - S = Q K^T: hi.hi and the two small products in two accumulators,
//       added once in f32. The tensor cores' f32 sums truncate; the small
//       products' accumulator is 2^-11 smaller, so its truncation is lost.
//     - Softmax on the score fragments in registers (quad shuffles for a
//       row's max and sum), scale * log2 e folded into one FFMA before
//       ex2.approx; softcap with the accurate tanhf. Only tiles that cross
//       the diagonal or the ragged end of Sk are masked.
//     - P V: P split in registers; the score fragment is the A operand's
//       layout once k position t is key 2t and t + 4 is key 2t + 1 (V's
//       split words follow that order). Each K/V tile's P V is summed
//       afresh, CH n-tiles of O at a time (hi.hi and the small products
//       apart), and added to O in one rounded FFMA that also rescales O:
//       the truncating sums never run over more than one tile of keys.
//       Summed into O directly they ran over the whole row, and the error
//       grew with S: 0.27 of the tolerance at the prefill shape and 1.08
//       (a failure) at S 32,768 non-causal, against 0.06 and 0.02 here.
//     Per head dim (F32Design): D 64 4 warps, 64-key tiles, Q in
//     registers, 101 KB, 2 CTAs a SM; D 96 4 warps, 32-key tiles, 101 KB,
//     2 a SM; D 128 8 warps, 32-key tiles, Q 68 KB + raw K/V 32 KB + split
//     K/V 68 KB = 167 KB, one a SM, and 4 warps (64-row tiles, twice the
//     CTAs) where 128-row tiles would leave SMs idle. Times (kernel alone,
//     scripts/bench_flash.py on an NVIDIA H100 80GB HBM3 at 700 W, beside
//     F.scaled_dot_product_attention in the same call; PERF.md has every
//     run): qwen3-1.7b's prefill shape in f32 2.61 ms against SDPA's 13.36
//     (0.20x; 32 % of the bound), the small check's shape (B 2, S 2,304, D
//     64) 0.191 against 1.080, and the four test shapes 0.019-0.053 ms
//     (0.32-1.06x SDPA; 1.06x at S 333 non-causal, 12 CTAs), where the
//     design before (shared-memory FMA loops, 4 warps of 64 rows a CTA)
//     took 0.068-0.193, 0.653 and 10.95 ms.
//
// Measured on the H100 and left out, being slower (PERF.md has the times):
// at D 128, issuing Q K_j^T ahead of P_{j-1} V_{j-1} with no turns, turns
// without it (ping-pong), one CTA per tile instead of the persistent grid,
// 3 K/V stages, the causal diagonal tile cut to 64 keys for warpgroup 0
// (a 64-key wgmma chosen at run time: every D 128 shape 35 % slower), and
// with softcap: tanh as ex2 + rcp (two MUFU operations, 1.03 ms at grok-1's
// shape), 2 or 4 of every 8 ex2 as a cubic on the FMA pipe (5 % slower),
// and no turns (0.892 ms against 0.826 with the TMA store; without it, no
// turns would be 1.4 % faster than this design, 0.815 ms, but D 128 keeps
// one design with and without softcap); at D 64, the same overlap with no turns (at two and three
// warpgroups), turns at two warpgroups, 3 and 4 K/V stages, and 2 of every
// 8 ex2 as the cubic; at D 96, two warpgroups, turns (which spill at three
// warpgroups), and 3 K/V stages. Not done: a 2-CTA cluster that multicasts
// one K/V load to two q heads of one kv head (the K/V-loaded-once probe's
// 3.5 %), packing the G q heads of one kv head into one CTA.
// f32, measured and left out (PERF.md has the times): each warp splitting its own
// K/V fragments (every element split once a warp; 4.59 ms at the f32
// prefill shape), cvt.rna.tf32.f32 for the rounding (the same bits behind
// an inf/NaN guard: 16-25 % slower), Q in registers at D 96 and 128
// (spills), P V summed into O directly (error grows with S; fails at S
// 32,768), one accumulator for all three score products (less accurate,
// no faster), three (no faster), 2, 8 or 16 n-tiles of O a P V pass, the
// split loops unrolled (more spills), 64-key tiles at D 128 (Q then fits
// only in registers), 16-key tiles, 3 CTAs a SM at D 64, and 2 warps a CTA
// for small grids. Not done: wgmma (see above), a persistent grid, and a
// split over keys for the smallest grids (the fixed entry point has no
// scratch for its partial sums).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;   // the JAX kernel's mask value
constexpr unsigned FULL = 0xffffffffu;

struct Strides {
  long long b, s, h;
};

// ======================================================= bf16: Hopper
using bf16 = __nv_bfloat16;

constexpr int HBK = 128;           // keys per K/V stage
constexpr int STAGES = 2;          // K/V ring depth
constexpr float LOG2E = 1.4426950408889634f;

// The design each head dim ships: WG consumer warpgroups of 64 q rows
// share a q tile. With PINGPONG a warpgroup issues Q K_j^T and
// P_{j-1} V_{j-1} together, in turns with the other warpgroups, and runs
// tile j's softmax while its own P V and the others' products are on the
// tensor cores. With TMA_STORE a warpgroup stages its 64 output rows in
// shared memory and one thread stores them with TMA, so that the writes
// run on while the next tile starts.
template <int WG_, bool PINGPONG_, bool TMA_STORE_ = false>
struct Knobs {
  static constexpr int WG = WG_;
  static constexpr bool PINGPONG = PINGPONG_;
  static constexpr bool TMA_STORE = TMA_STORE_;
};
template <int D>
struct Design;
template <>
struct Design<64> : Knobs<3, true> {};
template <>
struct Design<96> : Knobs<3, false> {};
template <>
struct Design<128> : Knobs<2, true, true> {};

template <int D>
struct HopperLayout {
  static constexpr int WG = Design<D>::WG;
  static constexpr int BQ = 64 * WG;              // q rows per tile
  static constexpr int THREADS = 128 * (WG + 1);  // producer + consumer warpgroups
  // registers a thread (setmaxnreg) of the consumers and of the producer
  static constexpr int REGS = WG == 2 ? 232 : 160;
  static constexpr int PREGS = WG == 2 ? 40 : 32;
  // A box is 64 columns, one 128-byte row under the 128-byte swizzle,
  // where 64 divides D; else 32 columns under the 64-byte swizzle.
  static constexpr int BOX_COLS = D % 64 == 0 ? 64 : 32;
  static constexpr int ROW = 2 * BOX_COLS;             // bytes of one swizzled box row
  static constexpr int SWIZZLE = ROW == 128 ? 1 : 2;   // the wgmma descriptor's layout type
  static constexpr int BOXES = D / BOX_COLS;           // boxes per tile row
  static constexpr int Q_BOX = BQ * ROW;               // bytes of one box of the Q tile
  static constexpr int KV_BOX = HBK * ROW;             // ... of a K or V stage
  static constexpr int O_BOX = 64 * ROW;               // ... of a warpgroup's output rows
  static constexpr bool TMA_STORE = Design<D>::TMA_STORE;
  static_assert(!TMA_STORE || ROW == 128, "the output's staging assumes the 128-byte swizzle");
  static constexpr int Q = 0;
  static constexpr int K = Q + BOXES * Q_BOX;
  static constexpr int V = K + STAGES * BOXES * KV_BOX;
  static constexpr int O = V + STAGES * BOXES * KV_BOX;  // TMA_STORE: per warpgroup
  static constexpr int BAR = O + (TMA_STORE ? WG * BOXES * O_BOX : 0);
  static constexpr int NBAR = 2 + 4 * STAGES;  // q full/empty, k/v full, k/v empty
  static constexpr size_t BYTES = BAR + 8 * NBAR + 1024;  // + slack to align the base to 1 KB
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count));
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}
// returns once the phase of parity `phase` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int phase) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(phase)
      : "memory");
}

// one box of a rank-4 tensor map -> shared memory, completing on `bar`
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar,
                                         int col, int head, int row, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(col), "r"(head), "r"(row),
      "r"(batch)
      : "memory");
}

// one box of shared memory -> a rank-4 tensor map; rows past the tensor's
// end are not written
__device__ __forceinline__ void tma_store(const CUtensorMap* map, const void* src, int col,
                                          int head, int row, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_addr(src)), "r"(col), "r"(head), "r"(row), "r"(batch)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// returns once this thread's bulk stores have read their shared memory
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
// returns once they have completed
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
// this thread's writes to shared memory, seen by the TMA (async proxy)
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// four 8x8 bf16 matrices: lanes 8m..8m+7 give matrix m's row addresses,
// and each thread's register m holds its two values of matrix m
__device__ __forceinline__ void stmatrix_x4(uint32_t addr, uint32_t a, uint32_t b, uint32_t c,
                                            uint32_t d) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "r"(a), "r"(b), "r"(c), "r"(d)
               : "memory");
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// returns once at most N committed groups are still running
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// pins registers at this point: no read moves above a wait, no write
// below an issue
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) asm volatile("" : "+r"(r[i][c])::"memory");
}

// wgmma shared-memory descriptor: start address, leading and stride byte
// offsets (16-byte units), layout type SWIZZLE (1: 128-byte, 2: 64-byte)
template <int SWIZZLE>
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | ((uint64_t)SWIZZLE << 62);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// one MUFU operation, relative error at most 2^-10.987 (PTX ISA)
__device__ __forceinline__ float tanh_approx(float x) {
  float y;
  asm("tanh.approx.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// d (64 x 128) = A (64 x 16, shared, K-major) . B (128 x 16, shared, K-major)^T,
// plus d where acc != 0
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16\n{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "},\n"
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(acc));
}

// d (64 x 128) += A (64 x 16, registers) . B (16 x 128, shared, MN-major)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16\n{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "},\n"
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 96) += A (64 x 16, registers) . B (16 x 96, shared, MN-major)
__device__ __forceinline__ void wgmma_rs_n96(float (&d)[48], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16\n{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
      "},\n"
      "{%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 64) += A (64 x 16, registers) . B (16 x 64, shared, MN-major)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16\n{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "},\n"
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// S = Q K^T over D: D/16 k-steps; a k-step is 32 bytes along a swizzled
// box row, and the next box starts at the next BOX_COLS columns
template <int D>
__device__ __forceinline__ void qk_issue(float (&s)[64], const unsigned char* q,
                                         const unsigned char* k) {
  using LY = HopperLayout<D>;
  constexpr int STEPS = LY::BOX_COLS / 16;  // k-steps per box
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int off = (kk % STEPS) * 32;
    const uint64_t da =
        smem_desc<LY::SWIZZLE>(q + (kk / STEPS) * LY::Q_BOX + off, 16, 8 * LY::ROW);
    const uint64_t db =
        smem_desc<LY::SWIZZLE>(k + (kk / STEPS) * LY::KV_BOX + off, 16, 8 * LY::ROW);
    wgmma_ss_n128(s, da, db, kk > 0);
  }
}

// O += P V over the stage's 128 keys, one wgmma of n = D a k-step: V is
// MN-major (rows are keys, D is contiguous); a k-step is 16 key rows, the
// leading offset steps to the next box of D, the stride offset to the
// next 8 keys
template <int D>
__device__ __forceinline__ void pv_issue(float (&o)[D / 2], const uint32_t (&p)[HBK / 16][4],
                                         const unsigned char* v) {
  using LY = HopperLayout<D>;
#pragma unroll
  for (int kk = 0; kk < HBK / 16; ++kk) {
    const uint64_t db = smem_desc<LY::SWIZZLE>(v + kk * 16 * LY::ROW, LY::KV_BOX, 8 * LY::ROW);
    if constexpr (D == 128)
      wgmma_rs_n128(o, p[kk], db);
    else if constexpr (D == 96)
      wgmma_rs_n96(o, p[kk], db);
    else
      wgmma_rs_n64(o, p[kk], db);
  }
}

// halving tree over the first 2W values in place; the result lands in a[0]
template <int W, int N, typename Op>
__device__ __forceinline__ void tree(float (&a)[N], Op op) {
  if constexpr (W >= 1) {
#pragma unroll
    for (int i = 0; i < W; ++i) a[i] = op(a[i], a[i + W]);
    tree<W / 2>(a, op);
  }
}

// With softcap the tile holds tanh(s * scale / softcap), and softcap * log2 e
// goes into mul: the row max commutes with the positive factor, and the
// mask's -1e30 times it stays finite.
template <bool CAP>
struct Softmax {
  float m[2] = {NEG_INF, NEG_INF};  // running max of this thread's two rows
  float l[2] = {0.f, 0.f};          // this thread's partial row sums
  float mul;                        // score (CAP: its tanh) -> log2 units
  float cap_in;                     // CAP: scale / softcap

  // scores -> unnormalised probabilities in place; returns in corr the
  // factors that rescale what was accumulated before this tile.
  // Accumulator element i sits at row g + 8*((i>>1)&1) and column
  // 8*(i>>2) + 2*t4 + (i&1) of the warp's 16 x 128 slice.
  template <bool MASK>
  __device__ __forceinline__ void tile(float (&s)[64], float (&corr)[2], int k0, int row_a,
                                       int t4, int Sk, int causal) {
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      if (CAP) s[i] = tanh_approx(s[i] * cap_in);
      if (MASK) {
        const int key = k0 + 8 * (i >> 2) + 2 * t4 + (i & 1);
        const int row = row_a + 8 * ((i >> 1) & 1);
        if (key >= Sk || (causal && key > row)) s[i] = NEG_INF;
      }
    }
    float neg[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) mx[j] = fmaxf(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]);
      tree<8>(mx, [](float a, float b) { return fmaxf(a, b); });
      // a row's keys sit in one quad of lanes
      mx[0] = fmaxf(mx[0], __shfl_xor_sync(FULL, mx[0], 1));
      mx[0] = fmaxf(fmaxf(mx[0], __shfl_xor_sync(FULL, mx[0], 2)), m[r]);
      corr[r] = ex2((m[r] - mx[0]) * mul);
      m[r] = mx[0];
      neg[r] = -mx[0] * mul;
    }
#pragma unroll
    for (int i = 0; i < 64; ++i) s[i] = ex2(fmaf(s[i], mul, neg[(i >> 1) & 1]));
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float sum[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) sum[j] = s[4 * j + 2 * r] + s[4 * j + 2 * r + 1];
      tree<8>(sum, [](float a, float b) { return a + b; });
      l[r] = l[r] * corr[r] + sum[0];
    }
  }
};

// P (bf16) as the register A operand of k-step kk: the accumulator's
// elements 8kk..8kk+7 in order
__device__ __forceinline__ void to_p(uint32_t (&p)[HBK / 16][4], const float (&s)[64]) {
#pragma unroll
  for (int kk = 0; kk < HBK / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) p[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
}

template <int N>
__device__ __forceinline__ void rescale(float (&o)[N], const float (&corr)[2]) {
#pragma unroll
  for (int i = 0; i < N; ++i) o[i] *= corr[(i >> 1) & 1];
}

// Turns on the tensor cores (PINGPONG): named barrier 1 + w is warpgroup
// w's; it waits there for its turn and then arrives at the next one's.
template <int WG>
__device__ __forceinline__ void take_turn(int w) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(1 + w) : "memory");
}
template <int WG>
__device__ __forceinline__ void pass_turn(int w) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(1 + (w + 1) % WG) : "memory");
}
// the 128 threads of consumer warpgroup w meet (named barrier 1 + WG + w)
template <int WG>
__device__ __forceinline__ void wg_sync(int w) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + WG + w) : "memory");
}

struct Barriers {
  uint64_t* q_full;
  uint64_t* q_empty;
  uint64_t* k_full;  // [STAGES]
  uint64_t* v_full;
  uint64_t* k_empty;
  uint64_t* v_empty;
};

// The CTA's work list. Tiles of BQ q rows are numbered heaviest first
// (causal q tiles from the last; within one, every (batch, head)); CTA c
// takes tiles r * gridDim.x + c in even rounds r and
// r * gridDim.x + gridDim.x - 1 - c in odd ones, a snake that evens out
// the causal tiles' sizes.
struct Tile {
  int h, b, q0, nkt;
};
template <int BQ>
struct Work {
  int tiles, nqt, H, B, Sk, causal;

  __device__ __forceinline__ int index(int r) const {
    const int c = (r & 1) ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
    return r * gridDim.x + c;
  }
  __device__ __forceinline__ bool has(int r) const { return index(r) < tiles; }
  __device__ __forceinline__ Tile at(int r) const {
    const int i = index(r);
    const int bh = i % (H * B);
    Tile t;
    t.h = bh % H;
    t.b = bh / H;
    t.q0 = (nqt - 1 - i / (H * B)) * BQ;
    const int kv_end = causal ? min(Sk, t.q0 + BQ) : Sk;
    t.nkt = (kv_end + HBK - 1) / HBK;
    return t;
  }
};

template <int D>
__device__ __forceinline__ void produce(const CUtensorMap* qm, const CUtensorMap* km,
                                        const CUtensorMap* vm, unsigned char* smem, Barriers br,
                                        Work<HopperLayout<D>::BQ> wk, int G) {
  using LY = HopperLayout<D>;
  int j = 0;  // K/V tiles loaded so far, over all of the CTA's q tiles
  for (int r = 0; wk.has(r); ++r) {
    const Tile t = wk.at(r);
    if (r > 0) mbar_wait(br.q_empty, (r - 1) & 1);  // the last Q K^T of tile r-1 is done
    mbar_expect_tx(br.q_full, LY::BQ * D * sizeof(bf16));
#pragma unroll
    for (int c = 0; c < LY::BOXES; ++c)
      tma_load(smem + LY::Q + c * LY::Q_BOX, qm, br.q_full, c * LY::BOX_COLS, t.h, t.q0, t.b);
    for (int jj = 0; jj < t.nkt; ++jj, ++j) {
      const int st = j % STAGES;
      const int ph = (j / STAGES) & 1;
      mbar_wait(br.k_empty + st, ph ^ 1);  // the first round finds the stage free
      mbar_expect_tx(br.k_full + st, HBK * D * sizeof(bf16));
#pragma unroll
      for (int c = 0; c < LY::BOXES; ++c)
        tma_load(smem + LY::K + (st * LY::BOXES + c) * LY::KV_BOX, km, br.k_full + st,
                 c * LY::BOX_COLS, t.h / G, jj * HBK, t.b);
      mbar_wait(br.v_empty + st, ph ^ 1);
      mbar_expect_tx(br.v_full + st, HBK * D * sizeof(bf16));
#pragma unroll
      for (int c = 0; c < LY::BOXES; ++c)
        tma_load(smem + LY::V + (st * LY::BOXES + c) * LY::KV_BOX, vm, br.v_full + st,
                 c * LY::BOX_COLS, t.h / G, jj * HBK, t.b);
    }
  }
}

template <int D, bool CAP>
__device__ __forceinline__ void consume(unsigned char* smem, Barriers br, bf16* __restrict__ o,
                                        const CUtensorMap* om, Strides os,
                                        Work<HopperLayout<D>::BQ> wk, int Sq, float scale,
                                        float softcap) {
  using LY = HopperLayout<D>;
  constexpr bool PINGPONG = Design<D>::PINGPONG;
  // A warpgroup skips the K/V tiles whose keys are all masked for its
  // rows; there are such tiles only where a q tile spans more rows than a
  // K/V tile. Turns need every warpgroup to take as many, so not there.
  constexpr bool SKIP = LY::BQ > HBK && !PINGPONG;
  const int w = threadIdx.x / 128 - 1;  // consumer warpgroup 0 .. WG-1
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int t4 = lane & 3;
  const bool lead = lane == 0;  // arrives for its warp
  const int Sk = wk.Sk;
  const int causal = wk.causal;
  const unsigned char* qs = smem + LY::Q + w * 64 * LY::ROW;
  auto k_stage = [&](int st) { return smem + LY::K + st * LY::BOXES * LY::KV_BOX; };
  auto v_stage = [&](int st) { return smem + LY::V + st * LY::BOXES * LY::KV_BOX; };

  if constexpr (PINGPONG)
    if (w == LY::WG - 1) pass_turn<LY::WG>(w);  // warpgroup 0 goes first

  float acc[D / 2];
  float s[64];
  uint32_t p[HBK / 16][4];
  float corr[2];
  int j = 0;  // K/V tiles consumed so far, over all of the CTA's q tiles
  for (int r = 0; wk.has(r); ++r) {
    const Tile t = wk.at(r);
    const int wrow0 = t.q0 + 64 * w;                    // this warpgroup's first q row
    const int row_a = wrow0 + 16 * warp + (lane >> 2);  // this thread's two rows
    int n = t.nkt;  // the K/V tiles this warpgroup computes on
    if constexpr (SKIP)
      n = wrow0 >= Sq ? 0 : min(n, ((causal ? min(Sk, wrow0 + 64) : Sk) + HBK - 1) / HBK);
    Softmax<CAP> sm;
    sm.cap_in = CAP ? scale / softcap : 0.f;
    sm.mul = (CAP ? softcap : scale) * LOG2E;
    auto softmax = [&](int jj) {
      const int k0 = jj * HBK;
      if (k0 + HBK > Sk || (causal && k0 + HBK - 1 > wrow0))
        sm.template tile<true>(s, corr, k0, row_a, t4, Sk, causal);
      else
        sm.template tile<false>(s, corr, k0, row_a, t4, Sk, causal);
    };
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

    mbar_wait(br.q_full, r & 1);
    if constexpr (SKIP)
      if (n == 0 && lead) mbar_arrive(br.q_empty);
    if constexpr (!PINGPONG) {
      for (int jj = 0; jj < n; ++jj, ++j) {
        const int st = j % STAGES;
        const int ph = (j / STAGES) & 1;
        mbar_wait(br.k_full + st, ph);
        wg_fence();
        qk_issue<D>(s, qs, k_stage(st));
        wg_commit();
        wg_wait<0>();
        fence_regs(s);
        // S has landed: free K, and Q after this warpgroup's last K/V tile
        if (lead) {
          mbar_arrive(br.k_empty + st);
          if (jj == n - 1) mbar_arrive(br.q_empty);
        }
        softmax(jj);
        rescale(acc, corr);
        to_p(p, s);
        fence_regs(acc);
        mbar_wait(br.v_full + st, ph);
        wg_fence();
        pv_issue<D>(acc, p, v_stage(st));
        wg_commit();
        wg_wait<0>();
        fence_regs(acc);
        if (lead) mbar_arrive(br.v_empty + st);
      }
    } else if (n > 0) {
      // S_0, then for each later tile: issue Q K_jj^T and P_{jj-1} V_{jj-1}
      // in this warpgroup's turn, run tile jj's softmax while the products
      // run, rescale after them
      {
        const int st = j % STAGES;
        mbar_wait(br.k_full + st, (j / STAGES) & 1);
        take_turn<LY::WG>(w);
        wg_fence();
        qk_issue<D>(s, qs, k_stage(st));
        wg_commit();
        pass_turn<LY::WG>(w);
        wg_wait<0>();
        fence_regs(s);
        if (lead) {
          mbar_arrive(br.k_empty + st);
          if (n == 1) mbar_arrive(br.q_empty);
        }
        softmax(0);
        to_p(p, s);
      }
      for (int jj = 1; jj < n; ++jj) {
        const int jp = j + jj - 1;  // the tile whose P V runs now
        const int st = (jp + 1) % STAGES;
        const int stp = jp % STAGES;
        mbar_wait(br.k_full + st, ((jp + 1) / STAGES) & 1);
        mbar_wait(br.v_full + stp, (jp / STAGES) & 1);
        fence_regs(acc);
        fence_regs(p);
        take_turn<LY::WG>(w);
        wg_fence();
        qk_issue<D>(s, qs, k_stage(st));
        wg_commit();
        pv_issue<D>(acc, p, v_stage(stp));
        wg_commit();
        pass_turn<LY::WG>(w);
        wg_wait<1>();
        fence_regs(s);
        if (lead) {
          mbar_arrive(br.k_empty + st);
          if (jj == n - 1) mbar_arrive(br.q_empty);
        }
        softmax(jj);
        wg_wait<0>();
        fence_regs(acc);
        fence_regs(p);
        if (lead) mbar_arrive(br.v_empty + stp);
        rescale(acc, corr);
        to_p(p, s);
      }
      const int jl = j + n - 1;
      const int stl = jl % STAGES;
      mbar_wait(br.v_full + stl, (jl / STAGES) & 1);
      fence_regs(acc);
      fence_regs(p);
      take_turn<LY::WG>(w);
      wg_fence();
      pv_issue<D>(acc, p, v_stage(stl));
      wg_commit();
      pass_turn<LY::WG>(w);
      wg_wait<0>();
      fence_regs(acc);
      if (lead) mbar_arrive(br.v_empty + stl);
      j += n;
    }
    if constexpr (SKIP) {
      // the tile's remaining K/V stages: this warpgroup only frees them
      for (int jj = n; jj < t.nkt; ++jj, ++j) {
        const int st = j % STAGES;
        const int ph = (j / STAGES) & 1;
        mbar_wait(br.k_full + st, ph);
        if (lead) mbar_arrive(br.k_empty + st);
        mbar_wait(br.v_full + st, ph);
        if (lead) mbar_arrive(br.v_empty + st);
      }
    }

    float inv[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      float l = sm.l[rr];
      l += __shfl_xor_sync(FULL, l, 1);
      l += __shfl_xor_sync(FULL, l, 2);
      inv[rr] = 1.f / fmaxf(l, 1e-30f);
    }
    if constexpr (LY::TMA_STORE) {
      // bf16 O -> this warpgroup's boxes, under the 128-byte swizzle as the
      // tensor map stores them (stmatrix: 8x8 blocks, conflict-free); then
      // one thread stores the boxes, and waits for them only before it
      // writes the boxes again
      unsigned char* ob = smem + LY::O + w * LY::BOXES * LY::O_BOX;
      if (tid == 0) bulk_wait_read();
      wg_sync<LY::WG>(w);
      const int mi = lane >> 3;                              // this lane's matrix of an x4
      const int orow = 16 * warp + 8 * (mi & 1) + (lane & 7);  // its row of the 64
#pragma unroll
      for (int c = 0; c < D / 16; ++c) {  // 8-column blocks 2c and 2c + 1
        const int nb = 2 * c + (mi >> 1);
        const uint32_t addr = smem_addr(ob + (nb / 8) * LY::O_BOX + orow * LY::ROW +
                                        (((nb % 8) ^ (orow & 7)) << 4));
        stmatrix_x4(addr, pack_bf16(acc[8 * c] * inv[0], acc[8 * c + 1] * inv[0]),
                    pack_bf16(acc[8 * c + 2] * inv[1], acc[8 * c + 3] * inv[1]),
                    pack_bf16(acc[8 * c + 4] * inv[0], acc[8 * c + 5] * inv[0]),
                    pack_bf16(acc[8 * c + 6] * inv[1], acc[8 * c + 7] * inv[1]));
      }
      fence_async_smem();
      wg_sync<LY::WG>(w);
      if (tid == 0) {
#pragma unroll
        for (int c = 0; c < LY::BOXES; ++c)
          tma_store(om, ob + c * LY::O_BOX, c * LY::BOX_COLS, t.h, wrow0, t.b);
        bulk_commit();
      }
    } else {
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int row = row_a + 8 * rr;
        if (row >= Sq) continue;
        bf16* orow = o + t.b * os.b + (long long)row * os.s + t.h * os.h + 2 * t4;
#pragma unroll
        for (int n8 = 0; n8 < D / 8; ++n8)
          *reinterpret_cast<uint32_t*>(orow + 8 * n8) =
              pack_bf16(acc[4 * n8 + 2 * rr] * inv[rr], acc[4 * n8 + 2 * rr + 1] * inv[rr]);
      }
    }
  }
  if constexpr (LY::TMA_STORE)
    if (tid == 0) bulk_wait();  // before the CTA's shared memory goes
}

template <int D, bool CAP>
__global__ void __launch_bounds__(HopperLayout<D>::THREADS, 1)
    fa_fwd_hopper(const __grid_constant__ CUtensorMap qm, const __grid_constant__ CUtensorMap km,
                  const __grid_constant__ CUtensorMap vm, const __grid_constant__ CUtensorMap om,
                  bf16* __restrict__ o, Strides os,
                  Work<HopperLayout<D>::BQ> wk, int G, int Sq, float scale, float softcap) {
  using LY = HopperLayout<D>;
  extern __shared__ unsigned char smem_raw[];
  // the 128-byte swizzle repeats every 1 KB (the 64-byte one every 512
  // bytes): tiles start on 1 KB boundaries
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + LY::BAR);
  const Barriers br{bars, bars + 1, bars + 2, bars + 2 + STAGES, bars + 2 + 2 * STAGES,
                    bars + 2 + 3 * STAGES};

  if (threadIdx.x == 0) {
    mbar_init(br.q_full, 1);
    mbar_init(br.q_empty, 4 * LY::WG);  // one arrive per consumer warp
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(br.k_full + st, 1);
      mbar_init(br.v_full + st, 1);
      mbar_init(br.k_empty + st, 4 * LY::WG);
      mbar_init(br.v_empty + st, 4 * LY::WG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // producer: one branch to the end, no reconvergence
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(LY::PREGS));
    if (threadIdx.x == 0) produce<D>(&qm, &km, &vm, smem, br, wk, G);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(LY::REGS));
    consume<D, CAP>(smem, br, o, &om, os, wk, Sq, scale, softcap);
  }
}

// cuTensorMapEncodeTiled, taken from the driver at run time
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &res) ==
            cudaSuccess &&
        res == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// rank-4 map (D, heads, S, batch) over a bf16 tensor with element strides
// st (the wrapper gives a dim of size 1, never stepped, 8: 16 bytes, as TMA
// needs); box (LY::BOX_COLS, 1, rows, 1) under LY's swizzle. Rows past S
// come in as zeros, and still count toward the barrier's transaction bytes.
template <int D>
bool tensor_map(EncodeTiled enc, CUtensorMap* map, const void* base, int heads, int S, int B,
                Strides st, int rows) {
  using LY = HopperLayout<D>;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)st.h * sizeof(bf16), (cuuint64_t)st.s * sizeof(bf16),
                                 (cuuint64_t)st.b * sizeof(bf16)};
  const cuuint32_t box[4] = {(cuuint32_t)LY::BOX_COLS, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides,
             box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             LY::SWIZZLE == 1 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D, bool CAP>
int launch_tiles(const CUtensorMap& qm, const CUtensorMap& km, const CUtensorMap& vm,
                 const CUtensorMap& om, void* o, Strides os, Work<HopperLayout<D>::BQ> wk, int G, int Sq, float scale,
                 float softcap, cudaStream_t stream) {
  auto kern = fa_fwd_hopper<D, CAP>;
  const size_t bytes = HopperLayout<D>::BYTES;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  // persistent: one CTA per SM walks its share of the tiles
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  const int grid = wk.tiles < sms ? wk.tiles : sms;
  kern<<<grid, HopperLayout<D>::THREADS, bytes, stream>>>(qm, km, vm, om, static_cast<bf16*>(o),
                                                          os, wk, G, Sq, scale, softcap);
  return (int)cudaGetLastError();
}

// D: the head dim (the tensors' last extent)
template <int D>
int launch_hopper(const void* q, const void* k, const void* v, void* o, int B, int H, int KVH,
                  int Sq, int Sk, Strides qs, Strides ks, Strides vs, Strides os, float scale,
                  float softcap, int causal, cudaStream_t stream) {
  constexpr int BQ_ = HopperLayout<D>::BQ;
  const int nqt = (Sq + BQ_ - 1) / BQ_;
  if ((long long)nqt * H * B > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const EncodeTiled enc = encode_tiled();
  if (!enc) return (int)cudaErrorNotSupported;
  CUtensorMap qm, km, vm, om;  // om: a warpgroup's 64 rows of the output (TMA_STORE)
  if (!tensor_map<D>(enc, &qm, q, H, Sq, B, qs, BQ_) ||
      !tensor_map<D>(enc, &km, k, KVH, Sk, B, ks, HBK) ||
      !tensor_map<D>(enc, &vm, v, KVH, Sk, B, vs, HBK) ||
      !tensor_map<D>(enc, &om, o, H, Sq, B, os, 64))
    return (int)cudaErrorInvalidValue;
  const Work<BQ_> wk{nqt * H * B, nqt, H, B, Sk, causal};
  if (softcap > 0.f)
    return launch_tiles<D, true>(qm, km, vm, om, o, os, wk, H / KVH, Sq, scale, softcap, stream);
  return launch_tiles<D, false>(qm, km, vm, om, o, os, wk, H / KVH, Sq, scale, softcap, stream);
}

// ======================================================= f32: 3xTF32 on mma.sync
// (the design is in the note at the top of the file)

// The design each head dim ships: NW warps of 16 q rows share a q tile and
// every K/V tile of BK keys. A grid of fewer such tiles than the card has
// SMs takes NW_SMALL warps a CTA instead (shorter q tiles: more SMs at
// work). With Q_RES a thread keeps its Q fragments split (hi, lo) in
// registers for the whole q tile; else Q stays raw in shared memory and is
// split again for every K/V tile (D/2 fewer registers a thread).
template <int NW_, int NW_SMALL_, int BK_, bool Q_RES_>
struct F32Knobs {
  static constexpr int NW = NW_;
  static constexpr int NW_SMALL = NW_SMALL_;
  static constexpr int BK = BK_;
  static constexpr bool Q_RES = Q_RES_;
};
template <int D>
struct F32Design;
template <>
struct F32Design<64> : F32Knobs<4, 4, 64, true> {};
template <>
struct F32Design<96> : F32Knobs<4, 4, 32, false> {};
template <>
struct F32Design<128> : F32Knobs<8, 4, 32, false> {};

// Shared memory, in floats: the raw K and V tiles as cp.async lands them
// (BK x D each), then the split tiles the warps read, each fragment's hi
// and lo in one 16-byte word:
//   SK: key r, columns 2p, 2p + 1 at r * LDSK + 4p: {hi, hi, lo, lo}
//   SV: keys 2p, 2p + 1, column n at p * LDSV + 4n: {hi, hi, lo, lo}
// LDSK = 16 and LDSV = 8 mod 32: a quarter warp's 16-byte fragment loads
// (2 keys x 4 column pairs of K; 4 key pairs x 2 columns of V) hit every
// bank once. Without Q_RES, the raw Q tile follows (BQ rows of LDQ = 8
// mod 32: a half warp's float2 loads hit every bank once).
template <int D, int NW_>
struct F32Layout {
  static constexpr int NW = NW_;
  static constexpr int BK = F32Design<D>::BK;
  static constexpr int BQ = 16 * NW;  // q rows per CTA
  static constexpr int THREADS = 32 * NW;
  static constexpr int LDSK = 2 * D + 16;
  static constexpr int LDSV = 4 * D + 8;
  static constexpr int RAW_V = BK * D;
  static constexpr int SK = 2 * BK * D;
  static constexpr int SV = SK + BK * LDSK;
  static constexpr int LDQ = D + 8;
  static constexpr int Q = SV + (BK / 2) * LDSV;
  static constexpr size_t BYTES =
      sizeof(float) * (Q + (F32Design<D>::Q_RES ? 0 : BQ * LDQ));
  // CTAs a SM: its 228 KB of shared memory, 1 KB of it kept for each CTA
  static constexpr int PER_SM = 233472 / (BYTES + 1024);
};

// 16 bytes global -> shared, asynchronously; zeros where !in (src not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// returns once this thread's copies have all landed
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// x = hi + lo, each a tf32 rounded as cvt.rna.tf32.f32 rounds (to
// nearest, ties away from zero) and with its low 13 bits cleared: half a
// tf32 ulp added to the magnitude bits, then the 13 bits masked. On finite
// x this is cvt.rna's result bit for bit; cvt.rna itself compiles to the
// same add and mask behind an inf/NaN guard (FSETP, SEL) that took 16-25 %
// of the kernel's time (PERF.md). x - hi is exact in f32.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  const uint32_t h = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  hi = h;
  lo = (__float_as_uint(x - __uint_as_float(h)) + 0x1000u) & 0xffffe000u;
}
// the split of a and b as one 16-byte word {hi a, hi b, lo a, lo b}
__device__ __forceinline__ uint4 split_pair(float a, float b) {
  uint4 w;
  split_tf32(a, w.x, w.z);
  split_tf32(b, w.y, w.w);
  return w;
}

// d (16 x 8) += a (16 x 8, row) . b (8 x 8, col), tf32 in, f32 sums.
// a: (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4); b: (t, g), (t + 4, g);
// d: (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1) (g = lane / 4, t = lane % 4)
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d + dl += a . b in 3xTF32, b as {hi, hi, lo, lo}: the two small products
// (first, as CUTLASS's fast f32 orders them) into dl, hi.hi into d
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], float (&dl)[4], const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], uint4 b) {
  mma_tf32(dl, al, b.x, b.y);
  mma_tf32(dl, ah, b.z, b.w);
  mma_tf32(d, ah, b.x, b.y);
}

// The online softmax of a warp's 16 rows on the score fragments: this
// thread holds rows g (r = 0) and g + 8 (r = 1), keys 8n + 2t + (i & 1) of
// s[n][i], row g + 8 * (i >> 1). With softcap the tile holds
// tanh(s * scale / softcap) (tanhf: tanh.approx's 2^-10.987 would break
// the f32 tolerance), and softcap * log2 e goes into mul.
template <bool CAP, int NT>
struct SoftmaxF32 {
  float m[2] = {NEG_INF, NEG_INF};  // running max of this thread's two rows
  float l[2] = {0.f, 0.f};          // this thread's partial row sums
  float mul;                        // score (CAP: its tanh) -> log2 units
  float cap_in;                     // CAP: scale / softcap

  template <bool MASK>
  __device__ __forceinline__ void tile(float (&s)[NT][4], float (&corr)[2], int k0, int row_a,
                                       int t, int Sk, int causal) {
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (CAP) s[n][i] = tanhf(s[n][i] * cap_in);
        if (MASK) {
          const int key = k0 + 8 * n + 2 * t + (i & 1);
          if (key >= Sk || (causal && key > row_a + 8 * (i >> 1))) s[n][i] = NEG_INF;
        }
      }
    float neg[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = fmaxf(s[0][2 * r], s[0][2 * r + 1]);
#pragma unroll
      for (int n = 1; n < NT; ++n) mx = fmaxf(mx, fmaxf(s[n][2 * r], s[n][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));  // a row's keys sit in one quad
      mx = fmaxf(fmaxf(mx, __shfl_xor_sync(FULL, mx, 2)), m[r]);
      corr[r] = ex2((m[r] - mx) * mul);
      m[r] = mx;
      neg[r] = -mx * mul;
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        s[n][2 * r] = ex2(fmaf(s[n][2 * r], mul, neg[r]));
        s[n][2 * r + 1] = ex2(fmaf(s[n][2 * r + 1], mul, neg[r]));
        sum += s[n][2 * r] + s[n][2 * r + 1];
      }
      l[r] = l[r] * corr[r] + sum;
    }
  }
};

// One CTA per q tile of BQ rows of one (batch, head), tiles numbered
// heaviest first (causal: the last q tiles first) in a flat grid.
template <int D, int NW, bool CAP>
__global__ void __launch_bounds__(32 * NW, F32Layout<D, NW>::PER_SM)
    fa_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, float* __restrict__ o, int BH, int H, int G, int nqt,
               int Sq, int Sk, Strides qs, Strides ks, Strides vs, Strides os, float scale,
               float softcap, int causal) {
  using LY = F32Layout<D, NW>;
  using DS = F32Design<D>;
  constexpr int BK = LY::BK;
  constexpr int NT = BK / 8;  // 8-key n-tiles of S, k-steps of P V
  constexpr int KS = D / 8;   // k-steps of Q K^T, n-tiles of O
  constexpr int CH = 4;       // n-tiles of O a P V pass sums afresh
  static_assert(KS % CH == 0, "P V runs over whole chunks of O");
  extern __shared__ __align__(16) float smem_f[];

  const int bh = blockIdx.x % BH;
  const int h = bh % H;
  const int b = bh / H;
  const int q0 = (nqt - 1 - (int)(blockIdx.x / BH)) * LY::BQ;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wr0 = q0 + 16 * warp;  // this warp's first q row
  const int row_a = wr0 + g;       // this thread's rows: row_a, row_a + 8
  const float* kb = k + b * ks.b + (h / G) * ks.h;
  const float* vb = v + b * vs.b + (h / G) * vs.h;
  const float* sk = smem_f + LY::SK;
  const float* sv = smem_f + LY::SV;

  const int kv_end = causal ? min(Sk, q0 + LY::BQ) : Sk;
  const int n = (kv_end + BK - 1) / BK;  // K/V tiles the CTA loads
  // the K/V tiles this warp computes on: none past Sq, none wholly above
  // its rows' diagonal
  const int wn = wr0 >= Sq ? 0 : ((causal ? min(Sk, wr0 + 16) : Sk) + BK - 1) / BK;

  constexpr int CPR = D / 4;  // 16-byte chunks a row
  auto load = [&](int j) {    // raw K/V tile j; rows past Sk as zeros
    for (int i = threadIdx.x; i < BK * CPR; i += LY::THREADS) {
      const int r = i / CPR;
      const int c = (i % CPR) * 4;
      const int key = j * BK + r;
      const bool in = key < Sk;
      const long long row = in ? key : 0;
      cp_async16(smem_f + r * D + c, kb + row * ks.s + c, in);
      cp_async16(smem_f + LY::RAW_V + r * D + c, vb + row * vs.s + c, in);
    }
    cp_async_commit();
  };
  // the landed raw tile -> SK, SV: every element split once for all warps
  auto split = [&]() {
    for (int i = threadIdx.x; i < BK * CPR; i += LY::THREADS) {
      const int r = i / CPR;
      const int c = (i % CPR) * 4;
      const float4 x = *reinterpret_cast<const float4*>(smem_f + r * D + c);
      float* dst = smem_f + LY::SK + r * LY::LDSK + 2 * c;
      *reinterpret_cast<uint4*>(dst) = split_pair(x.x, x.y);
      *reinterpret_cast<uint4*>(dst + 4) = split_pair(x.z, x.w);
    }
    for (int i = threadIdx.x; i < (BK / 2) * CPR; i += LY::THREADS) {
      const int p = i / CPR;
      const int c = (i % CPR) * 4;
      const float4 x = *reinterpret_cast<const float4*>(smem_f + LY::RAW_V + 2 * p * D + c);
      const float4 y = *reinterpret_cast<const float4*>(smem_f + LY::RAW_V + (2 * p + 1) * D + c);
      uint4* dst = reinterpret_cast<uint4*>(smem_f + LY::SV + p * LY::LDSV + 4 * c);
      dst[0] = split_pair(x.x, y.x);
      dst[1] = split_pair(x.y, y.y);
      dst[2] = split_pair(x.z, y.z);
      dst[3] = split_pair(x.w, y.w);
    }
  };
  // Q as A fragments: k-step kk's position t is column 8kk + 2t and t + 4
  // is 8kk + 2t + 1 (the same order of D in Q and K leaves the dot
  // products as they are), so a fragment's two columns of a row are one
  // float2. Q_RES: split once into registers; else the raw tile comes into
  // shared memory with K/V tile 0 (rows past Sq as zeros).
  const float* qb = q + b * qs.b + h * qs.h;
  const float* qsm = smem_f + LY::Q + (16 * warp + g) * LY::LDQ + 2 * t;
  if constexpr (!DS::Q_RES) {
    for (int i = threadIdx.x; i < LY::BQ * CPR; i += LY::THREADS) {
      const int r = i / CPR;
      const int c = (i % CPR) * 4;
      const bool in = q0 + r < Sq;
      cp_async16(smem_f + LY::Q + r * LY::LDQ + c, qb + (in ? q0 + r : 0) * qs.s + c, in);
    }
  }
  load(0);
  uint32_t qh[DS::Q_RES ? KS : 1][4], ql[DS::Q_RES ? KS : 1][4];
  if constexpr (DS::Q_RES) {
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      float2 f[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row_a + 8 * r;
        f[r] = row < Sq ? *reinterpret_cast<const float2*>(qb + row * qs.s + 8 * kk + 2 * t)
                        : make_float2(0.f, 0.f);
      }
      split_tf32(f[0].x, qh[kk][0], ql[kk][0]);
      split_tf32(f[1].x, qh[kk][1], ql[kk][1]);
      split_tf32(f[0].y, qh[kk][2], ql[kk][2]);
      split_tf32(f[1].y, qh[kk][3], ql[kk][3]);
    }
  }

  SoftmaxF32<CAP, NT> sm;
  sm.cap_in = CAP ? scale / softcap : 0.f;
  sm.mul = (CAP ? softcap : scale) * LOG2E;
  float acc[KS][4];  // O, unnormalised
#pragma unroll
  for (int nn = 0; nn < KS; ++nn)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nn][i] = 0.f;

  for (int j = 0; j < n; ++j) {
    cp_async_wait_all();  // raw tile j has landed (this thread's copies) ...
    __syncthreads();      // ... everyone's, and every warp is done with SK, SV
    split();
    __syncthreads();      // SK, SV hold tile j; the raw tile is free
    if (j + 1 < n) load(j + 1);  // under this tile's products
    if (j >= wn) continue;
    const int k0 = j * BK;

    // S = Q K^T: B fragment (t, g), (t + 4, g) of n-tile nn is key
    // 8nn + g, columns 8kk + 2t and + 1
    // hi.hi in s, the two small products in sl, added once in f32: the
    // tensor cores truncate sl's sums at its own, 2^-11 smaller, scale
    float s[NT][4], sl[NT][4];
#pragma unroll
    for (int nn = 0; nn < NT; ++nn)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[nn][i] = sl[nn][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t ah[4], al[4];
      if constexpr (DS::Q_RES) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          ah[i] = qh[kk][i];
          al[i] = ql[kk][i];
        }
      } else {
        const float2 f0 = *reinterpret_cast<const float2*>(qsm + 8 * kk);
        const float2 f1 = *reinterpret_cast<const float2*>(qsm + 8 * LY::LDQ + 8 * kk);
        split_tf32(f0.x, ah[0], al[0]);
        split_tf32(f1.x, ah[1], al[1]);
        split_tf32(f0.y, ah[2], al[2]);
        split_tf32(f1.y, ah[3], al[3]);
      }
#pragma unroll
      for (int nn = 0; nn < NT; ++nn) {
        const uint4 kf =
            *reinterpret_cast<const uint4*>(sk + (8 * nn + g) * LY::LDSK + 4 * (4 * kk + t));
        mma_3xtf32(s[nn], sl[nn], ah, al, kf);
      }
    }
#pragma unroll
    for (int nn = 0; nn < NT; ++nn)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[nn][i] += sl[nn][i];

    float corr[2];
    if (k0 + BK > Sk || (causal && k0 + BK - 1 > wr0))
      sm.template tile<true>(s, corr, k0, row_a, t, Sk, causal);
    else
      sm.template tile<false>(s, corr, k0, row_a, t, Sk, causal);

    // P as tf32 A fragments in registers: k-step jj is n-tile jj of S, and
    // its position t is key 8jj + 2t, t + 4 is 8jj + 2t + 1 (what this
    // thread holds); V's B fragment follows: keys 8jj + 2t and + 1, one
    // pair of SV
    uint32_t ph[NT][4], pl[NT][4];
#pragma unroll
    for (int jj = 0; jj < NT; ++jj) {
      split_tf32(s[jj][0], ph[jj][0], pl[jj][0]);
      split_tf32(s[jj][2], ph[jj][1], pl[jj][1]);
      split_tf32(s[jj][1], ph[jj][2], pl[jj][2]);
      split_tf32(s[jj][3], ph[jj][3], pl[jj][3]);
    }
    // O = O * corr + P V, CH n-tiles at a time: the tile's products
    // summed afresh (hi.hi and the small ones apart, two chains an n-tile)
    // and added to O in one rounded FFMA, so that the tensor cores'
    // truncating sums never run over more than one tile of keys
#pragma unroll
    for (int c = 0; c < KS; c += CH) {
      float pv[CH][4], pvl[CH][4];
#pragma unroll
      for (int nn = 0; nn < CH; ++nn)
#pragma unroll
        for (int i = 0; i < 4; ++i) pv[nn][i] = pvl[nn][i] = 0.f;
#pragma unroll
      for (int jj = 0; jj < NT; ++jj)
#pragma unroll
        for (int nn = 0; nn < CH; ++nn) {
          const uint4 vf = *reinterpret_cast<const uint4*>(sv + (4 * jj + t) * LY::LDSV +
                                                           4 * (8 * (c + nn) + g));
          mma_3xtf32(pv[nn], pvl[nn], ph[jj], pl[jj], vf);
        }
#pragma unroll
      for (int nn = 0; nn < CH; ++nn)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          acc[c + nn][i] = fmaf(acc[c + nn][i], corr[i >> 1], pv[nn][i] + pvl[nn][i]);
    }
  }

  if (wr0 >= Sq) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = sm.l[r];
    l += __shfl_xor_sync(FULL, l, 1);
    l += __shfl_xor_sync(FULL, l, 2);
    const float inv = 1.f / fmaxf(l, 1e-30f);
    const int row = row_a + 8 * r;
    if (row >= Sq) continue;
    float* orow = o + b * os.b + (long long)row * os.s + h * os.h + 2 * t;
#pragma unroll
    for (int nn = 0; nn < KS; ++nn)
      *reinterpret_cast<float2*>(orow + 8 * nn) =
          make_float2(acc[nn][2 * r] * inv, acc[nn][2 * r + 1] * inv);
  }
}

template <int D, int NW, bool CAP>
int launch_f32_nw(const void* q, const void* k, const void* v, void* o, int B, int H, int KVH,
                  int Sq, int Sk, Strides qs, Strides ks, Strides vs, Strides os, float scale,
                  float softcap, int causal, cudaStream_t stream) {
  using LY = F32Layout<D, NW>;
  const int nqt = (Sq + LY::BQ - 1) / LY::BQ;
  const long long tiles = (long long)nqt * B * H;
  if (tiles > 0x7fffffff) return (int)cudaErrorInvalidValue;
  auto kern = fa_fwd_f32<D, NW, CAP>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)LY::BYTES);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  kern<<<(unsigned)tiles, LY::THREADS, LY::BYTES, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), B * H, H, H / KVH, nqt, Sq, Sk, qs, ks, vs, os, scale, softcap,
      causal);
  return (int)cudaGetLastError();
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* o, int B, int H, int KVH,
               int Sq, int Sk, Strides qs, Strides ks, Strides vs, Strides os, float scale,
               float softcap, int causal, cudaStream_t stream) {
  using DS = F32Design<D>;
  int dev = 0, sms = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  const bool small = (long long)((Sq + 16 * DS::NW - 1) / (16 * DS::NW)) * B * H < sms;
#define F32_ARGS q, k, v, o, B, H, KVH, Sq, Sk, qs, ks, vs, os, scale, softcap, causal, stream
  if (softcap > 0.f)
    return small ? launch_f32_nw<D, DS::NW_SMALL, true>(F32_ARGS)
                 : launch_f32_nw<D, DS::NW, true>(F32_ARGS);
  return small ? launch_f32_nw<D, DS::NW_SMALL, false>(F32_ARGS)
               : launch_f32_nw<D, DS::NW, false>(F32_ARGS);
#undef F32_ARGS
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements. Returns a
// cudaError_t (0 on success); invalid arguments return
// cudaErrorInvalidValue without launching.
extern "C" int fa_forward(const void* q, const void* k, const void* v, void* o, int dtype,
                          int B, int H, int KVH, int Sq, int Sk, int D, long long qsb,
                          long long qss, long long qsh, long long ksb, long long kss,
                          long long ksh, long long vsb, long long vss, long long vsh,
                          long long osb, long long oss, long long osh, float scale,
                          float softcap, int causal, void* stream) {
  if (B <= 0 || H <= 0 || KVH <= 0 || H % KVH != 0 || Sq <= 0 || Sk <= 0)
    return (int)cudaErrorInvalidValue;
  const Strides qs{qsb, qss, qsh}, ks{ksb, kss, ksh}, vs{vsb, vss, vsh}, os{osb, oss, osh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FA_ARGS q, k, v, o, B, H, KVH, Sq, Sk, qs, ks, vs, os, scale, softcap, causal, st
  if (dtype == 0 && D == 64) return launch_f32<64>(FA_ARGS);
  if (dtype == 0 && D == 96) return launch_f32<96>(FA_ARGS);
  if (dtype == 0 && D == 128) return launch_f32<128>(FA_ARGS);
  if (dtype == 1 && D == 64) return launch_hopper<64>(FA_ARGS);
  if (dtype == 1 && D == 96) return launch_hopper<96>(FA_ARGS);
  if (dtype == 1 && D == 128) return launch_hopper<128>(FA_ARGS);
#undef FA_ARGS
  return (int)cudaErrorInvalidValue;
}
