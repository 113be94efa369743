// The Mamba-2 SSD scan, forward, for Hopper (sm_90a): chunked, in f32 grade.
//
// It replaces no TPU kernel: the JAX package runs the scan as plain jnp
// (src/repro/models/ssm.py ssd_chunked, no Pallas), and the port ran it as
// plain PyTorch in f32 (models/ssm.py ssd_chunked), which at 7,680 tokens
// builds a (chunks x heads x 256 x 256) f32 decay block of 1 GB a layer and
// passes over it five times. This kernel computes what ssd_chunked and the
// D skip compute,
//
//   h_t = exp(dt_t A) h_{t-1} + dt_t B_t (x) x_t,   y_t = C_t . h_t + D x_t,
//
// by the SSD's chunked decomposition (Dao & Gu 2024), with no L x L x H
// block in device memory, and rounds y once, to bf16, at the end.
//
// Chunks of L = 256 tokens, heads of P = 64, one group of B and C of N = 64
// or 128 (jamba-1.5-large, granite-4.0-h-small). cum is the inclusive sum
// of dt A (rounded to f32, as PyTorch rounds a_log) over a chunk's tokens,
// summed in f64 by a warp scan in a fixed order and kept as an f32 pair
// (hi, lo): a chunk's sums reach the thousands, and exp(cum_q - cum_s) of
// two such sums rounded to f32 apart would be off by |cum| 2^-24 in the
// exponent (ssd_chunked's own error, up to about 1e-4 of y's rms); a
// difference of pairs is good to f32's precision:
//
//   ssd_cb     CB[q, s] = C_q . B_s, once a chunk for all heads (f32 sums of
//              exact bf16 products); only the 16 x 16 tiles on and below
//              the diagonal, the ones ssd_scan reads.
//   ssd_state  per (chunk, head): cum, written for the other phases, and the
//              chunk's state S_c = sum_s (B_s w_s) (x) x_s with
//              w_s = dt_s exp(cum_end - cum_s): an (N x L) . (L x P) product.
//   ssd_pass   per (head, 1,024 state elements): over the chunks in order,
//              h <- h exp(cum_end) + S_c from h0 (or 0); writes the state
//              entering each chunk, already split for ssd_scan (below), and
//              h_last in f32. It replaces ssd_chunked's Python loop.
//   ssd_scan   per (chunk, head): y_q = exp(cum_q) C_q . h_prev
//                + sum_{s <= q} CB[q, s] exp(cum_q - cum_s) dt_s x_s + D x_q,
//              the decayed tile formed in registers over the causal tiles
//              only, and y rounded to bf16 once.
//
// Precision: the same grade as ssd_chunked's f32 (TF32 off). x, B and C
// arrive in bf16 and enter the products as they are (exact). The f32
// operands (the decayed CB tile, B w and the carried state) enter as three
// bf16 terms, hi = bf16(v), mid = bf16(v - hi), lo = bf16(v - hi - mid)
// (each difference exact), about 2^-26 of v left out; the three products
// go into one f32 accumulator, the small ones first (each term over every
// accumulator of the row before the next term). mma.sync m16n8k16
// bf16 -> f32. Cumsums, exponentials (expf, not the approximate one), the
// state recurrence (mul and add rounded apart, as PyTorch's) and the
// epilogue stay in f32. No atomics; every sum runs in a fixed order, so two
// calls on one input give the same bits.
//
// What bounds it: at granite's widths a 7,680-token layer does 48.6 GFLOP
// of useful work (the benchmark's count: N L + H P L + 4 H N P a token;
// 0.049 ms at 989 TFLOP/s) and must move about 0.27 GB (x and y in bf16, B,
// C, dt, dt A, h_last; 0.080 ms at 3.35 TB/s), so the bound is bytes. The
// kernels do more: the three-term products triple the tensor-core work,
// the decayed tile costs an exponential an element, and the chunk states
// go through device memory twice (f32 out of ssd_state, three bf16 terms
// out of ssd_pass).
//
// Times (kernel alone, chip_smoke.py's kernels_ssd phase on an NVIDIA H100
// 80GB HBM3 at 700 W; PERF.md has every run): at granite's widths, 7,680
// tokens, 0.82 ms a call against ssd_chunked's 10.4 (ssd_scan 0.48-0.51,
// ssd_state 0.18-0.19, ssd_pass 0.11, at 2.9 TB/s, ssd_cb 0.01), 9.7 % of
// the bound; 2,304 tokens 0.32 ms against 3.26. Builds that left parts of
// ssd_scan out, at 7,680 tokens: without its intra-chunk products 0.25 ms
// faster, without the inter-chunk ones 0.06 faster; the rest, its loads
// of x, the state and CB and its stores of y, about 0.19 ms. One ssd_scan
// block (8 warps, 218 KB of shared memory) fits a SM, so products,
// exponentials and loads overlap poorly. Measured and left out: __expf for
// the decayed tile (1 % faster), 8 heads a ssd_state block (the same),
// unrolling either key loop by 2 (the same), 4 heads a ssd_scan block at
// 7,680 tokens (2 % slower; taken where it fills the last wave better, as
// at 2,304: 0.32 ms against 0.37).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// (internal linkage: the library exports ssd_forward alone)
namespace repro_ssd {
namespace {

constexpr int L = 256;        // tokens a chunk
constexpr int P = 64;         // head dim
constexpr int LDX = P + 8;    // shared row of x / the state, bf16 (144 B: ldmatrix conflict-free)
constexpr int HT_STATE = 4;   // heads a ssd_state block
constexpr int PASS_THREADS = 256;

typedef __nv_bfloat16 bf16;

struct Strides {
  long long b, s;  // batch and token strides, in elements
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// four 8 x 8 b16 matrices; lane l gives the address of row l % 8 of matrix l / 8
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d (16 x 8) += a (16 x 16, row) . b (16 x 8, col), bf16 in, f32 sums.
// a: (g, 2t..), (g + 8, 2t..), (g, 2t + 8..), (g + 8, 2t + 8..); b: (2t.., g),
// (2t + 8.., g); d: (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1)
// (g = lane / 4, t = lane % 4; ".." the next column or row in the pair)
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ float2 to_f2(uint32_t w) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&w));
}

// (a, b) = hi + mid + lo, each a bf16 pair (a in the low half)
__device__ __forceinline__ void split3(float a, float b, uint32_t& hi, uint32_t& mid,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  const float ra = a - hf.x, rb = b - hf.y;
  const __nv_bfloat162 m = __floats2bfloat162_rn(ra, rb);
  const float2 mf = __bfloat1622float2(m);
  hi = as_u32(h);
  mid = as_u32(m);
  lo = as_u32(__floats2bfloat162_rn(ra - mf.x, rb - mf.y));
}

// an A fragment of f32 values as its three bf16 terms
struct Split {
  uint32_t hi[4], mid[4], lo[4];
};
__device__ __forceinline__ void split_frag(Split& s, const float (&v)[8]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) split3(v[2 * i], v[2 * i + 1], s.hi[i], s.mid[i], s.lo[i]);
}
// d[n] += a . b[n] over the 8 n8 tiles of a 64-column B operand (b: four
// x4 loads, two tiles each): 8 products on 8 accumulators
__device__ __forceinline__ void mma_row(float (&d)[8][4], const uint32_t (&a)[4],
                                        const uint32_t (&b)[4][4]) {
#pragma unroll
  for (int np = 0; np < 4; ++np) {
    mma(d[2 * np], a, b[np][0], b[np][1]);
    mma(d[2 * np + 1], a, b[np][2], b[np][3]);
  }
}

// rows [r0, r0 + rows) of a (rows x W) bf16 global matrix (row stride ld
// elements, 16-byte aligned) into shared memory at row stride LD
template <int W, int LD>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, long long ld, int rows,
                                          int tid, int nthreads) {
  constexpr int PIECES = W / 8;
  for (int i = tid; i < rows * PIECES; i += nthreads) {
    const int r = i / PIECES, p = i % PIECES;
    cp_async16(dst + r * LD + 8 * p, src + r * ld + 8 * p);
  }
}

// The inclusive sums of v[0..256) in f64 by one warp: each lane sums its 8
// in order, then the lanes' totals by a shuffle scan. Returns this lane's 8
// sums (tokens 8 lane + i) in c.
__device__ __forceinline__ void warp_cumsum256(const float (&v)[8], double (&c)[8], int lane) {
  c[0] = v[0];
#pragma unroll
  for (int i = 1; i < 8; ++i) c[i] = c[i - 1] + (double)v[i];
  double incl = c[7];
#pragma unroll
  for (int off = 1; off < 32; off *= 2) {
    const double y = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += y;
  }
  const double excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane > 0) {
#pragma unroll
    for (int i = 0; i < 8; ++i) c[i] += excl;
  }
}

// q - s of two sums held as f32 pairs (hi = the f32 rounding of the sum, lo
// = the rest): the difference to about f32's relative precision however
// large the sums (the two his subtract exactly where they are close).
__device__ __forceinline__ float cum_diff(float qh, float ql, float sh, float sl) {
  return (qh - sh) + (ql - sl);
}

// ------------------------------------------------------------- ssd_cb
// Block: 64 query rows (4 warps of one 16-row tile) of one chunk; the
// heaviest (last) row blocks first. Warp: CB of its 16 rows against the
// keys up to its tile's end, 8 columns at a time.
template <int N>
__global__ void __launch_bounds__(128) cb_kernel(const bf16* __restrict__ Bm, Strides bs,
                                                 const bf16* __restrict__ Cm, Strides cs,
                                                 float* __restrict__ cb, int nc) {
  constexpr int LDN = N + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Cs = reinterpret_cast<bf16*>(smem);  // 64 x LDN
  bf16* Bs = Cs + 64 * LDN;                  // up to 256 x LDN
  const int qb = 3 - blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  load_rows<N, LDN>(Cs, Cm + b * cs.b + (long long)(c * L + 64 * qb) * cs.s, cs.s, 64, tid, 128);
  load_rows<N, LDN>(Bs, Bm + b * bs.b + (long long)(c * L) * bs.s, bs.s, 64 * (qb + 1), tid, 128);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  const int qt = 4 * qb + warp;  // the warp's 16-row tile in the chunk
  uint32_t a[N / 16][4];
#pragma unroll
  for (int kt = 0; kt < N / 16; ++kt)
    ldsm_x4(a[kt], Cs + (16 * warp + lane % 8 + 8 * ((lane / 8) & 1)) * LDN + 16 * kt +
                       8 * (lane / 16));
  float* out = cb + ((long long)(b * nc + c) * L + 16 * qt) * L;
  for (int j = 0; j < 2 * (qt + 1); ++j) {  // 8 key columns at a time
    float d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int kt = 0; kt < N / 16; kt += 2) {
      uint32_t bb[4];
      ldsm_x4(bb, Bs + (8 * j + lane % 8) * LDN + 16 * kt + 8 * (lane / 8));
      mma(d, a[kt], bb[0], bb[1]);
      mma(d, a[kt + 1], bb[2], bb[3]);
    }
    *reinterpret_cast<float2*>(out + g * L + 8 * j + 2 * t) = make_float2(d[0], d[1]);
    *reinterpret_cast<float2*>(out + (g + 8) * L + 8 * j + 2 * t) = make_float2(d[2], d[3]);
  }
}

// ------------------------------------------------------------- ssd_state
// Block: HT_STATE heads of one chunk, 4 warps; B of the chunk in shared
// memory once, x one head at a time. Warp w: state rows n in [32w, 32w + 32)
// (N 128; at N 64 rows [16w, 16w + 16)), all P columns.
template <int N>
struct StateLayout {
  static constexpr int LDN = N + 8;
  static constexpr int MT = N / 64;  // 16-row tiles a warp
  static constexpr size_t B_OFF = 0;
  static constexpr size_t X_OFF = B_OFF + sizeof(bf16) * L * LDN;
  static constexpr size_t W_OFF = X_OFF + sizeof(bf16) * L * LDX;
  static constexpr size_t BYTES = W_OFF + sizeof(float) * HT_STATE * L;
};

template <int N>
__global__ void __launch_bounds__(128, 2)
    state_kernel(const bf16* __restrict__ x, Strides xs, const bf16* __restrict__ Bm, Strides bs,
                 const float* __restrict__ dt, const float* __restrict__ A,
                 float* __restrict__ cum, float* __restrict__ states, int H, int S, int nc) {
  using LY = StateLayout<N>;
  constexpr int LDN = LY::LDN, MT = LY::MT;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Bs = reinterpret_cast<bf16*>(smem + LY::B_OFF);
  bf16* Xs = reinterpret_cast<bf16*>(smem + LY::X_OFF);
  float* Ws = reinterpret_cast<float*>(smem + LY::W_OFF);  // [HT][L]: dt, then w
  const int h0 = blockIdx.x * HT_STATE, c = blockIdx.y, b = blockIdx.z;
  const int nh = min(HT_STATE, H - h0);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const long long tok0 = (long long)c * L;
  const bf16* xg = x + b * xs.b + tok0 * xs.s + (long long)h0 * P;

  load_rows<N, LDN>(Bs, Bm + b * bs.b + tok0 * bs.s, bs.s, L, tid, 128);
  load_rows<P, LDX>(Xs, xg, xs.s, L, tid, 128);
  cp_async_commit();
  for (int i = tid; i < L * HT_STATE; i += 128) {
    const int s = i / HT_STATE, j = i % HT_STATE;
    Ws[j * L + s] = j < nh ? dt[((long long)b * S + tok0 + s) * H + h0 + j] : 0.f;
  }
  __syncthreads();
  // cum and w = dt exp(cum_end - cum) of each head, a warp a head
  for (int j = warp; j < nh; j += 4) {
    float* w = Ws + j * L;
    const float a = A[h0 + j];
    float dA[8], dtv[8];
    double cs[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      dtv[i] = w[8 * lane + i];
      dA[i] = dtv[i] * a;
    }
    warp_cumsum256(dA, cs, lane);
    const double end = __shfl_sync(0xffffffffu, cs[7], 31);
    float hi[8], lo[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      hi[i] = (float)cs[i];
      lo[i] = (float)(cs[i] - (double)hi[i]);
      w[8 * lane + i] = dtv[i] * expf((float)(end - cs[i]));
    }
    float* cg = cum + ((long long)(b * nc + c) * H + h0 + j) * 2 * L + 8 * lane;
    reinterpret_cast<float4*>(cg)[0] = make_float4(hi[0], hi[1], hi[2], hi[3]);
    reinterpret_cast<float4*>(cg)[1] = make_float4(hi[4], hi[5], hi[6], hi[7]);
    reinterpret_cast<float4*>(cg + L)[0] = make_float4(lo[0], lo[1], lo[2], lo[3]);
    reinterpret_cast<float4*>(cg + L)[1] = make_float4(lo[4], lo[5], lo[6], lo[7]);
  }

  for (int j = 0; j < nh; ++j) {
    cp_async_wait_all();
    __syncthreads();  // x of head j has landed; every w is written
    const float* w = Ws + j * L;
    float acc[MT][8][4];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[m][n][i] = 0.f;
#pragma unroll 1
    for (int ks = 0; ks < L / 16; ++ks) {
      const int k0 = 16 * ks;
      uint32_t bx[4][4];  // x: k16 x 64 columns, two n8 tiles a load
#pragma unroll
      for (int np = 0; np < 4; ++np)
        ldsm_x4_t(bx[np], Xs + (k0 + lane % 8 + 8 * ((lane / 8) & 1)) * LDX + 16 * np +
                              8 * (lane / 16));
      const float2 w0 = *reinterpret_cast<const float2*>(w + k0 + 2 * t);
      const float2 w1 = *reinterpret_cast<const float2*>(w + k0 + 2 * t + 8);
      Split sa[MT];
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        // A = (B w)^T: rows n, columns s, from B stored [s][n] (transposed load)
        const int n0 = (16 * MT) * warp + 16 * m;
        uint32_t braw[4];
        ldsm_x4_t(braw, Bs + (k0 + lane % 8 + 8 * (lane / 16)) * LDN + n0 + 8 * ((lane / 8) & 1));
        const float2 f0 = to_f2(braw[0]), f1 = to_f2(braw[1]), f2 = to_f2(braw[2]),
                     f3 = to_f2(braw[3]);
        const float v[8] = {f0.x * w0.x, f0.y * w0.y, f1.x * w0.x, f1.y * w0.y,
                            f2.x * w1.x, f2.y * w1.y, f3.x * w1.x, f3.y * w1.y};
        split_frag(sa[m], v);
      }
      // the three terms in turn, the small ones first: consecutive products
      // go to different accumulators
#pragma unroll
      for (int m = 0; m < MT; ++m) mma_row(acc[m], sa[m].lo, bx);
#pragma unroll
      for (int m = 0; m < MT; ++m) mma_row(acc[m], sa[m].mid, bx);
#pragma unroll
      for (int m = 0; m < MT; ++m) mma_row(acc[m], sa[m].hi, bx);
    }
    __syncthreads();  // every warp is done with Xs
    if (j + 1 < nh) {
      load_rows<P, LDX>(Xs, xg + (long long)(j + 1) * P, xs.s, L, tid, 128);
      cp_async_commit();
    }
    float* st = states + ((long long)(b * nc + c) * H + h0 + j) * (N * P);
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const int n0 = (16 * MT) * warp + 16 * m;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        *reinterpret_cast<float2*>(st + (n0 + g) * P + 8 * n + 2 * t) =
            make_float2(acc[m][n][0], acc[m][n][1]);
        *reinterpret_cast<float2*>(st + (n0 + g + 8) * P + 8 * n + 2 * t) =
            make_float2(acc[m][n][2], acc[m][n][3]);
      }
    }
  }
}

// ------------------------------------------------------------- ssd_pass
// Thread: 4 consecutive state elements of one (batch, head), over the
// chunks in order. hs[b][c][h][term][N][P] gets the state entering chunk c
// as its three bf16 terms (ssd_scan's B operand).
template <int N>
__global__ void __launch_bounds__(PASS_THREADS)
    pass_kernel(const float* __restrict__ states, const float* __restrict__ cum,
                const float* __restrict__ h0, bf16* __restrict__ hs, float* __restrict__ h_last,
                int H, int nc) {
  constexpr int NP = N * P;
  const int e = (blockIdx.x * PASS_THREADS + threadIdx.x) * 4, hh = blockIdx.y, b = blockIdx.z;
  const long long head = (long long)b * H + hh;
  float4 h = h0 ? *reinterpret_cast<const float4*>(h0 + head * NP + e)
                : make_float4(0.f, 0.f, 0.f, 0.f);
  const long long step = (long long)H * NP;  // one chunk further
  const float* sp = states + ((long long)b * nc * H + hh) * NP + e;
  bf16* op = hs + ((long long)b * nc * H + hh) * 3 * NP + e;
  const float* cp = cum + ((long long)b * nc * H + hh) * 2 * L + (L - 1);  // hi of cum_end
  float4 nxt = *reinterpret_cast<const float4*>(sp);
  for (int c = 0; c < nc; ++c) {
    const float4 s = nxt;
    if (c + 1 < nc) nxt = *reinterpret_cast<const float4*>(sp + (c + 1) * step);
    const float dec = expf(cp[(long long)c * H * 2 * L]);
    uint2 hi, mid, lo;
    split3(h.x, h.y, hi.x, mid.x, lo.x);
    split3(h.z, h.w, hi.y, mid.y, lo.y);
    bf16* o = op + (long long)c * 3 * step;
    *reinterpret_cast<uint2*>(o) = hi;
    *reinterpret_cast<uint2*>(o + NP) = mid;
    *reinterpret_cast<uint2*>(o + 2 * NP) = lo;
    h.x = __fadd_rn(__fmul_rn(h.x, dec), s.x);
    h.y = __fadd_rn(__fmul_rn(h.y, dec), s.y);
    h.z = __fadd_rn(__fmul_rn(h.z, dec), s.z);
    h.w = __fadd_rn(__fmul_rn(h.w, dec), s.w);
  }
  *reinterpret_cast<float4*>(h_last + head * NP + e) = h;
}

// ------------------------------------------------------------- ssd_scan
// Block: HT heads of one chunk, 8 warps; C of the chunk in shared memory
// once, x (double-buffered) and the entering state one head at a time. One
// block fits a SM, so the grid runs in waves of one block a SM: HT is 8, or
// 4 where that leaves the last wave less empty (at 2,304 tokens 288 blocks
// in 3 waves of 132, not 144 in 2). Warp w: query tiles w and 15 - w (16
// rows each: 17 causal key tiles between them, the same for every warp),
// all P columns.
template <int N, int HT>
struct ScanLayout {
  static constexpr int LDN = N + 8;
  static constexpr size_t C_OFF = 0;
  static constexpr size_t X_OFF = C_OFF + sizeof(bf16) * L * LDN;
  static constexpr size_t H_OFF = X_OFF + sizeof(bf16) * 2 * L * LDX;
  static constexpr size_t CUM_OFF = H_OFF + sizeof(bf16) * 3 * N * LDX;
  static constexpr size_t DT_OFF = CUM_OFF + sizeof(float) * HT * 2 * L;
  static constexpr size_t BYTES = DT_OFF + sizeof(float) * HT * L;
};

template <int N, int HT>
__global__ void __launch_bounds__(256, 1)
    scan_kernel(const bf16* __restrict__ x, Strides xs, const bf16* __restrict__ Cm, Strides cs,
                const float* __restrict__ dt, const float* __restrict__ cum,
                const float* __restrict__ cb, const bf16* __restrict__ hs,
                const float* __restrict__ D, bf16* __restrict__ y, int H, int S, int nc) {
  using LY = ScanLayout<N, HT>;
  constexpr int LDN = LY::LDN, NP = N * P;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Cs = reinterpret_cast<bf16*>(smem + LY::C_OFF);
  bf16* Xs = reinterpret_cast<bf16*>(smem + LY::X_OFF);  // [2][L][LDX]
  bf16* Hs = reinterpret_cast<bf16*>(smem + LY::H_OFF);  // [3][N][LDX]: hi, mid, lo
  float* Cum = reinterpret_cast<float*>(smem + LY::CUM_OFF);  // [HT][hi, lo][L]
  float* Dts = reinterpret_cast<float*>(smem + LY::DT_OFF);
  const int h0 = blockIdx.x * HT, c = blockIdx.y, b = blockIdx.z;
  const int nh = min(HT, H - h0);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const long long tok0 = (long long)c * L;
  const bf16* xg = x + b * xs.b + tok0 * xs.s + (long long)h0 * P;
  const bf16* hg = hs + ((long long)(b * nc + c) * H + h0) * 3 * NP;

  load_rows<N, LDN>(Cs, Cm + b * cs.b + tok0 * cs.s, cs.s, L, tid, 256);
  load_rows<P, LDX>(Xs, xg, xs.s, L, tid, 256);
  load_rows<P, LDX>(Hs, hg, P, 3 * N, tid, 256);
  cp_async_commit();
  const float* cg = cum + ((long long)(b * nc + c) * H + h0) * 2 * L;
  for (int i = tid; i < 2 * L * HT; i += 256) Cum[i] = i < nh * 2 * L ? cg[i] : 0.f;
  for (int i = tid; i < L * HT; i += 256) {
    const int s = i / HT, j = i % HT;
    Dts[j * L + s] = j < nh ? dt[((long long)b * S + tok0 + s) * H + h0 + j] : 0.f;
  }
  cp_async_wait_all();
  __syncthreads();

  const int qts[2] = {warp, 15 - warp};
  const float* cbc = cb + (long long)(b * nc + c) * L * L;
  for (int j = 0; j < nh; ++j) {
    const bf16* X = Xs + (j & 1) * L * LDX;
    if (j + 1 < nh) {
      load_rows<P, LDX>(Xs + ((j + 1) & 1) * L * LDX, xg + (long long)(j + 1) * P, xs.s, L, tid,
                        256);
      cp_async_commit();
    }
    const float* cm = Cum + j * 2 * L;  // hi; lo at cm + L
    const float* dm = Dts + j * L;
    float acc[2][8][4];
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[q][n][i] = 0.f;

    // inter-chunk: C_q . h_prev, the state in three terms (B operand)
#pragma unroll 1
    for (int kt = 0; kt < N / 16; ++kt) {
      uint32_t a[2][4];
#pragma unroll
      for (int q = 0; q < 2; ++q)
        ldsm_x4(a[q], Cs + (16 * qts[q] + lane % 8 + 8 * ((lane / 8) & 1)) * LDN + 16 * kt +
                          8 * (lane / 16));
#pragma unroll
      for (int term = 2; term >= 0; --term) {
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t bb[4];
          ldsm_x4_t(bb, Hs + term * N * LDX + (16 * kt + lane % 8 + 8 * ((lane / 8) & 1)) * LDX +
                            16 * np + 8 * (lane / 16));
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            mma(acc[q][2 * np], a[q], bb[0], bb[1]);
            mma(acc[q][2 * np + 1], a[q], bb[2], bb[3]);
          }
        }
      }
    }
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const float e0 = expf(cm[16 * qts[q] + g]), e1 = expf(cm[16 * qts[q] + g + 8]);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        acc[q][n][0] *= e0;
        acc[q][n][1] *= e0;
        acc[q][n][2] *= e1;
        acc[q][n][3] *= e1;
      }
    }
    __syncthreads();  // every warp is done with Hs
    if (j + 1 < nh) {
      load_rows<P, LDX>(Hs, hg + (long long)(j + 1) * 3 * NP, P, 3 * N, tid, 256);
      cp_async_commit();
    }

    // intra-chunk: sum over the causal key tiles of the decayed CB tile . x
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int qt = qts[q], r0 = 16 * qt + g, r1 = r0 + 8;
      const float c0 = cm[r0], c1 = cm[r1], l0 = cm[L + r0], l1 = cm[L + r1];
      const float* g0 = cbc + (long long)r0 * L + 2 * t;
      const float* g1 = cbc + (long long)r1 * L + 2 * t;
      // CB from device memory (L2: every head of the chunk reads it), one
      // key tile ahead of its use
      float2 nx00 = *reinterpret_cast<const float2*>(g0);
      float2 nx10 = *reinterpret_cast<const float2*>(g1);
      float2 nx01 = *reinterpret_cast<const float2*>(g0 + 8);
      float2 nx11 = *reinterpret_cast<const float2*>(g1 + 8);
#pragma unroll 1
      for (int st = 0; st <= qt; ++st) {
        const int s0 = 16 * st + 2 * t;
        const float2 cb00 = nx00, cb10 = nx10, cb01 = nx01, cb11 = nx11;
        if (st < qt) {
          nx00 = *reinterpret_cast<const float2*>(g0 + 16 * st + 16);
          nx10 = *reinterpret_cast<const float2*>(g1 + 16 * st + 16);
          nx01 = *reinterpret_cast<const float2*>(g0 + 16 * st + 24);
          nx11 = *reinterpret_cast<const float2*>(g1 + 16 * st + 24);
        }
        const float2 ks0 = *reinterpret_cast<const float2*>(cm + s0);
        const float2 ks1 = *reinterpret_cast<const float2*>(cm + s0 + 8);
        const float2 kl0 = *reinterpret_cast<const float2*>(cm + L + s0);
        const float2 kl1 = *reinterpret_cast<const float2*>(cm + L + s0 + 8);
        const float2 d0 = *reinterpret_cast<const float2*>(dm + s0);
        const float2 d1 = *reinterpret_cast<const float2*>(dm + s0 + 8);
        float v[8] = {cb00.x * expf(cum_diff(c0, l0, ks0.x, kl0.x)) * d0.x,
                      cb00.y * expf(cum_diff(c0, l0, ks0.y, kl0.y)) * d0.y,
                      cb10.x * expf(cum_diff(c1, l1, ks0.x, kl0.x)) * d0.x,
                      cb10.y * expf(cum_diff(c1, l1, ks0.y, kl0.y)) * d0.y,
                      cb01.x * expf(cum_diff(c0, l0, ks1.x, kl1.x)) * d1.x,
                      cb01.y * expf(cum_diff(c0, l0, ks1.y, kl1.y)) * d1.y,
                      cb11.x * expf(cum_diff(c1, l1, ks1.x, kl1.x)) * d1.x,
                      cb11.y * expf(cum_diff(c1, l1, ks1.y, kl1.y)) * d1.y};
        if (st == qt) {  // the diagonal tile: keys after the query are 0
          const int sq[8] = {s0, s0 + 1, s0, s0 + 1, s0 + 8, s0 + 9, s0 + 8, s0 + 9};
#pragma unroll
          for (int i = 0; i < 8; ++i)
            if (sq[i] > ((i & 2) ? r1 : r0)) v[i] = 0.f;
        }
        Split sa;
        split_frag(sa, v);
        uint32_t bx[4][4];
#pragma unroll
        for (int np = 0; np < 4; ++np)
          ldsm_x4_t(bx[np], X + (16 * st + lane % 8 + 8 * ((lane / 8) & 1)) * LDX + 16 * np +
                                8 * (lane / 16));
        mma_row(acc[q], sa.lo, bx);
        mma_row(acc[q], sa.mid, bx);
        mma_row(acc[q], sa.hi, bx);
      }
      // epilogue: + D x, rounded once to bf16
      const float dsk = D[h0 + j];
      bf16* y0 = y + ((long long)b * S + tok0 + r0) * H * P + (long long)(h0 + j) * P + 2 * t;
      bf16* y1 = y0 + 8LL * H * P;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const float2 x0 = to_f2(*reinterpret_cast<const uint32_t*>(X + r0 * LDX + 8 * n + 2 * t));
        const float2 x1 = to_f2(*reinterpret_cast<const uint32_t*>(X + r1 * LDX + 8 * n + 2 * t));
        *reinterpret_cast<__nv_bfloat162*>(y0 + 8 * n) =
            __floats2bfloat162_rn(acc[q][n][0] + x0.x * dsk, acc[q][n][1] + x0.y * dsk);
        *reinterpret_cast<__nv_bfloat162*>(y1 + 8 * n) =
            __floats2bfloat162_rn(acc[q][n][2] + x1.x * dsk, acc[q][n][3] + x1.y * dsk);
      }
    }
    cp_async_wait_all();
    __syncthreads();  // the next head's x and state have landed; this head's are free
  }
}

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// the share of the last of a grid's waves (one block a SM) that is full
double last_wave(long long blocks, int sms) {
  const long long waves = (blocks + sms - 1) / sms;
  return (double)blocks / (double)(waves * sms);
}

template <int N>
int launch(const bf16* x, Strides xs, const bf16* Bm, Strides bs, const bf16* Cm, Strides cs,
           const float* dt, const float* A, const float* D, const float* h0, bf16* y,
           float* h_last, float* cum, float* cb, float* states, bf16* hs, int B, int S, int H,
           cudaStream_t stream) {
  const int nc = S / L;
  constexpr size_t cb_bytes = sizeof(bf16) * (64 + L) * (N + 8);
  // every call, as the opt-ins and the SM count are the current device's
  int dev = 0, sms = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
      (err = set_smem(cb_kernel<N>, cb_bytes)) != cudaSuccess ||
      (err = set_smem(state_kernel<N>, StateLayout<N>::BYTES)) != cudaSuccess ||
      (err = set_smem(scan_kernel<N, 4>, ScanLayout<N, 4>::BYTES)) != cudaSuccess ||
      (err = set_smem(scan_kernel<N, 8>, ScanLayout<N, 8>::BYTES)) != cudaSuccess)
    return (int)err;
  cb_kernel<N><<<dim3(4, nc, B), 128, cb_bytes, stream>>>(Bm, bs, Cm, cs, cb, nc);
  state_kernel<N><<<dim3((H + HT_STATE - 1) / HT_STATE, nc, B), 128, StateLayout<N>::BYTES,
                    stream>>>(x, xs, Bm, bs, dt, A, cum, states, H, S, nc);
  pass_kernel<N><<<dim3(N * P / (4 * PASS_THREADS), H, B), PASS_THREADS, 0, stream>>>(
      states, cum, h0, hs, h_last, H, nc);
  const long long rows = (long long)nc * B;
  if (last_wave(rows * ((H + 3) / 4), sms) > last_wave(rows * ((H + 7) / 8), sms))
    scan_kernel<N, 4><<<dim3((H + 3) / 4, nc, B), 256, ScanLayout<N, 4>::BYTES, stream>>>(
        x, xs, Cm, cs, dt, cum, cb, hs, D, y, H, S, nc);
  else
    scan_kernel<N, 8><<<dim3((H + 7) / 8, nc, B), 256, ScanLayout<N, 8>::BYTES, stream>>>(
        x, xs, Cm, cs, dt, cum, cb, hs, D, y, H, S, nc);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace repro_ssd

// x (B, S, H, 64) bf16 with its (batch, token) strides; B and C (B, S, N)
// bf16 likewise; dt (B, S, H) f32 contiguous; A, D (H) f32; h0 (B, H, N, 64)
// f32 or null. Out: y (B, S, H, 64) bf16 and h_last (B, H, N, 64) f32, both
// contiguous. Scratch (f32 unless named): cum (B, S/256, H, 2, 256), cb (B,
// S/256, 256, 256), states (B, S/256, H, N, 64), hs (B, S/256, H, 3, N, 64)
// bf16. Strides in elements, each row 16-byte aligned. N is 64 or 128 and S
// a multiple of 256. Returns a cudaError_t (0 on success); arguments it does
// not take return cudaErrorInvalidValue without launching.
extern "C" int ssd_forward(const void* x, long long xsb, long long xss, const void* Bm,
                           long long bsb, long long bss, const void* Cm, long long csb,
                           long long css, const float* dt, const float* A, const float* D,
                           const float* h0, void* y, float* h_last, float* cum, float* cb,
                           float* states, void* hs, int B, int S, int H, int N, void* stream) {
  using namespace repro_ssd;
  if (B <= 0 || H <= 0 || S <= 0 || S % L != 0) return (int)cudaErrorInvalidValue;
  const Strides xs{xsb, xss}, bs{bsb, bss}, cs{csb, css};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SSD_ARGS                                                                          \
  static_cast<const bf16*>(x), xs, static_cast<const bf16*>(Bm), bs,                      \
      static_cast<const bf16*>(Cm), cs, dt, A, D, h0, static_cast<bf16*>(y), h_last, cum, \
      cb, states, static_cast<bf16*>(hs), B, S, H, st
  if (N == 64) return launch<64>(SSD_ARGS);
  if (N == 128) return launch<128>(SSD_ARGS);
#undef SSD_ARGS
  return (int)cudaErrorInvalidValue;
}
