// Flash-attention forward for Hopper (sm_90a), GQA, causal, optional softcap.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (_fa_kernel / flash_attention), which the JAX model reaches through its
// jnp twin _flash_attention_qchunked for self-attention with S > 2048.
//
// What bounds it: at the prefill shape (qwen3-1.7b, B=2, S=4096, 16 heads,
// D=128, causal) one call does 4*B*H*S*S*D/2 = 1.37e11 FLOP on ~100 MB of
// q/k/v/o, so it is bound by operations (the tensor cores), not bytes.
//
// Design (not the TPU grid carried over step by step): one CTA of 4 warps
// per (batch*head, 64-row q tile). The TPU's sequential kv grid axis
// becomes a loop over 64-row kv tiles inside the CTA, so the running max,
// denominator and accumulator never leave the SM. Warp w owns q rows
// [16w, 16w+16) throughout. Causal kv tiles wholly above the diagonal are
// never loaded, and q tiles are scheduled heaviest first. q head h reads
// kv head h / G in place (no repeat of K/V). Ragged Sq / Sk are masked
// here: rows past Sq are zero-filled and never written, keys past Sk are
// zero-filled and masked out. The model layout (B, S, KV, G, D) is read in
// place through strides: q is seen as (B, S, H, D) with H = KV*G, k/v as
// (B, S, KV, D); the last dimension must be contiguous and every stride a
// multiple of 16 bytes.
//
//   * bf16 (the serving path): FA2-style. Scores and the output accumulator
//     live in registers as mma.sync m16n8k16 fragments (f32 accumulate);
//     the softmax runs on those fragments with quad shuffles, and the
//     probabilities go to the P@V product straight from registers. K/V
//     tiles are double-buffered in shared memory with cp.async, so the
//     next tile loads while this one computes; fragments come in through
//     ldmatrix (V transposed on the fly).
//   * f32 (exact to f32 rounding, for tests at f32): the tiles are staged
//     in shared memory and both products are plain FMA loops.
// Not yet: wgmma/TMA and warp specialisation (later work).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;  // q rows per CTA
constexpr int BK = 64;  // kv rows per tile
constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr int WROWS = BQ / NWARPS;  // q rows owned by one warp (16)
constexpr float NEG_INF = -1e30f;   // the JAX kernel's mask value
constexpr unsigned FULL = 0xffffffffu;

struct Strides {
  long long b, s, h;
};

__host__ __device__ constexpr size_t round128(size_t x) { return (x + 127) / 128 * 128; }

__device__ __forceinline__ float masked_score(float s, float scale, float softcap, int key,
                                              int row, int Sk, int causal) {
  s *= scale;
  if (softcap > 0.f) s = tanhf(s / softcap) * softcap;
  return (key >= Sk || (causal && key > row)) ? NEG_INF : s;
}

// ======================================================= bf16: registers
using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy global -> shared; zero-fills when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d += a (16x16, row) * b (16x8, col); bf16 in, f32 accumulate
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int D>
struct Bf16Layout {
  static constexpr int LD = D + 8;  // 16-byte pad: ldmatrix rows hit distinct banks
  static constexpr size_t TILE = sizeof(bf16) * BQ * LD;
  static constexpr size_t BYTES = 5 * TILE;  // Q + two K + two V tiles
};

// rows [row0, row0 + 64) of one head -> shared memory, asynchronously
template <int D>
__device__ __forceinline__ void load_tile_async(bf16* dst, const bf16* src, long long stride,
                                                int row0, int n_rows) {
  constexpr int VPR = D / 8;  // 16-byte vectors per row
  constexpr int LD = Bf16Layout<D>::LD;
  for (int i = threadIdx.x; i < BK * VPR; i += NTHREADS) {
    const int r = i / VPR;
    const int c = (i % VPR) * 8;
    const bool ok = row0 + r < n_rows;
    cp_async16(dst + r * LD + c, src + (long long)(ok ? row0 + r : 0) * stride + c, ok);
  }
}

template <int D>
__global__ void __launch_bounds__(NTHREADS)
    fa_fwd_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, bf16* __restrict__ o, int H, int G, int Sq, int Sk,
                Strides qs, Strides ks, Strides vs, Strides os, float scale, float softcap,
                int causal) {
  constexpr int LD = Bf16Layout<D>::LD;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + BQ * LD;  // two buffers
  bf16* Vs = Ks + 2 * BK * LD;

  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int kvh = h / G;
  const int q0 = qt * BQ;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;  // fragment row within the 8-row group
  const int t4 = lane & 3;  // fragment column pair
  const int row_a = q0 + warp * WROWS + g;  // this thread's two q rows
  const int row_b = row_a + 8;

  const bf16* qb = q + b * qs.b + h * qs.h;
  const bf16* kb = k + b * ks.b + kvh * ks.h;
  const bf16* vb = v + b * vs.b + kvh * vs.h;

  const int kv_end = causal ? min(Sk, q0 + BQ) : Sk;
  const int nkt = (kv_end + BK - 1) / BK;
  load_tile_async<D>(Qs, qb, qs.s, q0, Sq);
  load_tile_async<D>(Ks, kb, ks.s, 0, Sk);
  load_tile_async<D>(Vs, vb, vs.s, 0, Sk);
  cp_async_commit();

  uint32_t qf[D / 16][4];
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m_r[2] = {NEG_INF, NEG_INF};
  float l_r[2] = {0.f, 0.f};  // this thread's partial row sums

  for (int j = 0; j < nkt; ++j) {
    if (j + 1 < nkt) {  // prefetch the next K/V tile into the other buffer
      const int nb = (j + 1) & 1;
      load_tile_async<D>(Ks + nb * BK * LD, kb, ks.s, (j + 1) * BK, Sk);
      load_tile_async<D>(Vs + nb * BK * LD, vb, vs.s, (j + 1) * BK, Sk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (j == 0) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        ldsm_x4(qf[kk], Qs + (warp * WROWS + (lane % 16)) * LD + kk * 16 + (lane / 16) * 8);
    }
    const bf16* Kt = Ks + (j & 1) * BK * LD;
    const bf16* Vt = Vs + (j & 1) * BK * LD;

    // S = Q K^T: 16 rows x 64 keys per warp, eight m16n8 fragments
    float s[BK / 8][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int np = 0; np < BK / 16; ++np) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t kf[4];
        ldsm_x4(kf, Kt + (np * 16 + (lane % 8) + (lane / 16) * 8) * LD + kk * 16 +
                        ((lane / 8) % 2) * 8);
        mma16816(s[2 * np], qf[kk], kf[0], kf[1]);
        mma16816(s[2 * np + 1], qf[kk], kf[2], kf[3]);
      }
    }

    // online softmax on the fragments: elements 0,1 are row_a, 2,3 row_b
    const int k0 = j * BK;
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + n * 8 + t4 * 2 + (e & 1);
        s[n][e] = masked_score(s[n][e], scale, softcap, key, e < 2 ? row_a : row_b, Sk,
                               causal);
        mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
      }
    }
    float m_new[2], corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {  // a row's 64 keys sit in one quad of lanes
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], 2));
      m_new[r] = fmaxf(m_r[r], mx[r]);
      corr[r] = __expf(m_r[r] - m_new[r]);
      m_r[r] = m_new[r];
      l_r[r] *= corr[r];
    }
    // P as the A operand of P@V: k-step t takes fragments 2t and 2t+1
    uint32_t pf[BK / 16][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
      const float p0 = __expf(s[n][0] - m_new[0]);
      const float p1 = __expf(s[n][1] - m_new[0]);
      const float p2 = __expf(s[n][2] - m_new[1]);
      const float p3 = __expf(s[n][3] - m_new[1]);
      l_r[0] += p0 + p1;
      l_r[1] += p2 + p3;
      pf[n / 2][(n & 1) * 2] = pack_bf16(p0, p1);
      pf[n / 2][(n & 1) * 2 + 1] = pack_bf16(p2, p3);
    }
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      acc[n][0] *= corr[0];
      acc[n][1] *= corr[0];
      acc[n][2] *= corr[1];
      acc[n][3] *= corr[1];
    }
    // O += P V: V fragments via a transposing ldmatrix
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
#pragma unroll
      for (int t = 0; t < BK / 16; ++t) {
        uint32_t vf[4];
        ldsm_x4_t(vf, Vt + (t * 16 + (lane % 8) + ((lane / 8) % 2) * 8) * LD + dp * 16 +
                         (lane / 16) * 8);
        mma16816(acc[2 * dp], pf[t], vf[0], vf[1]);
        mma16816(acc[2 * dp + 1], pf[t], vf[2], vf[3]);
      }
    }
    __syncthreads();  // every warp is done with this buffer before it refills
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_r[r];
    l += __shfl_xor_sync(FULL, l, 1);
    l += __shfl_xor_sync(FULL, l, 2);
    inv[r] = 1.f / fmaxf(l, 1e-30f);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r ? row_b : row_a;
    if (row >= Sq) continue;
    bf16* orow = o + b * os.b + (long long)row * os.s + h * os.h;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(orow + n * 8 + t4 * 2) =
          pack_bf16(acc[n][2 * r] * inv[r], acc[n][2 * r + 1] * inv[r]);
  }
}

// ======================================================= f32: shared memory
template <int D>
struct F32Layout {
  static constexpr int LD = D + 1;    // odd row stride: column reads are conflict-free
  static constexpr int LDS = BK + 1;  // scores, then probabilities in place
  static constexpr int LDO = D + 4;   // output accumulator
  static constexpr size_t TILE = round128(sizeof(float) * BQ * LD);
  static constexpr size_t Q = 0;
  static constexpr size_t K = Q + TILE;
  static constexpr size_t V = K + TILE;
  static constexpr size_t S = V + TILE;
  static constexpr size_t O = S + round128(sizeof(float) * BQ * LDS);
  static constexpr size_t M = O + round128(sizeof(float) * BQ * LDO);
  static constexpr size_t L = M + round128(sizeof(float) * BQ);
  static constexpr size_t BYTES = L + round128(sizeof(float) * BQ);
};

template <int D>
__device__ __forceinline__ void load_tile_f32(float* dst, const float* src, long long stride,
                                              int row0, int n_rows) {
  constexpr int VPR = D / 4;
  constexpr int LD = F32Layout<D>::LD;
  for (int i = threadIdx.x; i < BK * VPR; i += NTHREADS) {
    const int r = i / VPR;
    const int c = (i % VPR) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < n_rows)
      val = *reinterpret_cast<const float4*>(src + (long long)(row0 + r) * stride + c);
    dst[r * LD + c] = val.x;
    dst[r * LD + c + 1] = val.y;
    dst[r * LD + c + 2] = val.z;
    dst[r * LD + c + 3] = val.w;
  }
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(FULL, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
  return x;
}

template <int D>
__global__ void __launch_bounds__(NTHREADS)
    fa_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, float* __restrict__ o, int H, int G, int Sq, int Sk,
               Strides qs, Strides ks, Strides vs, Strides os, float scale, float softcap,
               int causal) {
  using LY = F32Layout<D>;
  constexpr int NJ = D / 32;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem + LY::Q);
  float* Ks = reinterpret_cast<float*>(smem + LY::K);
  float* Vs = reinterpret_cast<float*>(smem + LY::V);
  float* Ss = reinterpret_cast<float*>(smem + LY::S);
  float* Os = reinterpret_cast<float*>(smem + LY::O);
  float* row_m = reinterpret_cast<float*>(smem + LY::M);
  float* row_l = reinterpret_cast<float*>(smem + LY::L);

  const int qt = gridDim.x - 1 - blockIdx.x;
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int kvh = h / G;
  const int q0 = qt * BQ;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r0 = warp * WROWS;

  load_tile_f32<D>(Qs, q + b * qs.b + h * qs.h, qs.s, q0, Sq);
  for (int i = threadIdx.x; i < BQ * LY::LDO; i += NTHREADS) Os[i] = 0.f;
  if (threadIdx.x < BQ) {
    row_m[threadIdx.x] = NEG_INF;
    row_l[threadIdx.x] = 0.f;
  }
  const int kv_end = causal ? min(Sk, q0 + BQ) : Sk;
  const int nkt = (kv_end + BK - 1) / BK;
  for (int kt = 0; kt < nkt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile_f32<D>(Ks, k + b * ks.b + kvh * ks.h, ks.s, k0, Sk);
    load_tile_f32<D>(Vs, v + b * vs.b + kvh * vs.h, vs.s, k0, Sk);
    __syncthreads();
    // scores: lane owns key columns lane and lane + 32 of the warp's rows
    float sacc[WROWS][2] = {};
    for (int d = 0; d < D; ++d) {
      const float ka = Ks[lane * LY::LD + d];
      const float kb2 = Ks[(lane + 32) * LY::LD + d];
#pragma unroll
      for (int r = 0; r < WROWS; ++r) {
        const float qv = Qs[(r0 + r) * LY::LD + d];
        sacc[r][0] = fmaf(qv, ka, sacc[r][0]);
        sacc[r][1] = fmaf(qv, kb2, sacc[r][1]);
      }
    }
    for (int r = 0; r < WROWS; ++r) {
      const int row = r0 + r;
      float s0 = masked_score(sacc[r][0], scale, softcap, k0 + lane, q0 + row, Sk, causal);
      float s1 = masked_score(sacc[r][1], scale, softcap, k0 + lane + 32, q0 + row, Sk, causal);
      const float mx = warp_max(fmaxf(s0, s1));
      const float m_old = row_m[row];
      const float m_new = fmaxf(m_old, mx);
      s0 = expf(s0 - m_new);
      s1 = expf(s1 - m_new);
      Ss[row * LY::LDS + lane] = s0;
      Ss[row * LY::LDS + lane + 32] = s1;
      const float sum = warp_sum(s0 + s1);
      const float corr = expf(m_old - m_new);
      for (int d = lane; d < D; d += 32) Os[row * LY::LDO + d] *= corr;
      __syncwarp();  // every lane has read row_m before lane 0 updates it
      if (lane == 0) {
        row_m[row] = m_new;
        row_l[row] = row_l[row] * corr + sum;
      }
    }
    __syncwarp();
    // O += P V: lane owns output columns lane + 32*j of the warp's rows
    float oacc[WROWS][NJ];
#pragma unroll
    for (int r = 0; r < WROWS; ++r)
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) oacc[r][jj] = Os[(r0 + r) * LY::LDO + lane + 32 * jj];
    for (int c = 0; c < BK; ++c) {
      float vv[NJ];
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) vv[jj] = Vs[c * LY::LD + lane + 32 * jj];
#pragma unroll
      for (int r = 0; r < WROWS; ++r) {
        const float p = Ss[(r0 + r) * LY::LDS + c];
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj) oacc[r][jj] = fmaf(p, vv[jj], oacc[r][jj]);
      }
    }
#pragma unroll
    for (int r = 0; r < WROWS; ++r)
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) Os[(r0 + r) * LY::LDO + lane + 32 * jj] = oacc[r][jj];
    __syncwarp();
  }
  for (int r = 0; r < WROWS; ++r) {
    const int qpos = q0 + r0 + r;
    if (qpos >= Sq) break;
    const float l = fmaxf(row_l[r0 + r], 1e-30f);
    float* orow = o + b * os.b + (long long)qpos * os.s + h * os.h;
    for (int d = lane; d < D; d += 32) orow[d] = Os[(r0 + r) * LY::LDO + d] / l;
  }
}

template <typename T, typename Kern>
int launch(Kern kern, size_t bytes, const void* q, const void* k, const void* v, void* o, int B,
           int H, int KVH, int Sq, int Sk, Strides qs, Strides ks, Strides vs, Strides os,
           float scale, float softcap, int causal, cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + BQ - 1) / BQ, B * H);
  kern<<<grid, NTHREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), H, H / KVH, Sq, Sk, qs, ks, vs, os, scale, softcap, causal);
  return (int)cudaGetLastError();
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
  if (B <= 0 || H <= 0 || KVH <= 0 || H % KVH != 0 || Sq <= 0 || Sk <= 0 ||
      B * H > 65535)
    return (int)cudaErrorInvalidValue;
  const Strides qs{qsb, qss, qsh}, ks{ksb, kss, ksh}, vs{vsb, vss, vsh}, os{osb, oss, osh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FA_ARGS q, k, v, o, B, H, KVH, Sq, Sk, qs, ks, vs, os, scale, softcap, causal, st
  if (dtype == 0 && D == 64)
    return launch<float>(fa_fwd_f32<64>, F32Layout<64>::BYTES, FA_ARGS);
  if (dtype == 0 && D == 128)
    return launch<float>(fa_fwd_f32<128>, F32Layout<128>::BYTES, FA_ARGS);
  if (dtype == 1 && D == 64)
    return launch<bf16>(fa_fwd_bf16<64>, Bf16Layout<64>::BYTES, FA_ARGS);
  if (dtype == 1 && D == 128)
    return launch<bf16>(fa_fwd_bf16<128>, Bf16Layout<128>::BYTES, FA_ARGS);
#undef FA_ARGS
  return (int)cudaErrorInvalidValue;
}
