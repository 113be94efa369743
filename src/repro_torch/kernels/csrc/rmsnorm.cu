// RMSNorm over the last dim, forward, for Hopper (sm_90a): one pass, bf16 in
// and out, f32 inside.
//
// It replaces no TPU kernel: the JAX package leaves the norm to XLA, which
// fuses it, and the port ran it as plain PyTorch (models/layers.py
// apply_norm): x.float(), square, mean, + eps, rsqrt, a product, the scale's
// cast, a second product and the cast back, nine kernels that move about 40
// bytes an element through device memory where the norm needs 4. This
// kernel computes
//
//   y = bf16( (x * rsqrt(mean(x * x) + eps)) * scale ),
//
// with the plain path's arithmetic: each x * x rounded to f32, their sum in
// f32, the mean as the sum times PyTorch's factor (rows / (rows * d) in
// f32), + eps, rsqrtf, the two products rounded apart in that order (no
// fused multiply-add), and one rounding to bf16 at the end. Only the order
// of the sum differs: a warp's butterfly of shuffles, then the row's warps
// in a fixed order through shared memory. No atomics, so two calls on one
// input give the same bits.
//
// Layout: each row of x (bf16, d a multiple of 8, contiguous in d, rows
// `x_stride` elements apart) is read once with 16-byte loads and kept in
// registers until its output is written; y is contiguous. A row is served by
// `wpr` warps whose lanes each hold `VEC` 16-byte vectors (the least number
// of warps for which at most kMaxVec vectors a lane suffice), and a block
// holds as many rows as fit in kBlockThreads threads: at d 4,096 four warps
// of 4 vectors a lane, two rows a block; at d 5,120 five warps, one row.
// The scale (bf16 or f32, d values) is read after the sum, from L2.
//
// What bounds it: bytes. At S 7,680 x d 4,096 a call moves 126 MB (x in, y
// out, the scale), 37.6 us at 3.35 TB/s; four operations an element are
// nothing. On an H100 80GB HBM3 at 700 W, x streaming from device memory:
// 46 us there (81 % of the bound), 115 us at 16,384 x 5,120 (87 %), 15-19 us
// at 2,304 rows (75-77 %), where the plain path takes 0.18-1.32 ms. Lanes of
// up to 8 vectors (fewer warps a row) ran 5-37 % slower at every shape, up
// to 2 vectors within 2 % either way, 128 or 512 threads a block within 3 %.
// PERF.md has the runs (chip_smoke.py's kernels_rmsnorm phase).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// (internal linkage: the library exports rms_norm alone)
namespace repro_rmsnorm {
namespace {

constexpr int kMaxVec = 4;          // 16-byte vectors a lane holds, at most
constexpr int kBlockThreads = 256;  // threads a block, where rows are narrow enough
constexpr int kMaxWarps = 32;       // warps a row, at most: d up to 32,768

__device__ __forceinline__ float lo_of(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float hi_of(uint32_t u) { return __uint_as_float(u & 0xffff0000u); }

// eight scale values from vector i of the scale, as f32 (exact)
__device__ __forceinline__ void load_scale(const __nv_bfloat16* s, int i, float out[8]) {
  const uint4 v = __ldg(reinterpret_cast<const uint4*>(s) + i);
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    out[2 * j] = lo_of(w[j]);
    out[2 * j + 1] = hi_of(w[j]);
  }
}

__device__ __forceinline__ void load_scale(const float* s, int i, float out[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(s) + 2 * i);
  const float4 b = __ldg(reinterpret_cast<const float4*>(s) + 2 * i + 1);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);  // each rounded to nearest even
  return *reinterpret_cast<const uint32_t*>(&p);
}

// blockDim (32 * wpr, rows a block); row blockIdx.x * blockDim.y + threadIdx.y
template <int VEC, typename Scale>
__global__ void __launch_bounds__(1024)
rms_norm_kernel(const __nv_bfloat16* __restrict__ x, long long x_stride,
                const Scale* __restrict__ scale, __nv_bfloat16* __restrict__ y, long long rows,
                int d, float inv_d, float eps) {
  __shared__ float partial[kMaxWarps];
  const int tpr = blockDim.x, t = threadIdx.x, nvec = d / 8;
  const long long row = (long long)blockIdx.x * blockDim.y + threadIdx.y;
  const bool live = row < rows;
  const uint4* xr = reinterpret_cast<const uint4*>(x + (live ? row : 0) * x_stride);

  uint4 v[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    const int i = t + k * tpr;
    v[k] = (live && i < nvec) ? xr[i] : make_uint4(0, 0, 0, 0);
  }
  float ss = 0.f;  // zeros past the row add nothing
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    const uint32_t w[4] = {v[k].x, v[k].y, v[k].z, v[k].w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float a = lo_of(w[j]), b = hi_of(w[j]);
      ss = __fadd_rn(ss, __fmul_rn(a, a));
      ss = __fadd_rn(ss, __fmul_rn(b, b));
    }
  }
  // a butterfly leaves the same sum in every lane (IEEE addition commutes)
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss = __fadd_rn(ss, __shfl_xor_sync(0xffffffffu, ss, o));
  const int wpr = tpr / 32;
  if (wpr > 1) {  // the same for the whole block
    float* mine = partial + threadIdx.y * wpr;
    if ((t & 31) == 0) mine[t / 32] = ss;
    __syncthreads();
    ss = mine[0];
    for (int w = 1; w < wpr; ++w) ss = __fadd_rn(ss, mine[w]);
  }
  if (!live) return;

  const float r = rsqrtf(__fadd_rn(__fmul_rn(ss, inv_d), eps));
  uint4* yr = reinterpret_cast<uint4*>(y + row * (long long)d);
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    const int i = t + k * tpr;
    if (i >= nvec) break;
    float s[8];
    load_scale(scale, i, s);
    const uint32_t w[4] = {v[k].x, v[k].y, v[k].z, v[k].w};
    uint32_t o[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      o[j] = pack(__fmul_rn(__fmul_rn(lo_of(w[j]), r), s[2 * j]),
                  __fmul_rn(__fmul_rn(hi_of(w[j]), r), s[2 * j + 1]));
    yr[i] = make_uint4(o[0], o[1], o[2], o[3]);
  }
}

template <typename Scale>
cudaError_t launch(const void* x, long long x_stride, const void* scale, void* y,
                   long long rows, int d, float eps, cudaStream_t st) {
  const int nvec = d / 8;
  const int wpr = (nvec + 32 * kMaxVec - 1) / (32 * kMaxVec);
  const int vec = (nvec + 32 * wpr - 1) / (32 * wpr);
  const int rpb = wpr * 32 >= kBlockThreads ? 1 : kBlockThreads / (wpr * 32);
  const dim3 block(32 * wpr, rpb);
  const long long blocks = (rows + rpb - 1) / rpb;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  // PyTorch's mean: the sum times (output elements / input elements) in f32
  const float inv_d = static_cast<float>(rows) / static_cast<float>(rows * d);
#define RMS_ARGS                                                                         \
  static_cast<const __nv_bfloat16*>(x), x_stride, static_cast<const Scale*>(scale),      \
      static_cast<__nv_bfloat16*>(y), rows, d, inv_d, eps
  switch (vec) {
    case 1: rms_norm_kernel<1, Scale><<<(unsigned)blocks, block, 0, st>>>(RMS_ARGS); break;
    case 2: rms_norm_kernel<2, Scale><<<(unsigned)blocks, block, 0, st>>>(RMS_ARGS); break;
    case 3: rms_norm_kernel<3, Scale><<<(unsigned)blocks, block, 0, st>>>(RMS_ARGS); break;
    case 4: rms_norm_kernel<4, Scale><<<(unsigned)blocks, block, 0, st>>>(RMS_ARGS); break;
    default: return cudaErrorInvalidValue;
  }
#undef RMS_ARGS
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro_rmsnorm

// x (rows, d) bf16, rows x_stride elements apart, 16-byte aligned; scale (d,)
// bf16 (scale_f32 0) or f32 (1), 16-byte aligned; y (rows, d) bf16, contiguous.
extern "C" int rms_norm(const void* x, long long x_stride, const void* scale, int scale_f32,
                        void* y, long long rows, int d, float eps, void* stream) {
  using namespace repro_rmsnorm;
  if (rows <= 0 || d <= 0 || d % 8 != 0 || d > 8 * 32 * kMaxWarps * kMaxVec ||
      x_stride % 8 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(scale_f32 ? launch<float>(x, x_stride, scale, y, rows, d, eps, st)
                         : launch<__nv_bfloat16>(x, x_stride, scale, y, rows, d, eps, st));
}
