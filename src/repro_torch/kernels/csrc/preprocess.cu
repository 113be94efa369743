// Fused bilinear resize + horizontal flip + normalisation of one image for
// Hopper, in float64.
//
// Replaces the Pallas TPU kernel src/repro/kernels/preprocess.py
// (_prep_kernel / preprocess_plane), which computes, per channel,
// (Ry · img · Rxᵀ − mean) / std with the flip folded into Rx: two banded
// matmuls in f32, the form that suits the TPU's matrix unit.
//
// Here the resize is the 4-tap gather that the storage node's numpy path
// computes (src/repro/data/preprocess.py, bilinear_resize then the
// normalisation), repeated operation for operation in float64, so that an
// image preprocessed on the card has exactly the bytes it would have had
// on a storage node. The prep pipeline promises batches that do not depend
// on where a share ran; two f32 matmuls land about 1e-6 away from numpy.
// Every operation is written with a _rn intrinsic, which nvcc never
// contracts into an FMA: a fused multiply-add rounds once where numpy
// rounds twice.
//
// What bounds it: bytes. Each output element reads four input pixels (the
// crop is read about once overall) and writes 8 bytes after about 13 f64
// operations, far below the card's operations-per-byte line. At the prep
// path's crops (up to 512 x 512 to 224 x 224, one launch per image) the
// bound is under a microsecond, so a launch costs its launch latency.
//
// Design: one thread per output element (oy, ox, c), channels fastest, so
// that a warp's stores into an (out, out, C) batch slot are contiguous.
// Input and output are read and written through element strides, so an
// HWC crop seen as CHW and one image's slot of an NHWC batch need no copy.
// A flip reads column w - 1 - x of the unflipped crop, which is numpy's
// crop[:, ::-1].
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;      // threads per block
constexpr int MAX_C = 4;     // channels (mean and std travel by value)

struct Norm {
  float mean[MAX_C];
  float stdv[MAX_C];
};

// Source index pair and weight of output index o along an axis of n input
// pixels resized to `out`, in numpy's order: s = ((o + 0.5) * n) / out - 0.5,
// i0 = clip(floor(s), 0, n - 1), i1 = clip(i0 + 1, 0, n - 1),
// w = clip(s - i0, 0, 1) with i0 the clamped index.
__device__ __forceinline__ void axis(int o, int n, int out, int& i0, int& i1, double& w) {
  const double s =
      __dsub_rn(__ddiv_rn(__dmul_rn(__dadd_rn((double)o, 0.5), (double)n), (double)out), 0.5);
  i0 = min(max((int)floor(s), 0), n - 1);
  i1 = min(i0 + 1, n - 1);
  w = fmin(fmax(__dsub_rn(s, (double)i0), 0.0), 1.0);
}

// A pixel as numpy sees it: u8 -> f32 -> f64, both exact.
__device__ __forceinline__ double pixel(const uint8_t* p) { return (double)(float)*p; }
__device__ __forceinline__ double pixel(const float* p) { return (double)*p; }

template <typename T>
__global__ void __launch_bounds__(NT)
    prep_kernel(const T* __restrict__ img, int C, int h, int w, long long sc, long long sh,
                long long sw, int flip, double* __restrict__ out, long long oc, long long oys,
                long long oxs, int oh, int ow, Norm norm) {
  const long long t = (long long)blockIdx.x * NT + threadIdx.x;
  if (t >= (long long)oh * ow * C) return;
  const int c = (int)(t % C);
  const long long p = t / C;
  const int ox = (int)(p % ow);
  const int oy = (int)(p / ow);

  int y0, y1, x0, x1;
  double wy, wx;
  axis(oy, h, oh, y0, y1, wy);
  axis(ox, w, ow, x0, x1, wx);
  if (flip) {
    x0 = w - 1 - x0;
    x1 = w - 1 - x1;
  }
  const T* pc = img + c * sc;
  const double f00 = pixel(pc + y0 * sh + x0 * sw), f01 = pixel(pc + y0 * sh + x1 * sw);
  const double f10 = pixel(pc + y1 * sh + x0 * sw), f11 = pixel(pc + y1 * sh + x1 * sw);
  const double ux = __dsub_rn(1.0, wx), uy = __dsub_rn(1.0, wy);
  const double top = __dadd_rn(__dmul_rn(f00, ux), __dmul_rn(f01, wx));
  const double bot = __dadd_rn(__dmul_rn(f10, ux), __dmul_rn(f11, wx));
  const double r = __dadd_rn(__dmul_rn(top, uy), __dmul_rn(bot, wy));
  out[c * oc + oy * oys + ox * oxs] =
      __ddiv_rn(__dsub_rn(r, (double)norm.mean[c]), (double)norm.stdv[c]);
}

}  // namespace

// img: (C, h, w) of uint8 (dtype 0) or float32 (dtype 1) at element
// strides (sc, sh, sw); out: (C, oh, ow) float64 at element strides
// (oc, oys, oxs); mean/std: C float32 values on the host. Returns a
// cudaError_t (0 on success); invalid arguments return
// cudaErrorInvalidValue without launching.
extern "C" int preprocess_image(const void* img, int dtype, int C, int h, int w, long long sc,
                                long long sh, long long sw, int flip, void* out, long long oc,
                                long long oys, long long oxs, int oh, int ow, const float* mean,
                                const float* stdv, void* stream) {
  if (C < 1 || C > MAX_C || h < 1 || w < 1 || oh < 1 || ow < 1)
    return (int)cudaErrorInvalidValue;
  const long long blocks = ((long long)oh * ow * C + NT - 1) / NT;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  Norm norm = {};
  for (int c = 0; c < C; ++c) {
    norm.mean[c] = mean[c];
    norm.stdv[c] = stdv[c];
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  double* o = static_cast<double*>(out);
  switch (dtype) {
    case 0:
      prep_kernel<uint8_t><<<(unsigned)blocks, NT, 0, st>>>(static_cast<const uint8_t*>(img), C,
                                                            h, w, sc, sh, sw, flip, o, oc, oys,
                                                            oxs, oh, ow, norm);
      break;
    case 1:
      prep_kernel<float><<<(unsigned)blocks, NT, 0, st>>>(static_cast<const float*>(img), C, h,
                                                          w, sc, sh, sw, flip, o, oc, oys, oxs,
                                                          oh, ow, norm);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
