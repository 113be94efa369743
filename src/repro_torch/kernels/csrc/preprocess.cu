// Fused bilinear resize + horizontal flip + normalisation for Hopper, in
// float64: one image at any strides (preprocess_image), or every crop of a
// minibatch's share in one launch (preprocess_batch).
//
// Replaces the Pallas TPU kernel src/repro/kernels/preprocess.py
// (_prep_kernel / preprocess_plane), which computes, per channel,
// (Ry · img · Rxᵀ − mean) / std with the flip folded into Rx: two banded
// matmuls in f32, the form that suits the TPU's matrix unit. The JAX
// package preprocesses a minibatch's local share image by image
// (src/repro/data/offload_prep.py, local_images); preprocess_batch gives
// the same images in one launch.
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
// operations, far below the card's operations-per-byte line. One image
// (512 x 512 to 224 x 224) is bound under a microsecond, so a launch per
// image costs its launch latency; a minibatch's local share (171 crops,
// about 206 MB of float64 out) is bound near 0.07 ms, which one launch can
// approach.
//
// preprocess_image: one thread per output element (oy, ox, c), channels
// fastest, so that a warp's stores into an (out, out, C) batch slot are
// contiguous. Input and output are read and written through element
// strides, so an HWC crop seen as CHW and one image's slot of an NHWC
// batch need no copy. A flip reads column w - 1 - x of the unflipped crop,
// which is numpy's crop[:, ::-1].
//
// preprocess_batch: the crops lie back to back, HWC uint8 and unflipped,
// in one buffer that the host fills and copies in one go; a table gives
// each its offset, shape, flip and batch slot. The grid is (row tiles of
// one output image, images). A block computes the source indices and
// weights of its ROWS output rows and of every output column once, into
// shared memory (the per-image kernel recomputes them in every thread),
// then gathers from the crop (L2-resident) and writes its rows of the slot
// with coalesced stores. Both kernels share axis(), pixel() and
// resample(), so they give the same bits.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;      // threads per block
constexpr int MAX_C = 4;     // channels (mean and std travel by value)
constexpr int ROWS = 8;      // output rows per block of the batch kernel
constexpr int MAX_OUT = 2048;  // batch output side: its taps fit in 48 KB of shared memory
constexpr int DESC = 6;      // batch table row: offset, h, w, C, flip, slot

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

// One output element from its four source pixels and two weights, in
// numpy's order: blend along x, then y, then (r - mean) / std.
__device__ __forceinline__ double resample(double f00, double f01, double f10, double f11,
                                           double wx, double wy, float mean, float stdv) {
  const double ux = __dsub_rn(1.0, wx), uy = __dsub_rn(1.0, wy);
  const double top = __dadd_rn(__dmul_rn(f00, ux), __dmul_rn(f01, wx));
  const double bot = __dadd_rn(__dmul_rn(f10, ux), __dmul_rn(f11, wx));
  const double r = __dadd_rn(__dmul_rn(top, uy), __dmul_rn(bot, wy));
  return __ddiv_rn(__dsub_rn(r, (double)mean), (double)stdv);
}

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
  out[c * oc + oy * oys + ox * oxs] =
      resample(f00, f01, f10, f11, wx, wy, norm.mean[c], norm.stdv[c]);
}

// Block (row tile, image): rows [ROWS * blockIdx.x, + ROWS) of image
// blockIdx.y, whose table row is desc[DESC * blockIdx.y ...].
__global__ void __launch_bounds__(NT)
    batch_kernel(const uint8_t* __restrict__ packed, const long long* __restrict__ desc,
                 double* __restrict__ out, int C, int oh, int ow, Norm norm) {
  extern __shared__ double taps[];
  double* swx = taps;                          // [ow] column weights
  double* swy = swx + ow;                      // [ROWS] row weights
  int* sx0 = reinterpret_cast<int*>(swy + ROWS);  // [ow] source columns, flipped
  int* sx1 = sx0 + ow;
  int* sy0 = sx1 + ow;                         // [ROWS] source rows
  int* sy1 = sy0 + ROWS;

  const long long* d = desc + (long long)blockIdx.y * DESC;
  const int h = (int)d[1], w = (int)d[2], flip = (int)d[4];
  const int oy0 = blockIdx.x * ROWS;
  const int rows = min(ROWS, oh - oy0);
  for (int t = threadIdx.x; t < ow + rows; t += NT) {
    int i0, i1;
    double wt;
    if (t < ow) {
      axis(t, w, ow, i0, i1, wt);
      if (flip) {
        i0 = w - 1 - i0;
        i1 = w - 1 - i1;
      }
      sx0[t] = i0;
      sx1[t] = i1;
      swx[t] = wt;
    } else {
      axis(oy0 + t - ow, h, oh, i0, i1, wt);
      sy0[t - ow] = i0;
      sy1[t - ow] = i1;
      swy[t - ow] = wt;
    }
  }
  __syncthreads();

  // Thread t owns the elements e = t, t + NT, ... of an output row (ow * C
  // values, channels fastest) in each of the block's rows, so the index
  // arithmetic is done once per column, not once per output.
  const uint8_t* img = packed + d[0];
  const long long row_in = (long long)w * C;
  const int row_out = ow * C;
  double* o = out + (d[5] * oh + oy0) * (long long)row_out;
  for (int e = threadIdx.x; e < row_out; e += NT) {
    const int c = e % C, ox = e / C;
    const int x0 = sx0[ox] * C + c, x1 = sx1[ox] * C + c;
    const double wx = swx[ox];
    const float mean = norm.mean[c], stdv = norm.stdv[c];
    for (int ry = 0; ry < rows; ++ry) {
      const uint8_t* p0 = img + sy0[ry] * row_in;
      const uint8_t* p1 = img + sy1[ry] * row_in;
      o[ry * row_out + e] = resample(pixel(p0 + x0), pixel(p0 + x1), pixel(p1 + x0),
                                     pixel(p1 + x1), wx, swy[ry], mean, stdv);
    }
  }
}

Norm make_norm(int C, const float* mean, const float* stdv) {
  Norm norm = {};
  for (int c = 0; c < C; ++c) {
    norm.mean[c] = mean[c];
    norm.stdv[c] = stdv[c];
  }
  return norm;
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
  const Norm norm = make_norm(C, mean, stdv);
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

// packed: the crops, HWC uint8, back to back on the device; desc: n_images
// rows of DESC int64 values on the device (byte offset of the crop in
// packed, h, w, C, flip, slot of out), as the wrapper checked them; out:
// (n, oh, ow, C) float64, contiguous; mean/std: C float32 values on the
// host. Returns a cudaError_t (0 on success); invalid arguments return
// cudaErrorInvalidValue without launching.
extern "C" int preprocess_batch(const void* packed, const long long* desc, int n_images,
                                void* out, int C, int oh, int ow, const float* mean,
                                const float* stdv, void* stream) {
  if (n_images < 1 || n_images > 65535 || C < 1 || C > MAX_C || oh < 1 || ow < 1 ||
      ow > MAX_OUT)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((oh + ROWS - 1) / ROWS, n_images);
  const size_t smem = (size_t)(ow + ROWS) * (sizeof(double) + 2 * sizeof(int));
  batch_kernel<<<grid, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(packed), desc, static_cast<double*>(out), C, oh, ow,
      make_norm(C, mean, stdv));
  return (int)cudaGetLastError();
}
