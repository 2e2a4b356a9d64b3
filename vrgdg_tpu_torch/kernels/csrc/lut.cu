// Apply LUT on Hopper (sm_90a), with a plain C interface loaded through
// ctypes by vrgdg_tpu_torch/kernels/lut_cuda.py.
//
// lut_apply replaces no Pallas kernel.  It implements
// vrgdg_tpu_torch/ops/lut.py::apply_lut_bundle, the port of
// vrgdg_tpu/ops/lut.py::apply_lut_bundle, which the JAX package leaves to
// XLA's gather.  On the card the eager torch chain of that function (a
// (..., 24) row gather, then seven lerps a channel with float64
// temporaries, then the strength blend) ran at 0.1% of its roofline, and
// it is the whole device work of every single-stage Apply LUT.  Per
// element of a (..., C >= 3) float32 batch, in one pass:
// - the lattice coordinates of ops/lut.py::_coords, with true division by
//   the span floored at 1e-6 (not the fused phase 1's reciprocal);
// - one (N^3, 24) corner-bundle row (six 16-byte loads);
// - the trilerp over the blue, green, then red fractions, and the clamp;
// - the strength blend, whose factor the wrapper computes on the host as
//   ops/lut.py::_finish does;
// - channels past the third copied.
// Every lerp is ops/lut.py::_lerp: the float32 product a * (1 - f), exact
// in float64, plus the float32 product b * f, summed in float64 and
// rounded once to float32.  The product is exact, so one double FMA gives
// that sum's bits.  The __f*_rn intrinsics keep nvcc from contracting a
// float32 product into a neighbouring add whatever NVCC_FLAGS say, so the
// kernel gives the CPU's eager bits.  grade.cu's trilerp rounds in float32
// with contraction, so the two share no code.
//
// What bounds it on an H100.  A 3-channel pixel moves 24 bytes of HBM (12
// in, 12 out): 0.12 ms for 1080p x 8 at 3.35 TB/s.  Its row gather reads
// 96 bytes a pixel from L2 (a 33^3 bundle is 3.4 MB and stays there),
// four times the HBM bytes.  Its SASS holds 24 double FMAs and 85
// conversions and other 16-a-clock instructions a pixel: 0.34 ms at
// 1080p x 8, the bound.  Timed on the card at 1080p x 8: 0.45 ms on
// uniform frames, where a float32-FMA yardstick of the same mapping takes
// as long (the gather's L2 latency sets the time), and 0.38 ms on smooth
// frames, whose neighbouring pixels share rows, where the yardstick takes
// under half (the conversions set it).  The plain torch chain: 28.6 ms.
//
// The design, chosen by timing alternatives on the card
// (kernel_variants/lut_variants.py, 1080p x 8, uniform / smooth frames):
// one pixel a thread, 128 threads a block, 48 registers.  Built beside the
// variants, that mapping takes 0.420 / 0.377 ms; 256 threads 0.426 /
// 0.379, 512 0.453 / 0.420; two pixels a thread 0.440 / 0.396; a
// 32-register cap 0.530 / 0.380; staging source and output through shared
// memory with 16-byte loads and stores 0.496 / 0.384.  So source and
// output move a float at a time (a warp's loads of one channel fall on 32
// pixels' contiguous 12-byte strides, which L1 coalesces) and frames need
// no alignment.  This kernel itself, through its wrapper, times 0.446 /
// 0.375 (0.434 / 0.380 at 256 threads): 128 threads are kept for smooth
// content, which is what footage and the benchmark's textured clips are.

#include "common.h"

namespace {

constexpr int kLutThreads = 128;

// ops/lut.py::_lerp: a * (1 - f) + b * f, with keep = (double)(1 - f)
// rounded to float32 first.
__device__ __forceinline__ float lerp_f64(float a, float b, float f,
                                          double keep) {
  return __double2float_rn(__fma_rn(static_cast<double>(a), keep,
                                    static_cast<double>(__fmul_rn(b, f))));
}

__device__ __forceinline__ double keep_of(float f) {
  return static_cast<double>(__fsub_rn(1.0f, f));
}

// One pixel: source rgb -> graded and blended rgb.  span is the domain's
// floored span, blend the strength factor.
__device__ __forceinline__ void lut_pixel(const float src[3],
                                          const float* __restrict__ bundle,
                                          int lut_size, const float dmin[3],
                                          const float span[3], float blend,
                                          double keep_blend, float out[3]) {
  const float max_index = static_cast<float>(lut_size - 1);
  float frac[3];
  int lo[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float coord = __fmul_rn(
        clip01(__fdiv_rn(__fsub_rn(src[i], dmin[i]), span[i])), max_index);
    const float floor_coord = floorf(coord);
    frac[i] = __fsub_rn(coord, floor_coord);
    lo[i] = static_cast<int>(floor_coord);
  }
  const int cell = (lo[2] * lut_size + lo[1]) * lut_size + lo[0];
  const float4* row4 =
      reinterpret_cast<const float4*>(bundle + static_cast<size_t>(cell) * 24);
  float g[24];
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    const float4 v = __ldg(row4 + k);
    g[4 * k] = v.x;
    g[4 * k + 1] = v.y;
    g[4 * k + 2] = v.z;
    g[4 * k + 3] = v.w;
  }
  // corners [c000, c100, c010, c110, c001, c101, c011, c111], digits b, g, r
  const float fr = frac[0], fg = frac[1], fb = frac[2];
  const double keep_r = keep_of(fr), keep_g = keep_of(fg),
               keep_b = keep_of(fb);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float c00 = lerp_f64(g[0 + c], g[3 + c], fb, keep_b);
    const float c01 = lerp_f64(g[6 + c], g[9 + c], fb, keep_b);
    const float c10 = lerp_f64(g[12 + c], g[15 + c], fb, keep_b);
    const float c11 = lerp_f64(g[18 + c], g[21 + c], fb, keep_b);
    const float c0 = lerp_f64(c00, c01, fg, keep_g);
    const float c1 = lerp_f64(c10, c11, fg, keep_g);
    const float graded = clip01(lerp_f64(c0, c1, fr, keep_r));
    out[c] = lerp_f64(src[c], graded, blend, keep_blend);
  }
}

// One thread a pixel of a flat (pixels, channels) float32 array; grid
// ceil(pixels / kLutThreads).  dmin and dmax are 3 floats on the device.
__global__ void __launch_bounds__(kLutThreads)
lut_apply_kernel(const float* __restrict__ frames, long long pixels,
                 int channels, const float* __restrict__ bundle,
                 int lut_size, const float* __restrict__ dmin_in,
                 const float* __restrict__ dmax_in, float blend,
                 float* __restrict__ out) {
  const long long p =
      static_cast<long long>(blockIdx.x) * kLutThreads + threadIdx.x;
  if (p >= pixels) return;
  float dmin[3], span[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    dmin[i] = __ldg(dmin_in + i);
    span[i] = fmaxf(__fsub_rn(__ldg(dmax_in + i), dmin[i]), 1e-6f);
  }
  const size_t base = static_cast<size_t>(p) * channels;
  const float src[3] = {__ldg(frames + base), __ldg(frames + base + 1),
                        __ldg(frames + base + 2)};
  float rgb[3];
  lut_pixel(src, bundle, lut_size, dmin, span, blend, keep_of(blend), rgb);
#pragma unroll
  for (int c = 0; c < 3; ++c) out[base + c] = rgb[c];
  for (int c = 3; c < channels; ++c) out[base + c] = __ldg(frames + base + c);
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue when the pixels need more blocks than a grid
// holds.  bundle must be 16-byte aligned; the wrapper checks.
int vrgdg_lut_apply(int device, const float* frames, long long pixels,
                    int channels, const float* bundle, int lut_size,
                    const float* dmin, const float* dmax, float blend,
                    float* out, void* stream) {
  const long long blocks = (pixels + kLutThreads - 1) / kLutThreads;
  if (blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  VRGDG_SELECT_DEVICE(device);
  lut_apply_kernel<<<static_cast<unsigned>(blocks), kLutThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      frames, pixels, channels, bundle, lut_size, dmin, dmax, blend, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
