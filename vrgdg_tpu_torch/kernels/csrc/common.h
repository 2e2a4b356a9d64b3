// Device helpers shared by the port's Hopper kernels: clipping, the
// colour-space conversions of vrgdg_tpu_torch/core/colorspace.py, and the
// Philox4x32-10 grain stream of vrgdg_tpu_torch/ops/grain.py.
//
// Every .cu under csrc/ builds into a shared library of its own and
// includes this header once, so the film-grain kernel (grain.cu) and the
// grade's phase 2 (grade.cu) draw identical grain from one copy of the
// stream.  Numerics follow the plain PyTorch versions formula by formula
// (same constants, same association order, same clip points), except that
// the colour conversions take their powers through exp2f/log2f and divide
// by constants through reciprocals: the last-ulp differences the kernels'
// bounds allow.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Rec.709 luma.
constexpr float kLumaR = 0.2126f;
constexpr float kLumaG = 0.7152f;
constexpr float kLumaB = 0.0722f;

// sRGB D65 white and the kornia RGB <-> XYZ matrices.
constexpr float kWhiteX = 0.95047f;
constexpr float kWhiteY = 1.0f;
constexpr float kWhiteZ = 1.08883f;

__constant__ float kRgb2Xyz[3][3] = {
    {0.412453f, 0.357580f, 0.180423f},
    {0.212671f, 0.715160f, 0.072169f},
    {0.019334f, 0.119193f, 0.950227f},
};
__constant__ float kXyz2Rgb[3][3] = {
    {3.2404813432005266f, -1.5371515162713185f, -0.4985363261688878f},
    {-0.9692549499965682f, 1.8759900014898907f, 0.0415559265582928f},
    {0.0556466391351772f, -0.2040413383665112f, 1.0573110696453443f},
};

constexpr float kLabEps = 0.008856f;
constexpr float kLabKappa = 7.787f;
constexpr float kLabOffset = 0.13793103448275862f;  // 4/29
constexpr float kLabFtCut = 0.2068966f;
constexpr float kInvGamma = 0.41666666666666669f;   // 1/2.4
constexpr float kInvKappa = 1.0f / kLabKappa;
constexpr float kInv1055 = 1.0f / 1.055f;
constexpr float kInv1292 = 1.0f / 12.92f;
constexpr float kInv116 = 1.0f / 116.0f;
constexpr float kInv500 = 1.0f / 500.0f;
constexpr float kInv200 = 1.0f / 200.0f;
constexpr float kTwoPi = 6.283185307179586f;
constexpr float kTwoPow24Inv = 5.9604644775390625e-08f;
constexpr uint32_t kSeedMask = 0x7FFFFFFFu;

__device__ __forceinline__ float clip01(float x) {
  return fminf(fmaxf(x, 0.0f), 1.0f);
}

// x / d for a constant d of reciprocal r = 1/d: the product x * r,
// corrected by one FMA step.  A bare x * r carries the rounding of r with
// the same sign on every pixel; phase 1's frame means sum millions of
// pixels, and that bias moved the colour-match offsets past the bounds.
__device__ __forceinline__ float div_const(float x, float d, float r) {
  const float q = x * r;
  return fmaf(fmaf(-q, d, x), r, q);
}

// sRGB -> linear.  v^2.4 is taken as v^2 * 2^(0.4 log2 v): the rounding of
// the exponent is scaled by 0.4, not 2.4, so this stays within ~3e-7
// relative of powf at a fraction of its instructions.
__device__ __forceinline__ float srgb_to_linear(float x) {
  if (x > 0.04045f) {
    const float v = div_const(x + 0.055f, 1.055f, kInv1055);
    return v * v * exp2f(0.4f * log2f(v));
  }
  return div_const(x, 12.92f, kInv1292);
}

// linear -> sRGB, x^(1/2.4) as 2^(log2 x / 2.4)
__device__ __forceinline__ float linear_to_srgb(float x) {
  return x > 0.0031308f ? 1.055f * exp2f(log2f(x) * kInvGamma) - 0.055f
                        : 12.92f * x;
}

__device__ __forceinline__ float lab_f(float t) {
  return t > kLabEps ? cbrtf(fmaxf(t, 0.0f)) : kLabKappa * t + kLabOffset;
}

__device__ __forceinline__ float lab_f_inverse(float f) {
  return f > kLabFtCut ? f * f * f : (f - kLabOffset) * kInvKappa;
}

__device__ __forceinline__ void rgb_to_lab(const float rgb[3], float lab[3]) {
  const float rl = srgb_to_linear(rgb[0]);
  const float gl = srgb_to_linear(rgb[1]);
  const float bl = srgb_to_linear(rgb[2]);
  const float white[3] = {kWhiteX, kWhiteY, kWhiteZ};
  const float inv_white[3] = {1.0f / kWhiteX, 1.0f / kWhiteY, 1.0f / kWhiteZ};
  float f[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float xyz = rl * kRgb2Xyz[i][0] + gl * kRgb2Xyz[i][1] +
                      bl * kRgb2Xyz[i][2];
    f[i] = lab_f(div_const(xyz, white[i], inv_white[i]));
  }
  lab[0] = 116.0f * f[1] - 16.0f;
  lab[1] = 500.0f * (f[0] - f[1]);
  lab[2] = 200.0f * (f[1] - f[2]);
}

// LAB -> sRGB, clipped to [0, 1].  Nothing downstream sums these values,
// so the divisions by constants are plain products with reciprocals.
__device__ __forceinline__ void lab_to_rgb(const float lab[3], float rgb[3]) {
  const float fy = (lab[0] + 16.0f) * kInv116;
  const float fx = lab[1] * kInv500 + fy;
  const float fz = fmaxf(fy - lab[2] * kInv200, 0.0f);
  const float x = lab_f_inverse(fx) * kWhiteX;
  const float y = lab_f_inverse(fy) * kWhiteY;
  const float z = lab_f_inverse(fz) * kWhiteZ;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float linear = fmaxf(
        x * kXyz2Rgb[i][0] + y * kXyz2Rgb[i][1] + z * kXyz2Rgb[i][2], 0.0f);
    rgb[i] = clip01(linear_to_srgb(linear));
  }
}

__device__ __forceinline__ float luma(const float c[3]) {
  return c[0] * kLumaR + c[1] * kLumaG + c[2] * kLumaB;
}

// Philox4x32-10 (Salmon et al., SC'11).
__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0,
                                               uint32_t k1) {
#pragma unroll
  for (int round = 0; round < 10; ++round) {
    if (round) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t hi0 = __umulhi(0xD2511F53u, c.x);
    const uint32_t lo0 = 0xD2511F53u * c.x;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z);
    const uint32_t lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}

// A uniform in (0, 1] from the top 24 bits, so logf never sees 0.
__device__ __forceinline__ float uniform01(uint32_t bits) {
  return static_cast<float>((bits >> 8) + 1u) * kTwoPow24Inv;
}

// Unit-intensity grain of one pixel: key (seed + absolute frame) &
// 0x7FFFFFFF, counter = the pixel's index y * W + x.  Box-Muller normals
// (r0 cos t0, r0 sin t0, r1 cos t1) for R, G, B, scaled (2, 1, 3), then
// desaturated toward the unscaled green normal by keep_mix = 1 - mix.
__device__ __forceinline__ void grain_field(uint32_t key, uint32_t counter,
                                            float mix, float keep_mix,
                                            float grain[3]) {
  const uint4 bits = philox4x32_10(make_uint4(counter, 0u, 0u, 0u), key, 0u);
  const float r0 = sqrtf(-2.0f * logf(uniform01(bits.x)));
  const float t0 = kTwoPi * uniform01(bits.y);
  const float r1 = sqrtf(-2.0f * logf(uniform01(bits.z)));
  const float t1 = kTwoPi * uniform01(bits.w);
  const float noise[3] = {r0 * cosf(t0), r0 * sinf(t0), r1 * cosf(t1)};
  const float scale[3] = {2.0f, 1.0f, 3.0f};
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    grain[c] = mix * (noise[c] * scale[c]) + keep_mix * noise[1];
  }
}

}  // namespace

// Every launcher selects ``device`` first: each library links its own
// CUDA runtime, whose current device is not PyTorch's.
#define VRGDG_SELECT_DEVICE(device)                              \
  do {                                                           \
    const cudaError_t selected = cudaSetDevice(device);          \
    if (selected != cudaSuccess) return static_cast<int>(selected); \
  } while (0)

// Each library carries one copy (it is built from one .cu), so the
// wrappers can turn any launcher's return code into text.
extern "C" const char* vrgdg_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
