// The fused grade stack's two Hopper kernels (sm_90a), with a plain C
// interface loaded through ctypes by vrgdg_tpu_torch/kernels/grade_cuda.py.
//
// grade_phase1 replaces vrgdg_tpu/kernels/grade_pallas.py::
// _phase1_rowmajor_kernel: per pixel, the LUT trilerp read straight from
// the (N^3, 24) corner bundle, the strength blend, the elementwise adjust
// sliders, RGB -> CIELAB, and per-block float64 partial sums of L, a, b and
// their squares for the colour-match statistics.
//
// grade_phase2 replaces vrgdg_tpu/kernels/grade_pallas.py::
// _phase2_flat_kernel: the per-frame affine LAB transfer, LAB -> RGB, the
// 3x3 zero-border box unsharp and the Philox4x32-10 film grain.
//
// Both read and write BHWC float32.  What bounds them on an H100: phase 1
// moves 24 bytes of HBM per pixel (12 in, 12 out) and gathers one 96-byte
// bundle row per pixel, which stays in the 50 MB L2 (3.4 MB for N=33); its
// arithmetic (one powf per channel, one cbrtf per channel) is small beside
// that.  Phase 2 moves the same 24 bytes per pixel but is arithmetic-heavy:
// LAB -> RGB costs three powf per pixel, so each block converts its
// (8+2) x (32+2) halo tile once into shared memory instead of nine times
// per pixel, and the grain costs one Philox call (10 rounds) plus two
// logf/sqrtf and three sinf/cosf per pixel.
//
// Numerics follow the plain PyTorch versions in grade_cuda.py formula by
// formula (same constants, same association order, same clip points).
// Built without --use_fast_math; nvcc's default FMA contraction is the
// remaining last-ulp difference from the plain versions.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Rec.709 luma.
constexpr float kLumaR = 0.2126f;
constexpr float kLumaG = 0.7152f;
constexpr float kLumaB = 0.0722f;

// sRGB D65 white and the kornia RGB <-> XYZ matrices
// (vrgdg_tpu_torch/core/colorspace.py).
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
constexpr float kTwoPi = 6.283185307179586f;
constexpr float kTwoPow24Inv = 5.9604644775390625e-08f;

// Adjust slider bits (grade_cuda.py builds the mask and the values).
constexpr int kTempTint = 1 << 0;
constexpr int kExposure = 1 << 1;
constexpr int kContrast = 1 << 2;
constexpr int kSaturation = 1 << 3;
constexpr int kHighlights = 1 << 4;
constexpr int kShadows = 1 << 5;
constexpr int kWhites = 1 << 6;
constexpr int kBlacks = 1 << 7;
constexpr int kFade = 1 << 8;
constexpr int kVignette = 1 << 9;
constexpr int kAdjustOn = 1 << 10;

constexpr int kPhase1Threads = 256;
constexpr int kTileW = 32;
constexpr int kTileH = 8;

__device__ __forceinline__ float clip01(float x) {
  return fminf(fmaxf(x, 0.0f), 1.0f);
}

__device__ __forceinline__ float srgb_to_linear(float x) {
  return x > 0.04045f ? powf((x + 0.055f) / 1.055f, 2.4f) : x / 12.92f;
}

__device__ __forceinline__ float linear_to_srgb(float x) {
  return x > 0.0031308f ? 1.055f * powf(fmaxf(x, 0.0f), kInvGamma) - 0.055f
                        : 12.92f * x;
}

__device__ __forceinline__ float lab_f(float t) {
  return t > kLabEps ? cbrtf(fmaxf(t, 0.0f)) : kLabKappa * t + kLabOffset;
}

__device__ __forceinline__ float lab_f_inverse(float f) {
  return f > kLabFtCut ? f * f * f : (f - kLabOffset) / kLabKappa;
}

__device__ __forceinline__ void rgb_to_lab(const float rgb[3], float lab[3]) {
  const float rl = srgb_to_linear(rgb[0]);
  const float gl = srgb_to_linear(rgb[1]);
  const float bl = srgb_to_linear(rgb[2]);
  const float white[3] = {kWhiteX, kWhiteY, kWhiteZ};
  float f[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float xyz = rl * kRgb2Xyz[i][0] + gl * kRgb2Xyz[i][1] +
                      bl * kRgb2Xyz[i][2];
    f[i] = lab_f(xyz / white[i]);
  }
  lab[0] = 116.0f * f[1] - 16.0f;
  lab[1] = 500.0f * (f[0] - f[1]);
  lab[2] = 200.0f * (f[1] - f[2]);
}

// LAB -> sRGB, clipped to [0, 1].
__device__ __forceinline__ void lab_to_rgb(const float lab[3], float rgb[3]) {
  const float fy = (lab[0] + 16.0f) / 116.0f;
  const float fx = lab[1] / 500.0f + fy;
  const float fz = fmaxf(fy - lab[2] / 200.0f, 0.0f);
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

// torch.linspace(-1, 1, steps)[i] as PyTorch computes it.
__device__ __forceinline__ float linspace_pm1(int i, int steps) {
  if (steps == 1) return -1.0f;
  const float step = 2.0f / static_cast<float>(steps - 1);
  return i < steps / 2 ? -1.0f + step * static_cast<float>(i)
                       : 1.0f - step * static_cast<float>(steps - i - 1);
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

}  // namespace

// Slider values for the adjust chain, already folded on the host exactly
// as vrgdg_tpu_torch/ops/adjust.py folds them into float32 scalars.
struct AdjustParams {
  float offset[3];
  float exposure;
  float contrast;
  float saturation;
  float highlights;
  float shadows;
  float whites;
  float blacks;
  float fade_scale;
  float fade_lift;
  float vignette;
};

namespace {

__device__ __forceinline__ void apply_adjust(float c[3], int flags,
                                             const AdjustParams& s, int y,
                                             int x, int height, int width) {
#pragma unroll
  for (int i = 0; i < 3; ++i) c[i] = clip01(c[i]);
  if (flags & kTempTint) {
#pragma unroll
    for (int i = 0; i < 3; ++i) c[i] = c[i] + s.offset[i];
  }
  if (flags & kExposure) {
#pragma unroll
    for (int i = 0; i < 3; ++i) c[i] = c[i] * s.exposure;
  }
  if (flags & kContrast) {
#pragma unroll
    for (int i = 0; i < 3; ++i) c[i] = (c[i] - 0.5f) * s.contrast + 0.5f;
  }
  if (flags & kSaturation) {
    const float gray = luma(c);
#pragma unroll
    for (int i = 0; i < 3; ++i) c[i] = gray + (c[i] - gray) * s.saturation;
  }
  if (flags & (kHighlights | kShadows | kWhites | kBlacks)) {
    const float l = luma(c);
    if (flags & kHighlights) {
      const float t = clip01((l - 0.55f) / 0.45f) * s.highlights;
#pragma unroll
      for (int i = 0; i < 3; ++i) c[i] = c[i] + t;
    }
    if (flags & kShadows) {
      const float t = clip01((0.45f - l) / 0.45f) * s.shadows;
#pragma unroll
      for (int i = 0; i < 3; ++i) c[i] = c[i] + t;
    }
    if (flags & kWhites) {
      const float t = clip01((l - 0.75f) / 0.25f) * s.whites;
#pragma unroll
      for (int i = 0; i < 3; ++i) c[i] = c[i] + t;
    }
    if (flags & kBlacks) {
      const float t = clip01((0.25f - l) / 0.25f) * s.blacks;
#pragma unroll
      for (int i = 0; i < 3; ++i) c[i] = c[i] + t;
    }
  }
  if (flags & kFade) {
#pragma unroll
    for (int i = 0; i < 3; ++i) c[i] = c[i] * s.fade_scale + s.fade_lift;
  }
  if (flags & kVignette) {
    const float yy = linspace_pm1(y, height);
    const float xx = linspace_pm1(x, width);
    const float distance = sqrtf(xx * xx + yy * yy);
    const float mask =
        1.0f - clip01((distance - 0.35f) / 1.05f) * s.vignette * 0.75f;
#pragma unroll
    for (int i = 0; i < 3; ++i) c[i] = c[i] * mask;
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) c[i] = clip01(c[i]);
}

// Grid (ceil(H*W / 256), B); one thread per pixel.  partials[b, block, k]
// holds the block's float64 sums [L, a, b, L^2, a^2, b^2], reduced in a
// fixed order (warp shuffles, then warp 0 over the warp totals): no
// atomics, so reruns are bit-identical.
__global__ void __launch_bounds__(kPhase1Threads)
grade_phase1_kernel(const float* __restrict__ src,
                    const float* __restrict__ bundle, int lut_size,
                    const float* __restrict__ domain, float blend,
                    float keep, int adjust_flags, AdjustParams adjust,
                    int height, int width, float* __restrict__ lab_out,
                    double* __restrict__ partials) {
  const int frame = blockIdx.y;
  const int pixels = height * width;
  const int p = blockIdx.x * kPhase1Threads + threadIdx.x;
  double sums[6] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
  if (p < pixels) {
    const size_t base = (static_cast<size_t>(frame) * pixels + p) * 3;
    const float source[3] = {src[base], src[base + 1], src[base + 2]};
    const float max_index = static_cast<float>(lut_size - 1);
    float frac[3];
    int lo[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      // (x - dmin) * (1/span): the same expression the plain version uses
      const float coord =
          clip01((source[i] - domain[i]) * domain[3 + i]) * max_index;
      const float floor_coord = floorf(coord);
      frac[i] = coord - floor_coord;
      lo[i] = static_cast<int>(floor_coord);
    }
    const int cell = (lo[2] * lut_size + lo[1]) * lut_size + lo[0];
    const float4* row4 =
        reinterpret_cast<const float4*>(bundle + static_cast<size_t>(cell) * 24);
    float g[24];
#pragma unroll
    for (int q = 0; q < 6; ++q) {
      const float4 v = __ldg(row4 + q);
      g[4 * q] = v.x;
      g[4 * q + 1] = v.y;
      g[4 * q + 2] = v.z;
      g[4 * q + 3] = v.w;
    }
    const float fr = frac[0], fg = frac[1], fb = frac[2];
    float color[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      // corners [c000, c100, c010, c110, c001, c101, c011, c111] (b, g, r)
      const float c00 = g[0 + c] * (1.0f - fb) + g[3 + c] * fb;
      const float c01 = g[6 + c] * (1.0f - fb) + g[9 + c] * fb;
      const float c10 = g[12 + c] * (1.0f - fb) + g[15 + c] * fb;
      const float c11 = g[18 + c] * (1.0f - fb) + g[21 + c] * fb;
      const float c0 = c00 * (1.0f - fg) + c01 * fg;
      const float c1 = c10 * (1.0f - fg) + c11 * fg;
      const float graded = clip01(c0 * (1.0f - fr) + c1 * fr);
      color[c] = source[c] * keep + graded * blend;
    }
    if (adjust_flags & kAdjustOn) {
      apply_adjust(color, adjust_flags, adjust, p / width, p % width, height,
                   width);
    }
    float lab[3];
    rgb_to_lab(color, lab);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      lab_out[base + c] = lab[c];
      const double v = static_cast<double>(lab[c]);
      sums[c] = v;
      sums[3 + c] = v * v;
    }
  }

  __shared__ double warp_sums[kPhase1Threads / 32][6];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    double v = sums[k];
#pragma unroll
    for (int offset = 16; offset > 0; offset >>= 1) {
      v += __shfl_down_sync(0xFFFFFFFFu, v, offset);
    }
    if (lane == 0) warp_sums[warp][k] = v;
  }
  __syncthreads();
  if (threadIdx.x < 6) {
    double total = 0.0;
#pragma unroll
    for (int w = 0; w < kPhase1Threads / 32; ++w) {
      total += warp_sums[w][threadIdx.x];
    }
    partials[(static_cast<size_t>(frame) * gridDim.x + blockIdx.x) * 6 +
             threadIdx.x] = total;
  }
}

// Grid (ceil(W/32), ceil(H/8), B), block (32, 8).  Each block converts its
// halo tile's LAB to clipped RGB once, into shared memory; out-of-frame
// halo entries hold 0 (the zero border).  coeff[b] = [A_L, A_a, A_b, B_L,
// B_a, B_b] of the affine transfer lab' = A * lab + B.
__global__ void __launch_bounds__(kTileW * kTileH)
grade_phase2_kernel(const float* __restrict__ lab,
                    const float* __restrict__ coeff, int height, int width,
                    float sharpen, float grain, float mix, float keep_mix,
                    uint32_t seed_base, float* __restrict__ out) {
  __shared__ float tile[kTileH + 2][kTileW + 2][3];
  const int frame = blockIdx.z;
  const int x0 = blockIdx.x * kTileW;
  const int y0 = blockIdx.y * kTileH;
  const size_t frame_base = static_cast<size_t>(frame) * height * width;
  const float a[3] = {coeff[frame * 6], coeff[frame * 6 + 1],
                      coeff[frame * 6 + 2]};
  const float b[3] = {coeff[frame * 6 + 3], coeff[frame * 6 + 4],
                      coeff[frame * 6 + 5]};

  const int tid = threadIdx.y * kTileW + threadIdx.x;
  for (int i = tid; i < (kTileH + 2) * (kTileW + 2);
       i += kTileW * kTileH) {
    const int ty = i / (kTileW + 2);
    const int tx = i % (kTileW + 2);
    const int y = y0 + ty - 1;
    const int x = x0 + tx - 1;
    float rgb[3] = {0.0f, 0.0f, 0.0f};
    if (y >= 0 && y < height && x >= 0 && x < width) {
      const size_t base = (frame_base + static_cast<size_t>(y) * width + x) * 3;
      float v[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) v[c] = lab[base + c] * a[c] + b[c];
      lab_to_rgb(v, rgb);
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) tile[ty][tx][c] = rgb[c];
  }
  __syncthreads();

  const int x = x0 + threadIdx.x;
  const int y = y0 + threadIdx.y;
  if (x >= width || y >= height) return;
  const int ty = threadIdx.y + 1;
  const int tx = threadIdx.x + 1;
  float sharp[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    // the nine taps summed row by row, left to right, as ops/sharpen.py
    // sums them
    float sum = 0.0f;
#pragma unroll
    for (int dy = -1; dy <= 1; ++dy) {
#pragma unroll
      for (int dx = -1; dx <= 1; ++dx) sum = sum + tile[ty + dy][tx + dx][c];
    }
    const float blur = sum / 9.0f;
    const float center = tile[ty][tx][c];
    sharp[c] = clip01(center + sharpen * (center - blur));
  }

  const size_t base = (frame_base + static_cast<size_t>(y) * width + x) * 3;
  if (grain > 0.0f) {
    const uint32_t key = (seed_base + static_cast<uint32_t>(frame)) & 0x7FFFFFFFu;
    const uint32_t counter = static_cast<uint32_t>(y) * width + x;
    const uint4 bits = philox4x32_10(make_uint4(counter, 0u, 0u, 0u), key, 0u);
    const float r0 = sqrtf(-2.0f * logf(uniform01(bits.x)));
    const float t0 = kTwoPi * uniform01(bits.y);
    const float r1 = sqrtf(-2.0f * logf(uniform01(bits.z)));
    const float t1 = kTwoPi * uniform01(bits.w);
    const float noise[3] = {r0 * cosf(t0), r0 * sinf(t0), r1 * cosf(t1)};
    const float scale[3] = {2.0f, 1.0f, 3.0f};
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float g = mix * (noise[c] * scale[c]) + keep_mix * noise[1];
      out[base + c] = clip01(sharp[c] + g * grain);
    }
  } else {
#pragma unroll
    for (int c = 0; c < 3; ++c) out[base + c] = sharp[c];
  }
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 = launched).
// Each launcher selects ``device`` first: this library links its own CUDA
// runtime, whose current device is not PyTorch's.
int vrgdg_grade_phase1(int device, const float* src, const float* bundle,
                       int lut_size, const float* domain, float blend,
                       float keep, int adjust_flags, AdjustParams adjust,
                       int batch, int height, int width, float* lab,
                       double* partials, void* stream) {
  const cudaError_t selected = cudaSetDevice(device);
  if (selected != cudaSuccess) return static_cast<int>(selected);
  const int pixels = height * width;
  const dim3 grid((pixels + kPhase1Threads - 1) / kPhase1Threads, batch);
  grade_phase1_kernel<<<grid, kPhase1Threads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      src, bundle, lut_size, domain, blend, keep, adjust_flags, adjust,
      height, width, lab, partials);
  return static_cast<int>(cudaGetLastError());
}

int vrgdg_grade_phase2(int device, const float* lab, const float* coeff,
                       int batch, int height, int width, float sharpen,
                       float grain, float mix, float keep_mix,
                       unsigned int seed_base, float* out, void* stream) {
  const cudaError_t selected = cudaSetDevice(device);
  if (selected != cudaSuccess) return static_cast<int>(selected);
  const dim3 block(kTileW, kTileH);
  const dim3 grid((width + kTileW - 1) / kTileW,
                  (height + kTileH - 1) / kTileH, batch);
  grade_phase2_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      lab, coeff, height, width, sharpen, grain, mix, keep_mix, seed_base,
      out);
  return static_cast<int>(cudaGetLastError());
}

int vrgdg_phase1_block_size() { return kPhase1Threads; }

const char* vrgdg_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
