// The fused grade stack's Hopper kernels (sm_90a), with a plain C interface
// loaded through ctypes by vrgdg_tpu_torch/kernels/grade_cuda.py.  Each
// phase is one kernel template over two memory layouts:
//
// - BHWC (the flat layout):
//   grade_phase1 replaces vrgdg_tpu/kernels/grade_pallas.py::
//   _phase1_rowmajor_kernel: per pixel, the LUT trilerp read straight from
//   the (N^3, 24) corner bundle, the strength blend, the elementwise adjust
//   sliders, RGB -> CIELAB, and per-block float64 partial sums of L, a, b
//   and their squares for the colour-match statistics.
//   grade_phase2 replaces grade_pallas.py::_phase2_flat_kernel: the
//   per-frame affine LAB transfer, LAB -> RGB, the 3x3 zero-border box
//   unsharp and the Philox4x32-10 film grain.
// - channel planes (the "rowmajor" and "plane" layouts):
//   grade_phase1_planes replaces grade_pallas.py::_phase1_kernel: the same
//   math without adjust, fed by corner-major planes (24, B, H*W) that the
//   wrapper gathers with torch indexing, as XLA gathers them for the TPU.
//   grade_phase2_planes replaces grade_pallas.py::_phase2_kernel: phase 2
//   over (B, 3, H, W) LAB planes in, RGB planes out.
//
// What bounds them on an H100: phase 1 moves 24 bytes of HBM per pixel
// (12 in, 12 out) and gathers one 96-byte bundle row per pixel, which stays
// in the 50 MB L2 (3.4 MB for N=33); the planes variant instead streams the
// 96 gathered bytes per pixel from HBM (coalesced, one plane per corner
// value), so it moves 120 bytes per pixel.  Its arithmetic (one powf per
// channel, one cbrtf per channel) is small beside that.  Phase 2 moves the
// same 24 bytes per pixel in either layout but is arithmetic-heavy: LAB ->
// RGB costs three powf per pixel, so each block converts its (8+2) x (32+2)
// halo tile once into shared memory instead of nine times per pixel, and
// the grain costs one Philox call (10 rounds) plus two logf/sqrtf and three
// sinf/cosf per pixel.  The planes layouts read and write each channel as
// its own coalesced row, the BHWC ones three interleaved floats per thread.
//
// Built without --use_fast_math; nvcc's default FMA contraction is the
// remaining last-ulp difference from the plain versions.

#include "common.h"

namespace {

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

// torch.linspace(-1, 1, steps)[i] as PyTorch computes it.
__device__ __forceinline__ float linspace_pm1(int i, int steps) {
  if (steps == 1) return -1.0f;
  const float step = 2.0f / static_cast<float>(steps - 1);
  return i < steps / 2 ? -1.0f + step * static_cast<float>(i)
                       : 1.0f - step * static_cast<float>(steps - i - 1);
}

// Offset of channel c of pixel (y, x) of frame b: BHWC interleaves the
// channels, the planes layout keeps (B, 3, H, W).
template <bool kPlanes>
__device__ __forceinline__ size_t pixel_at(int b, int c, size_t pixel,
                                           size_t pixels) {
  return kPlanes ? (static_cast<size_t>(b) * 3 + c) * pixels + pixel
                 : (static_cast<size_t>(b) * pixels + pixel) * 3 + c;
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
// atomics, so reruns are bit-identical.  Both layouts write the same
// partials rows, so the stats barrier is shared.
//
// BHWC: src (B, H, W, 3); table the (N^3, 24) bundle, read one 96-byte row
// per pixel with six float4 loads; lab (B, H, W, 3).
// Planes: src (3, B, H*W); table the gathered corner planes (24, B, H*W),
// plane 3j + c holding channel c of corner j; lab (B, 3, H*W).  No adjust.
template <bool kPlanes>
__global__ void __launch_bounds__(kPhase1Threads)
grade_phase1_kernel(const float* __restrict__ src,
                    const float* __restrict__ table, int lut_size,
                    const float* __restrict__ domain, float blend,
                    float keep, int adjust_flags, AdjustParams adjust,
                    int batch, int height, int width,
                    float* __restrict__ lab_out,
                    double* __restrict__ partials) {
  const int frame = blockIdx.y;
  const size_t pixels = static_cast<size_t>(height) * width;
  const int p = blockIdx.x * kPhase1Threads + threadIdx.x;
  double sums[6] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
  if (p < pixels) {
    float source[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      source[c] = kPlanes
          ? src[(static_cast<size_t>(c) * batch + frame) * pixels + p]
          : src[pixel_at<false>(frame, c, p, pixels)];
    }
    const float max_index = static_cast<float>(lut_size - 1);
    float frac[3];
    int lo[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      // (x - dmin) * (1/span): the same expression the plain version and
      // the planes wrapper's gather use, so frac and cell always agree
      const float coord =
          clip01((source[i] - domain[i]) * domain[3 + i]) * max_index;
      const float floor_coord = floorf(coord);
      frac[i] = coord - floor_coord;
      lo[i] = static_cast<int>(floor_coord);
    }
    float g[24];
    if constexpr (kPlanes) {
#pragma unroll
      for (int k = 0; k < 24; ++k) {
        g[k] = __ldg(table + (static_cast<size_t>(k) * batch + frame) *
                                 pixels + p);
      }
    } else {
      const int cell = (lo[2] * lut_size + lo[1]) * lut_size + lo[0];
      const float4* row4 = reinterpret_cast<const float4*>(
          table + static_cast<size_t>(cell) * 24);
#pragma unroll
      for (int q = 0; q < 6; ++q) {
        const float4 v = __ldg(row4 + q);
        g[4 * q] = v.x;
        g[4 * q + 1] = v.y;
        g[4 * q + 2] = v.z;
        g[4 * q + 3] = v.w;
      }
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
    if (!kPlanes && (adjust_flags & kAdjustOn)) {
      apply_adjust(color, adjust_flags, adjust, p / width, p % width, height,
                   width);
    }
    float lab[3];
    rgb_to_lab(color, lab);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      lab_out[pixel_at<kPlanes>(frame, c, p, pixels)] = lab[c];
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
// B_a, B_b] of the affine transfer lab' = A * lab + B.  lab and out are
// BHWC, or (B, 3, H, W) planes when kPlanes; the tile, the 9-tap order and
// the grain are the same in both, so every layout draws identical grain.
template <bool kPlanes>
__global__ void __launch_bounds__(kTileW * kTileH)
grade_phase2_kernel(const float* __restrict__ lab,
                    const float* __restrict__ coeff, int height, int width,
                    float sharpen, float grain, float mix, float keep_mix,
                    uint32_t seed_base, float* __restrict__ out) {
  __shared__ float tile[kTileH + 2][kTileW + 2][3];
  const int frame = blockIdx.z;
  const int x0 = blockIdx.x * kTileW;
  const int y0 = blockIdx.y * kTileH;
  const size_t pixels = static_cast<size_t>(height) * width;
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
      const size_t pixel = static_cast<size_t>(y) * width + x;
      float v[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        v[c] = lab[pixel_at<kPlanes>(frame, c, pixel, pixels)] * a[c] + b[c];
      }
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

  const size_t pixel = static_cast<size_t>(y) * width + x;
  if (grain > 0.0f) {
    const uint32_t key = (seed_base + static_cast<uint32_t>(frame)) & kSeedMask;
    float g[3];
    grain_field(key, static_cast<uint32_t>(pixel), mix, keep_mix, g);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      out[pixel_at<kPlanes>(frame, c, pixel, pixels)] =
          clip01(sharp[c] + g[c] * grain);
    }
  } else {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      out[pixel_at<kPlanes>(frame, c, pixel, pixels)] = sharp[c];
    }
  }
}

template <bool kPlanes>
int launch_phase1(int device, const float* src, const float* table,
                  int lut_size, const float* domain, float blend, float keep,
                  int adjust_flags, AdjustParams adjust, int batch,
                  int height, int width, float* lab, double* partials,
                  void* stream) {
  VRGDG_SELECT_DEVICE(device);
  const long long pixels = static_cast<long long>(height) * width;
  const dim3 grid(
      static_cast<unsigned>((pixels + kPhase1Threads - 1) / kPhase1Threads),
      batch);
  grade_phase1_kernel<kPlanes><<<grid, kPhase1Threads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      src, table, lut_size, domain, blend, keep, adjust_flags, adjust, batch,
      height, width, lab, partials);
  return static_cast<int>(cudaGetLastError());
}

template <bool kPlanes>
int launch_phase2(int device, const float* lab, const float* coeff,
                  int batch, int height, int width, float sharpen,
                  float grain, float mix, float keep_mix,
                  unsigned int seed_base, float* out, void* stream) {
  VRGDG_SELECT_DEVICE(device);
  const dim3 block(kTileW, kTileH);
  const dim3 grid((width + kTileW - 1) / kTileW,
                  (height + kTileH - 1) / kTileH, batch);
  grade_phase2_kernel<kPlanes><<<grid, block, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      lab, coeff, height, width, sharpen, grain, mix, keep_mix, seed_base,
      out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Each launcher returns cudaGetLastError() after the launch (0 = launched).

int vrgdg_grade_phase1(int device, const float* src, const float* bundle,
                       int lut_size, const float* domain, float blend,
                       float keep, int adjust_flags, AdjustParams adjust,
                       int batch, int height, int width, float* lab,
                       double* partials, void* stream) {
  return launch_phase1<false>(device, src, bundle, lut_size, domain, blend,
                              keep, adjust_flags, adjust, batch, height,
                              width, lab, partials, stream);
}

int vrgdg_grade_phase1_planes(int device, const float* src_planes,
                              const float* corner_planes, int lut_size,
                              const float* domain, float blend, float keep,
                              int batch, int height, int width,
                              float* lab_planes, double* partials,
                              void* stream) {
  return launch_phase1<true>(device, src_planes, corner_planes, lut_size,
                             domain, blend, keep, 0, AdjustParams{}, batch,
                             height, width, lab_planes, partials, stream);
}

int vrgdg_grade_phase2(int device, const float* lab, const float* coeff,
                       int batch, int height, int width, float sharpen,
                       float grain, float mix, float keep_mix,
                       unsigned int seed_base, float* out, void* stream) {
  return launch_phase2<false>(device, lab, coeff, batch, height, width,
                              sharpen, grain, mix, keep_mix, seed_base, out,
                              stream);
}

int vrgdg_grade_phase2_planes(int device, const float* lab_planes,
                              const float* coeff, int batch, int height,
                              int width, float sharpen, float grain,
                              float mix, float keep_mix,
                              unsigned int seed_base, float* out_planes,
                              void* stream) {
  return launch_phase2<true>(device, lab_planes, coeff, batch, height, width,
                             sharpen, grain, mix, keep_mix, seed_base,
                             out_planes, stream);
}

int vrgdg_phase1_block_size() { return kPhase1Threads; }

}  // extern "C"
