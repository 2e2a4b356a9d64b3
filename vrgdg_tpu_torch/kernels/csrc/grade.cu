// The fused grade stack's Hopper kernels (sm_90a), with a plain C interface
// loaded through ctypes by vrgdg_tpu_torch/kernels/grade_cuda.py.
//
// - grade_phase1 replaces vrgdg_tpu/kernels/grade_pallas.py::
//   _phase1_rowmajor_kernel: per pixel of a BHWC batch, the LUT trilerp
//   read straight from the (N^3, 24) corner bundle, the strength blend,
//   the elementwise adjust sliders, RGB -> CIELAB, and per-chunk float64
//   sums of L, a, b and their squares for the colour-match statistics.
// - grade_phase2 replaces grade_pallas.py::_phase2_flat_kernel and
//   grade_phase2_planes replaces ::_phase2_kernel: the per-frame affine LAB
//   transfer, LAB -> RGB, the 3x3 zero-border box unsharp and the
//   Philox4x32-10 film grain.  Phase 2 has one body for both layouts,
//   grade_phase2_kernel<Layout>: BHWC in and out for grade_phase2, (B, 3,
//   H, W) channel planes for grade_phase2_planes (the "rowmajor" and
//   "plane" layouts, off the main path); the two differ only in where
//   channel c of a pixel lies, so they give the same bits, permuted.
// - grade_phase1_planes (replaces grade_pallas.py::_phase1_kernel) runs
//   phase 1's math without adjust for the "plane" layout, fed by
//   corner-major planes (24, B, H*W) that the wrapper gathers with torch
//   indexing.  It keeps the first port's one-pixel-per-thread form and
//   writes grade_phase1's per-chunk partials rows.  All the kernels share
//   common.h's colour conversions, so every layout computes LAB and RGB
//   alike.
//
// What bounds the two main-path kernels on an H100.  Each moves 24 bytes
// of HBM a pixel (12 in, 12 out): 0.12 ms for a 4K x 2 batch at 3.35 TB/s,
// the larger term of their bound.  Their floating-point work a pixel
// (chip_smoke.py prices it from the SASS of probes of this file's
// per-pixel code) is below that at the card's FP32 and MUFU rates.  But it
// runs on dependent chains (the powers, cbrtf, Philox, Box-Muller), and
// phase 1 gathers a 96-byte bundle row a pixel from L2 (the 33^3 bundle,
// 3.4 MB, stays there), four times its HBM bytes.  What decides their time
// is latency: how many warps an SM holds to cover the gathers and the
// chains.  No product is larger than 3x3, so the tensor cores have no role.
//
// The design, chosen by timing alternatives on the card:
// - grade_phase1: a block owns one fixed chunk of kChunkPixels pixels of
//   one frame (the split depends on H x W alone, so reruns and batch
//   splits give the same partials bits); its kPhase1Threads threads walk
//   the chunk one pixel at a time at 64 registers, 32 warps an SM, loading
//   each next pixel's src one step ahead of its math, keep the six float64
//   sums in registers over the whole chunk and reduce them once, in a fixed
//   order, with no atomics (the first port reduced every 256 pixels).
//   Loads and stores are per pixel, so a frame's 16-byte (mis)alignment
//   does not matter.
// - phase 2 (both layouts): a 32 x 64 output tile a block (34 x 66 halo:
//   1.10 LAB -> RGB conversions per output pixel; the first port's 32 x 8
//   tile paid 1.33), the RGB halo in shared memory as three channel
//   planes, and each thread filtering an 8-row column strip with a 3 x 3
//   window per channel sliding down the strip in registers, the nine taps
//   summed row by row, left to right, as ops/sharpen.py sums them.
//   Out-of-frame halo entries are RGB 0, the zero border.  The grain is
//   common.h's grain_field, unchanged.  TMA is not used for the halo: a
//   tensor map needs a row pitch (3W floats in BHWC, W in planes) that is
//   a multiple of 16 bytes, which frames of a width not divisible by 4 do
//   not have.  The planes instantiation holds its stores' plane offsets
//   (64-bit multiples of H x W) in registers: 55 against the BHWC one's 48,
//   so 32 warps an SM, not 40.  __launch_bounds__(256, 5) would cap it at
//   48 but spills.  Its extra time over the BHWC one is on the write side:
//   kernel_variants/grade_variants.py times the same body with LAB planes
//   in and BHWC out about as fast as the BHWC kernel, and with BHWC in and
//   planes out about as slow as the planes one.
// - The asynchronous-copy designs lost to these on the card.  For phase 1:
//   src streamed through a ring of shared-memory stages filled by
//   cp.async.bulk with an mbarrier, 1, 2 or 4 pixels' gathers in flight a
//   thread, LAB out as float4 rows; for phase 2: a persistent loop over
//   64 x 32 tiles with the next halo loaded by cp.async into a second
//   buffer, 4 pixels a thread along x, float4 output rows.  The registers
//   that hold several bundle rows, and the shared memory of two halos, cost
//   more warps than the overlap saves.  kernel_variants/grade_variants.cu
//   keeps them, built on this file, and kernel_variants/grade_variants.py
//   times them beside these kernels.
//
// Built without --use_fast_math; nvcc's FMA contraction and common.h's
// rewritten powers and divisions are the last-ulp differences from the
// plain versions.

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

// grade_phase1: pixels a block owns (one partials row) and its threads.
constexpr int kChunkPixels = 8192;
constexpr int kPhase1Threads = 512;

// phase 2: output tile, threads a column, rows a thread.
constexpr int kTileW = 32;
constexpr int kStripThreads = 8;
constexpr int kStripRows = 8;
constexpr int kTileH = kStripThreads * kStripRows;

// grade_phase1_planes: threads a block, one pixel per thread
constexpr int kPlanesThreads = 256;

constexpr float kInvNine = 1.0f / 9.0f;

// torch.linspace(-1, 1, steps)[i] as PyTorch computes it.
__device__ __forceinline__ float linspace_pm1(int i, int steps) {
  if (steps == 1) return -1.0f;
  const float step = 2.0f / static_cast<float>(steps - 1);
  return i < steps / 2 ? -1.0f + step * static_cast<float>(i)
                       : 1.0f - step * static_cast<float>(steps - i - 1);
}

// The trilerp of one pixel from its bundle row ``g`` (corners [c000, c100,
// c010, c110, c001, c101, c011, c111], each (b, g, r)), blended with the
// source by ``keep`` / ``blend``.
__device__ __forceinline__ void trilerp_blend(const float g[24],
                                              const float frac[3],
                                              const float source[3],
                                              float blend, float keep,
                                              float color[3]) {
  const float fr = frac[0], fg = frac[1], fb = frac[2];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float c00 = g[0 + c] * (1.0f - fb) + g[3 + c] * fb;
    const float c01 = g[6 + c] * (1.0f - fb) + g[9 + c] * fb;
    const float c10 = g[12 + c] * (1.0f - fb) + g[15 + c] * fb;
    const float c11 = g[18 + c] * (1.0f - fb) + g[21 + c] * fb;
    const float c0 = c00 * (1.0f - fg) + c01 * fg;
    const float c1 = c10 * (1.0f - fg) + c11 * fg;
    const float graded = clip01(c0 * (1.0f - fr) + c1 * fr);
    color[c] = source[c] * keep + graded * blend;
  }
}

// Bundle row and lattice fractions of one pixel: (x - dmin) * (1/span), the
// expression the plain version and the planes wrapper's gather use, so frac
// and cell always agree with them.
__device__ __forceinline__ int lattice_cell(const float source[3],
                                            const float dmin[3],
                                            const float inv_span[3],
                                            int lut_size, float frac[3]) {
  const float max_index = static_cast<float>(lut_size - 1);
  int lo[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float coord = clip01((source[i] - dmin[i]) * inv_span[i]) * max_index;
    const float floor_coord = floorf(coord);
    frac[i] = coord - floor_coord;
    lo[i] = static_cast<int>(floor_coord);
  }
  return (lo[2] * lut_size + lo[1]) * lut_size + lo[0];
}

// Bundle row ``cell`` (96 bytes, 16-byte aligned) as six float4 loads.
__device__ __forceinline__ void gather_row(const float* __restrict__ table,
                                           int cell, float g[24]) {
  const float4* row4 =
      reinterpret_cast<const float4*>(table + static_cast<size_t>(cell) * 24);
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    const float4 v = __ldg(row4 + k);
    g[4 * k] = v.x;
    g[4 * k + 1] = v.y;
    g[4 * k + 2] = v.z;
    g[4 * k + 3] = v.w;
  }
}

// Block-wide fixed-order reduction of six float64 sums; thread k < 6 writes
// total k to ``row[k]``.
template <int kThreads>
__device__ __forceinline__ void reduce_sums(const double sums[6],
                                            double* __restrict__ row) {
  __shared__ double warp_sums[kThreads / 32][6];
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
    for (int w = 0; w < kThreads / 32; ++w) total += warp_sums[w][threadIdx.x];
    row[threadIdx.x] = total;
  }
}

// The (y, x) of pixel p of a frame of the given width: a float estimate
// from 1/width, corrected by one.
__device__ __forceinline__ void pixel_yx(int p, int width, float inv_width,
                                         int& y, int& x) {
  y = static_cast<int>(static_cast<float>(p) * inv_width);
  x = p - y * width;
  if (x < 0) {
    --y;
    x += width;
  } else if (x >= width) {
    ++y;
    x -= width;
  }
}

// One pixel's LAB into the six float64 sums [L, a, b, L^2, a^2, b^2].
__device__ __forceinline__ void add_sums(const float lab[3], double sums[6]) {
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const double v = static_cast<double>(lab[c]);
    sums[c] += v;
    sums[3 + c] += v * v;
  }
}

// The 3x3 box unsharp of one channel from its window w[row][column], the
// nine taps summed row by row, left to right, as ops/sharpen.py sums them.
__device__ __forceinline__ float unsharp3x3(const float w[3][3],
                                            float sharpen) {
  float sum = w[0][0];
  sum = sum + w[0][1];
  sum = sum + w[0][2];
  sum = sum + w[1][0];
  sum = sum + w[1][1];
  sum = sum + w[1][2];
  sum = sum + w[2][0];
  sum = sum + w[2][1];
  sum = sum + w[2][2];
  const float blur = sum * kInvNine;
  return clip01(w[1][1] + sharpen * (w[1][1] - blur));
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

// ---------------------------------------------------------------------------
// grade_phase1
// ---------------------------------------------------------------------------

// Grid (ceil(H*W / kChunkPixels), B), kPhase1Threads threads, each taking
// pixels tid, tid + kPhase1Threads, ... of the block's chunk.  src and lab
// are (B, H, W, 3); partials[b, chunk, k] holds the chunk's float64 sums
// [L, a, b, L^2, a^2, b^2].
__global__ void __launch_bounds__(kPhase1Threads, 2)
grade_phase1_kernel(const float* __restrict__ src,
                    const float* __restrict__ table, int lut_size,
                    const float* __restrict__ domain, float blend,
                    float keep, int adjust_flags, AdjustParams adjust,
                    int height, int width, float* __restrict__ lab_out,
                    double* __restrict__ partials) {
  const int frame = blockIdx.y;
  const long long pixels = static_cast<long long>(height) * width;
  const long long first = static_cast<long long>(blockIdx.x) * kChunkPixels;
  const int count = static_cast<int>(
      pixels - first < kChunkPixels ? pixels - first : kChunkPixels);
  const size_t offset = (static_cast<size_t>(frame) * pixels + first) * 3;
  const float* chunk_src = src + offset;
  float* chunk_lab = lab_out + offset;
  const float dmin[3] = {domain[0], domain[1], domain[2]};
  const float inv_span[3] = {domain[3], domain[4], domain[5]};
  const bool adjust_on = adjust_flags & kAdjustOn;
  const float inv_width = 1.0f / static_cast<float>(width);

  double sums[6] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
  // src is loaded one pixel ahead, so its HBM latency overlaps the
  // current pixel's gather and math
  float ahead[3] = {0.0f, 0.0f, 0.0f};
  auto load_src = [&](int q) {
    if (q < count) {
#pragma unroll
      for (int c = 0; c < 3; ++c) ahead[c] = __ldg(chunk_src + 3 * q + c);
    }
  };
  load_src(threadIdx.x);
  for (int q = threadIdx.x; q < count; q += kPhase1Threads) {
    const float source[3] = {ahead[0], ahead[1], ahead[2]};
    load_src(q + kPhase1Threads);
    float frac[3];
    const int cell = lattice_cell(source, dmin, inv_span, lut_size, frac);
    float g[24];
    gather_row(table, cell, g);
    float color[3];
    trilerp_blend(g, frac, source, blend, keep, color);
    if (adjust_on) {
      int y, x;
      pixel_yx(static_cast<int>(first) + q, width, inv_width, y, x);
      apply_adjust(color, adjust_flags, adjust, y, x, height, width);
    }
    float lab[3];
    rgb_to_lab(color, lab);
#pragma unroll
    for (int c = 0; c < 3; ++c) chunk_lab[3 * q + c] = lab[c];
    add_sums(lab, sums);
  }
  reduce_sums<kPhase1Threads>(
      sums, partials + (static_cast<size_t>(frame) * gridDim.x + blockIdx.x) *
                           6);
}

// ---------------------------------------------------------------------------
// phase 2: grade_phase2 (BHWC) and grade_phase2_planes (channel planes)
// ---------------------------------------------------------------------------

// Phase 2's addressing policies: where the LAB read (lab) and the RGB write
// (rgb) of channel c of pixel p lie, counted from the first float of the
// frame.  A frame holds 3 * pixels floats in both layouts, so frame f
// starts at f * 3 * pixels: BHWC puts channel c of pixel p at (f * pixels
// + p) * 3 + c, planes at (f * 3 + c) * pixels + p.
struct BhwcLayout {
  __device__ __forceinline__ static size_t lab(size_t pixel, int c,
                                               size_t /*pixels*/) {
    return pixel * 3 + c;
  }
  __device__ __forceinline__ static size_t rgb(size_t pixel, int c,
                                               size_t pixels) {
    return lab(pixel, c, pixels);
  }
};
struct PlanesLayout {
  __device__ __forceinline__ static size_t lab(size_t pixel, int c,
                                               size_t pixels) {
    return static_cast<size_t>(c) * pixels + pixel;
  }
  __device__ __forceinline__ static size_t rgb(size_t pixel, int c,
                                               size_t pixels) {
    return lab(pixel, c, pixels);
  }
};

// Grid (ceil(W / kTileW), ceil(H / kTileH), B), block (kTileW,
// kStripThreads).  The block converts its tile's (kTileH + 2) x (kTileW +
// 2) halo from LAB to clipped RGB once, into three shared channel planes
// (out-of-frame entries RGB 0, the zero border); thread (tx, ty) then
// filters column x0 + tx, rows y0 + kStripRows * ty .. + kStripRows - 1,
// sliding a 3 x 3 window per channel down the strip.  coeff[b] = [A_L,
// A_a, A_b, B_L, B_a, B_b] of the affine transfer lab' = A * lab + B; lab
// and out are (B, H, W, 3) or (B, 3, H, W), as Layout says.  Loads and
// stores are per pixel and channel, so no width or frame start needs an
// alignment.
template <typename Layout>
__global__ void __launch_bounds__(kTileW * kStripThreads)
grade_phase2_kernel(const float* __restrict__ lab,
                    const float* __restrict__ coeff, int height, int width,
                    float sharpen, float grain, float mix, float keep_mix,
                    uint32_t seed_base, float* __restrict__ out) {
  __shared__ float rgb_tile[3][kTileH + 2][kTileW + 2];
  const int frame = blockIdx.z;
  const int x0 = blockIdx.x * kTileW;
  const int y0 = blockIdx.y * kTileH;
  const size_t pixels = static_cast<size_t>(height) * width;
  const float* frame_lab = lab + static_cast<size_t>(frame) * pixels * 3;
  float* frame_out = out + static_cast<size_t>(frame) * pixels * 3;
  const float a[3] = {coeff[frame * 6], coeff[frame * 6 + 1],
                      coeff[frame * 6 + 2]};
  const float b[3] = {coeff[frame * 6 + 3], coeff[frame * 6 + 4],
                      coeff[frame * 6 + 5]};

  const int tid = threadIdx.y * kTileW + threadIdx.x;
  for (int i = tid; i < (kTileH + 2) * (kTileW + 2);
       i += kTileW * kStripThreads) {
    const int hy = i / (kTileW + 2);
    const int hx = i - hy * (kTileW + 2);
    const int y = y0 + hy - 1;
    const int x = x0 + hx - 1;
    float rgb[3] = {0.0f, 0.0f, 0.0f};
    if (y >= 0 && y < height && x >= 0 && x < width) {
      const size_t pixel = static_cast<size_t>(y) * width + x;
      float v[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        v[c] = frame_lab[Layout::lab(pixel, c, pixels)] * a[c] + b[c];
      }
      lab_to_rgb(v, rgb);
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) rgb_tile[c][hy][hx] = rgb[c];
  }
  __syncthreads();

  const int x = x0 + threadIdx.x;
  if (x >= width) return;
  const int hx = threadIdx.x + 1;
  const int top = threadIdx.y * kStripRows;  // halo row above the strip
  const uint32_t key = (seed_base + static_cast<uint32_t>(frame)) & kSeedMask;
  // w[c][r][d]: channel c, halo rows top + row + r, columns hx - 1 + d
  float w[3][3][3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
#pragma unroll
      for (int d = 0; d < 3; ++d) w[c][r][d] = rgb_tile[c][top + r][hx - 1 + d];
    }
  }
#pragma unroll
  for (int row = 0; row < kStripRows; ++row) {
    float sharp[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        w[c][2][d] = rgb_tile[c][top + row + 2][hx - 1 + d];
      }
      sharp[c] = unsharp3x3(w[c], sharpen);
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        w[c][0][d] = w[c][1][d];
        w[c][1][d] = w[c][2][d];
      }
    }
    const int y = y0 + top + row;
    if (y >= height) break;
    const size_t pixel = static_cast<size_t>(y) * width + x;
    if (grain > 0.0f) {
      float g[3];
      grain_field(key, static_cast<uint32_t>(pixel), mix, keep_mix, g);
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        frame_out[Layout::rgb(pixel, c, pixels)] =
            clip01(sharp[c] + g[c] * grain);
      }
    } else {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        frame_out[Layout::rgb(pixel, c, pixels)] = sharp[c];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// grade_phase1_planes ("plane" layout)
// ---------------------------------------------------------------------------

// Grid (ceil(H*W / kChunkPixels), B), kPlanesThreads threads looping over
// the block's chunk one pixel a thread: src (3, B, H*W); table the gathered
// corner planes (24, B, H*W), plane 3j + c holding channel c of corner j;
// lab (B, 3, H*W); partials as grade_phase1's.  No adjust.
__global__ void __launch_bounds__(kPlanesThreads)
grade_phase1_planes_kernel(const float* __restrict__ src,
                           const float* __restrict__ table, int lut_size,
                           const float* __restrict__ domain, float blend,
                           float keep, int batch, int height, int width,
                           float* __restrict__ lab_out,
                           double* __restrict__ partials) {
  const int frame = blockIdx.y;
  const size_t pixels = static_cast<size_t>(height) * width;
  const size_t first = static_cast<size_t>(blockIdx.x) * kChunkPixels;
  const size_t end =
      first + kChunkPixels < pixels ? first + kChunkPixels : pixels;
  const float dmin[3] = {domain[0], domain[1], domain[2]};
  const float inv_span[3] = {domain[3], domain[4], domain[5]};
  double sums[6] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
  for (size_t p = first + threadIdx.x; p < end; p += kPlanesThreads) {
    float source[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      source[c] = src[(static_cast<size_t>(c) * batch + frame) * pixels + p];
    }
    float frac[3];
    lattice_cell(source, dmin, inv_span, lut_size, frac);
    float g[24];
#pragma unroll
    for (int k = 0; k < 24; ++k) {
      g[k] = __ldg(table + (static_cast<size_t>(k) * batch + frame) * pixels +
                   p);
    }
    float color[3];
    trilerp_blend(g, frac, source, blend, keep, color);
    float lab[3];
    rgb_to_lab(color, lab);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      lab_out[(static_cast<size_t>(frame) * 3 + c) * pixels + p] = lab[c];
    }
    add_sums(lab, sums);
  }
  reduce_sums<kPlanesThreads>(
      sums, partials + (static_cast<size_t>(frame) * gridDim.x + blockIdx.x) *
                           6);
}

unsigned chunks_of(int height, int width) {
  const long long pixels = static_cast<long long>(height) * width;
  return static_cast<unsigned>((pixels + kChunkPixels - 1) / kChunkPixels);
}

template <typename Layout>
int launch_phase2(int device, const float* lab, const float* coeff,
                  int batch, int height, int width, float sharpen,
                  float grain, float mix, float keep_mix,
                  unsigned int seed_base, float* out, void* stream) {
  VRGDG_SELECT_DEVICE(device);
  const dim3 block(kTileW, kStripThreads);
  const dim3 grid((width + kTileW - 1) / kTileW,
                  (height + kTileH - 1) / kTileH, batch);
  grade_phase2_kernel<Layout><<<grid, block, 0,
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
  VRGDG_SELECT_DEVICE(device);
  const dim3 grid(chunks_of(height, width), batch);
  grade_phase1_kernel<<<grid, kPhase1Threads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      src, bundle, lut_size, domain, blend, keep, adjust_flags, adjust,
      height, width, lab, partials);
  return static_cast<int>(cudaGetLastError());
}

int vrgdg_grade_phase1_planes(int device, const float* src_planes,
                              const float* corner_planes, int lut_size,
                              const float* domain, float blend, float keep,
                              int batch, int height, int width,
                              float* lab_planes, double* partials,
                              void* stream) {
  VRGDG_SELECT_DEVICE(device);
  const dim3 grid(chunks_of(height, width), batch);
  grade_phase1_planes_kernel<<<grid, kPlanesThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      src_planes, corner_planes, lut_size, domain, blend, keep, batch,
      height, width, lab_planes, partials);
  return static_cast<int>(cudaGetLastError());
}

int vrgdg_grade_phase2(int device, const float* lab, const float* coeff,
                       int batch, int height, int width, float sharpen,
                       float grain, float mix, float keep_mix,
                       unsigned int seed_base, float* out, void* stream) {
  return launch_phase2<BhwcLayout>(device, lab, coeff, batch, height, width,
                                   sharpen, grain, mix, keep_mix, seed_base,
                                   out, stream);
}

int vrgdg_grade_phase2_planes(int device, const float* lab_planes,
                              const float* coeff, int batch, int height,
                              int width, float sharpen, float grain,
                              float mix, float keep_mix,
                              unsigned int seed_base, float* out_planes,
                              void* stream) {
  return launch_phase2<PlanesLayout>(device, lab_planes, coeff, batch,
                                     height, width, sharpen, grain, mix,
                                     keep_mix, seed_base, out_planes, stream);
}

int vrgdg_phase1_block_size() { return kChunkPixels; }

}  // extern "C"
