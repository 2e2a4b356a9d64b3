// The enhancer's whole-frame step on Hopper (sm_90a), with a plain C
// interface loaded through ctypes by vrgdg_tpu_torch/kernels/enhance_cuda.py.
//
// enhance_step replaces no Pallas kernel.  It implements the chain that
// vrgdg_tpu_torch/jobs/enhancer.py runs on a uint8 batch
// (video_io.dequantize_on_device -> _enhance_step -> quantize_on_device),
// whose JAX counterpart (vrgdg_tpu/jobs/enhancer.py::_enhance_step) is left
// to XLA.  On the card that chain ran as two dense float32 products a
// frame (over 99% of their multiply-adds by zero: Lanczos-4 has at most 8
// taps a sample) and then six passes over a float32 frame at the output
// size; at 720p -> 4K it spent about 3.3 ms a frame of kernels on a frame
// whose own bytes are 27.6 MB.  Per output tile, in one launch:
// - the source window the tile's taps read, its uint8 levels divided by
//   255 in true float32 division (the CPU's bits; the torch chain on the
//   card multiplies by the reciprocal), into shared memory;
// - the width pass: each ring column's 8 taps held in registers, summed in
//   ascending source order with one FMA a tap over the window's rows;
// - the height pass over the tile and a one-pixel ring, the same way,
//   clamped to [0, 1]; the ring outside the frame is zero under the zero
//   border and the frame's edge under the edge border (ops/sharpen.py's
//   _pad_hw);
// - the unsharp: the 3x3 box sum in box_blur_3x3's order, divided by 9,
//   then clamp(img + s * (img - blur)) as ops/sharpen.py::unsharp;
// - the grain: common.h's grain_field with key (seed + frame) & 0x7FFFFFFF
//   and counter y * W + x, clip(x + grain * intensity), as film_grain;
// - the quantize: clamp(x * 255, 0, 255) truncated to uint8, stored by
//   the pixel's thread: a warp's 32 pixels are 96 contiguous bytes of a
//   row, which L2 merges into whole sectors.
// The tap tables are ops/resize.py::_tap_plan's (the dense matrix's
// float32 weights, border-clamped taps already summed), each row padded to
// 8 taps of weight 0 on its last source index, so a block reads only the
// source window its taps name.  The __f*_rn intrinsics keep nvcc from
// contracting the unsharp and the quantize into FMAs, so those stages give
// the CPU's bits from the same resampled values; the resample's sums differ
// from the products' by float32 rounding (another order).  No float32 frame
// at the output size is ever in device memory.
//
// What bounds it on an H100: a 720p -> 4K frame moves 27.6 MB of HBM
// (uint8 in and out), 8.25 us at 3.35 TB/s, and Lanczos-4's 8 taps a
// sample, width pass first, are 7.9 us of float32 operations at 67
// TFLOP/s.  The time goes to the work between: on the card at 720p -> 4K
// x 1 the kernel takes about 0.20 ms, of which the grain's Philox4x32-10
// call, two logf/sqrtf and three sinf/cosf a pixel and the unsharp take
// about 0.095 ms, and the block's shared-memory passes, barriers and
// stores with no resample arithmetic at all about 0.07 (copies of this
// kernel built with stages switched off).  The design keeps HBM at the
// frame's own bytes and the arithmetic in float32 as the configuration
// states.  Alternatives timed on the card (720p / 1080p -> 4K x 1, ms),
// each with the same bits: the output staged in shared memory so that
// consecutive threads store consecutive bytes, 0.2107 / 0.2380 against
// 0.2001 / 0.2237 for this kernel's stores; the height pass's taps read as
// 16-byte vectors, 1% faster, not kept; blocks 16 rows tall, 0.236 /
// 0.244 against 0.208 / 0.234 at 32 (8 rows: 0.292 / 0.302); warps that
// walk down 30-column strips, the ring's neighbours by shuffles and the
// unsharp from registers, 0.208 / 0.212 at 16 rows, but in blocks 240
// columns wide, whose window no longer fits for a 2x downscale.  The rows
// are 32 tall unless a steep downscale's window needs shorter.

#include "common.h"

namespace {

constexpr int kTaps = 8;              // a lanczos4 table row, padded
constexpr int kRingW = 64;            // ring columns a block
constexpr int kTileW = kRingW - 2;    // output columns a block
constexpr int kEnhanceThreads = 256;
constexpr int kGroups = kEnhanceThreads / kRingW;   // row groups
constexpr int kLevels = 256;
constexpr int C = 3;                  // channels: RGB

// The block's shared memory, in 4-byte words: the 256 levels, the ring
// rows' taps (rebased on the window) and weights, the ring, the
// dequantized source window and the width pass (enhance_cuda.smem_bytes,
// with which the wrapper picks tile_h).
struct Layout {
  int taps, ring, source, wide, words;
  __host__ __device__ Layout(int window, int span, int tile_h) {
    taps = kLevels;
    ring = taps + 2 * (tile_h + 2) * kTaps;
    source = ring + (tile_h + 2) * kRingW * C;
    wide = source + window * span * C;
    words = wide + window * kRingW * C;
  }
};

// Grid (ceil(dst_w / kTileW), ceil(dst_h / tile_h), B); block tile_h x
// kTileW output pixels of frame blockIdx.z, 256 threads.  col_idx / col_w:
// (dst_w, kTaps) source columns and weights; row_idx / row_w: (dst_h,
// kTaps).  col_lo[blockIdx.x] / row_lo[blockIdx.y]: the first source
// column / row of the block's window of span columns and window rows,
// which holds every sample the taps of its ring name.
__global__ void __launch_bounds__(kEnhanceThreads)
enhance_step_kernel(const uint8_t* __restrict__ src, int src_h, int src_w,
                    const int* __restrict__ col_idx,
                    const float* __restrict__ col_w,
                    const int* __restrict__ col_lo, int span,
                    const int* __restrict__ row_idx,
                    const float* __restrict__ row_w,
                    const int* __restrict__ row_lo, int window, int dst_h,
                    int dst_w, int tile_h, int zero_border, float sharpen,
                    float intensity, float mix, float keep_mix,
                    uint32_t seed_base, uint8_t* __restrict__ out) {
  extern __shared__ float smem[];
  const Layout layout(window, span, tile_h);
  float* level = smem;
  int* tap_k = reinterpret_cast<int*>(smem + layout.taps);
  float* tap_w = smem + layout.taps + (tile_h + 2) * kTaps;
  float* ring = smem + layout.ring;       // (tile_h + 2) x kRingW x C
  float* source = smem + layout.source;   // rows x span x C
  float* wide = smem + layout.wide;       // rows x kRingW x C

  const int frame = blockIdx.z;
  const int y0 = blockIdx.y * tile_h;
  const int x0 = blockIdx.x * kTileW;
  const int lo = __ldg(row_lo + blockIdx.y);
  const int rows = min(window, src_h - lo);
  const int cx = __ldg(col_lo + blockIdx.x);
  const int cols_in = min(span, src_w - cx);
  const int ring_rows = tile_h + 2;
  const int lane = threadIdx.x % kRingW;
  const int group = threadIdx.x / kRingW;

  for (int i = threadIdx.x; i < kLevels; i += kEnhanceThreads) {
    level[i] = __fdiv_rn(static_cast<float>(i), 255.0f);
  }
  for (int e = threadIdx.x; e < ring_rows * kTaps; e += kEnhanceThreads) {
    const int y = min(max(y0 - 1 + e / kTaps, 0), dst_h - 1);
    const int t = y * kTaps + e % kTaps;
    tap_k[e] = __ldg(row_idx + t) - lo;
    tap_w[e] = __ldg(row_w + t);
  }
  __syncthreads();

  // The source window, dequantized once: row r by group, its bytes by
  // lane.
  const uint8_t* frame_src =
      src + static_cast<size_t>(frame) * src_h * src_w * C;
  for (int r = group; r < rows; r += kGroups) {
    const uint8_t* line =
        frame_src + (static_cast<size_t>(lo + r) * src_w + cx) * C;
    for (int q = lane; q < cols_in * C; q += kRingW) {
      source[r * span * C + q] = level[line[q]];
    }
  }
  __syncthreads();

  // Width pass: thread (lane, group) takes ring column lane, clamped into
  // the frame (the edge border's ring), over rows group, group + 4, ...;
  // its 8 taps stay in registers.
  {
    const int x = min(max(x0 - 1 + lane, 0), dst_w - 1);
    int k[kTaps];
    float w[kTaps];
#pragma unroll
    for (int t = 0; t < kTaps; ++t) {
      k[t] = (__ldg(col_idx + x * kTaps + t) - cx) * C;
      w[t] = __ldg(col_w + x * kTaps + t);
    }
    for (int r = group; r < rows; r += kGroups) {
      const float* line = source + r * span * C;
      float acc[C];
#pragma unroll
      for (int c = 0; c < C; ++c) acc[c] = 0.0f;
#pragma unroll
      for (int t = 0; t < kTaps; ++t) {
#pragma unroll
        for (int c = 0; c < C; ++c) {
          acc[c] = __fmaf_rn(w[t], line[k[t] + c], acc[c]);
        }
      }
#pragma unroll
      for (int c = 0; c < C; ++c) wide[(r * kRingW + lane) * C + c] = acc[c];
    }
  }
  __syncthreads();

  // Height pass over the tile and its ring, clamped to [0, 1]; outside
  // the frame the zero border's ring is 0.
  {
    const int x = x0 - 1 + lane;
    const bool out_x = x < 0 || x >= dst_w;
    for (int i = group; i < ring_rows; i += kGroups) {
      const int y = y0 - 1 + i;
      float* cell = ring + (i * kRingW + lane) * C;
      if (zero_border && (out_x || y < 0 || y >= dst_h)) {
#pragma unroll
        for (int c = 0; c < C; ++c) cell[c] = 0.0f;
        continue;
      }
      float acc[C];
#pragma unroll
      for (int c = 0; c < C; ++c) acc[c] = 0.0f;
#pragma unroll
      for (int t = 0; t < kTaps; ++t) {
        const float weight = tap_w[i * kTaps + t];
        const float* sample = wide + (tap_k[i * kTaps + t] * kRingW + lane) * C;
#pragma unroll
        for (int c = 0; c < C; ++c) {
          acc[c] = __fmaf_rn(weight, sample[c], acc[c]);
        }
      }
#pragma unroll
      for (int c = 0; c < C; ++c) cell[c] = clip01(acc[c]);
    }
  }
  __syncthreads();

  // Unsharp, grain, quantize and store a pixel.
  const int tile_rows = min(tile_h, dst_h - y0);
  const int cols = min(kTileW, dst_w - x0);
  const uint32_t key = (seed_base + static_cast<uint32_t>(frame)) & kSeedMask;
  for (int e = threadIdx.x; e < tile_rows * kRingW; e += kEnhanceThreads) {
    const int i = e / kRingW;             // row i by group, column j by lane
    const int j = e % kRingW;
    if (j >= cols) continue;
    const float* corner = ring + (i * kRingW + j) * C;   // the 3x3's top left
    float v[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float img = corner[(kRingW + 1) * C + c];
      if (sharpen != 0.0f) {
        float sum = corner[c];
        sum = __fadd_rn(sum, corner[C + c]);
        sum = __fadd_rn(sum, corner[2 * C + c]);
#pragma unroll
        for (int dy = 1; dy < 3; ++dy) {
          const float* line = corner + dy * kRingW * C;
          sum = __fadd_rn(sum, line[c]);
          sum = __fadd_rn(sum, line[C + c]);
          sum = __fadd_rn(sum, line[2 * C + c]);
        }
        const float blur = __fdiv_rn(sum, 9.0f);
        v[c] = clip01(
            __fadd_rn(img, __fmul_rn(sharpen, __fsub_rn(img, blur))));
      } else {
        v[c] = img;
      }
    }
    if (intensity != 0.0f) {
      const uint32_t counter =
          static_cast<uint32_t>(y0 + i) * static_cast<uint32_t>(dst_w) +
          static_cast<uint32_t>(x0 + j);
      float g[3];
      grain_field(key, counter, mix, keep_mix, g);
#pragma unroll
      for (int c = 0; c < C; ++c) v[c] = clip01(v[c] + g[c] * intensity);
    }
    uint8_t* pixel =
        out + ((static_cast<size_t>(frame) * dst_h + y0 + i) * dst_w + x0 + j) *
                  C;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float scaled =
          fminf(fmaxf(__fmul_rn(v[c], 255.0f), 0.0f), 255.0f);
      pixel[c] = static_cast<uint8_t>(__float2uint_rz(scaled));
    }
  }
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for a batch or a grid beyond what a launch holds
// or a window outside the source.
int vrgdg_enhance_step(int device, const uint8_t* src, int batch, int src_h,
                       int src_w, const int* col_idx, const float* col_w,
                       const int* col_lo, int span, const int* row_idx,
                       const float* row_w, const int* row_lo, int window,
                       int dst_h, int dst_w, int tile_h, int zero_border,
                       float sharpen, float intensity, float mix,
                       float keep_mix, unsigned int seed_base, uint8_t* out,
                       void* stream) {
  if (batch < 1 || batch > 65535 || tile_h < 1 || window < 1 ||
      window > src_h || span < 1 || span > src_w ||
      (dst_h + tile_h - 1) / tile_h > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  VRGDG_SELECT_DEVICE(device);
  const size_t smem =
      sizeof(float) * static_cast<size_t>(Layout(window, span, tile_h).words);
  if (smem > 48 * 1024) {
    const cudaError_t set = cudaFuncSetAttribute(
        enhance_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (set != cudaSuccess) return static_cast<int>(set);
  }
  const dim3 grid((dst_w + kTileW - 1) / kTileW,
                  (dst_h + tile_h - 1) / tile_h, batch);
  enhance_step_kernel<<<grid, kEnhanceThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      src, src_h, src_w, col_idx, col_w, col_lo, span, row_idx, row_w,
      row_lo, window, dst_h, dst_w, tile_h, zero_border, sharpen, intensity,
      mix, keep_mix, seed_base, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
