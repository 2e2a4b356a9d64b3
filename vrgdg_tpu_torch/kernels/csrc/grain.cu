// Standalone film grain on Hopper (sm_90a), with a plain C interface loaded
// through ctypes by vrgdg_tpu_torch/kernels/grain_cuda.py.
//
// film_grain replaces vrgdg_tpu/kernels/grain_pallas.py::_grain_kernel:
// per pixel, three Box-Muller normals, red scaled by 2 and blue by 3,
// desaturated toward the green normal by 1 - mix, then
// clip(x + grain * intensity); channels past the third are copied.  The
// TPU kernel drew from the TPU's hardware generator per (frame, 16-row
// tile); here the normals come from common.h's grain_field, the one
// Philox4x32-10 stream of vrgdg_tpu_torch/ops/grain.py (key (seed +
// absolute frame) & 0x7FFFFFFF, counter = pixel index), so the kernel
// equals the eager film_grain value for value and the grade's phase 2
// draws the same grain.
//
// What bounds it on an H100: one thread per pixel moves 8 * C bytes of HBM
// (24 for RGB).  Against that, a Philox call is 10 rounds of two 32-bit
// multiplies, plus two logf/sqrtf and three sinf/cosf per pixel: about 100
// instructions per 24 bytes, below the card's ratio of issue rate to
// bandwidth, so the design keeps the bytes at their minimum (each pixel
// read once, written once, no scratch) and leaves the arithmetic as it is.
// No layout or padding carries over from the TPU: frames keep their
// (B, H, W, C) shape.  A height shard (rows [row_start, row_start + H) of
// frames frame_height rows tall) offsets the counter by row_start * W, so
// it draws the rows of the whole frame's grain that it owns.

#include "common.h"

namespace {

constexpr int kGrainThreads = 256;

// Grid (ceil(H*W / 256), B); one thread per pixel of frame blockIdx.y.
// counter_base is the whole frame's index of the tile's first pixel.
__global__ void __launch_bounds__(kGrainThreads)
film_grain_kernel(const float* __restrict__ frames, int pixels,
                  int channels, float intensity, float mix, float keep_mix,
                  uint32_t seed_base, uint32_t counter_base,
                  float* __restrict__ out) {
  const int frame = blockIdx.y;
  const int p = blockIdx.x * kGrainThreads + threadIdx.x;
  if (p >= pixels) return;
  const size_t base =
      (static_cast<size_t>(frame) * pixels + p) * static_cast<size_t>(channels);
  if (intensity != 0.0f) {
    const uint32_t key = (seed_base + static_cast<uint32_t>(frame)) & kSeedMask;
    float g[3];
    grain_field(key, counter_base + static_cast<uint32_t>(p), mix, keep_mix,
                g);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      out[base + c] = clip01(frames[base + c] + g[c] * intensity);
    }
  } else {
#pragma unroll
    for (int c = 0; c < 3; ++c) out[base + c] = clip01(frames[base + c]);
  }
  for (int c = 3; c < channels; ++c) out[base + c] = frames[base + c];
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue when rows [row_start, row_start + height) do not lie
// in a frame frame_height rows tall.
int vrgdg_film_grain(int device, const float* frames, int batch, int height,
                     int width, int channels, int row_start,
                     int frame_height, float intensity, float mix,
                     float keep_mix, unsigned int seed_base, float* out,
                     void* stream) {
  if (row_start < 0 || height > frame_height - row_start) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  VRGDG_SELECT_DEVICE(device);
  const int pixels = height * width;
  const uint32_t counter_base =
      static_cast<uint32_t>(row_start) * static_cast<uint32_t>(width);
  const dim3 grid((pixels + kGrainThreads - 1) / kGrainThreads, batch);
  film_grain_kernel<<<grid, kGrainThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      frames, pixels, channels, intensity, mix, keep_mix, seed_base,
      counter_base, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
