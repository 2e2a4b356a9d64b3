// Alternatives to lut_apply (vrgdg_tpu_torch/kernels/csrc/lut.cu), built on
// its per-pixel code so that they differ only in how threads map to
// pixels and how source and output move:
// - direct_t{128,256,512}_p1: one pixel a thread at three block sizes
//   (t128_p1 is the shipped kernel's mapping);
// - direct_t256_p2: two pixels a thread, p and p + 256, both rows'
//   gathers issued before either pixel's lerps;
// - direct_t256_p1_min8: one pixel a thread with at most 32 registers
//   (__launch_bounds__(256, 8)), for the most resident warps;
// - staged_t256: the block's 256 pixels of 3 channels staged through
//   shared memory with 16-byte loads and stores (3-channel, 16-byte
//   aligned frames only);
// - fp32_yardstick: the shipped mapping with the lerps in float32 FMAs.
//   It does NOT give the plain version's bits; it is timed only, to price
//   the float64 sums.
// kernel_variants/lut_variants.py checks every variant but the yardstick
// bit for bit against the shipped kernel and times them in rounds.

#include "../vrgdg_tpu_torch/kernels/csrc/lut.cu"

namespace {

__device__ __forceinline__ void load_domain(const float* __restrict__ dmin_in,
                                            const float* __restrict__ dmax_in,
                                            float dmin[3], float span[3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    dmin[i] = __ldg(dmin_in + i);
    span[i] = fmaxf(__fsub_rn(__ldg(dmax_in + i), dmin[i]), 1e-6f);
  }
}

template <int kThreads, int kPixels, int kMinBlocks>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
direct_kernel(const float* __restrict__ frames, long long pixels,
              int channels, const float* __restrict__ bundle, int lut_size,
              const float* __restrict__ dmin_in,
              const float* __restrict__ dmax_in, float blend,
              float* __restrict__ out) {
  float dmin[3], span[3];
  load_domain(dmin_in, dmax_in, dmin, span);
  const long long first =
      static_cast<long long>(blockIdx.x) * kThreads * kPixels + threadIdx.x;
  float src[kPixels][3];
#pragma unroll
  for (int k = 0; k < kPixels; ++k) {
    const long long p = first + static_cast<long long>(k) * kThreads;
    const size_t base = static_cast<size_t>(p < pixels ? p : 0) * channels;
#pragma unroll
    for (int c = 0; c < 3; ++c) src[k][c] = __ldg(frames + base + c);
  }
#pragma unroll
  for (int k = 0; k < kPixels; ++k) {
    const long long p = first + static_cast<long long>(k) * kThreads;
    if (p >= pixels) continue;
    const size_t base = static_cast<size_t>(p) * channels;
    float rgb[3];
    lut_pixel(src[k], bundle, lut_size, dmin, span, blend, keep_of(blend),
              rgb);
#pragma unroll
    for (int c = 0; c < 3; ++c) out[base + c] = rgb[c];
    for (int c = 3; c < channels; ++c) {
      out[base + c] = __ldg(frames + base + c);
    }
  }
}

constexpr int kStagedThreads = 256;
constexpr int kStagedFloats = kStagedThreads * 3;

__global__ void __launch_bounds__(kStagedThreads)
staged_kernel(const float* __restrict__ frames, long long pixels,
              const float* __restrict__ bundle, int lut_size,
              const float* __restrict__ dmin_in,
              const float* __restrict__ dmax_in, float blend,
              float* __restrict__ out) {
  __shared__ float4 stage4[kStagedFloats / 4];
  float* stage = reinterpret_cast<float*>(stage4);
  float dmin[3], span[3];
  load_domain(dmin_in, dmax_in, dmin, span);
  const long long first = static_cast<long long>(blockIdx.x) * kStagedThreads;
  const int count = static_cast<int>(
      pixels - first < kStagedThreads ? pixels - first : kStagedThreads);
  const float* block_src = frames + first * 3;
  float* block_out = out + first * 3;
  if (count == kStagedThreads) {
    for (int i = threadIdx.x; i < kStagedFloats / 4; i += kStagedThreads) {
      stage4[i] = __ldg(reinterpret_cast<const float4*>(block_src) + i);
    }
  } else {
    for (int i = threadIdx.x; i < count * 3; i += kStagedThreads) {
      stage[i] = __ldg(block_src + i);
    }
  }
  __syncthreads();
  const int t = threadIdx.x;
  float rgb[3];
  if (t < count) {
    const float src[3] = {stage[3 * t], stage[3 * t + 1], stage[3 * t + 2]};
    lut_pixel(src, bundle, lut_size, dmin, span, blend, keep_of(blend), rgb);
  }
  __syncthreads();
  if (t < count) {
#pragma unroll
    for (int c = 0; c < 3; ++c) stage[3 * t + c] = rgb[c];
  }
  __syncthreads();
  if (count == kStagedThreads) {
    for (int i = threadIdx.x; i < kStagedFloats / 4; i += kStagedThreads) {
      reinterpret_cast<float4*>(block_out)[i] = stage4[i];
    }
  } else {
    for (int i = threadIdx.x; i < count * 3; i += kStagedThreads) {
      block_out[i] = stage[i];
    }
  }
}

__device__ __forceinline__ float lerp_f32(float a, float b, float f) {
  return fmaf(a, 1.0f - f, b * f);
}

__global__ void __launch_bounds__(kLutThreads)
fp32_yardstick_kernel(const float* __restrict__ frames, long long pixels,
                      int channels, const float* __restrict__ bundle,
                      int lut_size, const float* __restrict__ dmin_in,
                      const float* __restrict__ dmax_in, float blend,
                      float* __restrict__ out) {
  const long long p =
      static_cast<long long>(blockIdx.x) * kLutThreads + threadIdx.x;
  if (p >= pixels) return;
  float dmin[3], span[3];
  load_domain(dmin_in, dmax_in, dmin, span);
  const size_t base = static_cast<size_t>(p) * channels;
  const float src[3] = {__ldg(frames + base), __ldg(frames + base + 1),
                        __ldg(frames + base + 2)};
  const float max_index = static_cast<float>(lut_size - 1);
  float frac[3];
  int lo[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float coord = clip01((src[i] - dmin[i]) / span[i]) * max_index;
    const float floor_coord = floorf(coord);
    frac[i] = coord - floor_coord;
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
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float c0 = lerp_f32(lerp_f32(g[c], g[3 + c], frac[2]),
                              lerp_f32(g[6 + c], g[9 + c], frac[2]), frac[1]);
    const float c1 = lerp_f32(lerp_f32(g[12 + c], g[15 + c], frac[2]),
                              lerp_f32(g[18 + c], g[21 + c], frac[2]),
                              frac[1]);
    out[base + c] = lerp_f32(src[c], clip01(lerp_f32(c0, c1, frac[0])),
                             blend);
  }
}

template <int kThreads, int kPixels, int kMinBlocks>
int launch_direct(const float* frames, long long pixels, int channels,
                  const float* bundle, int lut_size, const float* dmin,
                  const float* dmax, float blend, float* out,
                  cudaStream_t stream) {
  const long long per_block = static_cast<long long>(kThreads) * kPixels;
  const long long blocks = (pixels + per_block - 1) / per_block;
  direct_kernel<kThreads, kPixels, kMinBlocks>
      <<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
          frames, pixels, channels, bundle, lut_size, dmin, dmax, blend, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// variant: 0 direct_t128_p1, 1 direct_t256_p1, 2 direct_t512_p1,
// 3 direct_t256_p2, 4 direct_t256_p1_min8, 5 staged_t256,
// 6 fp32_yardstick.  Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for an unknown variant or frames staged_t256 does
// not take.
int vrgdg_lut_variant(int variant, int device, const float* frames,
                      long long pixels, int channels, const float* bundle,
                      int lut_size, const float* dmin, const float* dmax,
                      float blend, float* out, void* stream_ptr) {
  VRGDG_SELECT_DEVICE(device);
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  switch (variant) {
    case 0:
      return launch_direct<128, 1, 1>(frames, pixels, channels, bundle,
                                      lut_size, dmin, dmax, blend, out,
                                      stream);
    case 1:
      return launch_direct<256, 1, 1>(frames, pixels, channels, bundle,
                                      lut_size, dmin, dmax, blend, out,
                                      stream);
    case 2:
      return launch_direct<512, 1, 1>(frames, pixels, channels, bundle,
                                      lut_size, dmin, dmax, blend, out,
                                      stream);
    case 3:
      return launch_direct<256, 2, 1>(frames, pixels, channels, bundle,
                                      lut_size, dmin, dmax, blend, out,
                                      stream);
    case 4:
      return launch_direct<256, 1, 8>(frames, pixels, channels, bundle,
                                      lut_size, dmin, dmax, blend, out,
                                      stream);
    case 5: {
      if (channels != 3 || reinterpret_cast<uintptr_t>(frames) % 16 ||
          reinterpret_cast<uintptr_t>(out) % 16) {
        return static_cast<int>(cudaErrorInvalidValue);
      }
      const long long blocks = (pixels + kStagedThreads - 1) / kStagedThreads;
      staged_kernel<<<static_cast<unsigned>(blocks), kStagedThreads, 0,
                      stream>>>(frames, pixels, bundle, lut_size, dmin, dmax,
                                blend, out);
      return static_cast<int>(cudaGetLastError());
    }
    case 6: {
      if (channels != 3) return static_cast<int>(cudaErrorInvalidValue);
      const long long blocks = (pixels + kLutThreads - 1) / kLutThreads;
      fp32_yardstick_kernel<<<static_cast<unsigned>(blocks), kLutThreads, 0,
                              stream>>>(frames, pixels, channels, bundle,
                                        lut_size, dmin, dmax, blend, out);
      return static_cast<int>(cudaGetLastError());
    }
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
