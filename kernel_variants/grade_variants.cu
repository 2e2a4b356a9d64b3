// Timing variants of the fused grade's two main-path kernels on Hopper
// (sm_90a): the asynchronous-copy designs that lost to grade_phase1 and
// grade_phase2 on an H100, and phase 2 with mixed layouts.  This file includes the shipped grade.cu and
// calls its per-pixel code (lattice_cell, gather_row, trilerp_blend,
// apply_adjust, rgb_to_lab, add_sums, lab_to_rgb, unsharp3x3,
// grain_field), so every variant computes the same function and writes
// the same partials rows; only the layout of the work on the card
// differs.  grade_variants.py builds it, checks each variant against the
// plain PyTorch versions and times it beside the shipped kernels.
//
// Phase 1, phase1_variant_kernel<kThreads, kPix, kStages, kRing>: a block
// owns the shipped kernel's chunk of kChunkPixels pixels of one frame and
// walks it in stages of kThreads * kPix pixels.  Each thread takes kPix
// pixels of a stage and starts all their bundle-row gathers before the
// first trilerp.  With kRing, the chunk's src streams through kStages
// shared-memory stages, each filled by one cp.async.bulk copy that
// completes on the stage's mbarrier and is started as soon as the stage is
// free; each thread writes its LAB back into the stage and the block
// copies the stage out as float4 rows.  Without kRing, src comes straight
// from global memory and LAB goes straight back.  The bulk copies and the
// float4 rows need 16-byte aligned chunks, so the launcher refuses frames
// with H * W % 4 != 0.
//
// Phase 2, phase2_variant_kernel<kPersistent>: 64 x 32 output tiles, 256
// threads, each filtering 4 pixels along x on two rows from a 3 x 6 window
// a channel; the (32 + 2) x (64 + 2) LAB halo comes in by 4-byte cp.async
// (a halo row starts 4 bytes into a pixel, so wider copies would need
// alignment the rows lack), is converted once into three RGB planes in
// shared memory (out-of-frame entries RGB 0, the zero border), and each
// thread writes its 4 pixels as three float4 when W % 4 == 0.  With
// kPersistent, a grid of two blocks an SM loops over the tiles and loads
// the next tile's halo into a second buffer while it filters this one
// (80.8 KB of dynamic shared memory); without, each block takes one tile
// (53.9 KB).
//
// Phase 2's layouts: the shipped grade_phase2_kernel<Layout> with a policy
// that reads one layout and writes the other (LAB planes in, RGB BHWC out,
// and BHWC in, planes out), so the planes kernel's cost over the BHWC one
// splits into its read side and its write side.

#include "../vrgdg_tpu_torch/kernels/csrc/grade.cu"

namespace {

struct PlanesLabBhwcRgb {
  __device__ __forceinline__ static size_t lab(size_t pixel, int c,
                                               size_t pixels) {
    return PlanesLayout::lab(pixel, c, pixels);
  }
  __device__ __forceinline__ static size_t rgb(size_t pixel, int c,
                                               size_t pixels) {
    return BhwcLayout::rgb(pixel, c, pixels);
  }
};
struct BhwcLabPlanesRgb {
  __device__ __forceinline__ static size_t lab(size_t pixel, int c,
                                               size_t pixels) {
    return BhwcLayout::lab(pixel, c, pixels);
  }
  __device__ __forceinline__ static size_t rgb(size_t pixel, int c,
                                               size_t pixels) {
    return PlanesLayout::rgb(pixel, c, pixels);
  }
};

__device__ __forceinline__ uint32_t smem_address(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbarrier_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(
                   smem_address(bar))
               : "memory");
}

// One bulk copy of ``bytes`` (a multiple of 16, both ends 16-byte
// aligned) from global to shared memory, completing on ``bar``.
__device__ __forceinline__ void bulk_load(float* dst, const float* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_address(bar)),
      "r"(bytes)
      : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_address(dst)),
      "l"(src), "r"(bytes), "r"(smem_address(bar))
      : "memory");
}

__device__ __forceinline__ void mbarrier_wait(uint64_t* bar,
                                              uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(smem_address(bar)),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                   smem_address(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(kPending) : "memory");
}

// ---------------------------------------------------------------------------
// phase 1
// ---------------------------------------------------------------------------

// Grid (ceil(H*W / kChunkPixels), B), kThreads threads; the arguments and
// outputs of grade_phase1_kernel.
template <int kThreads, int kPix, int kStages, bool kRing>
__global__ void __launch_bounds__(kThreads)
phase1_variant_kernel(const float* __restrict__ src,
                      const float* __restrict__ table, int lut_size,
                      const float* __restrict__ domain, float blend,
                      float keep, int adjust_flags, AdjustParams adjust,
                      int height, int width, float* __restrict__ lab_out,
                      double* __restrict__ partials) {
  constexpr int kStage = kThreads * kPix;  // pixels a stage
  static_assert(kChunkPixels % kStage == 0, "a chunk is whole stages");
  __shared__ __align__(16) float ring[kRing ? kStages : 1]
                                     [kRing ? kStage * 3 : 4];
  __shared__ __align__(8) uint64_t full[kStages];
  const int frame = blockIdx.y;
  const long long pixels = static_cast<long long>(height) * width;
  const long long first = static_cast<long long>(blockIdx.x) * kChunkPixels;
  const int count = static_cast<int>(
      pixels - first < kChunkPixels ? pixels - first : kChunkPixels);
  const int stages = (count + kStage - 1) / kStage;
  const size_t offset = (static_cast<size_t>(frame) * pixels + first) * 3;
  const float* chunk_src = src + offset;
  float* chunk_lab = lab_out + offset;
  const float dmin[3] = {domain[0], domain[1], domain[2]};
  const float inv_span[3] = {domain[3], domain[4], domain[5]};
  const bool adjust_on = adjust_flags & kAdjustOn;
  const float inv_width = 1.0f / static_cast<float>(width);
  auto stage_pixels = [&](int t) {
    return count - t * kStage < kStage ? count - t * kStage : kStage;
  };

  if constexpr (kRing) {
    if (threadIdx.x == 0) {
#pragma unroll
      for (int s = 0; s < kStages; ++s) mbarrier_init(&full[s]);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
      for (int t = 0; t < kStages && t < stages; ++t) {
        bulk_load(ring[t], chunk_src + static_cast<size_t>(t) * kStage * 3,
                  stage_pixels(t) * 12, &full[t]);
      }
    }
    __syncthreads();
  }

  double sums[6] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
  for (int t = 0; t < stages; ++t) {
    const int slot = t % kStages;
    const int n = stage_pixels(t);
    const float* stage_src = chunk_src + static_cast<size_t>(t) * kStage * 3;
    if constexpr (kRing) mbarrier_wait(&full[slot], (t / kStages) & 1);
    float source[kPix][3], frac[kPix][3], g[kPix][24];
#pragma unroll
    for (int j = 0; j < kPix; ++j) {
      const int q = threadIdx.x + j * kThreads;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        source[j][c] = 0.0f;
        if (q < n) {
          if constexpr (kRing) {
            source[j][c] = ring[slot][3 * q + c];
          } else {
            source[j][c] = __ldg(stage_src + 3 * q + c);
          }
        }
      }
      // every gather of the stage in flight before the first trilerp
      gather_row(table, lattice_cell(source[j], dmin, inv_span, lut_size,
                                     frac[j]),
                 g[j]);
    }
#pragma unroll
    for (int j = 0; j < kPix; ++j) {
      const int q = threadIdx.x + j * kThreads;
      if (q >= n) continue;
      float color[3];
      trilerp_blend(g[j], frac[j], source[j], blend, keep, color);
      if (adjust_on) {
        int y, x;
        pixel_yx(static_cast<int>(first) + t * kStage + q, width, inv_width,
                 y, x);
        apply_adjust(color, adjust_flags, adjust, y, x, height, width);
      }
      float lab[3];
      rgb_to_lab(color, lab);
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        if constexpr (kRing) {
          ring[slot][3 * q + c] = lab[c];
        } else {
          chunk_lab[(static_cast<size_t>(t) * kStage + q) * 3 + c] = lab[c];
        }
      }
      add_sums(lab, sums);
    }
    if constexpr (kRing) {
      __syncthreads();
      const float4* from = reinterpret_cast<const float4*>(ring[slot]);
      float4* to = reinterpret_cast<float4*>(
          chunk_lab + static_cast<size_t>(t) * kStage * 3);
      for (int i = threadIdx.x; i < n * 3 / 4; i += kThreads) to[i] = from[i];
      // the stage's generic writes and reads, ordered before the bulk copy
      // that refills it
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      __syncthreads();
      if (threadIdx.x == 0 && t + kStages < stages) {
        bulk_load(ring[slot],
                  chunk_src + static_cast<size_t>(t + kStages) * kStage * 3,
                  stage_pixels(t + kStages) * 12, &full[slot]);
      }
    }
  }
  reduce_sums<kThreads>(
      sums, partials + (static_cast<size_t>(frame) * gridDim.x + blockIdx.x) *
                           6);
}

// ---------------------------------------------------------------------------
// phase 2
// ---------------------------------------------------------------------------

constexpr int kVarTileW = 64;
constexpr int kVarTileH = 32;
constexpr int kVarHaloW = kVarTileW + 2;
constexpr int kVarHaloH = kVarTileH + 2;
constexpr int kVarHalo = kVarHaloW * kVarHaloH;  // halo pixels
constexpr int kVarThreads = 256;                 // 16 x 16
constexpr int kVarPix = 4;                       // pixels a thread along x
constexpr int kVarRows = 2;                      // rows a thread

constexpr int phase2_smem_bytes(bool persistent) {
  return (persistent ? 3 : 2) * kVarHalo * 3 * static_cast<int>(sizeof(float));
}

// Grid: two blocks an SM (kPersistent) or one block a tile; 256 threads;
// dynamic shared memory phase2_smem_bytes(kPersistent).  The arguments and
// outputs of grade_phase2_kernel, plus the batch.
template <bool kPersistent>
__global__ void __launch_bounds__(kVarThreads)
phase2_variant_kernel(const float* __restrict__ lab,
                      const float* __restrict__ coeff, int batch, int height,
                      int width, float sharpen, float grain, float mix,
                      float keep_mix, uint32_t seed_base,
                      float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  float* halo[2] = {smem, smem + (kPersistent ? kVarHalo * 3 : 0)};
  float* rgb = smem + (kPersistent ? 2 : 1) * kVarHalo * 3;  // [3][H][W]
  const int tiles_x = (width + kVarTileW - 1) / kVarTileW;
  const int tiles_y = (height + kVarTileH - 1) / kVarTileH;
  const int tiles = tiles_x * tiles_y * batch;
  const size_t pixels = static_cast<size_t>(height) * width;
  struct Tile {
    int frame, x0, y0;
  };
  auto tile_at = [&](int tile) {
    const int frame = tile / (tiles_x * tiles_y);
    const int rest = tile - frame * tiles_x * tiles_y;
    return Tile{frame, (rest % tiles_x) * kVarTileW,
                (rest / tiles_x) * kVarTileH};
  };
  // the halo's in-frame LAB floats, row by row, 4 bytes a copy
  auto load = [&](int tile, float* buffer) {
    const Tile at = tile_at(tile);
    const float* frame_lab = lab + static_cast<size_t>(at.frame) * pixels * 3;
    for (int i = threadIdx.x; i < kVarHalo * 3; i += kVarThreads) {
      const int hy = i / (kVarHaloW * 3);
      const int k = i - hy * kVarHaloW * 3;
      const int y = at.y0 + hy - 1;
      const int x = at.x0 + k / 3 - 1;
      if (y >= 0 && y < height && x >= 0 && x < width) {
        cp_async4(buffer + i,
                  frame_lab + (static_cast<size_t>(y) * width + x) * 3 + k % 3);
      }
    }
    cp_async_commit();
  };

  const int step = kPersistent ? gridDim.x : tiles;
  int tile = blockIdx.x;
  if (kPersistent && tile < tiles) load(tile, halo[0]);
  for (int k = 0; tile < tiles; ++k, tile += step) {
    const float* buffer = halo[k & 1];
    if constexpr (kPersistent) {
      if (tile + step < tiles) {
        load(tile + step, halo[(k + 1) & 1]);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
    } else {
      load(tile, halo[0]);
      cp_async_wait<0>();
    }
    __syncthreads();

    const Tile at = tile_at(tile);
    const float a[3] = {coeff[at.frame * 6], coeff[at.frame * 6 + 1],
                        coeff[at.frame * 6 + 2]};
    const float b[3] = {coeff[at.frame * 6 + 3], coeff[at.frame * 6 + 4],
                        coeff[at.frame * 6 + 5]};
    for (int e = threadIdx.x; e < kVarHalo; e += kVarThreads) {
      const int hy = e / kVarHaloW;
      const int hx = e - hy * kVarHaloW;
      const int y = at.y0 + hy - 1;
      const int x = at.x0 + hx - 1;
      float v[3], out_rgb[3] = {0.0f, 0.0f, 0.0f};
      if (y >= 0 && y < height && x >= 0 && x < width) {
#pragma unroll
        for (int c = 0; c < 3; ++c) v[c] = buffer[3 * e + c] * a[c] + b[c];
        lab_to_rgb(v, out_rgb);
      }
#pragma unroll
      for (int c = 0; c < 3; ++c) rgb[c * kVarHalo + e] = out_rgb[c];
    }
    __syncthreads();

    const int tx = threadIdx.x % (kVarTileW / kVarPix);
    const int ty = threadIdx.x / (kVarTileW / kVarPix);
    const int x = at.x0 + tx * kVarPix;
    const uint32_t key =
        (seed_base + static_cast<uint32_t>(at.frame)) & kSeedMask;
#pragma unroll
    for (int r = 0; r < kVarRows; ++r) {
      const int hy = ty * kVarRows + r + 1;  // the output row's halo row
      const int y = at.y0 + hy - 1;
      if (x >= width || y >= height) break;
      float result[kVarPix][3];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        // the 3 x 6 window of channel c: halo rows hy - 1 .. hy + 1,
        // columns tx * kVarPix .. + 5
        float row[3][kVarPix + 2];
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
          for (int d = 0; d < kVarPix + 2; ++d) {
            row[dy][d] = rgb[c * kVarHalo + (hy - 1 + dy) * kVarHaloW +
                             tx * kVarPix + d];
          }
        }
#pragma unroll
        for (int p = 0; p < kVarPix; ++p) {
          float w[3][3];
#pragma unroll
          for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
            for (int d = 0; d < 3; ++d) w[dy][d] = row[dy][p + d];
          }
          result[p][c] = unsharp3x3(w, sharpen);
        }
      }
      const size_t pixel = static_cast<size_t>(y) * width + x;
#pragma unroll
      for (int p = 0; p < kVarPix; ++p) {
        if (grain > 0.0f && x + p < width) {
          float g[3];
          grain_field(key, static_cast<uint32_t>(pixel + p), mix, keep_mix,
                      g);
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            result[p][c] = clip01(result[p][c] + g[c] * grain);
          }
        }
      }
      float* o = out + (static_cast<size_t>(at.frame) * pixels + pixel) * 3;
      if ((width & 3) == 0 && x + kVarPix <= width) {
        float4* o4 = reinterpret_cast<float4*>(o);
        o4[0] = make_float4(result[0][0], result[0][1], result[0][2],
                            result[1][0]);
        o4[1] = make_float4(result[1][1], result[1][2], result[2][0],
                            result[2][1]);
        o4[2] = make_float4(result[2][2], result[3][0], result[3][1],
                            result[3][2]);
      } else {
#pragma unroll
        for (int p = 0; p < kVarPix; ++p) {
          if (x + p < width) {
#pragma unroll
            for (int c = 0; c < 3; ++c) o[3 * p + c] = result[p][c];
          }
        }
      }
    }
    __syncthreads();  // the RGB planes and this halo buffer are refilled
  }
}

template <int kThreads, int kPix, int kStages, bool kRing>
void launch_phase1(dim3 grid, cudaStream_t stream, const float* src,
                   const float* bundle, int lut_size, const float* domain,
                   float blend, float keep, int adjust_flags,
                   AdjustParams adjust, int height, int width, float* lab,
                   double* partials) {
  phase1_variant_kernel<kThreads, kPix, kStages, kRing>
      <<<grid, kThreads, 0, stream>>>(src, bundle, lut_size, domain, blend,
                                      keep, adjust_flags, adjust, height,
                                      width, lab, partials);
}

}  // namespace

extern "C" {

// Phase 1 variants, in the order grade_variants.py names them.  Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for an
// unknown variant or a frame of H * W % 4 != 0.
int vrgdg_variant_phase1(int variant, int device, const float* src,
                         const float* bundle, int lut_size,
                         const float* domain, float blend, float keep,
                         int adjust_flags, AdjustParams adjust, int batch,
                         int height, int width, float* lab,
                         double* partials, void* stream) {
  VRGDG_SELECT_DEVICE(device);
  if (static_cast<long long>(height) * width % 4 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(chunks_of(height, width), batch);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case 0:
      launch_phase1<256, 4, 3, true>(grid, s, src, bundle, lut_size, domain,
                                     blend, keep, adjust_flags, adjust,
                                     height, width, lab, partials);
      break;
    case 1:
      launch_phase1<128, 4, 3, true>(grid, s, src, bundle, lut_size, domain,
                                     blend, keep, adjust_flags, adjust,
                                     height, width, lab, partials);
      break;
    case 2:
      launch_phase1<256, 2, 3, true>(grid, s, src, bundle, lut_size, domain,
                                     blend, keep, adjust_flags, adjust,
                                     height, width, lab, partials);
      break;
    case 3:
      launch_phase1<512, 1, 2, true>(grid, s, src, bundle, lut_size, domain,
                                     blend, keep, adjust_flags, adjust,
                                     height, width, lab, partials);
      break;
    case 4:
      launch_phase1<256, 4, 1, false>(grid, s, src, bundle, lut_size, domain,
                                      blend, keep, adjust_flags, adjust,
                                      height, width, lab, partials);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// Phase 2 variants: 0 persistent and double-buffered, 1 one tile a block
// (BHWC in and out); the shipped kernel with 2 LAB planes in, RGB BHWC out,
// 3 LAB BHWC in, RGB planes out.
int vrgdg_variant_phase2(int variant, int device, const float* lab,
                         const float* coeff, int batch, int height,
                         int width, float sharpen, float grain, float mix,
                         float keep_mix, unsigned int seed_base, float* out,
                         void* stream) {
  if (variant == 2) {
    return launch_phase2<PlanesLabBhwcRgb>(device, lab, coeff, batch, height,
                                           width, sharpen, grain, mix,
                                           keep_mix, seed_base, out, stream);
  }
  if (variant == 3) {
    return launch_phase2<BhwcLabPlanesRgb>(device, lab, coeff, batch, height,
                                           width, sharpen, grain, mix,
                                           keep_mix, seed_base, out, stream);
  }
  VRGDG_SELECT_DEVICE(device);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles = ((width + kVarTileW - 1) / kVarTileW) *
                    ((height + kVarTileH - 1) / kVarTileH) * batch;
  if (variant == 0) {
    const int bytes = phase2_smem_bytes(true);
    cudaFuncSetAttribute(phase2_variant_kernel<true>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    int sms = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    const int blocks = tiles < 2 * sms ? tiles : 2 * sms;
    phase2_variant_kernel<true><<<blocks, kVarThreads, bytes, s>>>(
        lab, coeff, batch, height, width, sharpen, grain, mix, keep_mix,
        seed_base, out);
  } else if (variant == 1) {
    const int bytes = phase2_smem_bytes(false);
    cudaFuncSetAttribute(phase2_variant_kernel<false>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    phase2_variant_kernel<false><<<tiles, kVarThreads, bytes, s>>>(
        lab, coeff, batch, height, width, sharpen, grain, mix, keep_mix,
        seed_base, out);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
