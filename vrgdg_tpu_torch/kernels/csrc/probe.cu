// The transpose probe on Hopper (sm_90a), with a plain C interface loaded
// through ctypes by vrgdg_tpu_torch/kernels/probe_cuda.py.
//
// weighted_row_sum replaces tools/probe_transpose.py::main.kernel: for each
// row r of a (rows, 24) float32 block, sum_k (k + 1) * g[r, k].  On the TPU
// the probe asked whether Mosaic lowers the in-VMEM transpose of
// gather-native (128, 24) chunks into corner-major (24, 128) planes, the
// step that let the fused grade's phase 1 read the gather output without
// an XLA relayout copy.
//
// The same question on Hopper: can a block read gather-native rows with
// full-width coalesced loads and hand each thread its own row?  Each
// 128-thread block stages 128 rows (12 KB) into shared memory with 16-byte
// loads, neighbouring threads on neighbouring addresses, then reads them
// back transposed, one row per thread.  Rows are padded to 25 floats in
// shared memory: a warp's 32 rows then start on 32 different banks, so
// the transposed reads are free of bank conflicts (a 24-float stride would
// put every fourth row on the same bank).  Bound: HBM, 96 bytes read and 4
// written per row; the weighted sum is 24 FMAs.  This is the pattern a
// later phase-1 kernel would use in place of each thread's own six float4
// bundle reads.

#include "common.h"

namespace {

constexpr int kRowsPerBlock = 128;
constexpr int kWidth = 24;
constexpr int kPadded = kWidth + 1;
constexpr int kVec = kWidth / 4;   // float4 loads per row

__global__ void __launch_bounds__(kRowsPerBlock)
weighted_row_sum_kernel(const float* __restrict__ g, long long rows,
                        float* __restrict__ out) {
  __shared__ float stage[kRowsPerBlock * kPadded];
  const long long row0 = static_cast<long long>(blockIdx.x) * kRowsPerBlock;
  const long long valid_vec =
      (rows - row0 < kRowsPerBlock ? rows - row0 : kRowsPerBlock) * kVec;
  const float4* block4 = reinterpret_cast<const float4*>(g + row0 * kWidth);
  for (int i = threadIdx.x; i < kRowsPerBlock * kVec; i += kRowsPerBlock) {
    if (i < valid_vec) {
      const float4 v = __ldg(block4 + i);
      float* dst = stage + (i / kVec) * kPadded + (i % kVec) * 4;
      dst[0] = v.x;
      dst[1] = v.y;
      dst[2] = v.z;
      dst[3] = v.w;
    }
  }
  __syncthreads();
  const long long row = row0 + threadIdx.x;
  if (row >= rows) return;
  const float* mine = stage + threadIdx.x * kPadded;
  float acc = 0.0f;
  // a rounded multiply, then a rounded add (no FMA contraction), in the
  // plain version's order: the two agree bit for bit
#pragma unroll
  for (int k = 0; k < kWidth; ++k) {
    acc = __fadd_rn(acc, __fmul_rn(mine[k], static_cast<float>(k + 1)));
  }
  out[row] = acc;
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 = launched).  g must be
// 16-byte aligned; the wrapper checks.
int vrgdg_weighted_row_sum(int device, const float* g, long long rows,
                           float* out, void* stream) {
  VRGDG_SELECT_DEVICE(device);
  const long long blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  weighted_row_sum_kernel<<<static_cast<unsigned>(blocks), kRowsPerBlock, 0,
                            static_cast<cudaStream_t>(stream)>>>(g, rows, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
