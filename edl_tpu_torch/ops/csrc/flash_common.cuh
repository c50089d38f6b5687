// What the flash-attention forward (flash_fwd.cu) and backward
// (flash_bwd.cu) share besides the Hopper primitives of sm90.cuh:
//   device: the back-and-forth deal of work items over persistent CTAs,
//   the one-op exp2, the bf16 pair pack, a tile loaded box by box;
//   host: the rank-4 TMA tensor maps over [B, T, heads, D] bf16 with the
//   caller's strides (cuTensorMapEncodeTiled, reached through the CUDA
//   runtime that nvcc links statically, so nothing links libcuda), and
//   the once-per-device launch set-up (SM count, shared-memory opt-in).

#pragma once

#include <cuda_bf16.h>
#include <cudaTypedefs.h>

#include <atomic>

#include "sm90.cuh"

namespace edl {
namespace flash {

constexpr int kBoxCols = 64;  // bf16 columns a TMA box: one 128-byte row

// -- device -------------------------------------------------------------------

// The r-th work item of this CTA (>= the item count: none left). Items
// are numbered heaviest first; CTA c takes items c, 2G-1-c, 2G+c,
// 4G-1-c, ... of G CTAs -- a back-and-forth deal that pairs heavy items
// with light ones.
__device__ __forceinline__ int item_index(int r) {
  const int g = gridDim.x;
  return r * g + ((r & 1) ? g - 1 - int(blockIdx.x) : int(blockIdx.x));
}

// 2^x, one MUFU op; results below 2^-126 flush to 0
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x -> low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// A `Rows` x D tile at (row, head, batch) into shared memory: D / 64
// boxes of Rows x 128 bytes, one after the other.
template <int D, int Rows>
__device__ __forceinline__ void load_tile(unsigned char* dst,
                                          const CUtensorMap* map,
                                          uint64_t* bar, int head, int row,
                                          int batch) {
#pragma unroll
  for (int c = 0; c < D / kBoxCols; ++c) {
    sm90::tma_load_4d(dst + c * Rows * 128, map, bar, c * kBoxCols, head,
                      row, batch);
  }
}

// -- host ---------------------------------------------------------------------

inline PFN_cuTensorMapEncodeTiled encode_fn() {
  static const PFN_cuTensorMapEncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000,
                                         cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess) {
      f = nullptr;
    }
    return reinterpret_cast<PFN_cuTensorMapEncodeTiled>(f);
  }();
  return fn;
}

// [B, T, heads, D] bf16 with element strides (sb, st, sh), the last
// dimension contiguous: rank 4 (d, heads, T, B), boxes of 64 x 1 x rows x
// 1 in the 128-byte swizzle; loads fill rows past T with zeros, stores
// drop them.
inline bool make_map(CUtensorMap* map, const void* base, int D, int heads,
                     int T, int B, long long sb, long long st, long long sh,
                     int rows) {
  const PFN_cuTensorMapEncodeTiled encode = encode_fn();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {cuuint64_t(D), cuuint64_t(heads), cuuint64_t(T),
                              cuuint64_t(B)};
  const cuuint64_t strides[3] = {cuuint64_t(sh) * 2, cuuint64_t(st) * 2,
                                 cuuint64_t(sb) * 2};
  const cuuint32_t box[4] = {kBoxCols, 1, cuuint32_t(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

constexpr int kMaxDevices = 64;

// The current device's SM count (asked once per device) and, once per
// device for the kernel that owns `ready`, its opt-in to `smem_bytes` of
// dynamic shared memory.
inline cudaError_t launch_setup(const void* kernel, int smem_bytes,
                                std::atomic<bool> (&ready)[kMaxDevices],
                                int* sms) {
  static std::atomic<int> sm_counts[kMaxDevices];  // 0: not asked yet
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  *sms = sm_counts[dev].load(std::memory_order_relaxed);
  if (*sms == 0) {
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    sm_counts[dev].store(*sms, std::memory_order_relaxed);
  }
  if (!ready[dev].load(std::memory_order_acquire)) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_bytes);
    if (err != cudaSuccess) return err;
    ready[dev].store(true, std::memory_order_release);
  }
  return cudaSuccess;
}

}  // namespace flash
}  // namespace edl
