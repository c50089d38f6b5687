// Register-level building blocks of the flash-attention backward kernels
// (flash_bwd.cu): bf16 packing, the mma.sync m16n8k16 product, and the
// 64-row tile copy into shared memory. The forward (flash_fwd.cu) is
// built on sm90.cuh's TMA and wgmma instead.
//
// Fragment layouts of mma.sync.m16n8k16 (lane = 4 * g + t):
//   A 16x16 row-major: a0 (row g, cols 2t..2t+1), a1 (row g+8, same),
//                      a2 (row g, cols 2t+8..), a3 (row g+8, cols 2t+8..)
//   B 16x8 "col":      b0 (k rows 2t..2t+1, col g), b1 (k rows 2t+8.., col g)
//   C 16x8 f32:        c0,c1 (row g, cols 2t, 2t+1), c2,c3 (row g+8, same)
// So the C tiles of two adjacent 8-column products are exactly the A
// fragment of one 16-deep chunk: an accumulator is re-packed in
// registers as the next product's A operand (mma_a_from_acc).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace edl {

constexpr int kTile = 64;      // rows of every tile (queries or keys)
constexpr int kThreads = 128;  // 4 warps x 16 rows
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x -> low half
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_raw(__nv_bfloat16 lo,
                                             __nv_bfloat16 hi) {
  uint32_t a = *reinterpret_cast<unsigned short*>(&lo);
  uint32_t b = *reinterpret_cast<unsigned short*>(&hi);
  return a | (b << 16);
}

// D (16x8 f32) += A (16x16 bf16, row) . B (16x8 bf16, col)
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fragment of the 16 rows starting at `rows` (row stride LD), columns
// col0 .. col0 + 15 of a row-major bf16 tile in shared memory.
template <int LD>
__device__ __forceinline__ void mma_a_from_smem(uint32_t* a,
                                                const __nv_bfloat16* rows,
                                                int col0, int g, int t) {
  const __nv_bfloat16* base = rows + col0 + 2 * t;
  a[0] = *reinterpret_cast<const uint32_t*>(base + g * LD);
  a[1] = *reinterpret_cast<const uint32_t*>(base + (g + 8) * LD);
  a[2] = *reinterpret_cast<const uint32_t*>(base + g * LD + 8);
  a[3] = *reinterpret_cast<const uint32_t*>(base + (g + 8) * LD + 8);
}

// A fragment from the f32 accumulators c0 (columns 0..7) and c1
// (columns 8..15) of two adjacent products, rounded to bf16.
__device__ __forceinline__ void mma_a_from_acc(uint32_t* a, const float* c0,
                                               const float* c1) {
  a[0] = pack_f32(c0[0], c0[1]);
  a[1] = pack_f32(c0[2], c0[3]);
  a[2] = pack_f32(c1[0], c1[1]);
  a[3] = pack_f32(c1[2], c1[3]);
}

// B fragment of an n-major tile: B[k][n] = X[n][k], X row-major in shared
// memory (row stride LD) -- e.g. K for Q.K^T. `x` points at X[n0][k0].
template <int LD>
__device__ __forceinline__ void mma_b_nmajor(uint32_t& b0, uint32_t& b1,
                                             const __nv_bfloat16* x, int g,
                                             int t) {
  const __nv_bfloat16* r = x + g * LD + 2 * t;
  b0 = *reinterpret_cast<const uint32_t*>(r);
  b1 = *reinterpret_cast<const uint32_t*>(r + 8);
}

// B fragment of a k-major tile: B[k][n] = X[k][n], X row-major in shared
// memory -- e.g. V for P.V. `x` points at X[k0][n0].
template <int LD>
__device__ __forceinline__ void mma_b_kmajor(uint32_t& b0, uint32_t& b1,
                                             const __nv_bfloat16* x, int g,
                                             int t) {
  const __nv_bfloat16* c = x + (2 * t) * LD + g;
  b0 = pack_raw(c[0], c[LD]);
  b1 = pack_raw(c[8 * LD], c[9 * LD]);
}

// 64 rows x D of a [.., T, .., D] tensor into shared memory (row stride
// LD elements), 16 bytes per thread per step; rows past `valid` are
// zero-filled so no stale bits reach the products.
template <int D, int LD>
__device__ __forceinline__ void load_tile(__nv_bfloat16* s,
                                          const __nv_bfloat16* g,
                                          long long row_stride, int valid) {
  constexpr int kVecPerRow = D / 8;
  for (int i = threadIdx.x; i < kTile * kVecPerRow; i += kThreads) {
    const int r = i / kVecPerRow;
    const int c = (i % kVecPerRow) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid) {
      val = *reinterpret_cast<const uint4*>(g + r * row_stride + c);
    }
    *reinterpret_cast<uint4*>(s + r * LD + c) = val;
  }
}

}  // namespace edl
