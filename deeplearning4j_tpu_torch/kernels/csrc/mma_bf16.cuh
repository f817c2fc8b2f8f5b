// bf16 tensor-core building blocks shared by the flash-attention kernels
// (flash_fwd.cu, flash_bwd.cu): warp-level `mma.sync` m16n8k16 with f32
// accumulators, `ldmatrix` fragment loads from shared memory, 16-byte
// `cp.async` staging with zero-fill, and the register move that turns an
// f32 accumulator tile into a bf16 A operand.
//
// Fragment layouts of mma.sync.m16n8k16.row.col (lane = 4 * g + t,
// g = lane / 4 in 0..7, t = lane % 4 in 0..3):
// - A, 16 x 16 bf16, four 32-bit registers of two values each:
//   a0 = A[g][2t..2t+1], a1 = A[g+8][2t..2t+1],
//   a2 = A[g][2t+8..2t+9], a3 = A[g+8][2t+8..2t+9];
// - B, 16 x 8 bf16, two registers: b0 = B[2t..2t+1][g],
//   b1 = B[2t+8..2t+9][g];
// - C and D, 16 x 8 f32, four registers: c0 = C[g][2t], c1 = C[g][2t+1],
//   c2 = C[g+8][2t], c3 = C[g+8][2t+1].
// So the C tiles of two neighbouring 8-column blocks are, packed to bf16,
// exactly the A fragment of their 16 columns (`c_to_a`): an S = Q.K^T
// result feeds P.V without leaving the registers.
//
// Shared-memory tiles of these kernels are row-major with rows padded by
// 8 elements (16 bytes): the eight 16-byte row addresses of one ldmatrix
// phase then fall in eight different 4-bank groups, so ldmatrix has no
// bank conflicts, and each row start stays 16-byte aligned for cp.async.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace dl4j_mma {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// d += a . b for one m16n8k16 tile (bf16 operands, f32 accumulators)
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8 x 8 b16 matrices; lanes 8i..8i+7 give the row addresses of
// matrix i, and r[i] receives, at lane 4g + t, its row g, columns 2t and
// 2t+1.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(row)));
}

// The same with each matrix transposed: r[i] receives, at lane 4g + t,
// column g, rows 2t and 2t+1. Reads a B operand from a row-major [k][n]
// tile (V in P.V, dO and Q in the backward).
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
      "{%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(row)));
}

// 16 bytes global -> shared without passing through registers; the first
// `src_bytes` (0 or 16 here) are read, the rest of the 16 are zero-filled,
// so rows past a sequence end arrive as zeros. `src` must stay a valid
// address even when nothing is read.
__device__ __forceinline__ void cp_async_16(void* dst, const void* src,
                                            int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// 4 bytes (one f32) the same way; for per-row vectors whose rows are not
// 16-byte aligned in device memory.
__device__ __forceinline__ void cp_async_4(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups of this thread are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// two f32 values rounded to bf16 (nearest even, like astype) in one
// register, `lo` in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The C fragments of columns 16kk..16kk+7 (c_lo) and 16kk+8..16kk+15
// (c_hi) of a 16-row f32 tile, rounded to bf16, as the A fragment of
// those 16 columns.
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4], const float (&c_lo)[4],
                                       const float (&c_hi)[4]) {
  a[0] = pack_bf16(c_lo[0], c_lo[1]);
  a[1] = pack_bf16(c_lo[2], c_lo[3]);
  a[2] = pack_bf16(c_hi[0], c_hi[1]);
  a[3] = pack_bf16(c_hi[2], c_hi[3]);
}

// Rows [t0, t0 + 64) of one head of a BTHD bf16 tensor (rows `tstride`
// elements apart) into a [64][D + 8] shared tile with cp.async, rows at or
// past `len` zero-filled. Call from all `threads` threads of the block.
template <int D, int threads>
__device__ __forceinline__ void cp_tile_64(__nv_bfloat16* dst,
                                           const __nv_bfloat16* src, int t0,
                                           int len, int64_t tstride) {
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  static_assert((64 * kChunks) % threads == 0, "uneven tile copy");
#pragma unroll
  for (int it = 0; it < 64 * kChunks / threads; ++it) {
    const int i = threadIdx.x + it * threads;
    const int r = i / kChunks, c = i % kChunks, t = t0 + r;
    const bool in = t < len;
    cp_async_16(dst + r * (D + 8) + c * 8,
                src + (in ? t : 0) * tstride + c * 8, in ? 16 : 0);
  }
}

}  // namespace dl4j_mma
