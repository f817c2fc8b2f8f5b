// 3xTF32 tensor-core building blocks of the float32 flash-attention
// kernels (flash_fwd.cu, flash_bwd.cu): warp-level `mma.sync` m16n8k8 with
// TF32 operands and f32 accumulators, each f32 operand split in two TF32
// parts, fragment loads from f32 shared tiles, and 16-byte `cp.async`
// staging of f32 rows.
//
// The split: big = cvt.rna.tf32(x), small = cvt.rna.tf32(x - big). x - big
// is exact in f32 and small keeps its top 11 bits, so big + small is x to
// about 2^-22 relative. A product a.b is then small_a.big_b + big_a.small_b
// + big_a.big_b, summed in f32 with the two small cross products first
// (small_a.small_b, about 2^-22 of a.b, is dropped), and each k-step's
// three products are added to the running sum in f32 (`mma_3x`). One
// TF32 product keeps about 2^-11 and misses the f32 gate (1e-4 on the
// gradients) by an order of magnitude; the three meet it with more than
// 10x to spare (tests/test_torch_flash_tf32.py emulates both). The operands must be TF32
// bit patterns made by cvt: given raw f32 bits the tensor core truncates
// the low 13, and neither the rounding nor the split happens.
//
// Fragment layouts of mma.sync.m16n8k8.row.col.f32.tf32.tf32.f32 (lane =
// 4 * g + t, g = lane / 4 in 0..7, t = lane % 4 in 0..3):
// - A, 16 x 8: a0 = A[g][t], a1 = A[g+8][t], a2 = A[g][t+4],
//   a3 = A[g+8][t+4];
// - B, 8 x 8: b0 = B[t][g], b1 = B[t+4][g];
// - C and D, 16 x 8 f32: c0 = C[g][2t], c1 = C[g][2t+1], c2 = C[g+8][2t],
//   c3 = C[g+8][2t+1].
// A thread's accumulator holds columns 2t and 2t+1, its A fragment wants
// t and t+4. A sum does not care about its order, so an accumulator tile
// serves as an A operand over a permuted contraction index (`c_as_a`:
// logical k = t is column 2t, k = t + 4 is column 2t + 1), and the B
// operand that meets it is read with its contraction rows in the same
// order (`frag_b_kn`).
//
// `ldmatrix` moves 16-bit elements, so without `.trans` it reads an f32
// tile as 8 rows of 4 words: lane 4g + t receives word t of row g, which
// is exactly an A fragment (`frag_a`) or a B fragment read from an
// [n][k] tile (`frag_b_nk`). `.trans` would split f32 words, so a B
// operand read from a [k][n] tile (P^T.dO, dS^T.Q, dS.K) takes plain
// 32-bit shared loads.
//
// Shared tiles are row-major f32 with rows padded by 4 floats (LD = W + 4,
// W a multiple of 8, so LD / 4 is odd): the 8 rows x 4 words of an
// ldmatrix phase, and the 4 row pairs x 8 columns of `frag_b_kn`, then
// fall in 32 different banks, and every row starts on 16 bytes for
// cp.async.

#pragma once

#include <stdint.h>

#include "mma_bf16.cuh"

namespace dl4j_tf32 {

using dl4j_mma::cp_async_16;

// x = big + small, both TF32 bit patterns (round to nearest, ties away)
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(big) : "f"(x));
  const float rest = x - __uint_as_float(big);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(small) : "f"(rest));
}

// d += a . b for one m16n8k8 tile, TF32 operands
__device__ __forceinline__ void mma_1688(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d = a . b for one m16n8k8 tile from zero accumulators
__device__ __forceinline__ void mma_1688_zero(float (&d)[4],
                                              const uint32_t (&a)[4],
                                              uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%10, %11, %12, %13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.f), "f"(0.f), "f"(0.f), "f"(0.f));
}

// An A operand split once, for the several B operands it meets
struct FragA {
  uint32_t big[4], small[4];
};

__device__ __forceinline__ void split_a(FragA& a, const float (&x)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) split(x[e], a.big[e], a.small[e]);
}

// d += a . b in 3xTF32; b0, b1 are the f32 B fragment, split here. The
// three products of one k-step go to a fresh tile, which is added to d in
// f32 (round to nearest): the tensor core rounds its own sum toward zero,
// and a chain of hundreds of MMAs into one accumulator (dk, dv and dq sum
// over every visible row) would add up that bias to about 1e-4 of the
// result.
__device__ __forceinline__ void mma_3x(float (&d)[4], const FragA& a,
                                      float b0, float b1) {
  uint32_t bb0, bs0, bb1, bs1;
  split(b0, bb0, bs0);
  split(b1, bb1, bs1);
  float t[4];
  mma_1688_zero(t, a.small, bb0, bb1);
  mma_1688(t, a.big, bs0, bs1);
  mma_1688(t, a.big, bb0, bb1);
#pragma unroll
  for (int e = 0; e < 4; ++e) d[e] += t[e];
}

// Four 8 x 4 f32 matrices by ldmatrix (see the note): lanes 8i..8i+7 give
// the row addresses of matrix i, and r[i] receives, at lane 4g + t, its
// row g, word t.
__device__ __forceinline__ void ldsm_x4(float (&r)[4], const float* row) {
  uint32_t u[4];
  dl4j_mma::ldmatrix_x4(u, row);
#pragma unroll
  for (int e = 0; e < 4; ++e) r[e] = __uint_as_float(u[e]);
}

// The A fragment of rows r0..r0+15, columns k0..k0+7 of a row-major
// [row][k] tile with rows `ld` floats apart, split.
__device__ __forceinline__ void frag_a(FragA& a, const float* tile, int ld,
                                       int r0, int k0) {
  const int lane = threadIdx.x % 32;
  float x[4];
  ldsm_x4(x, tile + (r0 + lane % 8 + ((lane / 8) % 2) * 8) * ld + k0 +
                 (lane / 16) * 4);
  split_a(a, x);
}

// The same A fragment from two row-major planes that already hold the
// TF32 parts of the tile (`big` and `small`, split once by the block): two
// ldmatrix, no conversion.
__device__ __forceinline__ void frag_a_planes(FragA& a, const float* big,
                                              const float* small, int ld,
                                              int r0, int k0) {
  const int lane = threadIdx.x % 32;
  const int off = (r0 + lane % 8 + ((lane / 8) % 2) * 8) * ld + k0 +
                  (lane / 16) * 4;
  dl4j_mma::ldmatrix_x4(a.big, big + off);
  dl4j_mma::ldmatrix_x4(a.small, small + off);
}

// The B fragments of two 8-column tiles, columns n0..n0+7 and
// n0+8..n0+15, at contraction columns k0..k0+7, read from a row-major
// [n][k] tile (B = T^T): b[0], b[1] for the first tile, b[2], b[3] for
// the second.
__device__ __forceinline__ void frag_b_nk(float (&b)[4], const float* tile,
                                          int ld, int n0, int k0) {
  const int lane = threadIdx.x % 32;
  ldsm_x4(b, tile + (n0 + lane % 8 + (lane / 16) * 8) * ld + k0 +
                 ((lane / 8) % 2) * 4);
}

// The B fragment of columns n0..n0+7 at contraction rows k0..k0+7 of a
// row-major [k][n] tile, rows in `c_as_a`'s order: b0 = T[k0+2t][n0+g],
// b1 = T[k0+2t+1][n0+g].
__device__ __forceinline__ void frag_b_kn(float& b0, float& b1,
                                          const float* tile, int ld, int k0,
                                          int n0) {
  const int lane = threadIdx.x % 32;
  const float* p = tile + (k0 + 2 * (lane % 4)) * ld + n0 + lane / 4;
  b0 = p[0];
  b1 = p[ld];
}

// An accumulator tile (c0 = C[g][2t], c1 = C[g][2t+1], c2 = C[g+8][2t],
// c3 = C[g+8][2t+1]) as the split A operand of its 8 columns over the
// permuted contraction index (the note above).
__device__ __forceinline__ void c_as_a(FragA& a, const float (&c)[4]) {
  const float x[4] = {c[0], c[2], c[1], c[3]};
  split_a(a, x);
}

// Rows [t0, t0 + R) of one head of a BTHD f32 tensor whose rows hold d
// floats in device memory into an [R][W + 4] shared tile: columns at or
// past d and rows at or past `len` are zero-filled (zero columns add
// nothing to a product over d; d may exceed W, and then only the first W
// columns are read). With `vec` (every row start 16-byte aligned and d a
// multiple of 4) 16-byte chunks go by cp.async; otherwise element by
// element through registers, which need no cp.async wait. Call from all
// `threads` threads of the block.
template <int W, int threads, int R = 64>
__device__ __forceinline__ void cp_tile_f32(float* dst, const float* src,
                                            int t0, int len, int64_t tstride,
                                            int d, bool vec) {
  constexpr int LD = W + 4;
  if (vec) {
    constexpr int kChunks = W / 4;
    static_assert((R * kChunks) % threads == 0, "uneven tile copy");
#pragma unroll
    for (int it = 0; it < R * kChunks / threads; ++it) {
      const int i = threadIdx.x + it * threads;
      const int r = i / kChunks, c = i % kChunks, t = t0 + r;
      const bool in = t < len && c * 4 < d;
      cp_async_16(dst + r * LD + c * 4, src + (in ? t * tstride + c * 4 : 0),
                  in ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < R * W; i += threads) {
      const int r = i / W, c = i % W, t = t0 + r;
      dst[r * LD + c] = t < len && c < d ? src[t * tstride + c] : 0.f;
    }
  }
}

}  // namespace dl4j_tf32
