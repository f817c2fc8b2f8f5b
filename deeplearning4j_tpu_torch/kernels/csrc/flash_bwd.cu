// Flash-attention backward for Hopper (sm_90a): dk, dv and dq from the
// forward's lse without writing the [tq, tkv] probability matrix to
// device memory.
//
// Replaces the two TPU kernels behind `flash_backward_pallas` in
// deeplearning4j_tpu/pallas/flash_attention.py:
// - `_bwd_dkdv_kernel` (B2): dk, dv for one key block, scanning query
//   blocks (only the window's band when windowed);
// - `_bwd_dq_kernel` (B3): dq for one query block, scanning key blocks.
// Both recompute the tile math of `_bwd_tile`: s = k.q^T * scale,
// p = exp(s - lse), dp = v.do^T, ds = p * (dp - delta) * scale, then
// dv += p^T.do, dk += ds^T.q (B2) and dq += ds.k (B3). delta = sum(out *
// do) comes in f32 from the host wrapper, as in the reference. p is
// rounded to the input dtype before p^T.do and ds (from the unrounded p)
// before ds^T.q and ds.k, where the Pallas tiles round. Masked (q, k)
// pairs give p = 0 explicitly: the Pallas tile relies on
// exp(-1e30 - lse) == 0, which fails for a row whose lse is itself -1e30.
//
// Common to every variant:
// - B2 has one block per (batch*head, 64-key tile) that loops over the
//   64-query tiles from the causal diagonal to the window's far edge; B3
//   one block per (batch*head, 64-query tile) over the key tiles of its
//   band. Each block writes only its own rows, so neither kernel needs
//   atomics across blocks and the gradients are bitwise the same from run
//   to run.
// - Wholly dead tiles are never visited, so work scales with the window,
//   not with t^2. Ragged edges and padded query rows are masked here; the
//   host pads nothing.
//
// B2 bf16 (dtype 1): "mma.sync bf16", on the tensor cores (building
// blocks in mma_bf16.cuh). 4 warps, each owning 16 key rows.
// - At head_dim 64 each warp holds its K and V rows as A fragments in
//   registers. At head_dim 128 the dk and dv accumulators alone take 128
//   registers a thread, so K and V stay in shared memory and their
//   fragments are re-read by ldmatrix per query tile (about an eighth
//   more shared-memory reads), and each 64-query tile is taken in two
//   passes of 32 queries to halve the s and dp registers. The other
//   option, splitting the d columns across a warp pair, would compute
//   s and dp twice.
// - Q, dO, lse and delta tiles stream through a two-stage cp.async ring
//   (rows padded by 16 bytes against ldmatrix bank conflicts; rows past
//   tq zero-filled); the next tile's copy overlaps this tile's math.
// - S^T = K.Q^T and dP^T = V.dO^T by mma.sync, their B operands read
//   from the row-major Q and dO tiles by plain ldmatrix. p^T and ds^T are
//   formed in the f32 accumulators (the mask evaluated only on tiles that
//   cross the diagonal, the window edge or a sequence end), rounded to
//   bf16 in registers and fed straight back as the A operands of
//   dV += P^T.dO and dK += dS^T.Q, whose B operands come from the same
//   tiles by ldmatrix.trans. p and ds never touch shared memory.
//
// B3 bf16 (dtype 1): "mma.sync bf16", B1's query-stationary loop with a
// second product and another last product. 4 warps, each owning 16 query
// rows, with their lse and delta in registers.
// - At head_dim 64 each warp holds its Q and dO rows as A fragments in
//   registers. At head_dim 128 the dq accumulators take 64 registers and
//   s and dp another 64, so Q and dO stay in shared memory and their
//   fragments are re-read by ldmatrix per key tile (a sixth more
//   shared-memory reads: 32 rows of Q and dO against 192 of K and V).
// - K and V tiles stream through a two-stage cp.async ring as in B1.
// - S = Q.K^T and dP = dO.V^T by mma.sync, their B operands read from the
//   row-major K and V tiles by plain ldmatrix. p (0 where masked, the mask
//   evaluated only on edge tiles) and ds = p (dp - delta) scale from the
//   unrounded p are formed in the f32 accumulators; ds is rounded to bf16
//   in registers and fed straight back as the A operand of dQ += dS.K, K
//   read again by ldmatrix.trans. ds never touches shared memory.
//
// B2 and B3 f32 (dtype 0): "mma.sync 3xtf32", the same two loops on the
// tensor cores at f32 accuracy (building blocks in mma_tf32.cuh).
// - Arithmetic. Each of the five products (S^T, dP^T, dV, dK in B2; S,
//   dP, dQ in B3) runs on mma.sync m16n8k8 with TF32 operands: every f32
//   operand x, p and ds included, is split into big = cvt.rna.tf32(x) and
//   small = cvt.rna.tf32(x - big), and a.b is summed in f32 as
//   small_a.big_b + big_a.small_b + big_a.big_b. That keeps about 2^-22
//   of each product, within the f32 gate (1e-4 on the gradients) with
//   more than 10x to spare, where one TF32 product (about 2^-11) misses
//   it by an order of magnitude (tests/test_torch_flash_tf32.py emulates
//   both).
// - The loops are the bf16 kernels': warps of 16 key (B2) or query (B3)
//   rows; Q, dO (B2) or K, V (B3) tiles stream through a two-stage
//   cp.async ring while K, V (B2) or Q, dO (B3) stay in shared memory;
//   the A fragment of the resident rows is read and split once a k-step
//   and meets every B fragment of that step. p and ds stay in registers:
//   an accumulator tile is the A operand of the next product over a
//   permuted contraction index (columns 2t, 2t+1 as k = t, t+4), and
//   the B operand that meets it (dO, Q or K rows) is read by plain 32-bit
//   loads in the same order (ldmatrix.trans cannot transpose 32-bit
//   words). Shared rows are padded by 4 floats, so every fragment load is
//   free of bank conflicts. The k-steps over d are not unrolled (their
//   loads and splits would be hoisted into registers the accumulators
//   need).
// - Widths. A row of up to 128 floats stays whole (exact at 64 and 128,
//   else padded to the next tier up to 128): B2 keeps K and V and a
//   two-stage ring of Q and dO, 6 x 64 rows x (W + 4) floats, 203,776
//   bytes at 128 and 251,904 at the next tier, 160, past the 232,448 a
//   block may use; and B2's dk and dv accumulators take W registers a
//   thread, which at 160 leaves too few of the 255 for s, dp and the split
//   fragments. Up to 64 a block is 4 warps, one a 16-row group, and two
//   blocks share an SM (105,472 bytes each at 64). Above 64 the tiles
//   leave room for one block an SM, so a block is 8 warps: two a 16-row
//   group, each taking half of every tile's queries (B2) or keys (B3),
//   and the two halves' partial dk, dv or dq are added through shared
//   memory once, at the end, in a fixed order (no atomics, bitwise the
//   same run to run). B2 takes its queries in passes of 64 up to 64, of
//   32 up to 96 and of 16 above, to leave registers for the
//   accumulators. Above 128 the "wide" f32 kernels stream d in chunks of
//   64 columns (256 bytes a row) and write slices of 64 output columns
//   (grid z), with the bf16 wide kernels' schedule otherwise.
// - Sums. The tensor core rounds its own sum toward zero, so a chain of
//   hundreds of MMAs into one accumulator biases dk, dv and dq by about
//   1e-4 of their size; each k-step's three products go to a fresh tile
//   that an f32 add puts into the running sum (`mma_3x`). S and dP take
//   fresh tiles too: chained straight into their accumulators they ran
//   4-12 % faster but at 3-5x the error (an emulation of the rounding in
//   tests/test_torch_flash_tf32.py).
// - Bound: the 3xTF32 rate, 495 / 3 = 165 TFLOP/s, the least time the
//   card could take at f32 accuracy (the CUDA cores' 67 TFLOP/s is
//   reported beside it). Left on the table: wgmma and TMA (mma.sync
//   reaches a part of the TF32 peak only), splitting each operand once
//   instead of once a warp that reads it (every warp re-splits the
//   streamed tile's fragments), more than 8 warps an SM above 64, and
//   the causal schedule as below.
//
// Every head_dim the reference takes runs, by the route the Python launch
// plan chose (`launch_plan` in kernels/flash_attention.py):
// - exact (d 64 or 128): the kernels above and below, unpadded;
// - tier (bf16 any other d up to 256, f32 up to 128): the tensor-core
//   kernels compiled for the next width of DL4J_MMA_TIERS, rows
//   zero-padded to it in shared memory, padded columns never stored, rows
//   that are not 16-byte aligned copied element by element. Above 128,
//   the bf16 B2's dk and dv accumulators would take the tier's width in
//   registers a thread, so each B2 block writes one of two column slices
//   (grid z) and recomputes S^T and dP^T over the whole d (1.5x B2's
//   products); B3 takes each key tile in passes of 32 keys to shrink its
//   s and dp registers (at 256 ptxas spills a few bytes of B2 and B3;
//   passes of 16, which spill none, ran 8-10 % slower);
// - wide (bf16 above 256, f32 above 128): the tensor-core kernels with d
//   streamed in chunks of 64 columns for S and dP (two-stage cp.async
//   rings) and the output in slices of 128 columns (bf16) or 64 (f32)
//   on grid z, recomputing S and dP over the whole d for each slice. B2
//   takes query tiles of 32 rows there: the bf16 kernel's 128 dk and dv
//   accumulator floats a thread leave room for the s and dp of 32
//   queries, not 64.
// Every kernel puts batch*head on grid x (up to 2^31 - 1).
//
// Bound on an H100: B2 does 8*b*h*d*sum(visible keys) FLOPs (s, dp, dv,
// dk), B3 6*b*h*d*sum(visible) (s, dp, dq), against 989 TFLOP/s (bf16)
// or 165 TFLOP/s (f32 as 3xTF32); both read q, k, v, do once in the input
// dtype and lse, delta in f32, and write their outputs in f32, against
// 3.35 TB/s. Left on the table: wgmma, TMA and warp specialisation, and a
// schedule that balances the causal key tiles across the 132 SMs.
//
// C entry points `dl4j_flash_bwd_dkdv` and `dl4j_flash_bwd_dq` (loaded
// with ctypes) return the CUDA error code of the launch (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"
#include "mma_tf32.cuh"
#include "smem_attr.cuh"

namespace {

constexpr int kBQ = 64;        // query rows per tile
constexpr int kBK = 64;        // keys per tile

struct Args {
  const void *q, *k, *v, *dout, *lse, *delta;
  int batch, heads, tq, tkv, d, vec, causal, window;
  float scale;
  cudaStream_t stream;
};

// ---------------------------------------------------------------------------
// B2 bf16 tensor-core variant
// ---------------------------------------------------------------------------
using bf16 = __nv_bfloat16;
constexpr int kMmaThreads = 128;  // 4 warps x 16 key rows

template <int D>
constexpr size_t dkdv_mma_smem_bytes() {
  // K, V [64][D+8] and Q, dO [2 stages][64][D+8] in bf16; lse and delta
  // [2 stages][64] in f32
  return (size_t)6 * 64 * (D + 8) * sizeof(bf16) +
         (size_t)2 * 2 * kBQ * sizeof(float);
}

// D: the width rows take in shared memory; DS: the dk/dv columns a block
// writes (D, or D/2 above 128: slice blockIdx.z). kPad: rows hold d <= D
// elements in device memory (a padded tier); without it d == D.
template <int D, int DS, bool kPad>
__global__ void __launch_bounds__(kMmaThreads)
flash_bwd_dkdv_mma_kernel(const bf16* __restrict__ q,
                          const bf16* __restrict__ k,
                          const bf16* __restrict__ v,
                          const bf16* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          float* __restrict__ dk, float* __restrict__ dv,
                          int heads, int tq, int tkv, int d, int vec,
                          int causal, int window, float scale) {
  using namespace dl4j_mma;
  constexpr int LD = D + 8;   // padded shared row, elements
  constexpr int KC = D / 16;  // k-steps over d of S^T and dP^T
  constexpr int NO = DS / 8;  // 8-wide column tiles of this block's dk, dv
  // up to 64: K and V fragments live in registers and a query tile is one
  // pass; above: they are re-read from shared memory and a query tile
  // takes two passes of 32 (see the note at the top)
  constexpr bool kKVRegs = D <= 64;
  constexpr int QS = D <= 64 ? 64 : 32;  // query columns per pass
  constexpr int NS = QS / 8;             // 8-query column tiles of S^T
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);  // [64][LD]
  bf16* Vs = Ks + kBK * LD;                      // [64][LD]
  bf16* Qs = Vs + kBK * LD;                      // [2][64][LD]
  bf16* dOs = Qs + 2 * kBQ * LD;                 // [2][64][LD]
  float* lse_s = reinterpret_cast<float*>(dOs + 2 * kBQ * LD);  // [2][64]
  float* delta_s = lse_s + 2 * kBQ;                             // [2][64]

  const int bh = blockIdx.x;
  const int b = bh / heads, h = bh % heads;
  const int k0 = blockIdx.y * kBK;  // causal: the heaviest tiles come first
  const int c0 = DS == D ? 0 : blockIdx.z * DS;  // this block's columns
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int dh = kPad ? d : D;  // elements a row in device memory
  const int64_t tstride = (int64_t)heads * dh;
  const int64_t qoff = ((int64_t)b * tq * heads + h) * dh;
  const int64_t koff = ((int64_t)b * tkv * heads + h) * dh;
  const float* lse_b = lse + (int64_t)bh * tq;
  const float* delta_b = delta + (int64_t)bh * tq;
  auto load = [&](bf16* dst, const bf16* src, int t0, int len) {
    if constexpr (kPad)
      cp_tile_pad<D, kMmaThreads>(dst, src, t0, len, tstride, d, vec);
    else
      cp_tile_64<D, kMmaThreads>(dst, src, t0, len, tstride);
  };

  // query tiles that can see this key tile, as in the f32 kernel
  int q_lo = 0, q_hi = tq;
  if (causal) q_lo = k0;
  if (window > 0) q_hi = min(tq, k0 + kBK - 1 + window);
  const int qt_lo = q_lo / kBQ, qt_hi = (q_hi + kBQ - 1) / kBQ;

  // one stage of the ring: Q, dO, lse and delta of query tile qt
  auto load_q_tile = [&](int qt, int stage) {
    const int q0 = qt * kBQ;
    load(Qs + stage * kBQ * LD, q + qoff, q0, tq);
    load(dOs + stage * kBQ * LD, dout + qoff, q0, tq);
    const int i = threadIdx.x % kBQ, t = q0 + i;
    const float* src = threadIdx.x < kBQ ? lse_b : delta_b;
    float* dst = (threadIdx.x < kBQ ? lse_s : delta_s) + stage * kBQ + i;
    cp_async_4(dst, src + (t < tq ? t : 0), t < tq ? 4 : 0);
  };

  load(Ks, k + koff, k0, tkv);
  load(Vs, v + koff, k0, tkv);
  if (qt_lo < qt_hi) load_q_tile(qt_lo, 0);
  cp_async_commit();

  // ldmatrix row of this warp's K and V A fragments
  const int arow = (warp * 16 + lane % 16) * LD + (lane / 16) * 8;
  uint32_t kf[kKVRegs ? KC : 1][4], vf[kKVRegs ? KC : 1][4];
  float dk_acc[NO][4], dv_acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  for (int qt = qt_lo; qt < qt_hi; ++qt) {
    const int stage = (qt - qt_lo) & 1;
    if (qt + 1 < qt_hi) load_q_tile(qt + 1, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // this tile (and K, V) have landed
    __syncthreads();
    if constexpr (kKVRegs) {
      if (qt == qt_lo) {
#pragma unroll
        for (int kc = 0; kc < KC; ++kc) {
          ldmatrix_x4(kf[kc], Ks + arow + kc * 16);
          ldmatrix_x4(vf[kc], Vs + arow + kc * 16);
        }
      }
    }
    const bf16* Qt = Qs + stage * kBQ * LD;
    const bf16* dOt = dOs + stage * kBQ * LD;
    const float* lse_t = lse_s + stage * kBQ;
    const float* delta_t = delta_s + stage * kBQ;
    const int q0 = qt * kBQ;
    const bool edge = q0 + kBQ > tq || k0 + kBK > tkv ||
                      (causal && k0 + kBK - 1 > q0) ||
                      (window > 0 && q0 + kBQ - 1 - k0 >= window);

    // one pass at a time: unrolled, the two passes at head_dim 128 would
    // overlap and spill
#pragma unroll 1
    for (int qs = 0; qs < kBQ; qs += QS) {
      // S^T = K.Q^T and dP^T = V.dO^T; Q and dO rows are the B operands'
      // columns (plain ldmatrix)
      float s[NS][4], dp[NS][4];
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        uint32_t ka[4], va[4];
        if constexpr (kKVRegs) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            ka[e] = kf[kc][e];
            va[e] = vf[kc][e];
          }
        } else {
          ldmatrix_x4(ka, Ks + arow + kc * 16);
          ldmatrix_x4(va, Vs + arow + kc * 16);
        }
#pragma unroll
        for (int jp = 0; jp < NS / 2; ++jp) {
          const int off = (qs + jp * 16 + lane % 8 + (lane / 16) * 8) * LD +
                          kc * 16 + ((lane / 8) % 2) * 8;
          uint32_t bq[4], bo[4];
          ldmatrix_x4(bq, Qt + off);
          mma_16816(s[2 * jp], ka, bq[0], bq[1]);
          mma_16816(s[2 * jp + 1], ka, bq[2], bq[3]);
          ldmatrix_x4(bo, dOt + off);
          mma_16816(dp[2 * jp], va, bo[0], bo[1]);
          mma_16816(dp[2 * jp + 1], va, bo[2], bo[3]);
        }
      }

      // p^T = exp(s.scale - lse), 0 where masked; ds^T = p^T (dp^T -
      // delta) scale from the unrounded p
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qc = qs + j * 8 + 2 * t4 + e % 2;  // column in the tile
          float p = expf(s[j][e] * scale - lse_t[qc]);
          if (edge) {
            const int qi = q0 + qc, kj = k0 + warp * 16 + g + (e / 2) * 8;
            bool keep = qi < tq && kj < tkv;
            if (causal) keep = keep && qi >= kj;
            if (window > 0) keep = keep && qi - kj < window;
            p = keep ? p : 0.f;
          }
          dp[j][e] = p * (dp[j][e] - delta_t[qc]) * scale;
          s[j][e] = p;
        }

      // dV += P^T.dO and dK += dS^T.Q: A operands (rounded to bf16) from
      // the registers above, B operands by ldmatrix.trans
#pragma unroll
      for (int kk = 0; kk < NS / 2; ++kk) {
        uint32_t pa[4], da[4];
        c_to_a(pa, s[2 * kk], s[2 * kk + 1]);
        c_to_a(da, dp[2 * kk], dp[2 * kk + 1]);
        const int row =
            (qs + kk * 16 + lane % 8 + ((lane / 8) % 2) * 8) * LD + c0;
#pragma unroll
        for (int np = 0; np < NO / 2; ++np) {
          const int off = row + np * 16 + (lane / 16) * 8;
          uint32_t bo[4], bq[4];
          ldmatrix_x4_trans(bo, dOt + off);
          mma_16816(dv_acc[2 * np], pa, bo[0], bo[1]);
          mma_16816(dv_acc[2 * np + 1], pa, bo[2], bo[3]);
          ldmatrix_x4_trans(bq, Qt + off);
          mma_16816(dk_acc[2 * np], da, bq[0], bq[1]);
          mma_16816(dk_acc[2 * np + 1], da, bq[2], bq[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with this stage
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = k0 + warp * 16 + g + i * 8;
    if (t < tkv) {
      const int64_t row = koff + t * tstride + c0 + 2 * t4;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        if constexpr (kPad) {  // padded columns are not stored
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            if (c0 + n * 8 + 2 * t4 + j < d) {
              dk[row + n * 8 + j] = dk_acc[n][2 * i + j];
              dv[row + n * 8 + j] = dv_acc[n][2 * i + j];
            }
          }
        } else {
          *reinterpret_cast<float2*>(dk + row + n * 8) =
              make_float2(dk_acc[n][2 * i], dk_acc[n][2 * i + 1]);
          *reinterpret_cast<float2*>(dv + row + n * 8) =
              make_float2(dv_acc[n][2 * i], dv_acc[n][2 * i + 1]);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// B3 bf16 tensor-core variant
// ---------------------------------------------------------------------------
template <int D>
constexpr size_t dq_mma_smem_bytes() {
  // Q, dO [64][D+8] and K, V [2 stages][64][D+8], bf16
  return (size_t)6 * 64 * (D + 8) * sizeof(bf16);
}

// D: the width rows take in shared memory. kPad: rows hold d <= D
// elements in device memory (a padded tier); without it d == D.
template <int D, bool kPad>
__global__ void __launch_bounds__(kMmaThreads)
flash_bwd_dq_mma_kernel(const bf16* __restrict__ q,
                        const bf16* __restrict__ k,
                        const bf16* __restrict__ v,
                        const bf16* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        float* __restrict__ dq, int heads, int tq, int tkv,
                        int d, int vec, int causal, int window, float scale) {
  using namespace dl4j_mma;
  constexpr int LD = D + 8;    // padded shared row, elements
  constexpr int KC = D / 16;   // k-steps over d of S and dP
  // keys a pass: above 128 the dq accumulators take D/2 registers, so a
  // key tile is taken in passes of 32 to shrink s and dp
  constexpr int KS = D <= 128 ? kBK : 32;
  constexpr int NS = KS / 8;   // 8-key column tiles of S and dP a pass
  constexpr int NO = D / 8;    // 8-wide column tiles of dq
  // up to 64: the warp's Q and dO fragments live in registers; above: the
  // dq accumulators take D/2 registers, so the fragments are re-read from
  // shared memory per key tile (see the note at the top)
  constexpr bool kQRegs = D <= 64;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [64][LD]
  bf16* dOs = Qs + kBQ * LD;                     // [64][LD]
  bf16* Ks = dOs + kBQ * LD;                     // [2][64][LD]
  bf16* Vs = Ks + 2 * kBK * LD;                  // [2][64][LD]

  const int bh = blockIdx.x;
  const int b = bh / heads, h = bh % heads;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // heavy tiles first
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int dh = kPad ? d : D;  // elements a row in device memory
  const int64_t tstride = (int64_t)heads * dh;
  const int64_t qoff = ((int64_t)b * tq * heads + h) * dh;
  const int64_t koff = ((int64_t)b * tkv * heads + h) * dh;
  auto load = [&](bf16* dst, const bf16* src, int t0, int len) {
    if constexpr (kPad)
      cp_tile_pad<D, kMmaThreads>(dst, src, t0, len, tstride, d, vec);
    else
      cp_tile_64<D, kMmaThreads>(dst, src, t0, len, tstride);
  };

  // the key tiles this query tile can see, as in the forward
  int k_lo = 0, k_hi = tkv;
  if (causal) k_hi = min(tkv, q0 + kBQ);
  if (window > 0) k_lo = max(0, q0 - window + 1);
  const int kt_lo = k_lo / kBK, kt_hi = (k_hi + kBK - 1) / kBK;

  load(Qs, q + qoff, q0, tq);
  load(dOs, dout + qoff, q0, tq);
  load(Ks, k + koff, kt_lo * kBK, tkv);
  load(Vs, v + koff, kt_lo * kBK, tkv);
  cp_async_commit();

  // this thread's rows of the warp's 16: r0 = q0 + 16*warp + g, r0 + 8;
  // rows past tq read lse = delta = 0 and are masked and never written
  const int r0 = q0 + warp * 16 + g;
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + i * 8;
    lse_r[i] = r < tq ? lse[(int64_t)bh * tq + r] : 0.f;
    delta_r[i] = r < tq ? delta[(int64_t)bh * tq + r] : 0.f;
  }

  // ldmatrix row of this warp's Q and dO A fragments
  const int arow = (warp * 16 + lane % 16) * LD + (lane / 16) * 8;
  uint32_t qf[kQRegs ? KC : 1][4], of[kQRegs ? KC : 1][4];
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int stage = (kt - kt_lo) & 1;
    if (kt + 1 < kt_hi) {  // prefetch the next tile into the other stage
      const int next = (stage ^ 1) * kBK * LD;
      load(Ks + next, k + koff, (kt + 1) * kBK, tkv);
      load(Vs + next, v + koff, (kt + 1) * kBK, tkv);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this tile (and Q, dO) have landed
    __syncthreads();
    if constexpr (kQRegs) {
      if (kt == kt_lo) {
#pragma unroll
        for (int kc = 0; kc < KC; ++kc) {
          ldmatrix_x4(qf[kc], Qs + arow + kc * 16);
          ldmatrix_x4(of[kc], dOs + arow + kc * 16);
        }
      }
    }
    const bf16* Kt = Ks + stage * kBK * LD;
    const bf16* Vt = Vs + stage * kBK * LD;
    const int k0 = kt * kBK;
    const bool edge = q0 + kBQ > tq || k0 + kBK > tkv ||
                      (causal && k0 + kBK - 1 > q0) ||
                      (window > 0 && q0 + kBQ - 1 - k0 >= window);

    // one pass at a time (a single pass up to 128): unrolled, two passes
    // would overlap and spill
#pragma unroll 1
    for (int ks = 0; ks < kBK; ks += KS) {
      // S = Q.K^T and dP = dO.V^T over keys ks..ks+KS-1: K and V rows are
      // the B operands' columns (plain ldmatrix)
      float s[NS][4], dp[NS][4];
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        uint32_t qa[4], oa[4];
        if constexpr (kQRegs) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            qa[e] = qf[kc][e];
            oa[e] = of[kc][e];
          }
        } else {
          ldmatrix_x4(qa, Qs + arow + kc * 16);
          ldmatrix_x4(oa, dOs + arow + kc * 16);
        }
#pragma unroll
        for (int jp = 0; jp < NS / 2; ++jp) {
          const int off = (ks + jp * 16 + lane % 8 + (lane / 16) * 8) * LD +
                          kc * 16 + ((lane / 8) % 2) * 8;
          uint32_t bk[4], bv[4];
          ldmatrix_x4(bk, Kt + off);
          mma_16816(s[2 * jp], qa, bk[0], bk[1]);
          mma_16816(s[2 * jp + 1], qa, bk[2], bk[3]);
          ldmatrix_x4(bv, Vt + off);
          mma_16816(dp[2 * jp], oa, bv[0], bv[1]);
          mma_16816(dp[2 * jp + 1], oa, bv[2], bv[3]);
        }
      }

      // p = exp(s.scale - lse), 0 where masked (evaluated only on tiles
      // that cross the diagonal, the window edge or a sequence end); ds =
      // p (dp - delta) scale from the unrounded p
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e / 2;
          float p = expf(s[j][e] * scale - lse_r[i]);
          if (edge) {
            const int qi = r0 + i * 8;
            const int kj = k0 + ks + j * 8 + 2 * t4 + e % 2;
            bool keep = qi < tq && kj < tkv;
            if (causal) keep = keep && qi >= kj;
            if (window > 0) keep = keep && qi - kj < window;
            p = keep ? p : 0.f;
          }
          dp[j][e] = p * (dp[j][e] - delta_r[i]) * scale;
        }

      // dQ += dS.K: dS (rounded to bf16) from the registers above, K by
      // ldmatrix.trans
#pragma unroll
      for (int kk = 0; kk < NS / 2; ++kk) {
        uint32_t da[4];
        c_to_a(da, dp[2 * kk], dp[2 * kk + 1]);
        const int row =
            (ks + kk * 16 + lane % 8 + ((lane / 8) % 2) * 8) * LD;
#pragma unroll
        for (int np = 0; np < NO / 2; ++np) {
          uint32_t bk[4];
          ldmatrix_x4_trans(bk, Kt + row + np * 16 + (lane / 16) * 8);
          mma_16816(acc[2 * np], da, bk[0], bk[1]);
          mma_16816(acc[2 * np + 1], da, bk[2], bk[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with this stage
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + i * 8;
    if (r < tq) {
      float* row = dq + qoff + r * tstride + 2 * t4;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        if constexpr (kPad) {  // padded columns are not stored
#pragma unroll
          for (int j = 0; j < 2; ++j)
            if (n * 8 + 2 * t4 + j < d) row[n * 8 + j] = acc[n][2 * i + j];
        } else {
          *reinterpret_cast<float2*>(row + n * 8) =
              make_float2(acc[n][2 * i], acc[n][2 * i + 1]);
        }
      }
    }
  }
}

template <int D, bool kPad>
int launch_dq_mma(const Args& a, void* dq) {
  if (a.d > D || (!kPad && a.d != D)) return (int)cudaErrorInvalidValue;
  const size_t bytes = dq_mma_smem_bytes<D>();
  cudaError_t err = dl4j_smem::set_max_dynamic_smem(
      reinterpret_cast<const void*>(flash_bwd_dq_mma_kernel<D, kPad>),
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(a.batch * a.heads, (a.tq + kBQ - 1) / kBQ);
  flash_bwd_dq_mma_kernel<D, kPad><<<grid, kMmaThreads, bytes, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<float*>(dq), a.heads, a.tq, a.tkv, a.d, a.vec, a.causal,
      a.window, a.scale);
  return (int)cudaGetLastError();
}

// DS: dk/dv columns a block; the grid's z takes ceil(d / DS) slices
template <int D, int DS, bool kPad>
int launch_dkdv_mma(const Args& a, void* dk, void* dv) {
  if (a.d > D || (!kPad && a.d != D)) return (int)cudaErrorInvalidValue;
  const size_t bytes = dkdv_mma_smem_bytes<D>();
  cudaError_t err = dl4j_smem::set_max_dynamic_smem(
      reinterpret_cast<const void*>(flash_bwd_dkdv_mma_kernel<D, DS, kPad>),
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(a.batch * a.heads, (a.tkv + kBK - 1) / kBK,
                  (a.d + DS - 1) / DS);
  flash_bwd_dkdv_mma_kernel<D, DS, kPad>
      <<<grid, kMmaThreads, bytes, a.stream>>>(
          static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
          static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout),
          static_cast<const float*>(a.lse),
          static_cast<const float*>(a.delta), static_cast<float*>(dk),
          static_cast<float*>(dv), a.heads, a.tq, a.tkv, a.d, a.vec,
          a.causal, a.window, a.scale);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// B2 and B3 bf16 above 256: the tensor-core kernels with d streamed in
// chunks
// ---------------------------------------------------------------------------
constexpr int kWC = 64;   // columns of a (key or query) tile a chunk
constexpr int kWS = 128;  // output columns a block (grid z)
constexpr int kWQ = 32;   // query rows a B2 step (see the note at the top)

constexpr size_t dkdv_wide_smem_bytes() {
  // K, V [2 stages][64][kWC+8] and Q, dO [2 stages][32][kWC+8] chunks;
  // the Q and dO slices [32][kWS+8], bf16; lse and delta [32] f32
  return ((size_t)2 * (2 * kBK + 2 * kWQ) * (kWC + 8) +
          (size_t)2 * kWQ * (kWS + 8)) * sizeof(bf16) +
         (size_t)2 * kWQ * sizeof(float);
}

// One block per (batch*head, 64-key tile, 128-column slice of dk and
// dv); 4 warps of 16 key rows, as the tier kernel. Query tiles of 32 rows
// (the 128 dk and dv accumulator floats a thread leave room for the s
// and dp of 32 queries, not 64); each tile's S^T = K.Q^T and dP^T =
// V.dO^T are summed over d in chunks of 64 columns of K, V, Q and dO,
// which stream through a two-stage cp.async ring; the tile's Q and dO
// slices, lse and delta arrive with its first chunk.
__global__ void __launch_bounds__(kMmaThreads)
flash_bwd_dkdv_wide_kernel(const bf16* __restrict__ q,
                           const bf16* __restrict__ k,
                           const bf16* __restrict__ v,
                           const bf16* __restrict__ dout,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           float* __restrict__ dk, float* __restrict__ dv,
                           int heads, int tq, int tkv, int d, int vec,
                           int causal, int window, float scale) {
  using namespace dl4j_mma;
  constexpr int LC = kWC + 8, LS = kWS + 8;  // padded shared rows
  constexpr int KC = kWC / 16;               // k-steps a chunk
  constexpr int NS = kWQ / 8;                // 8-query column tiles of S^T
  constexpr int NO = kWS / 8;                // 8-wide column tiles of dk, dv
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Kc = reinterpret_cast<bf16*>(smem_raw);  // [2][64][LC]
  bf16* Vc = Kc + 2 * kBK * LC;                  // [2][64][LC]
  bf16* Qc = Vc + 2 * kBK * LC;                  // [2][32][LC]
  bf16* dOc = Qc + 2 * kWQ * LC;                 // [2][32][LC]
  bf16* Qsl = dOc + 2 * kWQ * LC;                // [32][LS]
  bf16* dOsl = Qsl + kWQ * LS;                   // [32][LS]
  float* lse_s = reinterpret_cast<float*>(dOsl + kWQ * LS);  // [32]
  float* delta_s = lse_s + kWQ;                              // [32]

  const int bh = blockIdx.x;
  const int b = bh / heads, h = bh % heads;
  const int k0 = blockIdx.y * kBK;  // causal: the heaviest tiles come first
  const int c0 = blockIdx.z * kWS;  // this block's dk and dv columns
  const int nch = (d + kWC - 1) / kWC;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int64_t tstride = (int64_t)heads * d;
  const int64_t qoff = ((int64_t)b * tq * heads + h) * d;
  const int64_t koff = ((int64_t)b * tkv * heads + h) * d;
  const float* lse_b = lse + (int64_t)bh * tq;
  const float* delta_b = delta + (int64_t)bh * tq;

  int q_lo = 0, q_hi = tq;
  if (causal) q_lo = k0;
  if (window > 0) q_hi = min(tq, k0 + kBK - 1 + window);
  const int qt_lo = q_lo / kWQ, qt_hi = (q_hi + kWQ - 1) / kWQ;
  const int steps = max(qt_hi - qt_lo, 0) * nch;

  // step i: chunk i % nch of query tile qt_lo + i / nch, into stage i % 2
  auto load_step = [&](int i) {
    const int c = (i % nch) * kWC, st = i & 1;
    const int q0 = (qt_lo + i / nch) * kWQ;
    cp_tile_pad<kWC, kMmaThreads>(Kc + st * kBK * LC, k + koff + c, k0, tkv,
                                  tstride, d - c, vec);
    cp_tile_pad<kWC, kMmaThreads>(Vc + st * kBK * LC, v + koff + c, k0, tkv,
                                  tstride, d - c, vec);
    cp_tile_pad<kWC, kMmaThreads, kWQ>(Qc + st * kWQ * LC, q + qoff + c, q0,
                                       tq, tstride, d - c, vec);
    cp_tile_pad<kWC, kMmaThreads, kWQ>(dOc + st * kWQ * LC,
                                       dout + qoff + c, q0, tq, tstride,
                                       d - c, vec);
  };
  if (steps > 0) load_step(0);
  cp_async_commit();

  const int arow = (warp * 16 + lane % 16) * LC + (lane / 16) * 8;
  float dk_acc[NO][4], dv_acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;
  float s[NS][4], dp[NS][4];

  for (int i = 0; i < steps; ++i) {
    const int ch = i % nch, st = i & 1;
    const int q0 = (qt_lo + i / nch) * kWQ;
    if (ch == 0) {
      // the previous tile's products are done (the barrier closing each
      // step): this tile's Q and dO slices, lse and delta
      cp_tile_pad<kWS, kMmaThreads, kWQ>(Qsl, q + qoff + c0, q0, tq, tstride,
                                         d - c0, vec);
      cp_tile_pad<kWS, kMmaThreads, kWQ>(dOsl, dout + qoff + c0, q0, tq,
                                         tstride, d - c0, vec);
      if (threadIdx.x < 2 * kWQ) {
        const int r = threadIdx.x % kWQ, t = q0 + r;
        const float* src = threadIdx.x < kWQ ? lse_b : delta_b;
        float* dst = (threadIdx.x < kWQ ? lse_s : delta_s) + r;
        cp_async_4(dst, src + (t < tq ? t : 0), t < tq ? 4 : 0);
      }
      cp_async_commit();
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    }
    if (i + 1 < steps) load_step(i + 1);
    cp_async_commit();
    cp_async_wait<1>();  // all but the prefetch have landed
    __syncthreads();

    const bf16* Kt = Kc + st * kBK * LC;
    const bf16* Vt = Vc + st * kBK * LC;
    const bf16* Qt = Qc + st * kWQ * LC;
    const bf16* dOt = dOc + st * kWQ * LC;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      uint32_t ka[4], va[4];
      ldmatrix_x4(ka, Kt + arow + kc * 16);
      ldmatrix_x4(va, Vt + arow + kc * 16);
#pragma unroll
      for (int jp = 0; jp < NS / 2; ++jp) {
        const int off = (jp * 16 + lane % 8 + (lane / 16) * 8) * LC +
                        kc * 16 + ((lane / 8) % 2) * 8;
        uint32_t bq[4], bo[4];
        ldmatrix_x4(bq, Qt + off);
        mma_16816(s[2 * jp], ka, bq[0], bq[1]);
        mma_16816(s[2 * jp + 1], ka, bq[2], bq[3]);
        ldmatrix_x4(bo, dOt + off);
        mma_16816(dp[2 * jp], va, bo[0], bo[1]);
        mma_16816(dp[2 * jp + 1], va, bo[2], bo[3]);
      }
    }

    if (ch == nch - 1) {  // S^T and dP^T are whole: p^T, ds^T, products
      const bool edge = q0 + kWQ > tq || k0 + kBK > tkv ||
                        (causal && k0 + kBK - 1 > q0) ||
                        (window > 0 && q0 + kWQ - 1 - k0 >= window);
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qc = j * 8 + 2 * t4 + e % 2;  // column in the tile
          float p = expf(s[j][e] * scale - lse_s[qc]);
          if (edge) {
            const int qi = q0 + qc, kj = k0 + warp * 16 + g + (e / 2) * 8;
            bool keep = qi < tq && kj < tkv;
            if (causal) keep = keep && qi >= kj;
            if (window > 0) keep = keep && qi - kj < window;
            p = keep ? p : 0.f;
          }
          dp[j][e] = p * (dp[j][e] - delta_s[qc]) * scale;
          s[j][e] = p;
        }
#pragma unroll
      for (int kk = 0; kk < NS / 2; ++kk) {
        uint32_t pa[4], da[4];
        c_to_a(pa, s[2 * kk], s[2 * kk + 1]);
        c_to_a(da, dp[2 * kk], dp[2 * kk + 1]);
        const int row = (kk * 16 + lane % 8 + ((lane / 8) % 2) * 8) * LS;
#pragma unroll
        for (int np = 0; np < NO / 2; ++np) {
          const int off = row + np * 16 + (lane / 16) * 8;
          uint32_t bo[4], bq[4];
          ldmatrix_x4_trans(bo, dOsl + off);
          mma_16816(dv_acc[2 * np], pa, bo[0], bo[1]);
          mma_16816(dv_acc[2 * np + 1], pa, bo[2], bo[3]);
          ldmatrix_x4_trans(bq, Qsl + off);
          mma_16816(dk_acc[2 * np], da, bq[0], bq[1]);
          mma_16816(dk_acc[2 * np + 1], da, bq[2], bq[3]);
        }
      }
    }
    __syncthreads();  // this stage, and at a tile's end the slices, are free
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = k0 + warp * 16 + g + i * 8;
    if (t < tkv) {
      const int64_t row = koff + t * tstride;
#pragma unroll
      for (int n = 0; n < NO; ++n)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int col = c0 + n * 8 + 2 * t4 + j;
          if (col < d) {
            dk[row + col] = dk_acc[n][2 * i + j];
            dv[row + col] = dv_acc[n][2 * i + j];
          }
        }
    }
  }
}

constexpr size_t dq_wide_smem_bytes() {
  // Q, dO, K, V chunks [2 stages][64][kWC+8] and the K slice [64][kWS+8]
  return ((size_t)8 * 64 * (kWC + 8) + (size_t)64 * (kWS + 8)) * sizeof(bf16);
}

// One block per (batch*head, 64-query tile, 128-column slice of dq); 4
// warps of 16 query rows with their lse and delta in registers, as the
// tier kernel. Each key tile's S = Q.K^T and dP = dO.V^T are summed over
// d in chunks of 64 columns of Q, dO, K and V, which stream through a
// two-stage cp.async ring; the tile's K slice arrives with its first
// chunk.
__global__ void __launch_bounds__(kMmaThreads)
flash_bwd_dq_wide_kernel(const bf16* __restrict__ q,
                         const bf16* __restrict__ k,
                         const bf16* __restrict__ v,
                         const bf16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         float* __restrict__ dq, int heads, int tq, int tkv,
                         int d, int vec, int causal, int window,
                         float scale) {
  using namespace dl4j_mma;
  constexpr int LC = kWC + 8, LS = kWS + 8;  // padded shared rows
  constexpr int KC = kWC / 16;               // k-steps a chunk
  constexpr int NS = kBK / 8;                // 8-key column tiles of S, dP
  constexpr int NO = kWS / 8;                // 8-wide column tiles of dq
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qc = reinterpret_cast<bf16*>(smem_raw);  // [2][64][LC]
  bf16* dOc = Qc + 2 * kBQ * LC;                 // [2][64][LC]
  bf16* Kc = dOc + 2 * kBQ * LC;                 // [2][64][LC]
  bf16* Vc = Kc + 2 * kBK * LC;                  // [2][64][LC]
  bf16* Ksl = Vc + 2 * kBK * LC;                 // [64][LS]

  const int bh = blockIdx.x;
  const int b = bh / heads, h = bh % heads;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // heavy tiles first
  const int c0 = blockIdx.z * kWS;  // this block's dq columns
  const int nch = (d + kWC - 1) / kWC;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int64_t tstride = (int64_t)heads * d;
  const int64_t qoff = ((int64_t)b * tq * heads + h) * d;
  const int64_t koff = ((int64_t)b * tkv * heads + h) * d;

  int k_lo = 0, k_hi = tkv;
  if (causal) k_hi = min(tkv, q0 + kBQ);
  if (window > 0) k_lo = max(0, q0 - window + 1);
  const int kt_lo = k_lo / kBK, kt_hi = (k_hi + kBK - 1) / kBK;
  const int steps = (kt_hi - kt_lo) * nch;

  // step i: chunk i % nch of key tile kt_lo + i / nch, into stage i % 2
  auto load_step = [&](int i) {
    const int c = (i % nch) * kWC, st = i & 1;
    const int k0 = (kt_lo + i / nch) * kBK;
    cp_tile_pad<kWC, kMmaThreads>(Qc + st * kBQ * LC, q + qoff + c, q0, tq,
                                  tstride, d - c, vec);
    cp_tile_pad<kWC, kMmaThreads>(dOc + st * kBQ * LC, dout + qoff + c, q0,
                                  tq, tstride, d - c, vec);
    cp_tile_pad<kWC, kMmaThreads>(Kc + st * kBK * LC, k + koff + c, k0, tkv,
                                  tstride, d - c, vec);
    cp_tile_pad<kWC, kMmaThreads>(Vc + st * kBK * LC, v + koff + c, k0, tkv,
                                  tstride, d - c, vec);
  };
  load_step(0);
  cp_async_commit();

  // rows past tq read lse = delta = 0 and are masked and never written
  const int r0 = q0 + warp * 16 + g;
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + i * 8;
    lse_r[i] = r < tq ? lse[(int64_t)bh * tq + r] : 0.f;
    delta_r[i] = r < tq ? delta[(int64_t)bh * tq + r] : 0.f;
  }

  const int arow = (warp * 16 + lane % 16) * LC + (lane / 16) * 8;
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float s[NS][4], dp[NS][4];

  for (int i = 0; i < steps; ++i) {
    const int ch = i % nch, st = i & 1;
    const int k0 = (kt_lo + i / nch) * kBK;
    if (ch == 0) {
      // the previous tile's dS.K is done (the barrier closing each step)
      cp_tile_pad<kWS, kMmaThreads>(Ksl, k + koff + c0, k0, tkv, tstride,
                                    d - c0, vec);
      cp_async_commit();
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    }
    if (i + 1 < steps) load_step(i + 1);
    cp_async_commit();
    cp_async_wait<1>();  // all but the prefetch have landed
    __syncthreads();

    const bf16* Qt = Qc + st * kBQ * LC;
    const bf16* dOt = dOc + st * kBQ * LC;
    const bf16* Kt = Kc + st * kBK * LC;
    const bf16* Vt = Vc + st * kBK * LC;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      uint32_t qa[4], oa[4];
      ldmatrix_x4(qa, Qt + arow + kc * 16);
      ldmatrix_x4(oa, dOt + arow + kc * 16);
#pragma unroll
      for (int jp = 0; jp < NS / 2; ++jp) {
        const int off = (jp * 16 + lane % 8 + (lane / 16) * 8) * LC +
                        kc * 16 + ((lane / 8) % 2) * 8;
        uint32_t bk[4], bv[4];
        ldmatrix_x4(bk, Kt + off);
        mma_16816(s[2 * jp], qa, bk[0], bk[1]);
        mma_16816(s[2 * jp + 1], qa, bk[2], bk[3]);
        ldmatrix_x4(bv, Vt + off);
        mma_16816(dp[2 * jp], oa, bv[0], bv[1]);
        mma_16816(dp[2 * jp + 1], oa, bv[2], bv[3]);
      }
    }

    if (ch == nch - 1) {  // S and dP are whole: p, ds, dQ += dS.K
      const bool edge = q0 + kBQ > tq || k0 + kBK > tkv ||
                        (causal && k0 + kBK - 1 > q0) ||
                        (window > 0 && q0 + kBQ - 1 - k0 >= window);
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e / 2;
          float p = expf(s[j][e] * scale - lse_r[r]);
          if (edge) {
            const int qi = r0 + r * 8;
            const int kj = k0 + j * 8 + 2 * t4 + e % 2;
            bool keep = qi < tq && kj < tkv;
            if (causal) keep = keep && qi >= kj;
            if (window > 0) keep = keep && qi - kj < window;
            p = keep ? p : 0.f;
          }
          dp[j][e] = p * (dp[j][e] - delta_r[r]) * scale;
        }
#pragma unroll
      for (int kk = 0; kk < NS / 2; ++kk) {
        uint32_t da[4];
        c_to_a(da, dp[2 * kk], dp[2 * kk + 1]);
        const int row = (kk * 16 + lane % 8 + ((lane / 8) % 2) * 8) * LS;
#pragma unroll
        for (int np = 0; np < NO / 2; ++np) {
          uint32_t bk[4];
          ldmatrix_x4_trans(bk, Ksl + row + np * 16 + (lane / 16) * 8);
          mma_16816(acc[2 * np], da, bk[0], bk[1]);
          mma_16816(acc[2 * np + 1], da, bk[2], bk[3]);
        }
      }
    }
    __syncthreads();  // this stage, and at a tile's end Ksl, are free
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + i * 8;
    if (r < tq) {
      float* row = dq + qoff + r * tstride;
#pragma unroll
      for (int n = 0; n < NO; ++n)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int col = c0 + n * 8 + 2 * t4 + j;
          if (col < d) row[col] = acc[n][2 * i + j];
        }
    }
  }
}

int launch_dkdv_wide(const Args& a, void* dk, void* dv) {
  const size_t bytes = dkdv_wide_smem_bytes();
  cudaError_t err = dl4j_smem::set_max_dynamic_smem(
      reinterpret_cast<const void*>(flash_bwd_dkdv_wide_kernel), (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(a.batch * a.heads, (a.tkv + kBK - 1) / kBK,
                  (a.d + kWS - 1) / kWS);
  flash_bwd_dkdv_wide_kernel<<<grid, kMmaThreads, bytes, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<float*>(dk), static_cast<float*>(dv), a.heads, a.tq,
      a.tkv, a.d, a.vec, a.causal, a.window, a.scale);
  return (int)cudaGetLastError();
}

int launch_dq_wide(const Args& a, void* dq) {
  const size_t bytes = dq_wide_smem_bytes();
  cudaError_t err = dl4j_smem::set_max_dynamic_smem(
      reinterpret_cast<const void*>(flash_bwd_dq_wide_kernel), (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(a.batch * a.heads, (a.tq + kBQ - 1) / kBQ,
                  (a.d + kWS - 1) / kWS);
  flash_bwd_dq_wide_kernel<<<grid, kMmaThreads, bytes, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<float*>(dq), a.heads, a.tq, a.tkv, a.d, a.vec, a.causal,
      a.window, a.scale);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// B2 and B3 f32 on the tensor cores (3xTF32, mma_tf32.cuh): rows of up to
// 128 floats whole in shared memory
// ---------------------------------------------------------------------------
// the widest f32 row a tile keeps whole: given by the build
// (kernels/_build.py) from kernels/__init__.py's F32_TIER_MAX
#ifndef DL4J_F32_TIER_MAX
#error "DL4J_F32_TIER_MAX must be defined by the build"
#endif
constexpr int kF32TierMax = DL4J_F32_TIER_MAX;

// Warps of a block of the f32 tile kernels: 4 warps of 16 rows up to 64
// (two blocks an SM), 8 above, two warps a 16-row group, each taking half
// of every tile's columns (one block an SM: the tiles need more than half
// of its shared memory)
template <int D>
constexpr int kTf32Warps = D > 64 ? 8 : 4;

template <int D>
constexpr size_t dkdv_tf32_smem_bytes() {
  // K, V [64][D+4] and Q, dO [2 stages][64][D+4] in f32; lse and delta
  // [2 stages][64]
  return ((size_t)6 * 64 * (D + 4) + (size_t)2 * 2 * kBQ) * sizeof(float);
}

// B2's tensor-core loop in f32: D the width rows take in shared memory;
// kPad: rows hold d <= D floats in device memory (a padded tier), else
// d == D.
template <int D, bool kPad>
__global__ void __launch_bounds__(32 * kTf32Warps<D>)
flash_bwd_dkdv_tf32_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           const float* __restrict__ dout,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           float* __restrict__ dk, float* __restrict__ dv,
                           int heads, int tq, int tkv, int d, int vec,
                           int causal, int window, float scale) {
  using namespace dl4j_tf32;
  using dl4j_mma::cp_async_4;
  using dl4j_mma::cp_async_commit;
  using dl4j_mma::cp_async_wait;
  constexpr int kThreads = 32 * kTf32Warps<D>;
  constexpr int LD = D + 4;              // padded shared row, floats
  constexpr int KC = D / 8;              // k-steps over d of S^T and dP^T
  constexpr int NO = D / 8;              // 8-wide column tiles of dk, dv
  constexpr int QH = kBQ * 4 / kTf32Warps<D>;  // a warp's queries a tile
  // query columns a pass: fewer at the widths whose dk and dv
  // accumulators leave fewer registers for s and dp
  constexpr int QS = D <= 64 ? 64 : D <= 96 ? 32 : 16;
  constexpr int NS = QS / 8;             // 8-query column tiles a pass
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Ks = reinterpret_cast<float*>(smem_raw);  // [64][LD]
  float* Vs = Ks + kBK * LD;                       // [64][LD]
  float* Qs = Vs + kBK * LD;                       // [2][64][LD]
  float* dOs = Qs + 2 * kBQ * LD;                  // [2][64][LD]
  float* lse_s = dOs + 2 * kBQ * LD;               // [2][64]
  float* delta_s = lse_s + 2 * kBQ;                // [2][64]

  const int bh = blockIdx.x;
  const int b = bh / heads, h = bh % heads;
  const int k0 = blockIdx.y * kBK;  // causal: the heaviest tiles come first
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int half = warp / 4;  // which of a tile's query halves (8 warps)
  const int dh = kPad ? d : D;  // floats a row in device memory
  const int64_t tstride = (int64_t)heads * dh;
  const int64_t qoff = ((int64_t)b * tq * heads + h) * dh;
  const int64_t koff = ((int64_t)b * tkv * heads + h) * dh;
  const float* lse_b = lse + (int64_t)bh * tq;
  const float* delta_b = delta + (int64_t)bh * tq;
  auto load = [&](float* dst, const float* src, int t0, int len) {
    cp_tile_f32<D, kThreads>(dst, src, t0, len, tstride, dh, !kPad || vec);
  };

  // query tiles that can see this key tile: the causal diagonal bounds
  // them from below, the window's far edge from above
  int q_lo = 0, q_hi = tq;
  if (causal) q_lo = k0;
  if (window > 0) q_hi = min(tq, k0 + kBK - 1 + window);
  const int qt_lo = q_lo / kBQ, qt_hi = (q_hi + kBQ - 1) / kBQ;

  // one stage of the ring: Q, dO, lse and delta of query tile qt
  auto load_q_tile = [&](int qt, int stage) {
    const int q0 = qt * kBQ;
    load(Qs + stage * kBQ * LD, q + qoff, q0, tq);
    load(dOs + stage * kBQ * LD, dout + qoff, q0, tq);
    if (threadIdx.x < 2 * kBQ) {
      const int i = threadIdx.x % kBQ, t = q0 + i;
      const float* src = threadIdx.x < kBQ ? lse_b : delta_b;
      float* dst = (threadIdx.x < kBQ ? lse_s : delta_s) + stage * kBQ + i;
      cp_async_4(dst, src + (t < tq ? t : 0), t < tq ? 4 : 0);
    }
  };

  load(Ks, k + koff, k0, tkv);
  load(Vs, v + koff, k0, tkv);
  if (qt_lo < qt_hi) load_q_tile(qt_lo, 0);
  cp_async_commit();

  const int krow = (warp % 4) * 16;  // this warp's key rows in the tile
  float dk_acc[NO][4], dv_acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  for (int qt = qt_lo; qt < qt_hi; ++qt) {
    const int stage = (qt - qt_lo) & 1;
    if (qt + 1 < qt_hi) load_q_tile(qt + 1, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // this tile (and K, V) have landed
    __syncthreads();
    const float* Qt = Qs + stage * kBQ * LD;
    const float* dOt = dOs + stage * kBQ * LD;
    const float* lse_t = lse_s + stage * kBQ;
    const float* delta_t = delta_s + stage * kBQ;
    const int q0 = qt * kBQ;
    const bool edge = q0 + kBQ > tq || k0 + kBK > tkv ||
                      (causal && k0 + kBK - 1 > q0) ||
                      (window > 0 && q0 + kBQ - 1 - k0 >= window);

#pragma unroll 1
    for (int qs = half * QH; qs < (half + 1) * QH; qs += QS) {
      // S^T = K.Q^T and dP^T = V.dO^T: K and V rows are the A operands
      // (split once a k-step), Q and dO rows the B operands' columns
      float s[NS][4], dp[NS][4];
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll 1
      for (int kc = 0; kc < KC; ++kc) {
        FragA ka, va;
        frag_a(ka, Ks, LD, krow, kc * 8);
        frag_a(va, Vs, LD, krow, kc * 8);
#pragma unroll
        for (int jp = 0; jp < NS / 2; ++jp) {
          float bq[4], bo[4];
          frag_b_nk(bq, Qt, LD, qs + jp * 16, kc * 8);
          mma_3x(s[2 * jp], ka, bq[0], bq[1]);
          mma_3x(s[2 * jp + 1], ka, bq[2], bq[3]);
          frag_b_nk(bo, dOt, LD, qs + jp * 16, kc * 8);
          mma_3x(dp[2 * jp], va, bo[0], bo[1]);
          mma_3x(dp[2 * jp + 1], va, bo[2], bo[3]);
        }
      }

      // p^T = exp(s.scale - lse), 0 where masked (evaluated only on tiles
      // that cross the diagonal, the window edge or a sequence end);
      // ds^T = p^T (dp^T - delta) scale
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qc = qs + j * 8 + 2 * t4 + e % 2;  // column in the tile
          float p = expf(s[j][e] * scale - lse_t[qc]);
          if (edge) {
            const int qi = q0 + qc, kj = k0 + krow + g + (e / 2) * 8;
            bool keep = qi < tq && kj < tkv;
            if (causal) keep = keep && qi >= kj;
            if (window > 0) keep = keep && qi - kj < window;
            p = keep ? p : 0.f;
          }
          dp[j][e] = p * (dp[j][e] - delta_t[qc]) * scale;
          s[j][e] = p;
        }

      // dV += P^T.dO and dK += dS^T.Q: the A operands are the
      // accumulators above over permuted queries, the B operands dO and Q
      // rows read in the same order
#pragma unroll
      for (int kk = 0; kk < NS; ++kk) {
        FragA pa, da;
        c_as_a(pa, s[kk]);
        c_as_a(da, dp[kk]);
#pragma unroll
        for (int n = 0; n < NO; ++n) {
          float b0, b1;
          frag_b_kn(b0, b1, dOt, LD, qs + kk * 8, n * 8);
          mma_3x(dv_acc[n], pa, b0, b1);
          frag_b_kn(b0, b1, Qt, LD, qs + kk * 8, n * 8);
          mma_3x(dk_acc[n], da, b0, b1);
        }
      }
    }
    __syncthreads();  // every warp is done with this stage
  }

  if constexpr (kTf32Warps<D> == 8) {
    // the second query half's dk and dv partials through shared memory
    // (the Q and dO ring is free; 128 threads x D floats fit in it), added
    // in a fixed order
    cp_async_wait<0>();
    __syncthreads();
    float* part = Qs;  // [D][128]: value i of thread j at i * 128 + j
    const int j = threadIdx.x % 128;
    if (half == 1) {
#pragma unroll
      for (int n = 0; n < NO; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          part[(n * 8 + e) * 128 + j] = dk_acc[n][e];
          part[(n * 8 + 4 + e) * 128 + j] = dv_acc[n][e];
        }
    }
    __syncthreads();
    if (half == 1) return;
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        dk_acc[n][e] += part[(n * 8 + e) * 128 + j];
        dv_acc[n][e] += part[(n * 8 + 4 + e) * 128 + j];
      }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = k0 + krow + g + i * 8;
    if (t < tkv) {
      const int64_t row = koff + t * tstride + 2 * t4;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        if constexpr (kPad) {  // padded columns are not stored
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            if (n * 8 + 2 * t4 + j < d) {
              dk[row + n * 8 + j] = dk_acc[n][2 * i + j];
              dv[row + n * 8 + j] = dv_acc[n][2 * i + j];
            }
          }
        } else {
          *reinterpret_cast<float2*>(dk + row + n * 8) =
              make_float2(dk_acc[n][2 * i], dk_acc[n][2 * i + 1]);
          *reinterpret_cast<float2*>(dv + row + n * 8) =
              make_float2(dv_acc[n][2 * i], dv_acc[n][2 * i + 1]);
        }
      }
    }
  }
}

template <int D>
constexpr size_t dq_tf32_smem_bytes() {
  // Q, dO [64][D+4] and K, V [2 stages][64][D+4], f32
  return (size_t)6 * 64 * (D + 4) * sizeof(float);
}

// B3's tensor-core loop in f32, one 64-key tile a step; D and kPad as in
// the B2 kernel above.
template <int D, bool kPad>
__global__ void __launch_bounds__(32 * kTf32Warps<D>)
flash_bwd_dq_tf32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         float* __restrict__ dq, int heads, int tq, int tkv,
                         int d, int vec, int causal, int window,
                         float scale) {
  using namespace dl4j_tf32;
  using dl4j_mma::cp_async_commit;
  using dl4j_mma::cp_async_wait;
  constexpr int kThreads = 32 * kTf32Warps<D>;
  constexpr int LD = D + 4;     // padded shared row, floats
  constexpr int KC = D / 8;     // k-steps over d of S and dP
  constexpr int KH = kBK * 4 / kTf32Warps<D>;  // a warp's keys a tile
  constexpr int NS = KH / 8;    // 8-key column tiles of S and dP a warp
  constexpr int NO = D / 8;     // 8-wide column tiles of dq
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);  // [64][LD]
  float* dOs = Qs + kBQ * LD;                      // [64][LD]
  float* Ks = dOs + kBQ * LD;                      // [2][64][LD]
  float* Vs = Ks + 2 * kBK * LD;                   // [2][64][LD]

  const int bh = blockIdx.x;
  const int b = bh / heads, h = bh % heads;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // heavy tiles first
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int half = warp / 4;  // which of a tile's key halves (8 warps)
  const int dh = kPad ? d : D;  // floats a row in device memory
  const int64_t tstride = (int64_t)heads * dh;
  const int64_t qoff = ((int64_t)b * tq * heads + h) * dh;
  const int64_t koff = ((int64_t)b * tkv * heads + h) * dh;
  auto load = [&](float* dst, const float* src, int t0, int len) {
    cp_tile_f32<D, kThreads>(dst, src, t0, len, tstride, dh, !kPad || vec);
  };

  // the key tiles this query tile can see, as in the forward
  int k_lo = 0, k_hi = tkv;
  if (causal) k_hi = min(tkv, q0 + kBQ);
  if (window > 0) k_lo = max(0, q0 - window + 1);
  const int kt_lo = k_lo / kBK, kt_hi = (k_hi + kBK - 1) / kBK;

  load(Qs, q + qoff, q0, tq);
  load(dOs, dout + qoff, q0, tq);
  load(Ks, k + koff, kt_lo * kBK, tkv);
  load(Vs, v + koff, kt_lo * kBK, tkv);
  cp_async_commit();

  // this thread's rows of the warp's 16: r0 = q0 + 16*warp + g, r0 + 8;
  // rows past tq read lse = delta = 0 and are masked and never written
  const int qrow = (warp % 4) * 16;
  const int r0 = q0 + qrow + g;
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + i * 8;
    lse_r[i] = r < tq ? lse[(int64_t)bh * tq + r] : 0.f;
    delta_r[i] = r < tq ? delta[(int64_t)bh * tq + r] : 0.f;
  }

  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int stage = (kt - kt_lo) & 1;
    if (kt + 1 < kt_hi) {  // prefetch the next tile into the other stage
      const int next = (stage ^ 1) * kBK * LD;
      load(Ks + next, k + koff, (kt + 1) * kBK, tkv);
      load(Vs + next, v + koff, (kt + 1) * kBK, tkv);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this tile (and Q, dO) have landed
    __syncthreads();
    const float* Kt = Ks + stage * kBK * LD;
    const float* Vt = Vs + stage * kBK * LD;
    const int k0 = kt * kBK;
    const bool edge = q0 + kBQ > tq || k0 + kBK > tkv ||
                      (causal && k0 + kBK - 1 > q0) ||
                      (window > 0 && q0 + kBQ - 1 - k0 >= window);

    {
      const int ks = half * KH;  // this warp's keys of the tile
      // S = Q.K^T and dP = dO.V^T over keys ks..ks+KH-1: Q and dO rows are
      // the A operands (split once a k-step), K and V rows the B operands'
      // columns
      float s[NS][4], dp[NS][4];
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll 1
      for (int kc = 0; kc < KC; ++kc) {
        FragA qa, oa;
        frag_a(qa, Qs, LD, qrow, kc * 8);
        frag_a(oa, dOs, LD, qrow, kc * 8);
#pragma unroll
        for (int jp = 0; jp < NS / 2; ++jp) {
          float bk[4], bv[4];
          frag_b_nk(bk, Kt, LD, ks + jp * 16, kc * 8);
          mma_3x(s[2 * jp], qa, bk[0], bk[1]);
          mma_3x(s[2 * jp + 1], qa, bk[2], bk[3]);
          frag_b_nk(bv, Vt, LD, ks + jp * 16, kc * 8);
          mma_3x(dp[2 * jp], oa, bv[0], bv[1]);
          mma_3x(dp[2 * jp + 1], oa, bv[2], bv[3]);
        }
      }

      // p = exp(s.scale - lse), 0 where masked (edge tiles only); ds = p
      // (dp - delta) scale
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e / 2;
          float p = expf(s[j][e] * scale - lse_r[i]);
          if (edge) {
            const int qi = r0 + i * 8;
            const int kj = k0 + ks + j * 8 + 2 * t4 + e % 2;
            bool keep = qi < tq && kj < tkv;
            if (causal) keep = keep && qi >= kj;
            if (window > 0) keep = keep && qi - kj < window;
            p = keep ? p : 0.f;
          }
          dp[j][e] = p * (dp[j][e] - delta_r[i]) * scale;
        }

      // dQ += dS.K: dS from the accumulators over permuted keys, K rows
      // read in the same order
#pragma unroll
      for (int kk = 0; kk < NS; ++kk) {
        FragA da;
        c_as_a(da, dp[kk]);
#pragma unroll
        for (int n = 0; n < NO; ++n) {
          float b0, b1;
          frag_b_kn(b0, b1, Kt, LD, ks + kk * 8, n * 8);
          mma_3x(acc[n], da, b0, b1);
        }
      }
    }
    __syncthreads();  // every warp is done with this stage
  }

  if constexpr (kTf32Warps<D> == 8) {
    // the second key half's dq partials through shared memory (the K ring
    // is free), added in a fixed order
    cp_async_wait<0>();
    __syncthreads();
    float* part = Ks;  // [D/2][128]: value i of thread j at i * 128 + j
    const int j = threadIdx.x % 128;
    if (half == 1) {
#pragma unroll
      for (int n = 0; n < NO; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[(n * 4 + e) * 128 + j] = acc[n][e];
    }
    __syncthreads();
    if (half == 1) return;
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] += part[(n * 4 + e) * 128 + j];
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + i * 8;
    if (r < tq) {
      float* row = dq + qoff + r * tstride + 2 * t4;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        if constexpr (kPad) {  // padded columns are not stored
#pragma unroll
          for (int j = 0; j < 2; ++j)
            if (n * 8 + 2 * t4 + j < d) row[n * 8 + j] = acc[n][2 * i + j];
        } else {
          *reinterpret_cast<float2*>(row + n * 8) =
              make_float2(acc[n][2 * i], acc[n][2 * i + 1]);
        }
      }
    }
  }
}

template <int D, bool kPad>
int launch_dkdv_tf32(const Args& a, void* dk, void* dv) {
  if (a.d > D || (!kPad && a.d != D)) return (int)cudaErrorInvalidValue;
  const size_t bytes = dkdv_tf32_smem_bytes<D>();
  cudaError_t err = dl4j_smem::set_max_dynamic_smem(
      reinterpret_cast<const void*>(flash_bwd_dkdv_tf32_kernel<D, kPad>),
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(a.batch * a.heads, (a.tkv + kBK - 1) / kBK);
  flash_bwd_dkdv_tf32_kernel<D, kPad>
      <<<grid, 32 * kTf32Warps<D>, bytes, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<float*>(dk), static_cast<float*>(dv), a.heads, a.tq,
      a.tkv, a.d, a.vec, a.causal, a.window, a.scale);
  return (int)cudaGetLastError();
}

template <int D, bool kPad>
int launch_dq_tf32(const Args& a, void* dq) {
  if (a.d > D || (!kPad && a.d != D)) return (int)cudaErrorInvalidValue;
  const size_t bytes = dq_tf32_smem_bytes<D>();
  cudaError_t err = dl4j_smem::set_max_dynamic_smem(
      reinterpret_cast<const void*>(flash_bwd_dq_tf32_kernel<D, kPad>),
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(a.batch * a.heads, (a.tq + kBQ - 1) / kBQ);
  flash_bwd_dq_tf32_kernel<D, kPad>
      <<<grid, 32 * kTf32Warps<D>, bytes, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<float*>(dq), a.heads, a.tq, a.tkv, a.d, a.vec, a.causal,
      a.window, a.scale);
  return (int)cudaGetLastError();
}

// the f32 instantiation of a padded tier (widths up to kF32TierMax only;
// wider f32 rows take the wide kernels below)
template <int T>
int launch_dkdv_tf32_tier(const Args& a, void* dk, void* dv) {
  if constexpr (T <= kF32TierMax)
    return launch_dkdv_tf32<T, true>(a, dk, dv);
  else
    return (int)cudaErrorInvalidValue;
}

template <int T>
int launch_dq_tf32_tier(const Args& a, void* dq) {
  if constexpr (T <= kF32TierMax)
    return launch_dq_tf32<T, true>(a, dq);
  else
    return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// B2 and B3 f32 above 128: the 3xTF32 kernels with d streamed in chunks
// ---------------------------------------------------------------------------
constexpr int kFC = 64;   // columns of a (key or query) tile a chunk, f32
constexpr int kFS = 64;   // output columns a block (grid z), f32

constexpr size_t dkdv_wide_tf32_smem_bytes() {
  // K, V [2 stages][64][kFC+4] and Q, dO [2 stages][32][kFC+4] chunks;
  // the Q and dO slices [32][kFS+4]; lse and delta [32]; all f32
  return ((size_t)2 * (2 * kBK + 2 * kWQ) * (kFC + 4) +
          (size_t)2 * kWQ * (kFS + 4) + (size_t)2 * kWQ) * sizeof(float);
}

// The bf16 wide B2's schedule in f32: one block per (batch*head, 64-key
// tile, 64-column slice of dk and dv), 4 warps of 16 key rows, query
// tiles of 32 rows; S^T and dP^T summed over d in chunks of 64 columns of
// K, V, Q and dO through a two-stage cp.async ring; the tile's Q and dO
// slices, lse and delta arrive with its first chunk.
__global__ void __launch_bounds__(kMmaThreads)
flash_bwd_dkdv_wide_tf32_kernel(const float* __restrict__ q,
                                const float* __restrict__ k,
                                const float* __restrict__ v,
                                const float* __restrict__ dout,
                                const float* __restrict__ lse,
                                const float* __restrict__ delta,
                                float* __restrict__ dk,
                                float* __restrict__ dv, int heads, int tq,
                                int tkv, int d, int vec, int causal,
                                int window, float scale) {
  using namespace dl4j_tf32;
  using dl4j_mma::cp_async_4;
  using dl4j_mma::cp_async_commit;
  using dl4j_mma::cp_async_wait;
  constexpr int LC = kFC + 4, LS = kFS + 4;  // padded shared rows
  constexpr int KC = kFC / 8;                // k-steps a chunk
  constexpr int NS = kWQ / 8;                // 8-query column tiles of S^T
  constexpr int NO = kFS / 8;                // 8-wide column tiles of dk, dv
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Kc = reinterpret_cast<float*>(smem_raw);  // [2][64][LC]
  float* Vc = Kc + 2 * kBK * LC;                   // [2][64][LC]
  float* Qc = Vc + 2 * kBK * LC;                   // [2][32][LC]
  float* dOc = Qc + 2 * kWQ * LC;                  // [2][32][LC]
  float* Qsl = dOc + 2 * kWQ * LC;                 // [32][LS]
  float* dOsl = Qsl + kWQ * LS;                    // [32][LS]
  float* lse_s = dOsl + kWQ * LS;                  // [32]
  float* delta_s = lse_s + kWQ;                    // [32]

  const int bh = blockIdx.x;
  const int b = bh / heads, h = bh % heads;
  const int k0 = blockIdx.y * kBK;  // causal: the heaviest tiles come first
  const int c0 = blockIdx.z * kFS;  // this block's dk and dv columns
  const int nch = (d + kFC - 1) / kFC;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int64_t tstride = (int64_t)heads * d;
  const int64_t qoff = ((int64_t)b * tq * heads + h) * d;
  const int64_t koff = ((int64_t)b * tkv * heads + h) * d;
  const float* lse_b = lse + (int64_t)bh * tq;
  const float* delta_b = delta + (int64_t)bh * tq;

  int q_lo = 0, q_hi = tq;
  if (causal) q_lo = k0;
  if (window > 0) q_hi = min(tq, k0 + kBK - 1 + window);
  const int qt_lo = q_lo / kWQ, qt_hi = (q_hi + kWQ - 1) / kWQ;
  const int steps = max(qt_hi - qt_lo, 0) * nch;

  // step i: chunk i % nch of query tile qt_lo + i / nch, into stage i % 2
  auto load_step = [&](int i) {
    const int c = (i % nch) * kFC, st = i & 1;
    const int q0 = (qt_lo + i / nch) * kWQ;
    cp_tile_f32<kFC, kMmaThreads>(Kc + st * kBK * LC, k + koff + c, k0, tkv,
                                  tstride, d - c, vec);
    cp_tile_f32<kFC, kMmaThreads>(Vc + st * kBK * LC, v + koff + c, k0, tkv,
                                  tstride, d - c, vec);
    cp_tile_f32<kFC, kMmaThreads, kWQ>(Qc + st * kWQ * LC, q + qoff + c, q0,
                                       tq, tstride, d - c, vec);
    cp_tile_f32<kFC, kMmaThreads, kWQ>(dOc + st * kWQ * LC, dout + qoff + c,
                                       q0, tq, tstride, d - c, vec);
  };
  if (steps > 0) load_step(0);
  cp_async_commit();

  const int krow = warp * 16;
  float dk_acc[NO][4], dv_acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;
  float s[NS][4], dp[NS][4];

  for (int i = 0; i < steps; ++i) {
    const int ch = i % nch, st = i & 1;
    const int q0 = (qt_lo + i / nch) * kWQ;
    if (ch == 0) {
      // the previous tile's products are done (the barrier closing each
      // step): this tile's Q and dO slices, lse and delta
      cp_tile_f32<kFS, kMmaThreads, kWQ>(Qsl, q + qoff + c0, q0, tq, tstride,
                                         d - c0, vec);
      cp_tile_f32<kFS, kMmaThreads, kWQ>(dOsl, dout + qoff + c0, q0, tq,
                                         tstride, d - c0, vec);
      if (threadIdx.x < 2 * kWQ) {
        const int r = threadIdx.x % kWQ, t = q0 + r;
        const float* src = threadIdx.x < kWQ ? lse_b : delta_b;
        float* dst = (threadIdx.x < kWQ ? lse_s : delta_s) + r;
        cp_async_4(dst, src + (t < tq ? t : 0), t < tq ? 4 : 0);
      }
      cp_async_commit();
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    }
    if (i + 1 < steps) load_step(i + 1);
    cp_async_commit();
    cp_async_wait<1>();  // all but the prefetch have landed
    __syncthreads();

    const float* Kt = Kc + st * kBK * LC;
    const float* Vt = Vc + st * kBK * LC;
    const float* Qt = Qc + st * kWQ * LC;
    const float* dOt = dOc + st * kWQ * LC;
#pragma unroll 1
    for (int kc = 0; kc < KC; ++kc) {
      FragA ka, va;
      frag_a(ka, Kt, LC, krow, kc * 8);
      frag_a(va, Vt, LC, krow, kc * 8);
#pragma unroll
      for (int jp = 0; jp < NS / 2; ++jp) {
        float bq[4], bo[4];
        frag_b_nk(bq, Qt, LC, jp * 16, kc * 8);
        mma_3x(s[2 * jp], ka, bq[0], bq[1]);
        mma_3x(s[2 * jp + 1], ka, bq[2], bq[3]);
        frag_b_nk(bo, dOt, LC, jp * 16, kc * 8);
        mma_3x(dp[2 * jp], va, bo[0], bo[1]);
        mma_3x(dp[2 * jp + 1], va, bo[2], bo[3]);
      }
    }

    if (ch == nch - 1) {  // S^T and dP^T are whole: p^T, ds^T, products
      const bool edge = q0 + kWQ > tq || k0 + kBK > tkv ||
                        (causal && k0 + kBK - 1 > q0) ||
                        (window > 0 && q0 + kWQ - 1 - k0 >= window);
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qc = j * 8 + 2 * t4 + e % 2;  // column in the tile
          float p = expf(s[j][e] * scale - lse_s[qc]);
          if (edge) {
            const int qi = q0 + qc, kj = k0 + krow + g + (e / 2) * 8;
            bool keep = qi < tq && kj < tkv;
            if (causal) keep = keep && qi >= kj;
            if (window > 0) keep = keep && qi - kj < window;
            p = keep ? p : 0.f;
          }
          dp[j][e] = p * (dp[j][e] - delta_s[qc]) * scale;
          s[j][e] = p;
        }
#pragma unroll
      for (int kk = 0; kk < NS; ++kk) {
        FragA pa, da;
        c_as_a(pa, s[kk]);
        c_as_a(da, dp[kk]);
#pragma unroll
        for (int n = 0; n < NO; ++n) {
          float b0, b1;
          frag_b_kn(b0, b1, dOsl, LS, kk * 8, n * 8);
          mma_3x(dv_acc[n], pa, b0, b1);
          frag_b_kn(b0, b1, Qsl, LS, kk * 8, n * 8);
          mma_3x(dk_acc[n], da, b0, b1);
        }
      }
    }
    __syncthreads();  // this stage, and at a tile's end the slices, are free
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = k0 + krow + g + i * 8;
    if (t < tkv) {
      const int64_t row = koff + t * tstride;
#pragma unroll
      for (int n = 0; n < NO; ++n)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int col = c0 + n * 8 + 2 * t4 + j;
          if (col < d) {
            dk[row + col] = dk_acc[n][2 * i + j];
            dv[row + col] = dv_acc[n][2 * i + j];
          }
        }
    }
  }
}

constexpr size_t dq_wide_tf32_smem_bytes() {
  // Q, dO, K, V chunks [2 stages][64][kFC+4] and the K slice [64][kFS+4]
  return ((size_t)8 * 64 * (kFC + 4) + (size_t)64 * (kFS + 4)) *
         sizeof(float);
}

// The bf16 wide B3's schedule in f32: one block per (batch*head, 64-query
// tile, 64-column slice of dq), 4 warps of 16 query rows; each key
// tile's S and dP summed over d in chunks of 64 columns of Q, dO, K and V
// through a two-stage cp.async ring; the tile's K slice arrives with its
// first chunk.
__global__ void __launch_bounds__(kMmaThreads)
flash_bwd_dq_wide_tf32_kernel(const float* __restrict__ q,
                              const float* __restrict__ k,
                              const float* __restrict__ v,
                              const float* __restrict__ dout,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta,
                              float* __restrict__ dq, int heads, int tq,
                              int tkv, int d, int vec, int causal, int window,
                              float scale) {
  using namespace dl4j_tf32;
  using dl4j_mma::cp_async_commit;
  using dl4j_mma::cp_async_wait;
  constexpr int LC = kFC + 4, LS = kFS + 4;  // padded shared rows
  constexpr int KC = kFC / 8;                // k-steps a chunk
  constexpr int NS = kBK / 8;                // 8-key column tiles of S, dP
  constexpr int NO = kFS / 8;                // 8-wide column tiles of dq
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qc = reinterpret_cast<float*>(smem_raw);  // [2][64][LC]
  float* dOc = Qc + 2 * kBQ * LC;                  // [2][64][LC]
  float* Kc = dOc + 2 * kBQ * LC;                  // [2][64][LC]
  float* Vc = Kc + 2 * kBK * LC;                   // [2][64][LC]
  float* Ksl = Vc + 2 * kBK * LC;                  // [64][LS]

  const int bh = blockIdx.x;
  const int b = bh / heads, h = bh % heads;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // heavy tiles first
  const int c0 = blockIdx.z * kFS;  // this block's dq columns
  const int nch = (d + kFC - 1) / kFC;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int64_t tstride = (int64_t)heads * d;
  const int64_t qoff = ((int64_t)b * tq * heads + h) * d;
  const int64_t koff = ((int64_t)b * tkv * heads + h) * d;

  int k_lo = 0, k_hi = tkv;
  if (causal) k_hi = min(tkv, q0 + kBQ);
  if (window > 0) k_lo = max(0, q0 - window + 1);
  const int kt_lo = k_lo / kBK, kt_hi = (k_hi + kBK - 1) / kBK;
  const int steps = (kt_hi - kt_lo) * nch;

  // step i: chunk i % nch of key tile kt_lo + i / nch, into stage i % 2
  auto load_step = [&](int i) {
    const int c = (i % nch) * kFC, st = i & 1;
    const int k0 = (kt_lo + i / nch) * kBK;
    cp_tile_f32<kFC, kMmaThreads>(Qc + st * kBQ * LC, q + qoff + c, q0, tq,
                                  tstride, d - c, vec);
    cp_tile_f32<kFC, kMmaThreads>(dOc + st * kBQ * LC, dout + qoff + c, q0,
                                  tq, tstride, d - c, vec);
    cp_tile_f32<kFC, kMmaThreads>(Kc + st * kBK * LC, k + koff + c, k0, tkv,
                                  tstride, d - c, vec);
    cp_tile_f32<kFC, kMmaThreads>(Vc + st * kBK * LC, v + koff + c, k0, tkv,
                                  tstride, d - c, vec);
  };
  load_step(0);
  cp_async_commit();

  // rows past tq read lse = delta = 0 and are masked and never written
  const int qrow = warp * 16;
  const int r0 = q0 + qrow + g;
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + i * 8;
    lse_r[i] = r < tq ? lse[(int64_t)bh * tq + r] : 0.f;
    delta_r[i] = r < tq ? delta[(int64_t)bh * tq + r] : 0.f;
  }

  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float s[NS][4], dp[NS][4];

  for (int i = 0; i < steps; ++i) {
    const int ch = i % nch, st = i & 1;
    const int k0 = (kt_lo + i / nch) * kBK;
    if (ch == 0) {
      // the previous tile's dS.K is done (the barrier closing each step)
      cp_tile_f32<kFS, kMmaThreads>(Ksl, k + koff + c0, k0, tkv, tstride,
                                    d - c0, vec);
      cp_async_commit();
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    }
    if (i + 1 < steps) load_step(i + 1);
    cp_async_commit();
    cp_async_wait<1>();  // all but the prefetch have landed
    __syncthreads();

    const float* Qt = Qc + st * kBQ * LC;
    const float* dOt = dOc + st * kBQ * LC;
    const float* Kt = Kc + st * kBK * LC;
    const float* Vt = Vc + st * kBK * LC;
#pragma unroll 1
    for (int kc = 0; kc < KC; ++kc) {
      FragA qa, oa;
      frag_a(qa, Qt, LC, qrow, kc * 8);
      frag_a(oa, dOt, LC, qrow, kc * 8);
#pragma unroll
      for (int jp = 0; jp < NS / 2; ++jp) {
        float bk[4], bv[4];
        frag_b_nk(bk, Kt, LC, jp * 16, kc * 8);
        mma_3x(s[2 * jp], qa, bk[0], bk[1]);
        mma_3x(s[2 * jp + 1], qa, bk[2], bk[3]);
        frag_b_nk(bv, Vt, LC, jp * 16, kc * 8);
        mma_3x(dp[2 * jp], oa, bv[0], bv[1]);
        mma_3x(dp[2 * jp + 1], oa, bv[2], bv[3]);
      }
    }

    if (ch == nch - 1) {  // S and dP are whole: p, ds, dQ += dS.K
      const bool edge = q0 + kBQ > tq || k0 + kBK > tkv ||
                        (causal && k0 + kBK - 1 > q0) ||
                        (window > 0 && q0 + kBQ - 1 - k0 >= window);
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e / 2;
          float p = expf(s[j][e] * scale - lse_r[r]);
          if (edge) {
            const int qi = r0 + r * 8;
            const int kj = k0 + j * 8 + 2 * t4 + e % 2;
            bool keep = qi < tq && kj < tkv;
            if (causal) keep = keep && qi >= kj;
            if (window > 0) keep = keep && qi - kj < window;
            p = keep ? p : 0.f;
          }
          dp[j][e] = p * (dp[j][e] - delta_r[r]) * scale;
        }
#pragma unroll
      for (int kk = 0; kk < NS; ++kk) {
        FragA da;
        c_as_a(da, dp[kk]);
#pragma unroll
        for (int n = 0; n < NO; ++n) {
          float b0, b1;
          frag_b_kn(b0, b1, Ksl, LS, kk * 8, n * 8);
          mma_3x(acc[n], da, b0, b1);
        }
      }
    }
    __syncthreads();  // this stage, and at a tile's end Ksl, are free
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + i * 8;
    if (r < tq) {
      float* row = dq + qoff + r * tstride;
#pragma unroll
      for (int n = 0; n < NO; ++n)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int col = c0 + n * 8 + 2 * t4 + j;
          if (col < d) row[col] = acc[n][2 * i + j];
        }
    }
  }
}

int launch_dkdv_wide_tf32(const Args& a, void* dk, void* dv) {
  const size_t bytes = dkdv_wide_tf32_smem_bytes();
  cudaError_t err = dl4j_smem::set_max_dynamic_smem(
      reinterpret_cast<const void*>(flash_bwd_dkdv_wide_tf32_kernel),
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(a.batch * a.heads, (a.tkv + kBK - 1) / kBK,
                  (a.d + kFS - 1) / kFS);
  flash_bwd_dkdv_wide_tf32_kernel<<<grid, kMmaThreads, bytes, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<float*>(dk), static_cast<float*>(dv), a.heads, a.tq,
      a.tkv, a.d, a.vec, a.causal, a.window, a.scale);
  return (int)cudaGetLastError();
}

int launch_dq_wide_tf32(const Args& a, void* dq) {
  const size_t bytes = dq_wide_tf32_smem_bytes();
  cudaError_t err = dl4j_smem::set_max_dynamic_smem(
      reinterpret_cast<const void*>(flash_bwd_dq_wide_tf32_kernel),
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(a.batch * a.heads, (a.tq + kBQ - 1) / kBQ,
                  (a.d + kFS - 1) / kFS);
  flash_bwd_dq_wide_tf32_kernel<<<grid, kMmaThreads, bytes, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<float*>(dq), a.heads, a.tq, a.tkv, a.d, a.vec, a.causal,
      a.window, a.scale);
  return (int)cudaGetLastError();
}

bool valid(const Args& a) {
  return a.batch >= 1 && a.heads >= 1 && a.tq >= 1 && a.tkv >= 1 &&
         a.d >= 1 && (int64_t)a.batch * a.heads <= 0x7fffffff &&
         (a.tq + kBQ - 1) / kBQ <= 65535 && (a.tkv + kBK - 1) / kBK <= 65535;
}

}  // namespace

// The padded bf16 tiers, one `DL4J_TIER(width)` entry each: given by the
// build (kernels/_build.py) from kernels/__init__.py's MMA_TIERS. B2
// splits its columns in two slices above 128.
#ifndef DL4J_MMA_TIERS
#error "DL4J_MMA_TIERS must be defined by the build"
#endif

// route: 0 = exact (head_dim 64 or 128, unpadded), 1 = tier (rows padded
// to `tier`: bf16 up to 256, f32 up to 128), 3 = wide (d streamed in
// chunks: bf16 above 256, f32 above 128); the codes are the forward's.
// vec: rows may move in 16-byte cp.async copies (tier, wide).
// dtype: 0 = float32 (3xTF32), 1 = bfloat16. window <= 0 means no window.
// q, k, v, dout: BTHD in the input dtype; lse, delta: [batch*heads, tq]
// f32; dk, dv: BTHD f32 [batch, tkv, heads, head_dim].
extern "C" int dl4j_flash_bwd_dkdv(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const void* lse, const void* delta,
                                   void* dk, void* dv, int batch, int heads,
                                   int tq, int tkv, int head_dim, int route,
                                   int tier, int vec, int dtype, int causal,
                                   int window, float scale, void* stream) {
  const Args a{q, k, v, dout, lse, delta, batch, heads, tq, tkv,
               head_dim, vec, causal, window, scale,
               static_cast<cudaStream_t>(stream)};
  if (!valid(a)) return (int)cudaErrorInvalidValue;
  if (route == 0) {
    if (dtype == 0 && head_dim == 64)
      return launch_dkdv_tf32<64, false>(a, dk, dv);
    if (dtype == 0 && head_dim == 128)
      return launch_dkdv_tf32<128, false>(a, dk, dv);
    if (dtype == 1 && head_dim == 64)
      return launch_dkdv_mma<64, 64, false>(a, dk, dv);
    if (dtype == 1 && head_dim == 128)
      return launch_dkdv_mma<128, 128, false>(a, dk, dv);
  } else if (route == 1 && dtype == 1) {
    switch (tier) {
#define DL4J_TIER(T) \
  case T:            \
    return launch_dkdv_mma<T, (T > 128 ? T / 2 : T), true>(a, dk, dv);
      DL4J_MMA_TIERS
#undef DL4J_TIER
    }
  } else if (route == 1 && dtype == 0) {
    switch (tier) {
#define DL4J_TIER(T) \
  case T:            \
    return launch_dkdv_tf32_tier<T>(a, dk, dv);
      DL4J_MMA_TIERS
#undef DL4J_TIER
    }
  } else if (route == 3 && dtype == 1) {
    return launch_dkdv_wide(a, dk, dv);
  } else if (route == 3 && dtype == 0) {
    return launch_dkdv_wide_tf32(a, dk, dv);
  }
  return (int)cudaErrorInvalidValue;
}

// Same inputs and codes; dq: BTHD f32 [batch, tq, heads, head_dim].
extern "C" int dl4j_flash_bwd_dq(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, void* dq, int batch,
                                 int heads, int tq, int tkv, int head_dim,
                                 int route, int tier, int vec, int dtype,
                                 int causal, int window, float scale,
                                 void* stream) {
  const Args a{q, k, v, dout, lse, delta, batch, heads, tq, tkv,
               head_dim, vec, causal, window, scale,
               static_cast<cudaStream_t>(stream)};
  if (!valid(a)) return (int)cudaErrorInvalidValue;
  if (route == 0) {
    if (dtype == 0 && head_dim == 64) return launch_dq_tf32<64, false>(a, dq);
    if (dtype == 0 && head_dim == 128)
      return launch_dq_tf32<128, false>(a, dq);
    if (dtype == 1 && head_dim == 64) return launch_dq_mma<64, false>(a, dq);
    if (dtype == 1 && head_dim == 128)
      return launch_dq_mma<128, false>(a, dq);
  } else if (route == 1 && dtype == 1) {
    switch (tier) {
#define DL4J_TIER(T) \
  case T:            \
    return launch_dq_mma<T, true>(a, dq);
      DL4J_MMA_TIERS
#undef DL4J_TIER
    }
  } else if (route == 1 && dtype == 0) {
    switch (tier) {
#define DL4J_TIER(T) \
  case T:            \
    return launch_dq_tf32_tier<T>(a, dq);
      DL4J_MMA_TIERS
#undef DL4J_TIER
    }
  } else if (route == 3 && dtype == 1) {
    return launch_dq_wide(a, dq);
  } else if (route == 3 && dtype == 0) {
    return launch_dq_wide_tf32(a, dq);
  }
  return (int)cudaErrorInvalidValue;
}
