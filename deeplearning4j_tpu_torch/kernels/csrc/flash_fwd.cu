// Flash-attention forward for Hopper (sm_90a): online-softmax attention
// that never writes the [tq, tkv] score matrix to device memory.
//
// Replaces the TPU kernel `_fwd_kernel` reached through
// `flash_attention_fwd` in deeplearning4j_tpu/pallas/flash_attention.py.
// It computes the same function: per query row, out = softmax(q.k^T *
// scale) . v over the visible keys (kv padding, causal q >= k, window
// q - k < window), with the running max and normaliser kept in f32,
// the probabilities rounded to the value dtype before the PV product,
// out written in the input dtype and lse = m + log(l) in f32. A row whose
// every key is masked gives out = 0 and lse = -1e30 (`safe_l`).
//
// The reference's kernel takes any head_dim d. The C entry point takes
// the route that the Python launch plan chose (`launch_plan` in
// kernels/flash_attention.py) from the shapes and the dtype:
// - exact (d 64 or 128): the two variants below, unpadded, by dtype;
// - tier (bf16 any other d up to 256, f32 up to 128): the tensor-core
//   kernel compiled for the next width of DL4J_MMA_TIERS, each row
//   zero-padded to it in shared memory. Zero columns add nothing to
//   Q.K^T; padded output columns are never stored; the scale is the real
//   d's. Above 128 the bf16 Q fragments no longer fit beside the output
//   accumulators (D/2 floats a thread) and are re-read from shared memory
//   per key tile; at 256 a key tile is taken in passes of 32 keys.
//   Rows whose starts are not 16-byte aligned (d % 8 != 0) are copied
//   element by element instead of by 16-byte cp.async;
// - wide (bf16 above 256, f32 above 128): the tensor-core kernel with d
//   streamed in chunks of 64 columns for Q.K^T and the output in slices
//   of 128 columns (bf16) or 64 (f32) on grid z; each slice recomputes
//   the scores over the whole d.
//
// bf16 (dtype 1): "mma.sync bf16", a FlashAttention-2-style kernel on the
// tensor cores (building blocks in mma_bf16.cuh).
// - One block of 4 warps owns one (batch*head, 64-row query tile); each
//   warp owns 16 query rows and keeps their Q fragment in registers,
//   loaded once with ldmatrix.
// - 64-key K and V tiles stream through a two-stage cp.async ring in
//   shared memory (rows padded by 16 bytes, so ldmatrix has no bank
//   conflicts); the next tile's copy overlaps this tile's math. Rows past
//   the sequence end are zero-filled by cp.async: the host pads nothing.
// - S = Q.K^T by mma.sync with f32 accumulators in registers. The online
//   softmax stays in registers: a row's 64 scores sit in one quad of
//   lanes, reduced with __shfl_xor over 1 and 2. Masked scores become
//   -inf and the running max starts at -1e30, as in the reference; only
//   tiles that cross the causal diagonal, the window edge or the sequence
//   end evaluate the mask.
// - l sums the unrounded f32 p (the reference's `_fwd_kernel:93`); p is
//   rounded to bf16 only as the A operand of P.V, taken straight from the
//   S accumulators, with V's B operand read by ldmatrix.trans.
//
// f32 (dtype 0): "mma.sync 3xtf32", the same loop on the tensor cores at
// f32 accuracy (building blocks in mma_tf32.cuh).
// - Arithmetic. Q.K^T and P.V run on mma.sync m16n8k8 with TF32
//   operands: every f32 operand (q, k, p, v) is split into big =
//   cvt.rna.tf32(x) and small = cvt.rna.tf32(x - big), and a k-step of 8
//   products is small_a.big_b + big_a.small_b + big_a.big_b, three MMAs
//   into a zeroed tile that an f32 add puts into the running sum
//   (`mma_3x`): the tensor core rounds its own sums toward zero, and
//   chained over a row's keys that bias would add up. One TF32 product a
//   k-step misses the f32 gate (2e-5 on out and lse) about 45x; the three
//   stay as close to the exact result as the plain f32 version
//   (tests/test_torch_flash_tf32.py emulates both).
// - S = Q.K^T: Q rows are the A operand, split once a block into two TF32
//   planes in shared memory and read by ldmatrix with no conversion in
//   the loop; K rows are the B operand's columns, read by plain ldmatrix
//   from the [key][d] tile and split a fragment at a time by every warp
//   that reads them. s = S * scale, then B1's online softmax in registers
//   (masked scores -inf, the mask on edge tiles only); l sums the
//   unrounded p.
// - O += P.V: p straight from the S accumulators as the A operand over a
//   permuted contraction index (`c_as_a`: columns 2t, 2t+1 as k = t,
//   t+4), split in registers; V's rows read in that order by 32-bit loads
//   (ldmatrix.trans cannot transpose 32-bit words).
// - K and V stream raw through a two-stage 16-byte cp.async ring of f32
//   rows padded by 4 floats (every fragment load free of bank conflicts).
//   Pre-split K and V planes would spare the warps their splits but
//   double the ring: at 64 a block would take 174,080 bytes, one block an
//   SM instead of two (one block an SM alone ran 7 % slower), and at 128
//   two stages no longer fit (337,920 bytes of the 232,448 a block may
//   use).
// - Widths. Rows of up to 128 floats: 8 warps a block, two a 16-row
//   group, each taking 32 of every tile's 64 keys with its own running
//   max, normaliser and output; the two states are merged once, at the
//   end, through shared memory in a fixed order. Up to 64 two blocks
//   share an SM (104,448 bytes each at 64) and ptxas is held to the 128
//   registers a thread that leaves (it spills up to 72 bytes at 64; 4
//   warps a block with no spill ran 21 % slower). Above 64 one block an
//   SM (202,752 bytes at 128) may take 255 registers (a thread's output
//   accumulators alone are 64 at 128; without the explicit bound ptxas
//   kept to 182-198 and ran 27-29 % slower). Above 128 (wide): 4 warps
//   of 16 rows; Q and K chunks stream through the ring and each chunk's
//   Q.K^T is summed in its own tile, added to the scores in f32 (a sum
//   over d in two levels, which cuts the emulated error at d 320 by a
//   sixth).
//
// Both dtypes: key tiles are visited in the same order, with the same
// per-row arithmetic, whatever tq is (a tile past a row's keys adds exact
// zeros), so a query row's result does not depend on how far the prompt
// was padded: the server's bucketed prefill equals `generate`'s exact one.
// No atomics: two launches give the same bits. Every kernel puts
// batch*head on grid x (up to 2^31 - 1) and the query tiles on grid y,
// issued last-first: under causal masking the heaviest blocks start first.
//
// Bound on an H100: FLOPs 4*b*h*d*sum(visible keys) against 989 TFLOP/s
// (bf16) or 165 TFLOP/s (f32, the 3xTF32 rate; the CUDA cores' 67
// TFLOP/s beside it), bytes (q + k + v + out) * elem + lse * 4
// against 3.35 TB/s. Left on the table: wgmma and TMA with warp
// specialisation (mma.sync reaches a part of the tensor cores' rate),
// splitting K and V once a block instead of once a warp (f32), and a
// persistent schedule that balances causal tiles across the 132 SMs.
//
// C entry point `dl4j_flash_fwd` (loaded with ctypes) returns the CUDA
// error code of the launch (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"
#include "mma_tf32.cuh"
#include "smem_attr.cuh"

namespace {

constexpr int kBQ = 64;          // query rows per block
constexpr int kBK = 64;          // keys per shared-memory tile
constexpr float kMaskValue = -1e30f;

// ---------------------------------------------------------------------------
// bf16 tensor-core variant
// ---------------------------------------------------------------------------
using bf16 = __nv_bfloat16;
constexpr int kMmaThreads = 128;  // 4 warps x 16 query rows

template <int D>
constexpr size_t mma_smem_bytes() {
  // Q [64][D+8], K and V [2 stages][64][D+8], bf16
  return (size_t)(kBQ + 4 * kBK) * (D + 8) * sizeof(bf16);
}

// D: the width rows take in shared memory. kPad: rows hold d <= D
// elements in device memory (a padded tier); without it d == D.
template <int D, bool kPad>
__global__ void __launch_bounds__(kMmaThreads)
flash_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ out,
                     float* __restrict__ lse, int heads, int tq, int tkv,
                     int d, int vec, int causal, int window, float scale) {
  using namespace dl4j_mma;
  constexpr int LD = D + 8;   // padded shared row, elements
  constexpr int KC = D / 16;  // k-steps of Q.K^T
  constexpr int NO = D / 8;   // 8-wide column tiles of the output
  // above 128 the output accumulators (D/2 floats a thread) leave no room
  // for the Q fragments: they are re-read from shared memory per key tile;
  // at 256 a key tile is taken in two passes of 32 to shrink the S
  // registers: ptxas spills 4 bytes, and passes of 16, which spill none,
  // ran 10 % slower
  constexpr bool kQRegs = D <= 128;
  constexpr int KS = D < 256 ? kBK : 32;  // keys a pass
  constexpr int NS = KS / 8;              // 8-key column tiles of S
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [64][LD]
  bf16* Ks = Qs + kBQ * LD;                      // [2][64][LD]
  bf16* Vs = Ks + 2 * kBK * LD;                  // [2][64][LD]

  const int bh = blockIdx.x;
  const int b = bh / heads, h = bh % heads;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // heavy tiles first
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int dh = kPad ? d : D;  // elements a row in device memory
  const int64_t tstride = (int64_t)heads * dh;
  const bf16* qb = q + ((int64_t)b * tq * heads + h) * dh;
  const bf16* kb = k + ((int64_t)b * tkv * heads + h) * dh;
  const bf16* vb = v + ((int64_t)b * tkv * heads + h) * dh;
  auto load = [&](bf16* dst, const bf16* src, int t0, int len) {
    if constexpr (kPad)
      cp_tile_pad<D, kMmaThreads>(dst, src, t0, len, tstride, d, vec);
    else
      cp_tile_64<D, kMmaThreads>(dst, src, t0, len, tstride);
  };

  // the key tiles this query tile can see: the causal diagonal caps them
  // from above, the window band from below; dead tiles are never loaded
  int k_lo = 0, k_hi = tkv;
  if (causal) k_hi = min(tkv, q0 + kBQ);
  if (window > 0) k_lo = max(0, q0 - window + 1);
  const int kt_lo = k_lo / kBK, kt_hi = (k_hi + kBK - 1) / kBK;

  load(Qs, qb, q0, tq);
  load(Ks, kb, kt_lo * kBK, tkv);
  load(Vs, vb, kt_lo * kBK, tkv);
  cp_async_commit();

  // this thread's rows of the warp's 16: r0 = q0 + 16*warp + g, r0 + 8
  const int r0 = q0 + warp * 16 + g;
  const int arow = (warp * 16 + lane % 16) * LD + (lane / 16) * 8;
  uint32_t qf[kQRegs ? KC : 1][4];
  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m_run[2] = {kMaskValue, kMaskValue};
  float l_part[2] = {0.f, 0.f};  // this lane's share of each row's l

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int stage = (kt - kt_lo) & 1;
    if (kt + 1 < kt_hi) {  // prefetch the next tile into the other stage
      const int next = (stage ^ 1) * kBK * LD;
      load(Ks + next, kb, (kt + 1) * kBK, tkv);
      load(Vs + next, vb, (kt + 1) * kBK, tkv);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this tile (and Q) have landed
    __syncthreads();
    if constexpr (kQRegs) {
      if (kt == kt_lo) {
#pragma unroll
        for (int kc = 0; kc < KC; ++kc)
          ldmatrix_x4(qf[kc], Qs + arow + kc * 16);
      }
    }
    const bf16* Kt = Ks + stage * kBK * LD;
    const bf16* Vt = Vs + stage * kBK * LD;
    const int k0 = kt * kBK;

    // scale, then mask only where this tile crosses the sequence end,
    // the causal diagonal or the window's far edge
    const bool edge = k0 + kBK > tkv || (causal && k0 + kBK - 1 > q0) ||
                      (window > 0 && q0 + kBQ - 1 - k0 >= window);

    // one pass of KS keys at a time (a single pass below 256)
#pragma unroll 1
    for (int ks = 0; ks < kBK; ks += KS) {
      // S = Q.K^T: K rows are the B operand's columns (plain ldmatrix)
      float s[NS][4];
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        uint32_t qa[4];
        if constexpr (kQRegs) {
#pragma unroll
          for (int e = 0; e < 4; ++e) qa[e] = qf[kc][e];
        } else {
          ldmatrix_x4(qa, Qs + arow + kc * 16);
        }
#pragma unroll
        for (int jp = 0; jp < NS / 2; ++jp) {
          uint32_t kf[4];
          ldmatrix_x4(kf, Kt + (ks + jp * 16 + lane % 8 + (lane / 16) * 8) *
                                   LD +
                              kc * 16 + ((lane / 8) % 2) * 8);
          mma_16816(s[2 * jp], qa, kf[0], kf[1]);
          mma_16816(s[2 * jp + 1], qa, kf[2], kf[3]);
        }
      }

#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[j][e] * scale;
          if (edge) {
            const int qi = r0 + (e / 2) * 8;
            const int kj = k0 + ks + j * 8 + 2 * t4 + e % 2;
            bool keep = kj < tkv;
            if (causal) keep = keep && qi >= kj;
            if (window > 0) keep = keep && qi - kj < window;
            x = keep ? x : -INFINITY;
          }
          s[j][e] = x;
        }

      // online softmax in registers; a row lives in one quad of lanes
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < NS; ++j)
          mx = fmaxf(mx, fmaxf(s[j][2 * i], s[j][2 * i + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_next = fmaxf(m_run[i], mx);
        const float corr = expf(m_run[i] - m_next);
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < NS; ++j) {
          const float p0 = expf(s[j][2 * i] - m_next);
          const float p1 = expf(s[j][2 * i + 1] - m_next);
          s[j][2 * i] = p0;
          s[j][2 * i + 1] = p1;
          sum += p0 + p1;
        }
        l_part[i] = l_part[i] * corr + sum;
        m_run[i] = m_next;
#pragma unroll
        for (int n = 0; n < NO; ++n) {
          o[n][2 * i] *= corr;
          o[n][2 * i + 1] *= corr;
        }
      }

      // O += P.V: P (rounded to bf16) from the S registers, V by
      // ldmatrix.trans
#pragma unroll
      for (int kk = 0; kk < NS / 2; ++kk) {
        uint32_t pa[4];
        c_to_a(pa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
        for (int np = 0; np < NO / 2; ++np) {
          uint32_t vf[4];
          ldmatrix_x4_trans(vf, Vt + (ks + kk * 16 + lane % 8 +
                                      ((lane / 8) % 2) * 8) * LD +
                                    np * 16 + (lane / 16) * 8);
          mma_16816(o[2 * np], pa, vf[0], vf[1]);
          mma_16816(o[2 * np + 1], pa, vf[2], vf[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with this stage
  }

  bf16* ob = out + ((int64_t)b * tq * heads + h) * dh;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_part[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float safe_l = l == 0.f ? 1.f : l;
    const int r = r0 + i * 8;
    if (r < tq) {
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        if constexpr (kPad) {  // padded columns are not stored
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int col = n * 8 + 2 * t4 + j;
            if (col < d)
              ob[r * tstride + col] = __float2bfloat16(o[n][2 * i + j] /
                                                       safe_l);
          }
        } else {
          *reinterpret_cast<uint32_t*>(ob + r * tstride + n * 8 + 2 * t4) =
              pack_bf16(o[n][2 * i] / safe_l, o[n][2 * i + 1] / safe_l);
        }
      }
      if (t4 == 0) lse[(int64_t)bh * tq + r] = m_run[i] + logf(safe_l);
    }
  }
}

template <int D, bool kPad>
int launch_mma(const void* q, const void* k, const void* v, void* out,
               void* lse, int batch, int heads, int tq, int tkv, int d,
               int vec, int causal, int window, float scale,
               cudaStream_t stream) {
  if (d > D || (!kPad && d != D)) return (int)cudaErrorInvalidValue;
  const size_t bytes = mma_smem_bytes<D>();
  cudaError_t err = dl4j_smem::set_max_dynamic_smem(
      reinterpret_cast<const void*>(flash_fwd_mma_kernel<D, kPad>),
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(batch * heads, (tq + kBQ - 1) / kBQ);
  flash_fwd_mma_kernel<D, kPad><<<grid, kMmaThreads, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out),
      static_cast<float*>(lse), heads, tq, tkv, d, vec, causal, window,
      scale);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 above 256: the tensor-core kernel with d streamed in chunks
// ---------------------------------------------------------------------------
constexpr int kWC = 64;   // columns of Q and K a chunk
constexpr int kWS = 128;  // output columns a block (grid z)

constexpr size_t wide_smem_bytes() {
  // Q and K chunks [2 stages][64][kWC+8], the V slice [64][kWS+8], bf16
  return ((size_t)4 * 64 * (kWC + 8) + (size_t)64 * (kWS + 8)) * sizeof(bf16);
}

// One block per (batch*head, 64-row query tile, 128-column output slice).
// Each key tile's S = Q.K^T is summed over d in chunks of 64 columns of Q
// and K, which stream through a two-stage cp.async ring, one (key tile,
// chunk) step after another; the tile's V slice arrives with its first
// chunk. Softmax and P.V are B1's: every slice computes the same m and l
// (the same arithmetic over the same keys), so lse comes from slice 0.
__global__ void __launch_bounds__(kMmaThreads)
flash_fwd_wide_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ out,
                      float* __restrict__ lse, int heads, int tq, int tkv,
                      int d, int vec, int causal, int window, float scale) {
  using namespace dl4j_mma;
  constexpr int LC = kWC + 8, LS = kWS + 8;  // padded shared rows
  constexpr int KC = kWC / 16;               // k-steps a chunk
  constexpr int NS = kBK / 8;                // 8-key column tiles of S
  constexpr int NO = kWS / 8;                // 8-wide output column tiles
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qc = reinterpret_cast<bf16*>(smem_raw);  // [2][64][LC]
  bf16* Kc = Qc + 2 * kBQ * LC;                  // [2][64][LC]
  bf16* Vs = Kc + 2 * kBK * LC;                  // [64][LS]

  const int bh = blockIdx.x;
  const int b = bh / heads, h = bh % heads;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // heavy tiles first
  const int c0 = blockIdx.z * kWS;  // this block's output columns
  const int nch = (d + kWC - 1) / kWC;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int64_t tstride = (int64_t)heads * d;
  const bf16* qb = q + ((int64_t)b * tq * heads + h) * d;
  const bf16* kb = k + ((int64_t)b * tkv * heads + h) * d;
  const bf16* vb = v + ((int64_t)b * tkv * heads + h) * d;

  int k_lo = 0, k_hi = tkv;
  if (causal) k_hi = min(tkv, q0 + kBQ);
  if (window > 0) k_lo = max(0, q0 - window + 1);
  const int kt_lo = k_lo / kBK, kt_hi = (k_hi + kBK - 1) / kBK;
  const int steps = (kt_hi - kt_lo) * nch;

  // step i: chunk i % nch of key tile kt_lo + i / nch, into stage i % 2
  auto load_step = [&](int i) {
    const int c = (i % nch) * kWC, st = i & 1;
    cp_tile_pad<kWC, kMmaThreads>(Qc + st * kBQ * LC, qb + c, q0, tq,
                                  tstride, d - c, vec);
    cp_tile_pad<kWC, kMmaThreads>(Kc + st * kBK * LC, kb + c,
                                  (kt_lo + i / nch) * kBK, tkv, tstride,
                                  d - c, vec);
  };
  load_step(0);
  cp_async_commit();

  const int r0 = q0 + warp * 16 + g;
  const int arow = (warp * 16 + lane % 16) * LC + (lane / 16) * 8;
  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m_run[2] = {kMaskValue, kMaskValue};
  float l_part[2] = {0.f, 0.f};
  float s[NS][4];

  for (int i = 0; i < steps; ++i) {
    const int ch = i % nch, st = i & 1;
    const int k0 = (kt_lo + i / nch) * kBK;
    if (ch == 0) {
      // the previous tile's P.V is done (the barrier closing each step)
      cp_tile_pad<kWS, kMmaThreads>(Vs, vb + c0, k0, tkv, tstride, d - c0,
                                    vec);
      cp_async_commit();
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    }
    if (i + 1 < steps) load_step(i + 1);
    cp_async_commit();
    cp_async_wait<1>();  // all but the prefetch have landed
    __syncthreads();

    const bf16* Qt = Qc + st * kBQ * LC;
    const bf16* Kt = Kc + st * kBK * LC;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      uint32_t qa[4];
      ldmatrix_x4(qa, Qt + arow + kc * 16);
#pragma unroll
      for (int jp = 0; jp < NS / 2; ++jp) {
        uint32_t kf[4];
        ldmatrix_x4(kf, Kt + (jp * 16 + lane % 8 + (lane / 16) * 8) * LC +
                            kc * 16 + ((lane / 8) % 2) * 8);
        mma_16816(s[2 * jp], qa, kf[0], kf[1]);
        mma_16816(s[2 * jp + 1], qa, kf[2], kf[3]);
      }
    }

    if (ch == nch - 1) {  // the tile's scores are whole: B1's softmax, P.V
      const bool edge = k0 + kBK > tkv || (causal && k0 + kBK - 1 > q0) ||
                        (window > 0 && q0 + kBQ - 1 - k0 >= window);
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[j][e] * scale;
          if (edge) {
            const int qi = r0 + (e / 2) * 8;
            const int kj = k0 + j * 8 + 2 * t4 + e % 2;
            bool keep = kj < tkv;
            if (causal) keep = keep && qi >= kj;
            if (window > 0) keep = keep && qi - kj < window;
            x = keep ? x : -INFINITY;
          }
          s[j][e] = x;
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < NS; ++j)
          mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_next = fmaxf(m_run[r], mx);
        const float corr = expf(m_run[r] - m_next);
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < NS; ++j) {
          const float p0 = expf(s[j][2 * r] - m_next);
          const float p1 = expf(s[j][2 * r + 1] - m_next);
          s[j][2 * r] = p0;
          s[j][2 * r + 1] = p1;
          sum += p0 + p1;
        }
        l_part[r] = l_part[r] * corr + sum;
        m_run[r] = m_next;
#pragma unroll
        for (int n = 0; n < NO; ++n) {
          o[n][2 * r] *= corr;
          o[n][2 * r + 1] *= corr;
        }
      }
#pragma unroll
      for (int kk = 0; kk < NS / 2; ++kk) {
        uint32_t pa[4];
        c_to_a(pa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
        for (int np = 0; np < NO / 2; ++np) {
          uint32_t vf[4];
          ldmatrix_x4_trans(vf, Vs + (kk * 16 + lane % 8 +
                                      ((lane / 8) % 2) * 8) * LS +
                                    np * 16 + (lane / 16) * 8);
          mma_16816(o[2 * np], pa, vf[0], vf[1]);
          mma_16816(o[2 * np + 1], pa, vf[2], vf[3]);
        }
      }
    }
    __syncthreads();  // this stage, and at a tile's end Vs, are free
  }

  bf16* ob = out + ((int64_t)b * tq * heads + h) * d;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_part[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float safe_l = l == 0.f ? 1.f : l;
    const int row = r0 + r * 8;
    if (row < tq) {
#pragma unroll
      for (int n = 0; n < NO; ++n)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int col = c0 + n * 8 + 2 * t4 + j;
          if (col < d)
            ob[row * tstride + col] = __float2bfloat16(o[n][2 * r + j] /
                                                       safe_l);
        }
      if (blockIdx.z == 0 && t4 == 0)
        lse[(int64_t)bh * tq + row] = m_run[r] + logf(safe_l);
    }
  }
}

int launch_wide(const void* q, const void* k, const void* v, void* out,
                void* lse, int batch, int heads, int tq, int tkv, int d,
                int vec, int causal, int window, float scale,
                cudaStream_t stream) {
  const size_t bytes = wide_smem_bytes();
  cudaError_t err = dl4j_smem::set_max_dynamic_smem(
      reinterpret_cast<const void*>(flash_fwd_wide_kernel), (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(batch * heads, (tq + kBQ - 1) / kBQ, (d + kWS - 1) / kWS);
  flash_fwd_wide_kernel<<<grid, kMmaThreads, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out),
      static_cast<float*>(lse), heads, tq, tkv, d, vec, causal, window,
      scale);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// f32 tensor-core variant (3xTF32, mma_tf32.cuh)
// ---------------------------------------------------------------------------
// the widest f32 row a tile keeps whole: given by the build
// (kernels/_build.py) from kernels/__init__.py's F32_TIER_MAX
#ifndef DL4J_F32_TIER_MAX
#error "DL4J_F32_TIER_MAX must be defined by the build"
#endif
constexpr int kF32TierMax = DL4J_F32_TIER_MAX;

// A block of the f32 tile kernel: 8 warps, two a 16-row group, each
// taking half of every key tile. Up to 64 two blocks share an SM and
// ptxas is held to the 128 registers a thread that leaves; above, one
// block an SM may take all 255.
constexpr int kTf32Threads = 256;
template <int D>
constexpr int kTf32BlocksPerSm = D <= 64 ? 2 : 1;

template <int D>
constexpr size_t tf32_smem_bytes() {
  // Q's big and small planes [64][D+4] and K, V [2 stages][64][D+4], f32
  return (size_t)6 * 64 * (D + 4) * sizeof(float);
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// One online-softmax step of a warp's 16 rows over NS x 8 keys, the first
// at key kj0: s = S * scale, masked scores -inf (evaluated on edge tiles
// only), then the running max m_run, this lane's share of the normaliser
// l_part and the output o rescaled; s leaves holding the unrounded p. r0:
// this thread's first row (the second is r0 + 8).
template <int NS, int NO>
__device__ __forceinline__ void softmax_step(float (&s)[NS][4],
                                             float (&o)[NO][4],
                                             float (&m_run)[2],
                                             float (&l_part)[2], float scale,
                                             bool edge, int r0, int kj0,
                                             int tkv, int causal,
                                             int window) {
  const int t4 = threadIdx.x % 4;
#pragma unroll
  for (int j = 0; j < NS; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = s[j][e] * scale;
      if (edge) {
        const int qi = r0 + (e / 2) * 8;
        const int kj = kj0 + j * 8 + 2 * t4 + e % 2;
        bool keep = kj < tkv;
        if (causal) keep = keep && qi >= kj;
        if (window > 0) keep = keep && qi - kj < window;
        x = keep ? x : -INFINITY;
      }
      s[j][e] = x;
    }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < NS; ++j)
      mx = fmaxf(mx, fmaxf(s[j][2 * i], s[j][2 * i + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_next = fmaxf(m_run[i], mx);
    const float corr = expf(m_run[i] - m_next);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      const float p0 = expf(s[j][2 * i] - m_next);
      const float p1 = expf(s[j][2 * i + 1] - m_next);
      s[j][2 * i] = p0;
      s[j][2 * i + 1] = p1;
      sum += p0 + p1;
    }
    l_part[i] = l_part[i] * corr + sum;
    m_run[i] = m_next;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      o[n][2 * i] *= corr;
      o[n][2 * i + 1] *= corr;
    }
  }
}

// O += P.V over NS x 8 keys in 3xTF32: p from the S registers as the A
// operand over permuted keys, V's rows kv0.. of a row-major [key][col]
// tile (rows `ld` floats apart) read in the same order.
template <int NS, int NO>
__device__ __forceinline__ void pv_tf32(float (&o)[NO][4],
                                        const float (&s)[NS][4],
                                        const float* V, int ld, int kv0) {
  using namespace dl4j_tf32;
#pragma unroll
  for (int kk = 0; kk < NS; ++kk) {
    FragA pa;
    c_as_a(pa, s[kk]);
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      float b0, b1;
      frag_b_kn(b0, b1, V, ld, kv0 + kk * 8, n * 8);
      mma_3x(o[n], pa, b0, b1);
    }
  }
}

// B1's loop in f32 on rows of up to 128 floats: D the width rows take in
// shared memory; kPad: rows hold d <= D floats in device memory (a padded
// tier), else d == D.
template <int D, bool kPad>
__global__ void __launch_bounds__(kTf32Threads, kTf32BlocksPerSm<D>)
flash_fwd_tf32_kernel(const float* __restrict__ q,
                      const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ out,
                      float* __restrict__ lse, int heads, int tq, int tkv,
                      int d, int vec, int causal, int window, float scale) {
  using namespace dl4j_tf32;
  using dl4j_mma::cp_async_commit;
  using dl4j_mma::cp_async_wait;
  constexpr int kThreads = kTf32Threads;
  constexpr int LD = D + 4;       // padded shared row, floats
  constexpr int KC = D / 8;       // k-steps of Q.K^T
  constexpr int KH = kBK / 2;     // a warp's keys a tile
  constexpr int NS = KH / 8;      // 8-key column tiles of S a warp
  constexpr int NO = D / 8;       // 8-wide column tiles of the output
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qb = reinterpret_cast<float*>(smem_raw);  // [64][LD] Q's big parts
  float* Qs = Qb + kBQ * LD;                       // [64][LD] small parts
  float* Ks = Qs + kBQ * LD;                       // [2][64][LD]
  float* Vs = Ks + 2 * kBK * LD;                   // [2][64][LD]

  const int bh = blockIdx.x;
  const int b = bh / heads, h = bh % heads;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // heavy tiles first
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int half = warp / 4;    // which half of every key tile
  const int dh = kPad ? d : D;  // floats a row in device memory
  const int64_t tstride = (int64_t)heads * dh;
  const int64_t qoff = ((int64_t)b * tq * heads + h) * dh;
  const int64_t koff = ((int64_t)b * tkv * heads + h) * dh;
  auto load = [&](float* dst, const float* src, int t0, int len) {
    cp_tile_f32<D, kThreads>(dst, src, t0, len, tstride, dh, !kPad || vec);
  };

  // the key tiles this query tile can see, as in the bf16 kernel
  int k_lo = 0, k_hi = tkv;
  if (causal) k_hi = min(tkv, q0 + kBQ);
  if (window > 0) k_lo = max(0, q0 - window + 1);
  const int kt_lo = k_lo / kBK, kt_hi = (k_hi + kBK - 1) / kBK;

  load(Qb, q + qoff, q0, tq);
  load(Ks, k + koff, kt_lo * kBK, tkv);
  load(Vs, v + koff, kt_lo * kBK, tkv);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  // Q split once a block: the big parts in place, the small ones beside;
  // the barrier after the first tile's wait orders these stores before
  // the fragment loads
  for (int i = threadIdx.x; i < kBQ * D; i += kThreads) {
    float* x = Qb + (i / D) * LD + i % D;
    uint32_t big, small;
    split(*x, big, small);
    x[0] = __uint_as_float(big);
    x[kBQ * LD] = __uint_as_float(small);
  }

  // this thread's rows of the warp's 16: r0 = q0 + qrow + g, r0 + 8
  const int qrow = (warp % 4) * 16;
  const int r0 = q0 + qrow + g;
  const int ks = half * KH;  // this warp's keys of every tile
  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m_run[2] = {kMaskValue, kMaskValue};
  float l_part[2] = {0.f, 0.f};  // this lane's share of each row's l

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int stage = (kt - kt_lo) & 1;
    if (kt + 1 < kt_hi) {  // prefetch the next tile into the other stage
      const int next = (stage ^ 1) * kBK * LD;
      load(Ks + next, k + koff, (kt + 1) * kBK, tkv);
      load(Vs + next, v + koff, (kt + 1) * kBK, tkv);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this tile has landed
    __syncthreads();
    const float* Kt = Ks + stage * kBK * LD;
    const float* Vt = Vs + stage * kBK * LD;
    const int k0 = kt * kBK;
    const bool edge = k0 + kBK > tkv || (causal && k0 + kBK - 1 > q0) ||
                      (window > 0 && q0 + kBQ - 1 - k0 >= window);

    // S = Q.K^T over this warp's keys: Q from its planes, K rows the B
    // operand's columns
    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll 1
    for (int kc = 0; kc < KC; ++kc) {
      FragA qa;
      frag_a_planes(qa, Qb, Qs, LD, qrow, kc * 8);
#pragma unroll
      for (int jp = 0; jp < NS / 2; ++jp) {
        float bk[4];
        frag_b_nk(bk, Kt, LD, ks + jp * 16, kc * 8);
        mma_3x(s[2 * jp], qa, bk[0], bk[1]);
        mma_3x(s[2 * jp + 1], qa, bk[2], bk[3]);
      }
    }
    softmax_step(s, o, m_run, l_part, scale, edge, r0, k0 + ks, tkv, causal,
                 window);
    pv_tf32(o, s, Vt, LD, ks);
    __syncthreads();  // every warp is done with this stage
  }

  // the second key half's state through shared memory (the K ring is
  // free; 128 threads x (D/2 + 4) floats fit in it), merged into the
  // first's in a fixed order
  cp_async_wait<0>();
  __syncthreads();
  float* part = Ks;  // value i of thread j at i * 128 + j
  const int j = threadIdx.x % 128;
  if (half == 1) {
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[(n * 4 + e) * 128 + j] = o[n][e];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      part[(NO * 4 + i) * 128 + j] = m_run[i];
      part[(NO * 4 + 2 + i) * 128 + j] = l_part[i];
    }
  }
  __syncthreads();
  if (half == 1) return;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float m1 = part[(NO * 4 + i) * 128 + j];
    const float m = fmaxf(m_run[i], m1);
    const float c0 = expf(m_run[i] - m), c1 = expf(m1 - m);
    l_part[i] = l_part[i] * c0 + part[(NO * 4 + 2 + i) * 128 + j] * c1;
    m_run[i] = m;
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int e = 2 * i + jj;
        o[n][e] = o[n][e] * c0 + part[(n * 4 + e) * 128 + j] * c1;
      }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float l = quad_sum(l_part[i]);
    const float safe_l = l == 0.f ? 1.f : l;
    const int r = r0 + i * 8;
    if (r < tq) {
      float* row = out + qoff + r * tstride + 2 * t4;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        if constexpr (kPad) {  // padded columns are not stored
#pragma unroll
          for (int jj = 0; jj < 2; ++jj)
            if (n * 8 + 2 * t4 + jj < d)
              row[n * 8 + jj] = o[n][2 * i + jj] / safe_l;
        } else {
          *reinterpret_cast<float2*>(row + n * 8) =
              make_float2(o[n][2 * i] / safe_l, o[n][2 * i + 1] / safe_l);
        }
      }
      if (t4 == 0) lse[(int64_t)bh * tq + r] = m_run[i] + logf(safe_l);
    }
  }
}

template <int D, bool kPad>
int launch_tf32(const void* q, const void* k, const void* v, void* out,
                void* lse, int batch, int heads, int tq, int tkv, int d,
                int vec, int causal, int window, float scale,
                cudaStream_t stream) {
  if (d > D || (!kPad && d != D)) return (int)cudaErrorInvalidValue;
  const size_t bytes = tf32_smem_bytes<D>();
  cudaError_t err = dl4j_smem::set_max_dynamic_smem(
      reinterpret_cast<const void*>(flash_fwd_tf32_kernel<D, kPad>),
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(batch * heads, (tq + kBQ - 1) / kBQ);
  flash_fwd_tf32_kernel<D, kPad><<<grid, kTf32Threads, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out),
      static_cast<float*>(lse), heads, tq, tkv, d, vec, causal, window,
      scale);
  return (int)cudaGetLastError();
}

// the f32 instantiation of a padded tier (widths up to kF32TierMax only;
// wider f32 rows take the wide kernel below)
template <int T>
int launch_tf32_tier(const void* q, const void* k, const void* v, void* out,
                     void* lse, int batch, int heads, int tq, int tkv, int d,
                     int vec, int causal, int window, float scale,
                     cudaStream_t stream) {
  if constexpr (T <= kF32TierMax)
    return launch_tf32<T, true>(q, k, v, out, lse, batch, heads, tq, tkv, d,
                                vec, causal, window, scale, stream);
  else
    return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// f32 above 128: the 3xTF32 kernel with d streamed in chunks
// ---------------------------------------------------------------------------
constexpr int kFC = 64;  // columns of Q and K a chunk, f32
constexpr int kFS = 64;  // output columns a block (grid z), f32

constexpr size_t wide_tf32_smem_bytes() {
  // Q and K chunks [2 stages][64][kFC+4] and the V slice [64][kFS+4], f32
  return ((size_t)4 * 64 * (kFC + 4) + (size_t)64 * (kFS + 4)) *
         sizeof(float);
}

// The bf16 wide kernel's schedule in f32: one block of 4 warps per
// (batch*head, 64-row query tile, 64-column output slice); each key
// tile's scores summed over d a chunk of 64 columns at a time, each
// chunk's Q.K^T in its own tile added to the scores in f32; Q and K
// chunks stream through a two-stage cp.async ring, the tile's V slice
// arrives with its first chunk. Every slice computes the same m and l, so
// lse comes from slice 0.
__global__ void __launch_bounds__(kMmaThreads)
flash_fwd_wide_tf32_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           float* __restrict__ out, float* __restrict__ lse,
                           int heads, int tq, int tkv, int d, int vec,
                           int causal, int window, float scale) {
  using namespace dl4j_tf32;
  using dl4j_mma::cp_async_commit;
  using dl4j_mma::cp_async_wait;
  constexpr int LC = kFC + 4, LS = kFS + 4;  // padded shared rows
  constexpr int KC = kFC / 8;                // k-steps a chunk
  constexpr int NS = kBK / 8;                // 8-key column tiles of S
  constexpr int NO = kFS / 8;                // 8-wide output column tiles
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qc = reinterpret_cast<float*>(smem_raw);  // [2][64][LC]
  float* Kc = Qc + 2 * kBQ * LC;                   // [2][64][LC]
  float* Vsl = Kc + 2 * kBK * LC;                  // [64][LS]

  const int bh = blockIdx.x;
  const int b = bh / heads, h = bh % heads;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // heavy tiles first
  const int c0 = blockIdx.z * kFS;  // this block's output columns
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
    cp_tile_f32<kFC, kMmaThreads>(Qc + st * kBQ * LC, q + qoff + c, q0, tq,
                                  tstride, d - c, vec);
    cp_tile_f32<kFC, kMmaThreads>(Kc + st * kBK * LC, k + koff + c,
                                  (kt_lo + i / nch) * kBK, tkv, tstride,
                                  d - c, vec);
  };
  load_step(0);
  cp_async_commit();

  const int qrow = warp * 16;
  const int r0 = q0 + qrow + g;
  float o[NO][4], s[NS][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m_run[2] = {kMaskValue, kMaskValue};
  float l_part[2] = {0.f, 0.f};

  for (int i = 0; i < steps; ++i) {
    const int ch = i % nch, st = i & 1;
    const int k0 = (kt_lo + i / nch) * kBK;
    if (ch == 0) {
      // the previous tile's P.V is done (the barrier closing each step)
      cp_tile_f32<kFS, kMmaThreads>(Vsl, v + koff + c0, k0, tkv, tstride,
                                    d - c0, vec);
      cp_async_commit();
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    }
    if (i + 1 < steps) load_step(i + 1);
    cp_async_commit();
    cp_async_wait<1>();  // all but the prefetch have landed
    __syncthreads();

    const float* Qt = Qc + st * kBQ * LC;
    const float* Kt = Kc + st * kBK * LC;
    float sc[NS][4];  // this chunk's share of the scores
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
#pragma unroll 1
    for (int kc = 0; kc < KC; ++kc) {
      FragA qa;
      frag_a(qa, Qt, LC, qrow, kc * 8);
#pragma unroll
      for (int jp = 0; jp < NS / 2; ++jp) {
        float bk[4];
        frag_b_nk(bk, Kt, LC, jp * 16, kc * 8);
        mma_3x(sc[2 * jp], qa, bk[0], bk[1]);
        mma_3x(sc[2 * jp + 1], qa, bk[2], bk[3]);
      }
    }
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] += sc[j][e];

    if (ch == nch - 1) {  // the tile's scores are whole: softmax, P.V
      const bool edge = k0 + kBK > tkv || (causal && k0 + kBK - 1 > q0) ||
                        (window > 0 && q0 + kBQ - 1 - k0 >= window);
      softmax_step(s, o, m_run, l_part, scale, edge, r0, k0, tkv, causal,
                   window);
      pv_tf32(o, s, Vsl, LS, 0);
    }
    __syncthreads();  // this stage, and at a tile's end Vsl, are free
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float l = quad_sum(l_part[i]);
    const float safe_l = l == 0.f ? 1.f : l;
    const int r = r0 + i * 8;
    if (r < tq) {
      float* row = out + qoff + r * tstride;
#pragma unroll
      for (int n = 0; n < NO; ++n)
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int col = c0 + n * 8 + 2 * t4 + jj;
          if (col < d) row[col] = o[n][2 * i + jj] / safe_l;
        }
      if (blockIdx.z == 0 && t4 == 0)
        lse[(int64_t)bh * tq + r] = m_run[i] + logf(safe_l);
    }
  }
}

int launch_wide_tf32(const void* q, const void* k, const void* v, void* out,
                     void* lse, int batch, int heads, int tq, int tkv, int d,
                     int vec, int causal, int window, float scale,
                     cudaStream_t stream) {
  const size_t bytes = wide_tf32_smem_bytes();
  cudaError_t err = dl4j_smem::set_max_dynamic_smem(
      reinterpret_cast<const void*>(flash_fwd_wide_tf32_kernel), (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(batch * heads, (tq + kBQ - 1) / kBQ, (d + kFS - 1) / kFS);
  flash_fwd_wide_tf32_kernel<<<grid, kMmaThreads, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out),
      static_cast<float*>(lse), heads, tq, tkv, d, vec, causal, window,
      scale);
  return (int)cudaGetLastError();
}

}  // namespace

// The padded tiers, one `DL4J_TIER(width)` entry each: given by the build
// (kernels/_build.py) from kernels/__init__.py's MMA_TIERS; f32 takes
// those up to DL4J_F32_TIER_MAX
#ifndef DL4J_MMA_TIERS
#error "DL4J_MMA_TIERS must be defined by the build"
#endif

// route: 0 = exact (head_dim 64 or 128, unpadded), 1 = tier (rows padded
// to `tier`: bf16 up to 256, f32 up to 128), 3 = wide (d streamed in
// chunks: bf16 above 256, f32 above 128). vec: rows may move in 16-byte
// cp.async copies (tier, wide). dtype: 0 = float32 (3xTF32), 1 =
// bfloat16. window <= 0 means no window.
extern "C" int dl4j_flash_fwd(const void* q, const void* k, const void* v,
                              void* out, void* lse, int batch, int heads,
                              int tq, int tkv, int head_dim, int route,
                              int tier, int vec, int dtype, int causal,
                              int window, float scale, void* stream) {
  if (batch < 1 || heads < 1 || tq < 1 || tkv < 1 || head_dim < 1 ||
      (int64_t)batch * heads > 0x7fffffff || (tq + kBQ - 1) / kBQ > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int d = head_dim;
  if (route == 0) {
    if (dtype == 0 && d == 64)
      return launch_tf32<64, false>(q, k, v, out, lse, batch, heads, tq, tkv,
                                    d, 1, causal, window, scale, s);
    if (dtype == 0 && d == 128)
      return launch_tf32<128, false>(q, k, v, out, lse, batch, heads, tq,
                                     tkv, d, 1, causal, window, scale, s);
    if (dtype == 1 && d == 64)
      return launch_mma<64, false>(q, k, v, out, lse, batch, heads, tq, tkv,
                                   d, 1, causal, window, scale, s);
    if (dtype == 1 && d == 128)
      return launch_mma<128, false>(q, k, v, out, lse, batch, heads, tq,
                                    tkv, d, 1, causal, window, scale, s);
  } else if (route == 1 && dtype == 1) {
    switch (tier) {
#define DL4J_TIER(T)                                                       \
  case T:                                                                  \
    return launch_mma<T, true>(q, k, v, out, lse, batch, heads, tq, tkv, d, \
                               vec, causal, window, scale, s);
      DL4J_MMA_TIERS
#undef DL4J_TIER
    }
  } else if (route == 1 && dtype == 0) {
    switch (tier) {
#define DL4J_TIER(T)                                                    \
  case T:                                                               \
    return launch_tf32_tier<T>(q, k, v, out, lse, batch, heads, tq, tkv, \
                               d, vec, causal, window, scale, s);
      DL4J_MMA_TIERS
#undef DL4J_TIER
    }
  } else if (route == 3 && dtype == 1) {
    return launch_wide(q, k, v, out, lse, batch, heads, tq, tkv, d, vec,
                       causal, window, scale, s);
  } else if (route == 3 && dtype == 0) {
    return launch_wide_tf32(q, k, v, out, lse, batch, heads, tq, tkv, d, vec,
                            causal, window, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}
