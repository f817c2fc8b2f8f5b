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
// B2 and B3 f32 (dtype 0): "fma f32", the first kernels of this file,
// which take f32 inputs only since every bf16 launch runs on the tensor
// cores. One block of 256 threads; K, V, Q and dO staged in shared
// memory as f32 tiles; p and ds passed through shared memory; scalar f32
// FMAs. A tensor-core f32 path would need TF32, which cannot pass the
// f32 gate (1e-4).
//
// Every head_dim the reference takes runs, by the route the Python launch
// plan chose (`launch_plan` in kernels/flash_attention.py), as in
// flash_fwd.cu:
// - exact (d 64 or 128): the kernels above and below, unpadded;
// - tier (bf16, any other d up to 256): the tensor-core kernels compiled
//   for the next width of DL4J_MMA_TIERS, rows zero-padded to it in
//   shared memory, padded columns never stored, rows that are not
//   16-byte aligned copied element by element. Above 128, B2's dk and dv
//   accumulators would take the tier's width in registers a thread, so
//   each B2 block writes one of two column slices (grid z) and recomputes
//   S^T and dP^T over the whole d (1.5x B2's products); B3 takes each
//   key tile in passes of 32 keys to shrink its s and dp registers (at
//   256 ptxas spills a few bytes of B2 and B3; passes of 16, which spill
//   none, ran 8-10 % slower);
// - wide (bf16 above 256): the tensor-core kernels with d streamed in
//   chunks of 64 columns for S and dP (two-stage cp.async rings) and the
//   output in slices of 128 columns (grid z), recomputing S and dP over
//   the whole d for each slice. B2 takes query tiles of 32 rows there:
//   its 128 dk and dv accumulator floats a thread leave room for the s
//   and dp of 32 queries, not 64;
// - chunked (f32 at any other d): "fma f32", CUDA-core kernels that take
//   d in chunks of 64 columns for S and dP and write one slice of 64
//   output columns a block (grid z), recomputing S and dP over the whole
//   d for each slice.
// Every kernel puts batch*head on grid x (up to 2^31 - 1).
//
// Bound on an H100: B2 does 8*b*h*d*sum(visible keys) FLOPs (s, dp, dv,
// dk), B3 6*b*h*d*sum(visible) (s, dp, dq), against 989 TFLOP/s (bf16)
// or 67 TFLOP/s (f32); both read q, k, v, do once in the input dtype and
// lse, delta in f32, and write their outputs in f32, against 3.35 TB/s.
// Left on the table: wgmma, TMA and warp specialisation, and a schedule
// that balances the causal key tiles across the 132 SMs.
//
// C entry points `dl4j_flash_bwd_dkdv` and `dl4j_flash_bwd_dq` (loaded
// with ctypes) return the CUDA error code of the launch (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"
#include "smem_attr.cuh"

namespace {

constexpr int kBQ = 64;        // query rows per tile
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 256;  // 16 x 16 thread grid

// rows [t0, t0 + 64) of one head of a BTHD f32 tensor into a [64][D+1]
// tile; rows at or past `len` are zeros
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int t0, int len, int64_t tstride) {
  for (int i = threadIdx.x; i < 64 * D; i += kThreads) {
    const int r = i / D, c = i % D, t = t0 + r;
    dst[r * (D + 1) + c] = t < len ? src[t * tstride + c] : 0.f;
  }
}

__device__ __forceinline__ bool visible(int qi, int kj, int tq, int tkv,
                                        int causal, int window) {
  bool keep = qi < tq && kj < tkv;
  if (causal) keep = keep && qi >= kj;
  if (window > 0) keep = keep && qi - kj < window;
  return keep;
}

template <int D>
constexpr size_t dkdv_smem_floats() {
  // K, V, Q, dO [64][D+1]; P, dS [BK][BQ+1]; lse, delta [BQ]
  return 4 * 64 * (D + 1) + 2 * kBK * (kBQ + 1) + 2 * kBQ;
}

template <int D>
constexpr size_t dq_smem_floats() {
  // Q, dO, K, V [64][D+1]; dS [BQ][BK+1]; lse, delta [BQ]
  return 4 * 64 * (D + 1) + kBQ * (kBK + 1) + 2 * kBQ;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const float* __restrict__ q,
                      const float* __restrict__ k,
                      const float* __restrict__ v,
                      const float* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      float* __restrict__ dk, float* __restrict__ dv,
                      int heads, int tq, int tkv, int causal, int window,
                      float scale) {
  extern __shared__ float smem[];
  float* Ks = smem;                        // [BK][D+1]
  float* Vs = Ks + kBK * (D + 1);          // [BK][D+1]
  float* Qs = Vs + kBK * (D + 1);          // [BQ][D+1]
  float* dOs = Qs + kBQ * (D + 1);         // [BQ][D+1]
  float* Ps = dOs + kBQ * (D + 1);         // [BK][BQ+1] p
  float* dSs = Ps + kBK * (kBQ + 1);       // [BK][BQ+1] ds
  float* lse_s = dSs + kBK * (kBQ + 1);    // [BQ]
  float* delta_s = lse_s + kBQ;            // [BQ]

  const int bh = blockIdx.x;
  const int b = bh / heads, h = bh % heads;
  const int k0 = blockIdx.y * kBK;  // causal: the heaviest tiles come first
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int64_t tstride = (int64_t)heads * D;
  const int64_t qoff = ((int64_t)b * tq * heads + h) * D;
  const int64_t koff = ((int64_t)b * tkv * heads + h) * D;
  const float* lse_b = lse + (int64_t)bh * tq;
  const float* delta_b = delta + (int64_t)bh * tq;

  load_tile<D>(Ks, k + koff, k0, tkv, tstride);
  load_tile<D>(Vs, v + koff, k0, tkv, tstride);

  constexpr int CJ = D / 16;
  float dk_acc[4][CJ], dv_acc[4][CJ];  // key rows ty + 16*i, cols tx + 16*j
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < CJ; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  // query range that can see this key tile: the causal diagonal bounds it
  // from below, the window's far edge from above
  int q_lo = 0, q_hi = tq;
  if (causal) q_lo = k0;
  if (window > 0) q_hi = min(tq, k0 + kBK - 1 + window);
  const int qt_lo = q_lo / kBQ, qt_hi = (q_hi + kBQ - 1) / kBQ;

  for (int qt = qt_lo; qt < qt_hi; ++qt) {
    const int q0 = qt * kBQ;
    __syncthreads();  // the previous tile's Q/dO/P/dS reads are done
    load_tile<D>(Qs, q + qoff, q0, tq, tstride);
    load_tile<D>(dOs, dout + qoff, q0, tq, tstride);
    if (tid < kBQ) {
      const int t = q0 + tid;
      lse_s[tid] = t < tq ? lse_b[t] : 0.f;
      delta_s[tid] = t < tq ? delta_b[t] : 0.f;
    }
    __syncthreads();

    // s = K.Q^T and dp = V.dO^T for a 4 x 4 micro-tile per thread
    // (key rows ty + 16*i, query columns tx + 16*j)
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float kv[4], vv[4], qv[4], dov[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        kv[i] = Ks[(ty + 16 * i) * (D + 1) + d];
        vv[i] = Vs[(ty + 16 * i) * (D + 1) + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        qv[j] = Qs[(tx + 16 * j) * (D + 1) + d];
        dov[j] = dOs[(tx + 16 * j) * (D + 1) + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(kv[i], qv[j], s[i][j]);
          dp[i][j] = fmaf(vv[i], dov[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const bool keep = visible(q0 + c, k0 + r, tq, tkv, causal, window);
        const float p = keep ? expf(s[i][j] * scale - lse_s[c]) : 0.f;
        Ps[r * (kBQ + 1) + c] = p;
        dSs[r * (kBQ + 1) + c] = p * (dp[i][j] - delta_s[c]) * scale;
      }
    }
    __syncthreads();

    // dv += P.dO, dk += dS.Q over this tile's queries
#pragma unroll 4
    for (int qq = 0; qq < kBQ; ++qq) {
      float p[4], ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        p[i] = Ps[(ty + 16 * i) * (kBQ + 1) + qq];
        ds[i] = dSs[(ty + 16 * i) * (kBQ + 1) + qq];
      }
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const float dov = dOs[qq * (D + 1) + tx + 16 * j];
        const float qv = Qs[qq * (D + 1) + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          dv_acc[i][j] = fmaf(p[i], dov, dv_acc[i][j]);
          dk_acc[i][j] = fmaf(ds[i], qv, dk_acc[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = k0 + ty + 16 * i;
    if (t < tkv) {
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        dk[koff + t * tstride + tx + 16 * j] = dk_acc[i][j];
        dv[koff + t * tstride + tx + 16 * j] = dv_acc[i][j];
      }
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dq,
                    int heads, int tq, int tkv, int causal, int window,
                    float scale) {
  extern __shared__ float smem[];
  float* Qs = smem;                        // [BQ][D+1]
  float* dOs = Qs + kBQ * (D + 1);         // [BQ][D+1]
  float* Ks = dOs + kBQ * (D + 1);         // [BK][D+1]
  float* Vs = Ks + kBK * (D + 1);          // [BK][D+1]
  float* dSs = Vs + kBK * (D + 1);         // [BQ][BK+1] ds
  float* lse_s = dSs + kBQ * (kBK + 1);    // [BQ]
  float* delta_s = lse_s + kBQ;            // [BQ]

  const int bh = blockIdx.x;
  const int b = bh / heads, h = bh % heads;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // heavy tiles first
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int64_t tstride = (int64_t)heads * D;
  const int64_t qoff = ((int64_t)b * tq * heads + h) * D;
  const int64_t koff = ((int64_t)b * tkv * heads + h) * D;

  load_tile<D>(Qs, q + qoff, q0, tq, tstride);
  load_tile<D>(dOs, dout + qoff, q0, tq, tstride);
  if (tid < kBQ) {
    const int t = q0 + tid;
    lse_s[tid] = t < tq ? lse[(int64_t)bh * tq + t] : 0.f;
    delta_s[tid] = t < tq ? delta[(int64_t)bh * tq + t] : 0.f;
  }

  constexpr int CJ = D / 16;
  float dq_acc[4][CJ];  // query rows ty + 16*i, cols tx + 16*j
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < CJ; ++j) dq_acc[i][j] = 0.f;

  // key band of this query tile, as in the forward
  int k_lo = 0, k_hi = tkv;
  if (causal) k_hi = min(tkv, q0 + kBQ);
  if (window > 0) k_lo = max(0, q0 - window + 1);
  const int kt_lo = k_lo / kBK, kt_hi = (k_hi + kBK - 1) / kBK;

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile's K/dS reads are done
    load_tile<D>(Ks, k + koff, k0, tkv, tstride);
    load_tile<D>(Vs, v + koff, k0, tkv, tstride);
    __syncthreads();

    // s = Q.K^T and dp = dO.V^T (query rows ty + 16*i, key columns
    // tx + 16*j)
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], dov[4], kv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = Qs[(ty + 16 * i) * (D + 1) + d];
        dov[i] = dOs[(ty + 16 * i) * (D + 1) + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kv[j] = Ks[(tx + 16 * j) * (D + 1) + d];
        vv[j] = Vs[(tx + 16 * j) * (D + 1) + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(dov[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const bool keep = visible(q0 + r, k0 + c, tq, tkv, causal, window);
        const float p = keep ? expf(s[i][j] * scale - lse_s[r]) : 0.f;
        dSs[r * (kBK + 1) + c] = p * (dp[i][j] - delta_s[r]) * scale;
      }
    }
    __syncthreads();

    // dq += dS.K over this tile's keys
#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ds[i] = dSs[(ty + 16 * i) * (kBK + 1) + kk];
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const float kv = Ks[kk * (D + 1) + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) dq_acc[i][j] = fmaf(ds[i], kv, dq_acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + ty + 16 * i;
    if (t < tq) {
#pragma unroll
      for (int j = 0; j < CJ; ++j)
        dq[qoff + t * tstride + tx + 16 * j] = dq_acc[i][j];
    }
  }
}

struct Args {
  const void *q, *k, *v, *dout, *lse, *delta;
  int batch, heads, tq, tkv, d, vec, causal, window;
  float scale;
  cudaStream_t stream;
};

template <int D>
int launch_dkdv(const Args& a, void* dk, void* dv) {
  const size_t bytes = dkdv_smem_floats<D>() * sizeof(float);
  cudaError_t err = dl4j_smem::set_max_dynamic_smem(
      reinterpret_cast<const void*>(flash_bwd_dkdv_kernel<D>), (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(a.batch * a.heads, (a.tkv + kBK - 1) / kBK);
  flash_bwd_dkdv_kernel<D><<<grid, kThreads, bytes, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<float*>(dk), static_cast<float*>(dv), a.heads, a.tq,
      a.tkv, a.causal, a.window, a.scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dq(const Args& a, void* dq) {
  const size_t bytes = dq_smem_floats<D>() * sizeof(float);
  cudaError_t err = dl4j_smem::set_max_dynamic_smem(
      reinterpret_cast<const void*>(flash_bwd_dq_kernel<D>), (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(a.batch * a.heads, (a.tq + kBQ - 1) / kBQ);
  flash_bwd_dq_kernel<D><<<grid, kThreads, bytes, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<float*>(dq), a.heads, a.tq, a.tkv, a.causal, a.window,
      a.scale);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// B2 and B3 f32 at any other head_dim: the FMA kernels with d in chunks
// ---------------------------------------------------------------------------
constexpr int kC = 64;       // columns a chunk of S/dP and a slice of output
constexpr int kLC = kC + 1;  // padded shared row of a chunk, floats

// columns [c0, c0 + C) of rows [t0, t0 + 64) of one head of a BTHD f32
// tensor into a [64][C+1] tile; rows at or past `len` and columns at or
// past `d` are zeros
__device__ __forceinline__ void load_chunk(float* dst, const float* src,
                                           int t0, int len, int c0, int d,
                                           int64_t tstride) {
  for (int i = threadIdx.x; i < 64 * kC; i += kThreads) {
    const int r = i / kC, c = i % kC, t = t0 + r, col = c0 + c;
    dst[r * kLC + c] = t < len && col < d ? src[t * tstride + col] : 0.f;
  }
}

constexpr size_t dkdv_chunked_smem_floats() {
  // K, V, Q, dO chunks and P, dS [64][C+1]; lse, delta [BQ]
  return 6 * 64 * kLC + 2 * kBQ;
}

constexpr size_t dq_chunked_smem_floats() {
  // Q, dO, K, V chunks and dS [64][C+1]; lse, delta [BQ]
  return 5 * 64 * kLC + 2 * kBQ;
}

__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_chunked_kernel(const float* __restrict__ q,
                              const float* __restrict__ k,
                              const float* __restrict__ v,
                              const float* __restrict__ dout,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta,
                              float* __restrict__ dk, float* __restrict__ dv,
                              int heads, int tq, int tkv, int d, int causal,
                              int window, float scale) {
  extern __shared__ float smem[];
  float* Ks = smem;                  // [BK][C+1] a chunk of K
  float* Vs = Ks + kBK * kLC;        // [BK][C+1] a chunk of V
  float* Qs = Vs + kBK * kLC;        // [BQ][C+1] a chunk, then the slice
  float* dOs = Qs + kBQ * kLC;       // [BQ][C+1] a chunk, then the slice
  float* Ps = dOs + kBQ * kLC;       // [BK][C+1] p
  float* dSs = Ps + kBK * kLC;       // [BK][C+1] ds
  float* lse_s = dSs + kBK * kLC;    // [BQ]
  float* delta_s = lse_s + kBQ;      // [BQ]

  const int bh = blockIdx.x;
  const int b = bh / heads, h = bh % heads;
  const int k0 = blockIdx.y * kBK;  // causal: the heaviest tiles come first
  const int c0 = blockIdx.z * kC;   // this block's dk and dv columns
  const int nch = (d + kC - 1) / kC;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int64_t tstride = (int64_t)heads * d;
  const int64_t qoff = ((int64_t)b * tq * heads + h) * d;
  const int64_t koff = ((int64_t)b * tkv * heads + h) * d;
  const float* lse_b = lse + (int64_t)bh * tq;
  const float* delta_b = delta + (int64_t)bh * tq;

  // one chunk: K and V stay in shared memory for the whole block
  if (nch == 1) {
    load_chunk(Ks, k + koff, k0, tkv, 0, d, tstride);
    load_chunk(Vs, v + koff, k0, tkv, 0, d, tstride);
  }
  float dk_acc[4][4], dv_acc[4][4];  // key rows ty + 16*i, cols c0+tx+16*j
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  int q_lo = 0, q_hi = tq;
  if (causal) q_lo = k0;
  if (window > 0) q_hi = min(tq, k0 + kBK - 1 + window);
  const int qt_lo = q_lo / kBQ, qt_hi = (q_hi + kBQ - 1) / kBQ;

  for (int qt = qt_lo; qt < qt_hi; ++qt) {
    const int q0 = qt * kBQ;
    // s = K.Q^T and dp = V.dO^T over the whole d, chunk by chunk (key
    // rows ty + 16*i, query columns tx + 16*j)
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
    for (int ch = 0; ch < nch; ++ch) {
      __syncthreads();  // the previous chunk's (or tile's) reads are done
      if (nch > 1) {
        load_chunk(Ks, k + koff, k0, tkv, ch * kC, d, tstride);
        load_chunk(Vs, v + koff, k0, tkv, ch * kC, d, tstride);
      }
      load_chunk(Qs, q + qoff, q0, tq, ch * kC, d, tstride);
      load_chunk(dOs, dout + qoff, q0, tq, ch * kC, d, tstride);
      if (ch == 0 && tid < kBQ) {
        const int t = q0 + tid;
        lse_s[tid] = t < tq ? lse_b[t] : 0.f;
        delta_s[tid] = t < tq ? delta_b[t] : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int dd = 0; dd < kC; ++dd) {
        float kv[4], vv[4], qv[4], dov[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          kv[i] = Ks[(ty + 16 * i) * kLC + dd];
          vv[i] = Vs[(ty + 16 * i) * kLC + dd];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          qv[j] = Qs[(tx + 16 * j) * kLC + dd];
          dov[j] = dOs[(tx + 16 * j) * kLC + dd];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] = fmaf(kv[i], qv[j], s[i][j]);
            dp[i][j] = fmaf(vv[i], dov[j], dp[i][j]);
          }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const bool keep = visible(q0 + c, k0 + r, tq, tkv, causal, window);
        const float p = keep ? expf(s[i][j] * scale - lse_s[c]) : 0.f;
        Ps[r * kLC + c] = (p);
        dSs[r * kLC + c] = (p * (dp[i][j] - delta_s[c]) * scale);
      }
    }
    if (nch > 1) {  // this block's columns of Q and dO for dk and dv
      __syncthreads();
      load_chunk(Qs, q + qoff, q0, tq, c0, d, tstride);
      load_chunk(dOs, dout + qoff, q0, tq, c0, d, tstride);
    }
    __syncthreads();

    // dv += P.dO, dk += dS.Q over this tile's queries, this slice's columns
#pragma unroll 4
    for (int qq = 0; qq < kBQ; ++qq) {
      float p[4], ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        p[i] = Ps[(ty + 16 * i) * kLC + qq];
        ds[i] = dSs[(ty + 16 * i) * kLC + qq];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float dov = dOs[qq * kLC + tx + 16 * j];
        const float qv = Qs[qq * kLC + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          dv_acc[i][j] = fmaf(p[i], dov, dv_acc[i][j]);
          dk_acc[i][j] = fmaf(ds[i], qv, dk_acc[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = k0 + ty + 16 * i;
    if (t < tkv) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = c0 + tx + 16 * j;
        if (col < d) {
          dk[koff + t * tstride + col] = dk_acc[i][j];
          dv[koff + t * tstride + col] = dv_acc[i][j];
        }
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_chunked_kernel(const float* __restrict__ q, const float* __restrict__ k,
                            const float* __restrict__ v,
                            const float* __restrict__ dout,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            float* __restrict__ dq, int heads, int tq,
                            int tkv, int d, int causal, int window,
                            float scale) {
  extern __shared__ float smem[];
  float* Qs = smem;                  // [BQ][C+1] a chunk of Q
  float* dOs = Qs + kBQ * kLC;       // [BQ][C+1] a chunk of dO
  float* Ks = dOs + kBQ * kLC;       // [BK][C+1] a chunk, then the slice
  float* Vs = Ks + kBK * kLC;        // [BK][C+1] a chunk of V
  float* dSs = Vs + kBK * kLC;       // [BQ][C+1] ds
  float* lse_s = dSs + kBQ * kLC;    // [BQ]
  float* delta_s = lse_s + kBQ;      // [BQ]

  const int bh = blockIdx.x;
  const int b = bh / heads, h = bh % heads;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // heavy tiles first
  const int c0 = blockIdx.z * kC;  // this block's dq columns
  const int nch = (d + kC - 1) / kC;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int64_t tstride = (int64_t)heads * d;
  const int64_t qoff = ((int64_t)b * tq * heads + h) * d;
  const int64_t koff = ((int64_t)b * tkv * heads + h) * d;

  if (nch == 1) {  // one chunk: Q and dO stay in shared memory
    load_chunk(Qs, q + qoff, q0, tq, 0, d, tstride);
    load_chunk(dOs, dout + qoff, q0, tq, 0, d, tstride);
  }
  if (tid < kBQ) {
    const int t = q0 + tid;
    lse_s[tid] = t < tq ? lse[(int64_t)bh * tq + t] : 0.f;
    delta_s[tid] = t < tq ? delta[(int64_t)bh * tq + t] : 0.f;
  }
  float dq_acc[4][4];  // query rows ty + 16*i, cols c0 + tx + 16*j
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) dq_acc[i][j] = 0.f;

  int k_lo = 0, k_hi = tkv;
  if (causal) k_hi = min(tkv, q0 + kBQ);
  if (window > 0) k_lo = max(0, q0 - window + 1);
  const int kt_lo = k_lo / kBK, kt_hi = (k_hi + kBK - 1) / kBK;

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int k0 = kt * kBK;
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
    for (int ch = 0; ch < nch; ++ch) {
      __syncthreads();  // the previous chunk's (or tile's) reads are done
      if (nch > 1) {
        load_chunk(Qs, q + qoff, q0, tq, ch * kC, d, tstride);
        load_chunk(dOs, dout + qoff, q0, tq, ch * kC, d, tstride);
      }
      load_chunk(Ks, k + koff, k0, tkv, ch * kC, d, tstride);
      load_chunk(Vs, v + koff, k0, tkv, ch * kC, d, tstride);
      __syncthreads();
#pragma unroll 4
      for (int dd = 0; dd < kC; ++dd) {
        float qv[4], dov[4], kv[4], vv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          qv[i] = Qs[(ty + 16 * i) * kLC + dd];
          dov[i] = dOs[(ty + 16 * i) * kLC + dd];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          kv[j] = Ks[(tx + 16 * j) * kLC + dd];
          vv[j] = Vs[(tx + 16 * j) * kLC + dd];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
            dp[i][j] = fmaf(dov[i], vv[j], dp[i][j]);
          }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const bool keep = visible(q0 + r, k0 + c, tq, tkv, causal, window);
        const float p = keep ? expf(s[i][j] * scale - lse_s[r]) : 0.f;
        dSs[r * kLC + c] = (p * (dp[i][j] - delta_s[r]) * scale);
      }
    }
    if (nch > 1) {  // this block's columns of K for dq
      __syncthreads();
      load_chunk(Ks, k + koff, k0, tkv, c0, d, tstride);
    }
    __syncthreads();

    // dq += dS.K over this tile's keys, this slice's columns
#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ds[i] = dSs[(ty + 16 * i) * kLC + kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float kv = Ks[kk * kLC + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) dq_acc[i][j] = fmaf(ds[i], kv, dq_acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + ty + 16 * i;
    if (t < tq) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = c0 + tx + 16 * j;
        if (col < d) dq[qoff + t * tstride + col] = dq_acc[i][j];
      }
    }
  }
}

int launch_dkdv_chunked(const Args& a, void* dk, void* dv) {
  const size_t bytes = dkdv_chunked_smem_floats() * sizeof(float);
  cudaError_t err = dl4j_smem::set_max_dynamic_smem(
      reinterpret_cast<const void*>(flash_bwd_dkdv_chunked_kernel),
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(a.batch * a.heads, (a.tkv + kBK - 1) / kBK, (a.d + kC - 1) / kC);
  flash_bwd_dkdv_chunked_kernel<<<grid, kThreads, bytes, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<float*>(dk), static_cast<float*>(dv), a.heads, a.tq,
      a.tkv, a.d, a.causal, a.window, a.scale);
  return (int)cudaGetLastError();
}

int launch_dq_chunked(const Args& a, void* dq) {
  const size_t bytes = dq_chunked_smem_floats() * sizeof(float);
  cudaError_t err = dl4j_smem::set_max_dynamic_smem(
      reinterpret_cast<const void*>(flash_bwd_dq_chunked_kernel),
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(a.batch * a.heads, (a.tq + kBQ - 1) / kBQ, (a.d + kC - 1) / kC);
  flash_bwd_dq_chunked_kernel<<<grid, kThreads, bytes, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<float*>(dq), a.heads, a.tq, a.tkv, a.d, a.causal,
      a.window, a.scale);
  return (int)cudaGetLastError();
}

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

// route: 0 = exact (head_dim 64 or 128, unpadded), 1 = tier (bf16, rows
// padded to `tier`), 2 = chunked (f32, any head_dim), 3 = wide (bf16
// above 256). vec: rows may move in 16-byte cp.async copies (tier, wide).
// dtype: 0 = float32, 1 = bfloat16. window <= 0 means no window.
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
    if (dtype == 0 && head_dim == 64) return launch_dkdv<64>(a, dk, dv);
    if (dtype == 0 && head_dim == 128) return launch_dkdv<128>(a, dk, dv);
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
  } else if (route == 2 && dtype == 0) {
    return launch_dkdv_chunked(a, dk, dv);
  } else if (route == 3 && dtype == 1) {
    return launch_dkdv_wide(a, dk, dv);
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
    if (dtype == 0 && head_dim == 64) return launch_dq<64>(a, dq);
    if (dtype == 0 && head_dim == 128) return launch_dq<128>(a, dq);
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
  } else if (route == 2 && dtype == 0) {
    return launch_dq_chunked(a, dq);
  } else if (route == 3 && dtype == 1) {
    return launch_dq_wide(a, dq);
  }
  return (int)cudaErrorInvalidValue;
}
