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
// - tier (bf16, any other d up to 256): the tensor-core kernel compiled
//   for the next width of DL4J_MMA_TIERS, each row zero-padded to it in
//   shared memory. Zero columns add nothing to Q.K^T; padded output
//   columns are never stored; the scale is the real d's. Above 128 the
//   Q fragments no longer fit beside the output accumulators (D/2
//   floats a thread) and are re-read from shared memory per key tile;
//   at 256 a key tile is taken in passes of 32 keys.
//   Rows whose starts are not 16-byte aligned (d % 8 != 0) are copied
//   element by element instead of by 16-byte cp.async;
// - wide (bf16 above 256): the tensor-core kernel with d streamed in
//   chunks of 64 columns for Q.K^T and the output in slices of 128
//   columns (grid z); each slice recomputes the scores over the whole d
//   (QK^T ceil(d/128) times);
// - chunked (f32 at any other d): "fma f32" with d taken in chunks of 64
//   columns for Q.K^T and one slice of 64 output columns a block (grid
//   z); each slice recomputes the scores over the whole d.
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
//   -inf and the running max starts at -1e30, as before; only tiles that
//   cross the causal diagonal, the window edge or the sequence end
//   evaluate the mask.
// - l sums the unrounded f32 p (the reference's `_fwd_kernel:93`); p is
//   rounded to bf16 only as the A operand of P.V, taken straight from the
//   S accumulators, with V's B operand read by ldmatrix.trans.
// - Key tiles are visited in the same order, with the same per-row
//   arithmetic, whatever tq is, so a query row's result does not depend
//   on how far the prompt was padded (the server's bucketed prefill
//   equals `generate`'s exact one).
// - The grid is (batch*head, query tile) with the query tiles issued
//   last-first: under causal masking the heaviest blocks start first.
//
// f32 (dtype 0): "fma f32", the first kernel of this file. One block of
// 256 threads per (batch*head, 64-row query tile), K/V staged in shared
// memory as f32, scalar f32 FMAs. One TF32 product a tensor-core step
// keeps about three digits and cannot pass the f32 gate (2e-5); the
// 3xTF32 split the f32 backward kernels use (mma_tf32.cuh) keeps about
// 2^-22 and is this kernel's tensor-core route, not written yet.
// Every kernel puts batch*head on grid x (up to 2^31 - 1) and the query
// tiles on grid y, heaviest first.
//
// Bound on an H100: FLOPs 4*b*h*d*sum(visible keys) against 989 TFLOP/s
// (bf16) or 165 TFLOP/s (f32, the 3xTF32 rate; the CUDA cores' 67
// TFLOP/s beside it), bytes (q + k + v + out) * elem + lse * 4
// against 3.35 TB/s. Left on the table: wgmma and TMA with warp
// specialisation, and a persistent schedule that balances causal tiles
// across the 132 SMs.
//
// C entry point `dl4j_flash_fwd` (loaded with ctypes) returns the CUDA
// error code of the launch (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"
#include "smem_attr.cuh"

namespace {

constexpr int kBQ = 64;          // query rows per block
constexpr int kBK = 64;          // keys per shared-memory tile
constexpr int kThreads = 256;    // 16 x 16 thread grid
constexpr float kMaskValue = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, like astype
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int D>
constexpr size_t smem_floats() {
  // Q [BQ][D+1], K [BK][D+1], V [BK][D], S [BQ][BK+1], m/l/corr [BQ]
  return kBQ * (D + 1) + kBK * (D + 1) + kBK * D + kBQ * (kBK + 1) + 3 * kBQ;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, int heads, int tq, int tkv,
                 int causal, int window, float scale) {
  extern __shared__ float smem[];
  float* Qs = smem;                        // [BQ][D+1]
  float* Ks = Qs + kBQ * (D + 1);          // [BK][D+1]
  float* Vs = Ks + kBK * (D + 1);          // [BK][D]
  float* Ss = Vs + kBK * D;                // [BQ][BK+1] scores, then p
  float* m_s = Ss + kBQ * (kBK + 1);       // running max per row
  float* l_s = m_s + kBQ;                  // running normaliser per row
  float* c_s = l_s + kBQ;                  // this tile's rescale per row

  const int bh = blockIdx.x;
  const int b = bh / heads, h = bh % heads;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // heavy tiles first
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int warp = tid / 32, lane = tid % 32;
  // BTHD: consecutive time steps of one head are heads*D elements apart
  const int64_t tstride = (int64_t)heads * D;
  const T* qb = q + ((int64_t)b * tq * heads + h) * D;
  const T* kb = k + ((int64_t)b * tkv * heads + h) * D;
  const T* vb = v + ((int64_t)b * tkv * heads + h) * D;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, c = i % D, t = q0 + r;
    Qs[r * (D + 1) + c] = t < tq ? to_f32(qb[t * tstride + c]) : 0.f;
  }
  if (tid < kBQ) {
    m_s[tid] = kMaskValue;
    l_s[tid] = 0.f;
  }

  constexpr int CJ = D / 16;
  float acc[4][CJ];  // rows ty + 16*i, columns tx + 16*j
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < CJ; ++j) acc[i][j] = 0.f;

  // key range this query tile can see: the causal diagonal caps it from
  // above, the window band from below; dead tiles are never loaded
  int k_lo = 0, k_hi = tkv;
  if (causal) k_hi = min(tkv, q0 + kBQ);
  if (window > 0) k_lo = max(0, q0 - window + 1);
  const int kt_lo = k_lo / kBK, kt_hi = (k_hi + kBK - 1) / kBK;

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile's K/V/S reads are done
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int r = i / D, c = i % D, t = k0 + r;
      const bool in = t < tkv;
      Ks[r * (D + 1) + c] = in ? to_f32(kb[t * tstride + c]) : 0.f;
      Vs[r * D + c] = in ? to_f32(vb[t * tstride + c]) : 0.f;
    }
    __syncthreads();

    // scores for a 4 x 4 micro-tile per thread
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * (D + 1) + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * (D + 1) + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
    // masked scores become -inf: they never raise the running max (which
    // starts at -1e30, as in the reference) and exp() sends them to 0
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i, qi = q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j, kj = k0 + c;
        bool keep = qi < tq && kj < tkv;
        if (causal) keep = keep && qi >= kj;
        if (window > 0) keep = keep && qi - kj < window;
        Ss[r * (kBK + 1) + c] = keep ? s[i][j] * scale : -INFINITY;
      }
    }
    __syncthreads();

    // online softmax: one warp per 8 rows, two columns per lane
    for (int rr = 0; rr < kBQ / 8; ++rr) {
      const int r = warp * (kBQ / 8) + rr;
      float* srow = Ss + r * (kBK + 1);
      const float m_prev = m_s[r];
      const float a = srow[lane], c = srow[lane + 32];
      const float m_next = fmaxf(m_prev, warp_max(fmaxf(a, c)));
      const float pa = expf(a - m_next), pc = expf(c - m_next);
      const float psum = warp_sum(pa + pc);
      srow[lane] = to_f32(from_f32<T>(pa));
      srow[lane + 32] = to_f32(from_f32<T>(pc));
      if (lane == 0) {
        const float corr = expf(m_prev - m_next);
        l_s[r] = l_s[r] * corr + psum;
        m_s[r] = m_next;
        c_s[r] = corr;
      }
    }
    __syncthreads();

    // acc = acc * corr + p . v
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float corr = c_s[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < CJ; ++j) acc[i][j] *= corr;
    }
#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ss[(ty + 16 * i) * (kBK + 1) + kk];
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const float vv = Vs[kk * D + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(p[i], vv, acc[i][j]);
      }
    }
  }
  __syncthreads();

  T* ob = out + ((int64_t)b * tq * heads + h) * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i, t = q0 + r;
    if (t < tq) {
      const float l = l_s[r];
      const float safe_l = l == 0.f ? 1.f : l;
#pragma unroll
      for (int j = 0; j < CJ; ++j)
        ob[t * tstride + tx + 16 * j] = from_f32<T>(acc[i][j] / safe_l);
    }
  }
  if (tid < kBQ && q0 + tid < tq) {
    const float l = l_s[tid];
    lse[(int64_t)bh * tq + q0 + tid] = m_s[tid] + logf(l == 0.f ? 1.f : l);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out,
           void* lse, int batch, int heads, int tq, int tkv, int causal,
           int window, float scale, cudaStream_t stream) {
  const size_t bytes = smem_floats<D>() * sizeof(float);
  cudaError_t err = dl4j_smem::set_max_dynamic_smem(
      reinterpret_cast<const void*>(flash_fwd_kernel<T, D>), (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(batch * heads, (tq + kBQ - 1) / kBQ);
  flash_fwd_kernel<T, D><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out),
      static_cast<float*>(lse), heads, tq, tkv, causal, window, scale);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// f32 at any other head_dim: the FMA kernel with d taken in chunks
// ---------------------------------------------------------------------------
constexpr int kC = 64;  // columns a chunk of Q.K^T and a slice of the output

constexpr size_t chunked_smem_floats() {
  // Q and K chunks [BQ][C+1], the V slice [BK][C], S [BQ][BK+1], m/l/corr
  return kBQ * (kC + 1) + kBK * (kC + 1) + kBK * kC + kBQ * (kBK + 1) +
         3 * kBQ;
}

// columns [c0, c0 + C) of rows [t0, t0 + 64) of one head of a BTHD f32
// tensor into a [64][ld] tile; rows at or past `len` and columns at or
// past `d` are zeros
__device__ __forceinline__ void load_chunk(float* dst, int ld,
                                           const float* src, int t0, int len,
                                           int c0, int d, int64_t tstride) {
  for (int i = threadIdx.x; i < 64 * kC; i += kThreads) {
    const int r = i / kC, c = i % kC, t = t0 + r, col = c0 + c;
    dst[r * ld + c] = t < len && col < d ? src[t * tstride + col] : 0.f;
  }
}

__global__ void __launch_bounds__(kThreads)
flash_fwd_chunked_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ out,
                         float* __restrict__ lse, int heads, int tq, int tkv,
                         int d, int causal, int window, float scale) {
  extern __shared__ float smem[];
  float* Qs = smem;                        // [BQ][C+1] a chunk of Q
  float* Ks = Qs + kBQ * (kC + 1);         // [BK][C+1] a chunk of K
  float* Vs = Ks + kBK * (kC + 1);         // [BK][C] this block's V slice
  float* Ss = Vs + kBK * kC;               // [BQ][BK+1] scores, then p
  float* m_s = Ss + kBQ * (kBK + 1);
  float* l_s = m_s + kBQ;
  float* c_s = l_s + kBQ;

  const int bh = blockIdx.x;
  const int b = bh / heads, h = bh % heads;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // heavy tiles first
  const int c0 = blockIdx.z * kC;  // this block's output columns
  const int nch = (d + kC - 1) / kC;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int warp = tid / 32, lane = tid % 32;
  const int64_t tstride = (int64_t)heads * d;
  const float* qb = q + ((int64_t)b * tq * heads + h) * d;
  const float* kb = k + ((int64_t)b * tkv * heads + h) * d;
  const float* vb = v + ((int64_t)b * tkv * heads + h) * d;

  // one chunk: Q stays in shared memory for the whole block
  if (nch == 1) load_chunk(Qs, kC + 1, qb, q0, tq, 0, d, tstride);
  if (tid < kBQ) {
    m_s[tid] = kMaskValue;
    l_s[tid] = 0.f;
  }
  float acc[4][4];  // rows ty + 16*i, columns c0 + tx + 16*j
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  int k_lo = 0, k_hi = tkv;
  if (causal) k_hi = min(tkv, q0 + kBQ);
  if (window > 0) k_lo = max(0, q0 - window + 1);
  const int kt_lo = k_lo / kBK, kt_hi = (k_hi + kBK - 1) / kBK;

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int k0 = kt * kBK;
    // scores over the whole d, chunk by chunk (4 x 4 micro-tile a thread)
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int ch = 0; ch < nch; ++ch) {
      __syncthreads();  // the previous chunk's (or tile's) reads are done
      if (ch == 0) load_chunk(Vs, kC, vb, k0, tkv, c0, d, tstride);
      if (nch > 1) load_chunk(Qs, kC + 1, qb, q0, tq, ch * kC, d, tstride);
      load_chunk(Ks, kC + 1, kb, k0, tkv, ch * kC, d, tstride);
      __syncthreads();
#pragma unroll 8
      for (int dd = 0; dd < kC; ++dd) {
        float qv[4], kv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * (kC + 1) + dd];
#pragma unroll
        for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * (kC + 1) + dd];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i, qi = q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j, kj = k0 + c;
        bool keep = qi < tq && kj < tkv;
        if (causal) keep = keep && qi >= kj;
        if (window > 0) keep = keep && qi - kj < window;
        Ss[r * (kBK + 1) + c] = keep ? s[i][j] * scale : -INFINITY;
      }
    }
    __syncthreads();

    // online softmax, as in the exact kernel; every slice computes the
    // same m and l
    for (int rr = 0; rr < kBQ / 8; ++rr) {
      const int r = warp * (kBQ / 8) + rr;
      float* srow = Ss + r * (kBK + 1);
      const float m_prev = m_s[r];
      const float a = srow[lane], c = srow[lane + 32];
      const float m_next = fmaxf(m_prev, warp_max(fmaxf(a, c)));
      const float pa = expf(a - m_next), pc = expf(c - m_next);
      const float psum = warp_sum(pa + pc);
      srow[lane] = pa;
      srow[lane + 32] = pc;
      if (lane == 0) {
        const float corr = expf(m_prev - m_next);
        l_s[r] = l_s[r] * corr + psum;
        m_s[r] = m_next;
        c_s[r] = corr;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float corr = c_s[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] *= corr;
    }
#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ss[(ty + 16 * i) * (kBK + 1) + kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float vv = Vs[kk * kC + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(p[i], vv, acc[i][j]);
      }
    }
  }
  __syncthreads();

  float* ob = out + ((int64_t)b * tq * heads + h) * d;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i, t = q0 + r;
    if (t < tq) {
      const float l = l_s[r];
      const float safe_l = l == 0.f ? 1.f : l;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = c0 + tx + 16 * j;
        if (col < d) ob[t * tstride + col] = acc[i][j] / safe_l;
      }
    }
  }
  if (blockIdx.z == 0 && tid < kBQ && q0 + tid < tq) {
    const float l = l_s[tid];
    lse[(int64_t)bh * tq + q0 + tid] = m_s[tid] + logf(l == 0.f ? 1.f : l);
  }
}

int launch_chunked(const void* q, const void* k, const void* v, void* out,
                   void* lse, int batch, int heads, int tq, int tkv, int d,
                   int causal, int window, float scale, cudaStream_t stream) {
  const size_t bytes = chunked_smem_floats() * sizeof(float);
  cudaError_t err = dl4j_smem::set_max_dynamic_smem(
      reinterpret_cast<const void*>(flash_fwd_chunked_kernel), (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(batch * heads, (tq + kBQ - 1) / kBQ, (d + kC - 1) / kC);
  flash_fwd_chunked_kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out),
      static_cast<float*>(lse), heads, tq, tkv, d, causal, window, scale);
  return (int)cudaGetLastError();
}

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

  // the key tiles this query tile can see, as in the f32 kernel
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

}  // namespace

// The padded bf16 tiers, one `DL4J_TIER(width)` entry each: given by the
// build (kernels/_build.py) from kernels/__init__.py's MMA_TIERS
#ifndef DL4J_MMA_TIERS
#error "DL4J_MMA_TIERS must be defined by the build"
#endif

// route: 0 = exact (head_dim 64 or 128, unpadded), 1 = tier (bf16, rows
// padded to `tier`), 2 = chunked (f32, any head_dim), 3 = wide (bf16
// above 256). vec: rows may move in 16-byte cp.async copies (tier, wide).
// dtype: 0 = float32, 1 = bfloat16. window <= 0 means no window.
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
      return launch<float, 64>(q, k, v, out, lse, batch, heads, tq, tkv,
                               causal, window, scale, s);
    if (dtype == 0 && d == 128)
      return launch<float, 128>(q, k, v, out, lse, batch, heads, tq, tkv,
                                causal, window, scale, s);
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
  } else if (route == 2 && dtype == 0) {
    return launch_chunked(q, k, v, out, lse, batch, heads, tq, tkv, d,
                          causal, window, scale, s);
  } else if (route == 3 && dtype == 1) {
    return launch_wide(q, k, v, out, lse, batch, heads, tq, tkv, d, vec,
                       causal, window, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}
