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
// Two variants behind one C entry point, chosen by dtype:
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
// f32 (dtype 0): "fma f32", the first kernel of this file, unchanged. One
// block of 256 threads per (batch*head, 64-row query tile), K/V staged in
// shared memory as f32, scalar f32 FMAs. A tensor-core f32 path would need
// TF32, which keeps about three digits and cannot pass the f32 gate (2e-5).
//
// Bound on an H100: FLOPs 4*b*h*d*sum(visible keys) against 989 TFLOP/s
// (bf16) or 67 TFLOP/s (f32), bytes (q + k + v + out) * elem + lse * 4
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

  const int bh = blockIdx.y;
  const int b = bh / heads, h = bh % heads;
  const int q0 = blockIdx.x * kBQ;
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
  const dim3 grid((tq + kBQ - 1) / kBQ, batch * heads);
  flash_fwd_kernel<T, D><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out),
      static_cast<float*>(lse), heads, tq, tkv, causal, window, scale);
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

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ out,
                     float* __restrict__ lse, int heads, int tq, int tkv,
                     int causal, int window, float scale) {
  using namespace dl4j_mma;
  constexpr int LD = D + 8;   // padded shared row, elements
  constexpr int KC = D / 16;  // k-steps of Q.K^T
  constexpr int NS = kBK / 8;  // 8-key column tiles of S
  constexpr int NO = D / 8;   // 8-wide column tiles of the output
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [64][LD]
  bf16* Ks = Qs + kBQ * LD;                      // [2][64][LD]
  bf16* Vs = Ks + 2 * kBK * LD;                  // [2][64][LD]

  const int bh = blockIdx.x;
  const int b = bh / heads, h = bh % heads;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // heavy tiles first
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int64_t tstride = (int64_t)heads * D;
  const bf16* qb = q + ((int64_t)b * tq * heads + h) * D;
  const bf16* kb = k + ((int64_t)b * tkv * heads + h) * D;
  const bf16* vb = v + ((int64_t)b * tkv * heads + h) * D;

  // the key tiles this query tile can see, as in the f32 kernel
  int k_lo = 0, k_hi = tkv;
  if (causal) k_hi = min(tkv, q0 + kBQ);
  if (window > 0) k_lo = max(0, q0 - window + 1);
  const int kt_lo = k_lo / kBK, kt_hi = (k_hi + kBK - 1) / kBK;

  cp_tile_64<D, kMmaThreads>(Qs, qb, q0, tq, tstride);
  cp_tile_64<D, kMmaThreads>(Ks, kb, kt_lo * kBK, tkv, tstride);
  cp_tile_64<D, kMmaThreads>(Vs, vb, kt_lo * kBK, tkv, tstride);
  cp_async_commit();

  // this thread's rows of the warp's 16: r0 = q0 + 16*warp + g, r0 + 8
  const int r0 = q0 + warp * 16 + g;
  uint32_t qf[KC][4];
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
      cp_tile_64<D, kMmaThreads>(Ks + next, kb, (kt + 1) * kBK, tkv,
                                 tstride);
      cp_tile_64<D, kMmaThreads>(Vs + next, vb, (kt + 1) * kBK, tkv,
                                 tstride);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this tile (and Q) have landed
    __syncthreads();
    if (kt == kt_lo) {
#pragma unroll
      for (int kc = 0; kc < KC; ++kc)
        ldmatrix_x4(qf[kc], Qs + (warp * 16 + lane % 16) * LD + kc * 16 +
                                (lane / 16) * 8);
    }
    const bf16* Kt = Ks + stage * kBK * LD;
    const bf16* Vt = Vs + stage * kBK * LD;
    const int k0 = kt * kBK;

    // S = Q.K^T: K rows are the B operand's columns (plain ldmatrix)
    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
#pragma unroll
      for (int jp = 0; jp < NS / 2; ++jp) {
        uint32_t kf[4];
        ldmatrix_x4(kf, Kt + (jp * 16 + lane % 8 + (lane / 16) * 8) * LD +
                            kc * 16 + ((lane / 8) % 2) * 8);
        mma_16816(s[2 * jp], qf[kc], kf[0], kf[1]);
        mma_16816(s[2 * jp + 1], qf[kc], kf[2], kf[3]);
      }
    }

    // scale, then mask only where this tile crosses the sequence end,
    // the causal diagonal or the window's far edge
    const bool edge = k0 + kBK > tkv || (causal && k0 + kBK - 1 > q0) ||
                      (window > 0 && q0 + kBQ - 1 - k0 >= window);
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale;
        if (edge) {
          const int qi = r0 + (e / 2) * 8, kj = k0 + j * 8 + 2 * t4 + e % 2;
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
        ldmatrix_x4_trans(vf, Vt + (kk * 16 + lane % 8 +
                                    ((lane / 8) % 2) * 8) * LD +
                                  np * 16 + (lane / 16) * 8);
        mma_16816(o[2 * np], pa, vf[0], vf[1]);
        mma_16816(o[2 * np + 1], pa, vf[2], vf[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage
  }

  bf16* ob = out + ((int64_t)b * tq * heads + h) * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_part[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float safe_l = l == 0.f ? 1.f : l;
    const int r = r0 + i * 8;
    if (r < tq) {
#pragma unroll
      for (int n = 0; n < NO; ++n)
        *reinterpret_cast<uint32_t*>(ob + r * tstride + n * 8 + 2 * t4) =
            pack_bf16(o[n][2 * i] / safe_l, o[n][2 * i + 1] / safe_l);
      if (t4 == 0) lse[(int64_t)bh * tq + r] = m_run[i] + logf(safe_l);
    }
  }
}

template <int D>
int launch_mma(const void* q, const void* k, const void* v, void* out,
               void* lse, int batch, int heads, int tq, int tkv, int causal,
               int window, float scale, cudaStream_t stream) {
  const size_t bytes = mma_smem_bytes<D>();
  cudaError_t err = dl4j_smem::set_max_dynamic_smem(
      reinterpret_cast<const void*>(flash_fwd_mma_kernel<D>), (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(batch * heads, (tq + kBQ - 1) / kBQ);
  flash_fwd_mma_kernel<D><<<grid, kMmaThreads, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out),
      static_cast<float*>(lse), heads, tq, tkv, causal, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32 (the FMA kernel), 1 = bfloat16 (the tensor-core
// kernel). window <= 0 means no window.
extern "C" int dl4j_flash_fwd(const void* q, const void* k, const void* v,
                              void* out, void* lse, int batch, int heads,
                              int tq, int tkv, int head_dim, int dtype,
                              int causal, int window, float scale,
                              void* stream) {
  if (batch < 1 || heads < 1 || tq < 1 || tkv < 1 ||
      (int64_t)batch * heads > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && head_dim == 64)
    return launch<float, 64>(q, k, v, out, lse, batch, heads, tq, tkv,
                             causal, window, scale, s);
  if (dtype == 0 && head_dim == 128)
    return launch<float, 128>(q, k, v, out, lse, batch, heads, tq, tkv,
                              causal, window, scale, s);
  if (dtype == 1 && head_dim == 64)
    return launch_mma<64>(q, k, v, out, lse, batch, heads, tq, tkv, causal,
                          window, scale, s);
  if (dtype == 1 && head_dim == 128)
    return launch_mma<128>(q, k, v, out, lse, batch, heads, tq, tkv, causal,
                           window, scale, s);
  return (int)cudaErrorInvalidValue;
}
