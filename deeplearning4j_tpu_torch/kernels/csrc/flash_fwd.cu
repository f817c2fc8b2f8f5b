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
// Design (simple and right first):
// - One block of 256 threads owns one (batch*head, 64-row query tile).
//   The block loops over 64-key K/V tiles staged in shared memory (f32);
//   that loop replaces the TPU's sequential third grid axis.
// - Tiles above the causal diagonal and below the window band are never
//   visited; ragged edges are masked here, so the host pads nothing.
// - Products are plain f32 FMAs. A bf16 operand widened to f32 makes each
//   product exact, so the sums match a bf16 MMA with f32 accumulation up
//   to summation order.
//
// Bound on an H100: FLOPs 4*b*h*d*sum(visible keys) against 989 TFLOP/s
// (bf16) or 67 TFLOP/s (f32), bytes (q + k + v + out) * elem + lse * 4
// against 3.35 TB/s. At the serving prefill shapes ([1, <=1024, 8, 64])
// the bound is microseconds; this kernel is limited by its f32 FMA and
// shared-memory traffic instead. Left on the table: tensor cores
// (mma.sync / wgmma), TMA or cp.async double buffering of K/V, and a
// persistent schedule that balances causal tiles across the 132 SMs.
//
// C entry point `dl4j_flash_fwd` (loaded with ctypes) returns the CUDA
// error code of the launch (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((tq + kBQ - 1) / kBQ, batch * heads);
  flash_fwd_kernel<T, D><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out),
      static_cast<float*>(lse), heads, tq, tkv, causal, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. window <= 0 means no window.
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
    return launch<__nv_bfloat16, 64>(q, k, v, out, lse, batch, heads, tq,
                                     tkv, causal, window, scale, s);
  if (dtype == 1 && head_dim == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, out, lse, batch, heads, tq,
                                      tkv, causal, window, scale, s);
  return (int)cudaErrorInvalidValue;
}
