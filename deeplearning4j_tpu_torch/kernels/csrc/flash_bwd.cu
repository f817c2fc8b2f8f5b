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
// rounded to the input dtype before p^T.do and ds before ds^T.q and ds.k,
// where the Pallas tiles round. Masked (q, k) pairs give p = 0
// explicitly: the Pallas tile relies on exp(-1e30 - lse) == 0, which
// fails for a row whose lse is itself -1e30.
//
// Design (simple and right first, in the style of flash_fwd.cu):
// - B2: one block of 256 threads per (batch*head, 64-key tile). K and V
//   stay in shared memory; the block loops over 64-query tiles from the
//   causal diagonal to the window's far edge and keeps dk, dv in f32
//   registers (a 4 x D/16 micro-tile of each per thread).
// - B3: one block per (batch*head, 64-query tile). Q, dO, lse and delta
//   stay in shared memory; the block loops over the key tiles of its
//   band and keeps dq in f32 registers.
// - Each block writes only its own rows, so neither kernel needs atomics
//   across blocks: the two-kernel split removes them and keeps the
//   gradients the same from run to run.
// - Tiles that are wholly dead are never visited, so work scales with the
//   window, not with t^2. Ragged edges and padded query rows are masked
//   here; the host pads nothing.
// - Products are plain f32 FMAs on operands widened from the input dtype
//   (exact for bf16), so only the summation order differs from a bf16
//   MMA with f32 accumulation.
//
// Bound on an H100: B2 does 8*b*h*d*sum(visible keys) FLOPs (s, dp, dv,
// dk), B3 6*b*h*d*sum(visible) (s, dp, dq), against 989 TFLOP/s (bf16)
// or 67 TFLOP/s (f32); both read q, k, v, do once in the input dtype and
// lse, delta in f32, and write their outputs in f32, against 3.35 TB/s.
// At the training shape ([16, 1024, 8, 64] bf16 causal) both bounds are
// tens of microseconds. These kernels are limited by f32 FMA issue and
// shared-memory traffic instead. Left on the table: tensor cores
// (mma.sync / wgmma), cp.async or TMA staging of the streamed tiles, and
// one fused kernel that keeps dq in shared memory with atomics or a
// second pass.
//
// C entry points `dl4j_flash_bwd_dkdv` and `dl4j_flash_bwd_dq` (loaded
// with ctypes) return the CUDA error code of the launch (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;        // query rows per tile
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 256;  // 16 x 16 thread grid

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// x rounded to T and widened back (round to nearest even, like astype)
template <typename T>
__device__ __forceinline__ float round_to(float x);
template <>
__device__ __forceinline__ float round_to<float>(float x) { return x; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// rows [t0, t0 + 64) of one head of a BTHD tensor into a [64][D+1] f32
// tile; rows at or past `len` are zeros
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int t0,
                                          int len, int64_t tstride) {
  for (int i = threadIdx.x; i < 64 * D; i += kThreads) {
    const int r = i / D, c = i % D, t = t0 + r;
    dst[r * (D + 1) + c] = t < len ? to_f32(src[t * tstride + c]) : 0.f;
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

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
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
  float* Ps = dOs + kBQ * (D + 1);         // [BK][BQ+1] p, rounded to T
  float* dSs = Ps + kBK * (kBQ + 1);       // [BK][BQ+1] ds, rounded to T
  float* lse_s = dSs + kBK * (kBQ + 1);    // [BQ]
  float* delta_s = lse_s + kBQ;            // [BQ]

  const int bh = blockIdx.y;
  const int b = bh / heads, h = bh % heads;
  const int k0 = blockIdx.x * kBK;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int64_t tstride = (int64_t)heads * D;
  const int64_t qoff = ((int64_t)b * tq * heads + h) * D;
  const int64_t koff = ((int64_t)b * tkv * heads + h) * D;
  const float* lse_b = lse + (int64_t)bh * tq;
  const float* delta_b = delta + (int64_t)bh * tq;

  load_tile<T, D>(Ks, k + koff, k0, tkv, tstride);
  load_tile<T, D>(Vs, v + koff, k0, tkv, tstride);

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
    load_tile<T, D>(Qs, q + qoff, q0, tq, tstride);
    load_tile<T, D>(dOs, dout + qoff, q0, tq, tstride);
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
        const float ds = p * (dp[i][j] - delta_s[c]) * scale;
        Ps[r * (kBQ + 1) + c] = round_to<T>(p);
        dSs[r * (kBQ + 1) + c] = round_to<T>(ds);
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

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dq,
                    int heads, int tq, int tkv, int causal, int window,
                    float scale) {
  extern __shared__ float smem[];
  float* Qs = smem;                        // [BQ][D+1]
  float* dOs = Qs + kBQ * (D + 1);         // [BQ][D+1]
  float* Ks = dOs + kBQ * (D + 1);         // [BK][D+1]
  float* Vs = Ks + kBK * (D + 1);          // [BK][D+1]
  float* dSs = Vs + kBK * (D + 1);         // [BQ][BK+1] ds, rounded to T
  float* lse_s = dSs + kBQ * (kBK + 1);    // [BQ]
  float* delta_s = lse_s + kBQ;            // [BQ]

  const int bh = blockIdx.y;
  const int b = bh / heads, h = bh % heads;
  const int q0 = blockIdx.x * kBQ;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int64_t tstride = (int64_t)heads * D;
  const int64_t qoff = ((int64_t)b * tq * heads + h) * D;
  const int64_t koff = ((int64_t)b * tkv * heads + h) * D;

  load_tile<T, D>(Qs, q + qoff, q0, tq, tstride);
  load_tile<T, D>(dOs, dout + qoff, q0, tq, tstride);
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
    load_tile<T, D>(Ks, k + koff, k0, tkv, tstride);
    load_tile<T, D>(Vs, v + koff, k0, tkv, tstride);
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
        dSs[r * (kBK + 1) + c] =
            round_to<T>(p * (dp[i][j] - delta_s[r]) * scale);
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
  int batch, heads, tq, tkv, causal, window;
  float scale;
  cudaStream_t stream;
};

template <typename T, int D>
int launch_dkdv(const Args& a, void* dk, void* dv) {
  const size_t bytes = dkdv_smem_floats<D>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkdv_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.tkv + kBK - 1) / kBK, a.batch * a.heads);
  flash_bwd_dkdv_kernel<T, D><<<grid, kThreads, bytes, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<float*>(dk), static_cast<float*>(dv), a.heads, a.tq,
      a.tkv, a.causal, a.window, a.scale);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dq(const Args& a, void* dq) {
  const size_t bytes = dq_smem_floats<D>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.tq + kBQ - 1) / kBQ, a.batch * a.heads);
  flash_bwd_dq_kernel<T, D><<<grid, kThreads, bytes, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<float*>(dq), a.heads, a.tq, a.tkv, a.causal, a.window,
      a.scale);
  return (int)cudaGetLastError();
}

bool valid(const Args& a) {
  return a.batch >= 1 && a.heads >= 1 && a.tq >= 1 && a.tkv >= 1 &&
         (int64_t)a.batch * a.heads <= 65535;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. window <= 0 means no window.
// q, k, v, dout: BTHD in the input dtype; lse, delta: [batch*heads, tq]
// f32; dk, dv: BTHD f32 [batch, tkv, heads, head_dim].
extern "C" int dl4j_flash_bwd_dkdv(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const void* lse, const void* delta,
                                   void* dk, void* dv, int batch, int heads,
                                   int tq, int tkv, int head_dim, int dtype,
                                   int causal, int window, float scale,
                                   void* stream) {
  const Args a{q, k, v, dout, lse, delta, batch, heads, tq, tkv, causal,
               window, scale, static_cast<cudaStream_t>(stream)};
  if (!valid(a)) return (int)cudaErrorInvalidValue;
  if (dtype == 0 && head_dim == 64) return launch_dkdv<float, 64>(a, dk, dv);
  if (dtype == 0 && head_dim == 128)
    return launch_dkdv<float, 128>(a, dk, dv);
  if (dtype == 1 && head_dim == 64)
    return launch_dkdv<__nv_bfloat16, 64>(a, dk, dv);
  if (dtype == 1 && head_dim == 128)
    return launch_dkdv<__nv_bfloat16, 128>(a, dk, dv);
  return (int)cudaErrorInvalidValue;
}

// Same inputs; dq: BTHD f32 [batch, tq, heads, head_dim].
extern "C" int dl4j_flash_bwd_dq(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, void* dq, int batch,
                                 int heads, int tq, int tkv, int head_dim,
                                 int dtype, int causal, int window,
                                 float scale, void* stream) {
  const Args a{q, k, v, dout, lse, delta, batch, heads, tq, tkv, causal,
               window, scale, static_cast<cudaStream_t>(stream)};
  if (!valid(a)) return (int)cudaErrorInvalidValue;
  if (dtype == 0 && head_dim == 64) return launch_dq<float, 64>(a, dq);
  if (dtype == 0 && head_dim == 128) return launch_dq<float, 128>(a, dq);
  if (dtype == 1 && head_dim == 64)
    return launch_dq<__nv_bfloat16, 64>(a, dq);
  if (dtype == 1 && head_dim == 128)
    return launch_dq<__nv_bfloat16, 128>(a, dq);
  return (int)cudaErrorInvalidValue;
}
