// T5 attention backward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces: klab_multimodalmodel_tpu/ops/fused_attention.py, `_bwd_kernel`,
// reached through `_bwd` and the custom VJP `_t5_attention_bwd`.
//
// Given q (B,H,Q,D), k/v (B,H,K,D), the output gradient dO (B,H,Q,D), the
// head bias (H,Q,K), the key mask (B,K), the dropout seed and rate of the
// forward (`t5_attention_fwd.cu`), it recomputes, per (b, h):
//   P  = softmax(Q K^T + bias[h] + mask)            (fp32)
//   Pd = keep ? P / (1 - rate) : 0                    (same Philox bits)
//   dV = Pd^T dO        with Pd rounded to the io dtype
//   dP = dO V^T, then dP' = keep ? dP / (1 - rate) : 0
//   dS = P * (dP' - sum_k dP' * P)                    (fp32)
//   dQ = dS K, dK = dS^T Q   with dS rounded to the io dtype
//   dBias[h] = sum_b dS                               (fp32, when asked)
// which are the TPU kernel's roundings. dq/dk/dv come out in the io dtype.
//
// What bounds it on this card: per (b, h) it reads q, k, v, dO once and
// writes dq, dk, dv (8 L D elements) for 8 L^2 D FLOP of products (QK^T, dO
// V^T, dS K, dS^T Q, Pd^T dO: 10 L^2 D with the recomputed logits) -- L
// FLOP per byte in bf16 at L=128..320, under the bf16 tensor-core ridge
// (295 FLOP per byte), so bytes bound it. dBias adds an (H, Q, K) fp32
// write. This kernel runs scalar fp32 FMAs and recomputes the logits and dP
// three times, so it is far from either bound; tensor cores are later work.
//
// Design (three launches on the caller's stream, no float atomics, so two
// runs give the same bits):
//   1. dq kernel, one block per (b, h, 32-query tile): with the forward's row
//      max and sum, delta_i = sum_j dP'_ij P_ij over all key tiles; then dS
//      and dq over the key tiles again. Writes dq and delta (B,H,Q) fp32
//      scratch.
//   2. dk/dv kernel, one block per (b, h, 32-key tile): loops over all query
//      tiles, rebuilds P, Pd and dS for the 32x32 tile in shared memory and
//      accumulates dk, dv for its keys in registers. With dBias it writes dS
//      (B,H,Q,K) fp32 to scratch.
//   3. dBias kernel: dBias[h,q,k] = sum over b of that scratch, b in order.
// A thread of a 32x32 tile owns one row and 8 consecutive keys, so one
// Philox call gives the keep bits of 4 of them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 32;    // query rows and keys per tile
constexpr int kPerThread = 8;  // tile entries per thread: one row, 8 keys
constexpr int kLdT = kTile + 1;  // padded row of a 32x32 tile in smem
constexpr float kMaskedLogit = -1e9f;  // NEG of the TPU kernel

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Round through the io dtype (a no-op for fp32), as the TPU kernel casts
// Pd and dS before their products.
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<T>(x));
}

struct Params {
  const void *q, *k, *v, *dout;
  const float* bias;      // (H,Q,K) or null
  const int* kmask;       // (B,K) or null
  const long long* seed;  // one int64, or null for no dropout
  const float* stats;     // (B,H,Q,2): the forward's row max, row sum
  float* delta;           // (B,H,Q) scratch
  void *dq, *dk, *dv;
  float* ds;              // (B,H,Q,K) scratch, or null without dBias
  float* dbias;           // (H,Q,K) or null
  int B, H, Q, K, D;
  uint32_t threshold;
  float keep_prob;
};

__device__ __forceinline__ float dot(const float* a, const float* b, int D) {
  float s = 0.f;
  for (int d = 0; d < D; ++d) s = fmaf(a[d], b[d], s);
  return s;
}

// Logit of (row qi, key) from the shared-memory rows of q and k, plus the
// head bias and the key mask, in the forward's order.
__device__ __forceinline__ float logit(const Params& p, const float* qr,
                                       const float* kr, int b, int h, int qi,
                                       int key) {
  float s = dot(qr, kr, p.D);
  if (p.bias != nullptr) s += p.bias[((size_t)h * p.Q + qi) * p.K + key];
  if (p.kmask != nullptr && p.kmask[(size_t)b * p.K + key] <= 0)
    s += kMaskedLogit;
  return s;
}

// Stage rows [r0, r0 + 32) of a (rows, D) io-dtype matrix into shared memory
// as fp32 with padded rows; rows past `rows` are zero.
template <typename T>
__device__ __forceinline__ void stage(float* dst, const T* src, int r0,
                                      int rows, int D) {
  const int ld = D + 1;
  for (int i = threadIdx.x; i < kTile * D; i += kThreads) {
    const int r = i / D;
    const int d = i % D;
    dst[r * ld + d] =
        (r0 + r < rows) ? to_float(src[(size_t)(r0 + r) * D + d]) : 0.f;
  }
}

// Keep bits of 8 consecutive keys key0..key0+7 (key0 a multiple of 4) of
// row qi: two Philox calls.
__device__ __forceinline__ unsigned keep_bits(uint64_t seed, int b, int h,
                                              int qi, int key0,
                                              uint32_t threshold) {
  const uint2 key = make_uint2((uint32_t)seed, (uint32_t)(seed >> 32));
  unsigned bits = 0;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const uint4 w = klab::philox4x32_10(
        make_uint4((uint32_t)(key0 + 4 * half) >> 2, (uint32_t)qi,
                   (uint32_t)h, (uint32_t)b),
        key);
    bits |= (unsigned)(w.x > threshold) << (4 * half);
    bits |= (unsigned)(w.y > threshold) << (4 * half + 1);
    bits |= (unsigned)(w.z > threshold) << (4 * half + 2);
    bits |= (unsigned)(w.w > threshold) << (4 * half + 3);
  }
  return bits;
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}

// DPT: head dims each thread accumulates (d = (tid & 3) + 4 * c), D / 4
// rounded up to a multiple of 8.
template <typename T, int DPT>
__global__ void __launch_bounds__(kThreads) t5_bwd_dq_kernel(Params p) {
  extern __shared__ float smem[];
  const int D = p.D;
  const int ld = D + 1;
  float* q_s = smem;               // [32][D + 1]
  float* do_s = q_s + kTile * ld;  // [32][D + 1]
  float* k_s = do_s + kTile * ld;  // [32][D + 1]
  float* v_s = k_s + kTile * ld;   // [32][D + 1]
  float* ds_s = v_s + kTile * ld;  // [32][33]

  const int q0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int i = threadIdx.x >> 2;  // tile row of this thread
  const int g = threadIdx.x & 3;   // key group: keys g*8 .. g*8+7
  const int qi = q0 + i;
  const bool row_ok = qi < p.Q;
  const size_t bh = (size_t)b * p.H + h;
  const T* qp = static_cast<const T*>(p.q) + bh * p.Q * D;
  const T* dop = static_cast<const T*>(p.dout) + bh * p.Q * D;
  const T* kp = static_cast<const T*>(p.k) + bh * p.K * D;
  const T* vp = static_cast<const T*>(p.v) + bh * p.K * D;
  const bool dropout = p.seed != nullptr;
  const uint64_t seed = dropout ? (uint64_t)*p.seed : 0;

  stage<T>(q_s, qp, q0, p.Q, D);
  stage<T>(do_s, dop, q0, p.Q, D);
  const float* qr = q_s + i * ld;
  const float* dor = do_s + i * ld;

  float m_i = 0.f, l_i = 1.f;
  if (row_ok) {
    m_i = p.stats[(bh * p.Q + qi) * 2];
    l_i = p.stats[(bh * p.Q + qi) * 2 + 1];
  }

  // Pass 1: delta_i = sum_j dP'_ij P_ij.
  float delta = 0.f;
  for (int k0 = 0; k0 < p.K; k0 += kTile) {
    __syncthreads();
    stage<T>(k_s, kp, k0, p.K, D);
    stage<T>(v_s, vp, k0, p.K, D);
    __syncthreads();
    const int key0 = k0 + g * kPerThread;
    const unsigned keep =
        (dropout && row_ok) ? keep_bits(seed, b, h, qi, key0, p.threshold)
                            : 0xffu;
#pragma unroll
    for (int c = 0; c < kPerThread; ++c) {
      const int key = key0 + c;
      if (row_ok && key < p.K) {
        const int j = g * kPerThread + c;
        const float pr =
            expf(logit(p, qr, k_s + j * ld, b, h, qi, key) - m_i) / l_i;
        float dp = dot(dor, v_s + j * ld, D);
        if (dropout) dp = ((keep >> c) & 1u) ? dp / p.keep_prob : 0.f;
        delta = fmaf(dp, pr, delta);
      }
    }
  }
  delta = quad_sum(delta);
  if (row_ok && g == 0) p.delta[bh * p.Q + qi] = delta;

  // Pass 2: dS, then dq = dS K.
  float acc[DPT];
#pragma unroll
  for (int c = 0; c < DPT; ++c) acc[c] = 0.f;
  for (int k0 = 0; k0 < p.K; k0 += kTile) {
    __syncthreads();
    stage<T>(k_s, kp, k0, p.K, D);
    stage<T>(v_s, vp, k0, p.K, D);
    __syncthreads();
    const int key0 = k0 + g * kPerThread;
    const unsigned keep =
        (dropout && row_ok) ? keep_bits(seed, b, h, qi, key0, p.threshold)
                            : 0xffu;
#pragma unroll
    for (int c = 0; c < kPerThread; ++c) {
      const int key = key0 + c;
      const int j = g * kPerThread + c;
      float ds = 0.f;
      if (row_ok && key < p.K) {
        const float pr =
            expf(logit(p, qr, k_s + j * ld, b, h, qi, key) - m_i) / l_i;
        float dp = dot(dor, v_s + j * ld, D);
        if (dropout) dp = ((keep >> c) & 1u) ? dp / p.keep_prob : 0.f;
        ds = pr * (dp - delta);
      }
      ds_s[i * kLdT + j] = round_to<T>(ds);
    }
    __syncthreads();
    for (int j = 0; j < kTile; ++j) {
      const float dsv = ds_s[i * kLdT + j];
      const float* kr = k_s + j * ld;
#pragma unroll
      for (int c = 0; c < DPT; ++c) {
        const int d = g + 4 * c;
        if (d < D) acc[c] = fmaf(dsv, kr[d], acc[c]);
      }
    }
  }
  if (row_ok) {
    T* dq = static_cast<T*>(p.dq) + (bh * p.Q + qi) * D;
#pragma unroll
    for (int c = 0; c < DPT; ++c) {
      const int d = g + 4 * c;
      if (d < D) dq[d] = from_float<T>(acc[c]);
    }
  }
}

template <typename T, int DPT>
__global__ void __launch_bounds__(kThreads) t5_bwd_dkdv_kernel(Params p) {
  extern __shared__ float smem[];
  const int D = p.D;
  const int ld = D + 1;
  float* k_s = smem;               // [32][D + 1]
  float* v_s = k_s + kTile * ld;   // [32][D + 1]
  float* q_s = v_s + kTile * ld;   // [32][D + 1]
  float* do_s = q_s + kTile * ld;  // [32][D + 1]
  float* pd_s = do_s + kTile * ld;  // [32][33]: Pd, io-rounded
  float* ds_s = pd_s + kTile * kLdT;  // [32][33]: dS, io-rounded

  const int k0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int i = threadIdx.x >> 2;  // tile row (query) in the S phase
  const int g = threadIdx.x & 3;   // key group in the S phase
  const int jo = threadIdx.x >> 2;  // key this thread accumulates dk, dv of
  const size_t bh = (size_t)b * p.H + h;
  const T* qp = static_cast<const T*>(p.q) + bh * p.Q * D;
  const T* dop = static_cast<const T*>(p.dout) + bh * p.Q * D;
  const T* kp = static_cast<const T*>(p.k) + bh * p.K * D;
  const T* vp = static_cast<const T*>(p.v) + bh * p.K * D;
  const bool dropout = p.seed != nullptr;
  const uint64_t seed = dropout ? (uint64_t)*p.seed : 0;

  stage<T>(k_s, kp, k0, p.K, D);
  stage<T>(v_s, vp, k0, p.K, D);

  float dk[DPT], dv[DPT];
#pragma unroll
  for (int c = 0; c < DPT; ++c) dk[c] = dv[c] = 0.f;

  for (int q0 = 0; q0 < p.Q; q0 += kTile) {
    __syncthreads();  // the previous tile's Pd and dS fully consumed
    stage<T>(q_s, qp, q0, p.Q, D);
    stage<T>(do_s, dop, q0, p.Q, D);
    __syncthreads();
    const int qi = q0 + i;
    const bool row_ok = qi < p.Q;
    float m_i = 0.f, l_i = 1.f, delta = 0.f;
    if (row_ok) {
      m_i = p.stats[(bh * p.Q + qi) * 2];
      l_i = p.stats[(bh * p.Q + qi) * 2 + 1];
      delta = p.delta[bh * p.Q + qi];
    }
    const int key0 = k0 + g * kPerThread;
    const unsigned keep =
        (dropout && row_ok) ? keep_bits(seed, b, h, qi, key0, p.threshold)
                            : 0xffu;
#pragma unroll
    for (int c = 0; c < kPerThread; ++c) {
      const int key = key0 + c;
      const int j = g * kPerThread + c;
      float pd = 0.f, ds = 0.f;
      if (row_ok && key < p.K) {
        const float pr = expf(logit(p, q_s + i * ld, k_s + j * ld, b, h, qi,
                                    key) - m_i) / l_i;
        float dp = dot(do_s + i * ld, v_s + j * ld, D);
        pd = pr;
        if (dropout) {
          const bool kept = (keep >> c) & 1u;
          dp = kept ? dp / p.keep_prob : 0.f;
          pd = kept ? pr / p.keep_prob : 0.f;
        }
        ds = pr * (dp - delta);
        if (p.ds != nullptr) p.ds[(bh * p.Q + qi) * p.K + key] = ds;
      }
      pd_s[i * kLdT + j] = round_to<T>(pd);
      ds_s[i * kLdT + j] = round_to<T>(ds);
    }
    __syncthreads();
    for (int r = 0; r < kTile; ++r) {
      const float pdv = pd_s[r * kLdT + jo];
      const float dsv = ds_s[r * kLdT + jo];
      const float* dor = do_s + r * ld;
      const float* qr = q_s + r * ld;
#pragma unroll
      for (int c = 0; c < DPT; ++c) {
        const int d = g + 4 * c;
        if (d < D) {
          dv[c] = fmaf(pdv, dor[d], dv[c]);
          dk[c] = fmaf(dsv, qr[d], dk[c]);
        }
      }
    }
  }
  const int key = k0 + jo;
  if (key < p.K) {
    T* dkp = static_cast<T*>(p.dk) + (bh * p.K + key) * D;
    T* dvp = static_cast<T*>(p.dv) + (bh * p.K + key) * D;
#pragma unroll
    for (int c = 0; c < DPT; ++c) {
      const int d = g + 4 * c;
      if (d < D) {
        dkp[d] = from_float<T>(dk[c]);
        dvp[d] = from_float<T>(dv[c]);
      }
    }
  }
}

// dbias[x] = sum over b of ds[b][x], x over H*Q*K, b in order.
__global__ void t5_bwd_dbias_kernel(const float* __restrict__ ds,
                                    float* __restrict__ dbias, int B,
                                    size_t n) {
  for (size_t x = (size_t)blockIdx.x * blockDim.x + threadIdx.x; x < n;
       x += (size_t)gridDim.x * blockDim.x) {
    float acc = 0.f;
    for (int b = 0; b < B; ++b) acc += ds[(size_t)b * n + x];
    dbias[x] = acc;
  }
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t smem) {
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T, int DPT>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const size_t rows = (size_t)kTile * (p.D + 1);
  const size_t smem_dq = sizeof(float) * (4 * rows + kTile * kLdT);
  const size_t smem_dkdv = sizeof(float) * (4 * rows + 2 * kTile * kLdT);
  auto dq_kernel = t5_bwd_dq_kernel<T, DPT>;
  auto dkdv_kernel = t5_bwd_dkdv_kernel<T, DPT>;
  cudaError_t e = set_smem(dq_kernel, smem_dq);
  if (e != cudaSuccess) return e;
  e = set_smem(dkdv_kernel, smem_dkdv);
  if (e != cudaSuccess) return e;

  dq_kernel<<<dim3((p.Q + kTile - 1) / kTile, p.H, p.B), kThreads, smem_dq,
              stream>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  dkdv_kernel<<<dim3((p.K + kTile - 1) / kTile, p.H, p.B), kThreads,
                smem_dkdv, stream>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess || p.dbias == nullptr) return e;
  const size_t n = (size_t)p.H * p.Q * p.K;
  const int threads = 256;
  const int blocks = (int)((n + threads - 1) / threads < 8192
                               ? (n + threads - 1) / threads
                               : 8192);
  t5_bwd_dbias_kernel<<<blocks, threads, 0, stream>>>(p.ds, p.dbias, p.B, n);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Params& p, cudaStream_t stream) {
  switch ((p.D + 31) / 32) {
    case 1:
      return launch<T, 8>(p, stream);
    case 2:
      return launch<T, 16>(p, stream);
    case 3:
      return launch<T, 24>(p, stream);
    case 4:
      return launch<T, 32>(p, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q/dout/dq (B,H,Q,D), k/v/dk/dv (B,H,K,D): contiguous, fp32 (is_bf16=0) or
// bf16 (is_bf16=1). bias (H,Q,K) fp32 or NULL; kmask (B,K) int32 or NULL;
// seed: one int64 in device memory, or NULL for no dropout (then rate is
// ignored); rate in [0, 1). stats (B,H,Q,2) fp32: the forward's row max and
// sum (`t5_attention_fwd.cu` writes them). delta (B,H,Q) fp32 scratch. dbias
// (H,Q,K) fp32 or NULL; with dbias, ds is a (B,H,Q,K) fp32 scratch. Returns
// the first launch's cudaError_t that is not 0.
extern "C" int klab_t5_attention_bwd(
    const void* q, const void* k, const void* v, const void* dout,
    const void* bias, const void* kmask, const void* seed, const void* stats,
    void* delta, void* dq, void* dk, void* dv, void* ds, void* dbias, int B,
    int H, int Q, int K, int D, int is_bf16, double rate, void* stream) {
  if (B < 1 || H < 1 || Q < 1 || K < 1 || D < 1 || D > 128 || H > 65535 ||
      B > 65535 || !(rate >= 0.0 && rate < 1.0) || stats == nullptr ||
      (dbias != nullptr && (ds == nullptr || bias == nullptr)))
    return (int)cudaErrorInvalidValue;
  const Params p{q, k, v, dout,
                 static_cast<const float*>(bias),
                 static_cast<const int*>(kmask),
                 static_cast<const long long*>(seed),
                 static_cast<const float*>(stats), static_cast<float*>(delta),
                 dq, dk, dv, static_cast<float*>(ds),
                 static_cast<float*>(dbias), B, H, Q, K, D,
                 (uint32_t)(rate * 4294967296.0), (float)(1.0 - rate)};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return (int)dispatch<__nv_bfloat16>(p, s);
  return (int)dispatch<float>(p, s);
}
