// T5 attention forward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces: klab_multimodalmodel_tpu/ops/fused_attention.py, `_fwd_kernel`
// in plain mode (cosine=False), reached through `_fwd` and
// `t5_fused_attention[_packed]`.
//
// Computes, per (batch b, head h):
//   P = softmax(Q K^T + bias[h] + (kmask[b] > 0 ? 0 : -1e9))
//   O = dropout(P) V,  dropout(P) = keep ? P / (1 - rate) : 0
// with no 1/sqrt(d) scale, logits and softmax in fp32, and the output in the
// input dtype (fp32 or bf16). Q != K is allowed. At rate > 0 the keep bits
// come from Philox4x32-10 keyed by a seed read from device memory
// (`philox.cuh`): a pure function of (seed, b, h, q, k), which the backward
// (`t5_attention_bwd.cu`) draws again. With `stats` given, the row max and
// the row sum of exp(logit - max) go out as (B, H, Q, 2) fp32 for the
// backward. (A single log-sum-exp would lose a fully masked row: -1e9 +
// log K rounds to -1e9 in fp32, and exp(logit - lse) would give 1, not 1/K.)
//
// What bounds it on this card: at the serving shapes (B=8, H=16, D=64,
// L=32 or 96, fp32) one (b, h) moves 4*L*D*4 bytes of q/k/v/o for 4*L*L*D
// FLOP of products: L/4 FLOP per byte, 8 at L=32 and 24 at L=96, either side
// of the fp32 ridge (67 TFLOP/s over 3.35 TB/s = 20). The whole call is a
// few MB and a few hundred MFLOP, so at these sizes launch latency and the
// scalar-FMA products weigh more than either bound. At the training shapes
// (B=32, L=128..320, bf16) the ratio is L/2 = 64..160 FLOP per byte, under
// the bf16 tensor-core ridge (989 TFLOP/s over 3.35 TB/s = 295): bytes bound
// it, but only a tensor-core kernel comes near; this one runs fp32 FMAs.
// Dropout adds one Philox4x32-10 per probability (each lane draws the word
// of its own key; four lanes share a counter).
// Design: one block per (b, h, 32-query tile); key/value tiles of 32 rows
// are staged once in shared memory (fp32) and read by every query row of the
// block, so Q/K/V leave device memory once; an online (running max / sum)
// softmax over key tiles keeps any K within a fixed shared-memory footprint
// and never writes the logits out. Each lane owns one key of the tile for
// the logits and D/32 output columns for P V. No tensor cores yet: the
// matrix products are plain fp32 FMAs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kRowsPerWarp = 8;
constexpr int kBlockQ = kWarps * kRowsPerWarp;  // query rows per block
constexpr int kBlockK = 32;                     // keys per tile: one per lane
constexpr float kMaskedLogit = -1e9f;           // NEG of the TPU kernel
constexpr unsigned kFull = 0xffffffffu;

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

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// NCH = ceil(D / 32): output columns each lane owns (lane + 32 * c).
template <typename T, int NCH>
__global__ void __launch_bounds__(kWarps * 32)
    t5_attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v,
                            const float* __restrict__ bias,
                            const int* __restrict__ kmask,
                            const long long* __restrict__ seed,
                            T* __restrict__ out, float* __restrict__ stats,
                            int H, int Q, int K, int D, uint32_t threshold,
                            float keep_prob) {
  extern __shared__ float smem[];
  float* q_s = smem;                     // [kBlockQ][D]
  float* k_s = q_s + kBlockQ * D;        // [kBlockK][D + 1], padded: no
  float* v_s = k_s + kBlockK * (D + 1);  // [kBlockK][D]     bank conflicts

  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const size_t bh = (size_t)b * H + h;
  const T* qp = q + bh * Q * D;
  const T* kp = k + bh * K * D;
  const T* vp = v + bh * K * D;
  const bool dropout = seed != nullptr;
  const uint64_t seed_v = dropout ? (uint64_t)*seed : 0;

  for (int i = tid; i < kBlockQ * D; i += blockDim.x) {
    const int r = i / D;
    q_s[i] = (q0 + r < Q) ? to_float(qp[(size_t)q0 * D + i]) : 0.f;
  }

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][NCH];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < NCH; ++c) acc[r][c] = 0.f;
  }

  for (int k0 = 0; k0 < K; k0 += kBlockK) {
    __syncthreads();  // q_s written; the previous K/V tile fully consumed
    for (int i = tid; i < kBlockK * D; i += blockDim.x) {
      const int j = i / D;
      const int d = i % D;
      const bool ok = k0 + j < K;
      const size_t src = (size_t)(k0 + j) * D + d;
      k_s[j * (D + 1) + d] = ok ? to_float(kp[src]) : 0.f;
      v_s[j * D + d] = ok ? to_float(vp[src]) : 0.f;
    }
    __syncthreads();

    const int key = k0 + lane;
    const bool key_ok = key < K;
    float mask_add = 0.f;
    if (kmask != nullptr && key_ok && kmask[(size_t)b * K + key] <= 0)
      mask_add = kMaskedLogit;

#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int row = warp * kRowsPerWarp + r;
      const int qi = q0 + row;
      if (qi < Q) {  // warp-uniform
        float s = -INFINITY;
        if (key_ok) {
          const float* qr = q_s + row * D;
          const float* kr = k_s + lane * (D + 1);
          float dot = 0.f;
          for (int d = 0; d < D; ++d) dot = fmaf(qr[d], kr[d], dot);
          s = dot;
          if (bias != nullptr) s += bias[((size_t)h * Q + qi) * K + key];
          s += mask_add;
        }
        // Lane 0 always holds a valid key (k0 < K), so m_new is finite.
        const float m_new = fmaxf(m[r], warp_max(s));
        const float p = key_ok ? expf(s - m_new) : 0.f;
        const float corr = expf(m[r] - m_new);  // 0 on the first tile
        l[r] = l[r] * corr + warp_sum(p);
        // The normalizer sums the probabilities before dropout; only the
        // product with V sees the dropped, rescaled ones.
        float pd = p;
        if (dropout)
          pd = (key_ok && klab::dropout_keep(seed_v, b, h, qi, key, threshold))
                   ? p / keep_prob
                   : 0.f;
#pragma unroll
        for (int c = 0; c < NCH; ++c) acc[r][c] *= corr;
        for (int j = 0; j < kBlockK; ++j) {
          const float pj = __shfl_sync(kFull, pd, j);
#pragma unroll
          for (int c = 0; c < NCH; ++c) {
            const int d = lane + 32 * c;
            if (d < D) acc[r][c] = fmaf(pj, v_s[j * D + d], acc[r][c]);
          }
        }
        m[r] = m_new;
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int qi = q0 + warp * kRowsPerWarp + r;
    if (qi < Q) {
      const float inv = 1.f / l[r];
#pragma unroll
      for (int c = 0; c < NCH; ++c) {
        const int d = lane + 32 * c;
        if (d < D) out[(bh * Q + qi) * D + d] = from_float<T>(acc[r][c] * inv);
      }
      if (stats != nullptr && lane == 0) {
        stats[(bh * Q + qi) * 2] = m[r];
        stats[(bh * Q + qi) * 2 + 1] = l[r];
      }
    }
  }
}

struct Args {
  const void *q, *k, *v, *bias, *kmask, *seed;
  void *out, *stats;
  int B, H, Q, K, D;
  uint32_t threshold;
  float keep_prob;
};

template <typename T, int NCH>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const int D = a.D;
  const size_t smem =
      sizeof(float) * ((size_t)kBlockQ * D + (size_t)kBlockK * (D + 1) +
                       (size_t)kBlockK * D);
  auto kernel = t5_attention_fwd_kernel<T, NCH>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((a.Q + kBlockQ - 1) / kBlockQ, a.H, a.B);
  kernel<<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const float*>(a.bias),
      static_cast<const int*>(a.kmask), static_cast<const long long*>(a.seed),
      static_cast<T*>(a.out), static_cast<float*>(a.stats), a.H, a.Q, a.K, D,
      a.threshold, a.keep_prob);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Args& a, cudaStream_t stream) {
  switch ((a.D + 31) / 32) {
    case 1:
      return launch<T, 1>(a, stream);
    case 2:
      return launch<T, 2>(a, stream);
    case 3:
      return launch<T, 3>(a, stream);
    case 4:
      return launch<T, 4>(a, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B,H,Q,D), k/v (B,H,K,D), out (B,H,Q,D): contiguous, fp32 (is_bf16=0)
// or bf16 (is_bf16=1). bias (H,Q,K) fp32 or NULL; kmask (B,K) int32 or NULL.
// seed: one int64 in device memory, or NULL for no dropout; rate in [0, 1)
// is the dropout rate (ignored without a seed). stats (B,H,Q,2) fp32 or
// NULL. Returns the cudaError_t of the launch (0 = success).
extern "C" int klab_t5_attention_fwd(const void* q, const void* k,
                                     const void* v, const void* bias,
                                     const void* kmask, const void* seed,
                                     void* out, void* stats, int B, int H,
                                     int Q, int K, int D, int is_bf16,
                                     double rate, void* stream) {
  if (B < 1 || H < 1 || Q < 1 || K < 1 || D < 1 || D > 128 || H > 65535 ||
      B > 65535 || !(rate >= 0.0 && rate < 1.0))
    return (int)cudaErrorInvalidValue;
  // floor(rate * 2^32) and 1 - rate in fp32, as the TPU kernel forms them.
  const Args a{q, k, v, bias, kmask, seed, out, stats, B, H, Q, K, D,
               (uint32_t)(rate * 4294967296.0), (float)(1.0 - rate)};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return (int)dispatch<__nv_bfloat16>(a, s);
  return (int)dispatch<float>(a, s);
}
