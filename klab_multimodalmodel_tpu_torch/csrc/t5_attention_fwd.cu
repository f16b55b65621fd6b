// T5 attention forward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces: klab_multimodalmodel_tpu/ops/fused_attention.py, `_fwd_kernel`
// in plain mode (cosine=False) at dropout rate 0, reached through `_fwd` and
// `t5_fused_attention[_packed]`.
//
// Computes, per (batch b, head h):
//   O = softmax(Q K^T + bias[h] + (kmask[b] > 0 ? 0 : -1e9)) V
// with no 1/sqrt(d) scale, logits and softmax in fp32, and the output in the
// input dtype (fp32 or bf16). Q != K is allowed.
//
// What bounds it on this card: at the serving shapes (B=8, H=16, D=64,
// L=32 or 96, fp32) one (b, h) moves 4*L*D*4 bytes of q/k/v/o for 4*L*L*D
// FLOP of products: L/4 FLOP per byte, 8 at L=32 and 24 at L=96, either side
// of the fp32 ridge (67 TFLOP/s over 3.35 TB/s = 20). The whole call is a
// few MB and a few hundred MFLOP, so at these sizes launch latency and the
// scalar-FMA products weigh more than either bound.
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
                            T* __restrict__ out, int H, int Q, int K, int D) {
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
#pragma unroll
        for (int c = 0; c < NCH; ++c) acc[r][c] *= corr;
        for (int j = 0; j < kBlockK; ++j) {
          const float pj = __shfl_sync(kFull, p, j);
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
    }
  }
}

template <typename T, int NCH>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* bias, const void* kmask, void* out, int B,
                   int H, int Q, int K, int D, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)kBlockQ * D + (size_t)kBlockK * (D + 1) +
                       (size_t)kBlockK * D);
  auto kernel = t5_attention_fwd_kernel<T, NCH>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((Q + kBlockQ - 1) / kBlockQ, H, B);
  kernel<<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(bias),
      static_cast<const int*>(kmask), static_cast<T*>(out), H, Q, K, D);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v,
                     const void* bias, const void* kmask, void* out, int B,
                     int H, int Q, int K, int D, cudaStream_t stream) {
  switch ((D + 31) / 32) {
    case 1:
      return launch<T, 1>(q, k, v, bias, kmask, out, B, H, Q, K, D, stream);
    case 2:
      return launch<T, 2>(q, k, v, bias, kmask, out, B, H, Q, K, D, stream);
    case 3:
      return launch<T, 3>(q, k, v, bias, kmask, out, B, H, Q, K, D, stream);
    case 4:
      return launch<T, 4>(q, k, v, bias, kmask, out, B, H, Q, K, D, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B,H,Q,D), k/v (B,H,K,D), out (B,H,Q,D): contiguous, fp32 (is_bf16=0)
// or bf16 (is_bf16=1). bias (H,Q,K) fp32 or NULL; kmask (B,K) int32 or NULL.
// Returns the cudaError_t of the launch (0 = success).
extern "C" int klab_t5_attention_fwd(const void* q, const void* k,
                                     const void* v, const void* bias,
                                     const void* kmask, void* out, int B,
                                     int H, int Q, int K, int D, int is_bf16,
                                     void* stream) {
  if (B < 1 || H < 1 || Q < 1 || K < 1 || D < 1 || D > 128 || H > 65535 ||
      B > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return (int)dispatch<__nv_bfloat16>(q, k, v, bias, kmask, out, B, H, Q,
                                        K, D, s);
  return (int)dispatch<float>(q, k, v, bias, kmask, out, B, H, Q, K, D, s);
}
