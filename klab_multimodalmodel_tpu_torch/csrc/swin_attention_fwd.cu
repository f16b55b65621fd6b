// SwinV2 scaled-cosine window attention forward for Hopper (sm_90a), plain
// C interface for ctypes.
//
// Replaces: klab_multimodalmodel_tpu/ops/fused_attention.py, `_fwd_kernel`
// in cosine mode (cosine=True), reached through `_swin_attention` and
// `swin_fused_attention`.
//
// Computes, per (window b, head h), with N window tokens of head dim D:
//   qn = q * rsqrt(sum(q^2) + 1e-24), kn likewise (fp32, cast back to the
//   input dtype), S = (qn kn^T) * exp(min(scale[h], ln 100)) + bias[h]
//   (+ wmask[b mod nW] for shifted windows), P = softmax(S), O = P V, output
//   in the input dtype (fp32 or bf16).
// The chain from the logits to P runs in fp32, or in bf16 (`sm_bf16`, the
// reference's `swin_softmax_dtype='bfloat16'`): then every step rounds to
// bf16 as the TPU kernel's does in `sm_dtype` -- the logits, the scale, the
// product, each added table, the max-subtracted logits, their exp, the row
// sum and the quotient -- while sums and products are formed in fp32.
//
// What bounds it on this card: at the serving shapes (N=64, D=32) one
// (window, head) reads 24 KB of q/k/v (fp32) and writes 8 KB for ~0.5 MFLOP
// of products: ~16 FLOP per byte, under the fp32 ridge of 67 TFLOP/s over
// 3.35 TB/s (20 FLOP per byte), so the least time is set by the bytes, and
// only if the N x N logits never reach device memory. The bias and mask
// tables are shared by all windows and come from L2.
// Design: one block per (window, head) holds q, k, v and the N x N logits
// in shared memory (under 42 KB at N=64, D=32 in fp32), so nothing but q,
// k, v, the shared bias tables and the output crosses device memory; the
// logits never leave the SM. No tensor cores yet: plain fp32 FMAs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kLogMaxScale = 4.605170185988091f;  // ln(100)

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

// Round through the input dtype (a no-op for fp32), as the TPU kernel casts
// the normalized q/k and the probabilities back before each product.
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<T>(x));
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// One step of the softmax chain: rounds to bf16 when the chain runs in bf16.
template <bool SM_BF16>
__device__ __forceinline__ float chain(float x) {
  return SM_BF16 ? bf16_round(x) : x;
}

template <typename T, bool SM_BF16>
__global__ void __launch_bounds__(kThreads)
    swin_attention_fwd_kernel(const T* __restrict__ q,
                              const T* __restrict__ k,
                              const T* __restrict__ v,
                              const float* __restrict__ scale,
                              const float* __restrict__ bias,
                              const float* __restrict__ wmask,
                              T* __restrict__ out, int H, int N, int D,
                              int nW) {
  extern __shared__ float smem[];
  const int ld = D + 1;                // padded rows: no bank conflicts
  float* q_s = smem;                   // [N][D + 1]
  float* k_s = q_s + N * ld;           // [N][D + 1]
  float* v_s = k_s + N * ld;           // [N][D]
  float* s_s = v_s + N * D;            // [N][N + 1]
  const int lds = N + 1;

  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int nwarps = kThreads / 32;
  const size_t base = ((size_t)b * H + h) * N * D;

  for (int i = tid; i < N * D; i += kThreads) {
    const int r = i / D;
    const int d = i % D;
    q_s[r * ld + d] = to_float(q[base + i]);
    k_s[r * ld + d] = to_float(k[base + i]);
    v_s[i] = to_float(v[base + i]);
  }
  __syncthreads();

  // L2-normalize the rows of q and k: one warp per row.
  for (int r = warp; r < 2 * N; r += nwarps) {
    float* row = (r < N) ? q_s + r * ld : k_s + (r - N) * ld;
    float ss = 0.f;
    for (int d = lane; d < D; d += 32) ss = fmaf(row[d], row[d], ss);
    const float inv = 1.f / sqrtf(warp_sum(ss) + 1e-24f);
    for (int d = lane; d < D; d += 32) row[d] = round_to<T>(row[d] * inv);
  }
  __syncthreads();

  const float s = chain<SM_BF16>(expf(fminf(scale[h], kLogMaxScale)));
  const float* bias_h = bias + (size_t)h * N * N;
  const float* mask_w =
      (wmask != nullptr) ? wmask + (size_t)(b % nW) * N * N : nullptr;
  for (int i = tid; i < N * N; i += kThreads) {
    const int r = i / N;
    const int c = i % N;
    const float* qr = q_s + r * ld;
    const float* kr = k_s + c * ld;
    float dot = 0.f;
    for (int d = 0; d < D; ++d) dot = fmaf(qr[d], kr[d], dot);
    float logit;
    if (SM_BF16) {
      logit = bf16_round(bf16_round(dot) * s);
      logit = bf16_round(logit + bf16_round(bias_h[i]));
      if (mask_w != nullptr)
        logit = bf16_round(logit + bf16_round(mask_w[i]));
    } else {
      logit = dot * s + bias_h[i];
      if (mask_w != nullptr) logit += mask_w[i];
    }
    s_s[r * lds + c] = logit;
  }
  __syncthreads();

  // Row softmax, one warp per row.
  for (int r = warp; r < N; r += nwarps) {
    float* row = s_s + r * lds;
    float mx = -INFINITY;
    for (int c = lane; c < N; c += 32) mx = fmaxf(mx, row[c]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int c = lane; c < N; c += 32) {
      const float e = chain<SM_BF16>(expf(chain<SM_BF16>(row[c] - mx)));
      row[c] = e;
      sum += e;
    }
    sum = chain<SM_BF16>(warp_sum(sum));
    for (int c = lane; c < N; c += 32)
      row[c] = round_to<T>(chain<SM_BF16>(row[c] / sum));
  }
  __syncthreads();

  for (int i = tid; i < N * D; i += kThreads) {
    const int r = i / D;
    const int d = i % D;
    const float* pr = s_s + r * lds;
    float o = 0.f;
    for (int c = 0; c < N; ++c) o = fmaf(pr[c], v_s[c * D + d], o);
    out[base + i] = from_float<T>(o);
  }
}

template <typename T, bool SM_BF16>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* scale, const void* bias, const void* wmask,
                   void* out, int Bn, int H, int N, int D, int nW,
                   cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)2 * N * (D + 1) +
                                       (size_t)N * D + (size_t)N * (N + 1));
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  auto kernel = swin_attention_fwd_kernel<T, SM_BF16>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(Bn, H);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<const float*>(wmask),
      static_cast<T*>(out), H, N, D, nW);
  return cudaGetLastError();
}

}  // namespace

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v,
                     const void* scale, const void* bias, const void* wmask,
                     void* out, int Bn, int H, int N, int D, int nW,
                     int sm_bf16, cudaStream_t stream) {
  if (sm_bf16)
    return launch<T, true>(q, k, v, scale, bias, wmask, out, Bn, H, N, D, nW,
                           stream);
  return launch<T, false>(q, k, v, scale, bias, wmask, out, Bn, H, N, D, nW,
                          stream);
}

// q/k/v/out (Bn,H,N,D) contiguous, fp32 (is_bf16=0) or bf16 (is_bf16=1);
// scale (H,) fp32 raw logit scale; bias (H,N,N) fp32; wmask (nW,N,N) fp32
// or NULL (then nW is ignored); sm_bf16: the softmax chain in bf16 (1) or
// fp32 (0). Returns the launch's cudaError_t.
extern "C" int klab_swin_attention_fwd(const void* q, const void* k,
                                       const void* v, const void* scale,
                                       const void* bias, const void* wmask,
                                       void* out, int Bn, int H, int N, int D,
                                       int nW, int is_bf16, int sm_bf16,
                                       void* stream) {
  if (Bn < 1 || H < 1 || N < 1 || D < 1 || H > 65535 ||
      (wmask != nullptr && (nW < 1 || Bn % nW != 0)))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return (int)dispatch<__nv_bfloat16>(q, k, v, scale, bias, wmask, out, Bn,
                                        H, N, D, nW, sm_bf16, s);
  return (int)dispatch<float>(q, k, v, scale, bias, wmask, out, Bn, H, N, D,
                              nW, sm_bf16, s);
}
