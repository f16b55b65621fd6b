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
// write. In practice the recomputed logits and dP (three times, in two
// kernels) and the Philox draws (three times) set the time; with dBias, the
// (B, H, Q, K) fp32 dS scratch is written and read once more.
//
// Three launches on the caller's stream, no float atomics, so two runs give
// the same bits:
//   1. dq kernel, one block per (b, h, query tile): with the forward's row
//      max and sum, delta_i = sum_j dP'_ij P_ij over all key tiles (an
//      explicit pass: rowsum(dO o O) would not round as the TPU kernel
//      does); then dS and dq over the key tiles again. Writes dq and delta
//      (B,H,Q) fp32 scratch.
//   2. dk/dv kernel, one block per (b, h, key tile): loops over all query
//      tiles, rebuilds P, Pd and dS from the row statistics and delta, and
//      accumulates dk, dv for its keys.
//   3. dBias kernel: dBias[h,q,k] = sum over b of dS, b in order, from a
//      (B,H,Q,K) fp32 scratch that the dk/dv kernel writes in fp32 and the
//      dq kernel in bf16.
//
// fp32 (`t5_bwd_dq_kernel`, `t5_bwd_dkdv_kernel`): 32-row tiles staged in
// shared memory as fp32, every product a scalar FMA; a thread owns one row
// and 8 consecutive keys, so one Philox call gives 4 keep bits.
//
// bf16 (`*_tc_kernel`): 64-row tiles, four warps of 16 rows, every product
// on mma.sync m16n8k16 (bf16 in, fp32 accumulators) with ldmatrix from
// double-buffered cp.async tiles (head dim zero-padded to DP, a multiple of
// 16). The dq kernel keeps Q and dO fragments in registers and walks 16-key
// chunks: S = Q K^T and dP = dO V^T, then dS rounded to bf16 from the
// accumulators is the A operand of dq += dS K. The dk/dv kernel keeps K and
// V fragments in registers and computes the transposed tiles S^T = K Q^T and
// dP^T = V dO^T over 16-query chunks, so Pd^T and dS^T come out in the
// accumulator layout that feeds dV += Pd^T dO and dK += dS^T Q from
// registers. The roundings are the TPU kernel's: Pd and dS to bf16 before
// their products, dP in fp32, dS = P (dP' - delta) in fp32; the dS scratch
// is written from the fragments in 8-byte stores. No load waits inside a
// chunk's work: the head bias of the next 16-key (16-query) chunk is loaded
// into registers while this chunk's products run, and the key addends (row
// statistics) of the next tile reach shared memory through a register after
// this tile's work. One Philox call per four
// keep bits: in the dq kernel lanes t and t ^ 1 swap nibbles as in the
// forward; in the transposed dk/dv tile four lanes at stride 4 (rows g of
// one key group) share four counters, each draws one, and two shuffles give
// every lane all four nibbles.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma.cuh"
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
  int head_offset;  // the global index of head 0 (Philox's head)
  int q_offset;     // the global index of query row 0 (Philox's query)
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
        (dropout && row_ok) ? keep_bits(seed, b, h + p.head_offset,
                                             p.q_offset + qi, key0,
                                         p.threshold)
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
        (dropout && row_ok) ? keep_bits(seed, b, h + p.head_offset,
                                             p.q_offset + qi, key0,
                                         p.threshold)
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
        (dropout && row_ok) ? keep_bits(seed, b, h + p.head_offset,
                                             p.q_offset + qi, key0,
                                         p.threshold)
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

// The dBias reduction over the (B, H, Q, K) scratch, n = H * Q * K.
cudaError_t launch_dbias(const float* ds, float* dbias, int B, size_t n,
                         cudaStream_t stream) {
  const int threads = 256;
  const int blocks = (int)((n + threads - 1) / threads < 8192
                               ? (n + threads - 1) / threads
                               : 8192);
  t5_bwd_dbias_kernel<<<blocks, threads, 0, stream>>>(ds, dbias, B, n);
  return cudaGetLastError();
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
  return launch_dbias(p.ds, p.dbias, p.B, (size_t)p.H * p.Q * p.K, stream);
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

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

constexpr int kTcRows = 64;  // query rows (dq) or keys (dk/dv) per block
constexpr int kTcCols = 64;  // keys (dq) or query rows (dk/dv) per tile
constexpr int kTcThreads = 128;
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFull = 0xffffffffu;

struct TcParams {
  const __nv_bfloat16 *q, *k, *v, *dout;
  const float* bias;      // (H,Q,K) or null
  const int* kmask;       // (B,K) or null
  const long long* seed;  // one int64, or null for no dropout
  const float* stats;     // (B,H,Q,2): the forward's row max, row sum
  float* delta;           // (B,H,Q) scratch
  __nv_bfloat16 *dq, *dk, *dv;
  float* ds;              // (B,H,Q,K) scratch, or null without dBias
  int H, Q, K, D;
  uint32_t threshold;
  float inv_keep;         // 1 / (1 - rate)
  bool vec;               // D % 8 == 0 and 16-byte aligned matrices
  bool pair_vec;          // K even, bias and ds 8-byte aligned: float2
  int head_offset;        // the global index of head 0 (Philox's head)
  int q_offset;           // the global index of query row 0 (Philox's query)
};

// Shared memory of either kernel: two resident tiles, two double-buffered
// ones, and `extra` floats per double-buffered row.
template <int DP>
constexpr size_t bwd_tc_smem(int extra) {
  return sizeof(__nv_bfloat16) * (size_t)(2 * kTcRows + 4 * kTcCols) *
             (DP + 8) +
         sizeof(float) * 2 * kTcCols * extra;
}

template <int DP>
__global__ void __launch_bounds__(kTcThreads)
    t5_bwd_dq_tc_kernel(TcParams p) {
  using bf16 = __nv_bfloat16;
  constexpr int LD = DP + 8;
  constexpr int KS = DP / 16;
  constexpr int NT = DP / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);  // [64][LD], then dq
  bf16* do_s = q_s + kTcRows * LD;                // [64][LD]
  bf16* k_s = do_s + kTcRows * LD;                // [2][64][LD]
  bf16* v_s = k_s + 2 * kTcCols * LD;             // [2][64][LD]
  float* add_s = reinterpret_cast<float*>(v_s + 2 * kTcCols * LD);  // [2][64]

  const int q0 = blockIdx.x * kTcRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int row0 = q0 + warp * 16 + g;  // this lane's rows: row0, row0 + 8
  const size_t bh = (size_t)b * p.H + h;
  const bf16* kp = p.k + bh * p.K * p.D;
  const bf16* vp = p.v + bh * p.K * p.D;
  const bool dropout = p.seed != nullptr;
  const uint2 pkey = klab::seed_key(p.seed);

  klab::load_tile<kTcRows, DP, kTcThreads>(q_s, p.q + bh * p.Q * p.D, q0,
                                           p.Q, p.D, p.vec);
  klab::load_tile<kTcRows, DP, kTcThreads>(do_s, p.dout + bh * p.Q * p.D, q0,
                                           p.Q, p.D, p.vec);
  klab::load_tile<kTcCols, DP, kTcThreads>(k_s, kp, 0, p.K, p.D, p.vec);
  klab::load_tile<kTcCols, DP, kTcThreads>(v_s, vp, 0, p.K, p.D, p.vec);
  klab::cp_async_commit();
  const int ti = threadIdx.x;  // the key of a tile whose addend it stages
  if (ti < kTcCols) add_s[ti] = klab::key_addend(p.kmask, b, ti, p.K);

  // The forward's row max and 1 / row sum; rows past Q get P = 0.
  float m[2], il[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    m[r] = INFINITY;
    il[r] = 1.f;
    if (row < p.Q) {
      const float2 st =
          *reinterpret_cast<const float2*>(p.stats + (bh * p.Q + row) * 2);
      m[r] = st.x;
      il[r] = 1.f / st.y;
    }
  }

  uint32_t qf[KS][4], df[KS][4];
  float dq[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[n][e] = 0.f;
  float delta[2] = {0.f, 0.f};

  // This lane's bias entries of the 16-key chunk at key kc: (n, r) pairs,
  // loaded one chunk ahead so that the chunk's products hide their latency.
  const auto load_bias = [&](float2 (&dst)[2][2], int kc) {
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        dst[n][r] = klab::bias_pair(p.bias, h, p.Q, p.K, row0 + 8 * r,
                                    kc + 8 * n + 2 * t, p.pair_vec);
  };
  float2 bias_cur[2][2];
  load_bias(bias_cur, 0);

  // Both passes through one pipeline: tiles 0 .. nk-1 form delta, tiles
  // nk .. 2nk-1 the same keys again for dS and dq.
  const int nk = (p.K + kTcCols - 1) / kTcCols;
  for (int j = 0; j < 2 * nk; ++j) {
    const int st = j & 1;
    const int k1 = ((j + 1) % nk) * kTcCols;  // the next tile's first key
    float add_next = 0.f;
    if (j + 1 < 2 * nk) {
      klab::load_tile<kTcCols, DP, kTcThreads>(k_s + (st ^ 1) * kTcCols * LD,
                                               kp, k1, p.K, p.D, p.vec);
      klab::load_tile<kTcCols, DP, kTcThreads>(v_s + (st ^ 1) * kTcCols * LD,
                                               vp, k1, p.K, p.D, p.vec);
      if (ti < kTcCols) add_next = klab::key_addend(p.kmask, b, k1 + ti, p.K);
    }
    klab::cp_async_commit();
    klab::cp_async_wait<1>();
    __syncthreads();
    if (j == 0) {
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        const int off = (warp * 16 + (lane & 15)) * LD + ks * 16 + (lane >> 4) * 8;
        klab::ldmatrix_x4(qf[ks], q_s + off);
        klab::ldmatrix_x4(df[ks], do_s + off);
      }
    }
    const bool second = j >= nk;
    if (j == nk) {  // delta complete: sum the quad, keep it for the dk/dv kernel
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        delta[r] += __shfl_xor_sync(kFull, delta[r], 1);
        delta[r] += __shfl_xor_sync(kFull, delta[r], 2);
        if (t == 0 && row0 + 8 * r < p.Q)
          p.delta[bh * p.Q + row0 + 8 * r] = delta[r];
      }
    }
    const bf16* kt = k_s + st * kTcCols * LD;
    const bf16* vt = v_s + st * kTcCols * LD;
    const float* add = add_s + st * kTcCols;
    const int k0 = (j % nk) * kTcCols;
    const int k_end = min(k0 + kTcCols, p.K);

    for (int c = 0; k0 + 16 * c < k_end; ++c) {
      const int kc = k0 + 16 * c;
      float2 bias_next[2][2];
      load_bias(bias_next, kc + 16 < k_end ? kc + 16 : k1);
      // S = Q K^T and dP = dO V^T for keys kc .. kc + 15.
      float s[2][4] = {}, dp[2][4] = {};
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t kb[4], vb[4];
        const int off = (16 * c + (lane & 7) + ((lane >> 4) << 3)) * LD +
                        ks * 16 + (((lane >> 3) & 1) << 3);
        klab::ldmatrix_x4(kb, kt + off);
        klab::ldmatrix_x4(vb, vt + off);
        klab::mma_bf16(s[0], qf[ks], kb[0], kb[1]);
        klab::mma_bf16(s[1], qf[ks], kb[2], kb[3]);
        klab::mma_bf16(dp[0], df[ks], vb[0], vb[1]);
        klab::mma_bf16(dp[1], df[ks], vb[2], vb[3]);
      }
      // Keep bits as in the forward: lanes t, t ^ 1 share each counter.
      uint32_t bits[2] = {kFull, kFull};
      const int sel = 2 * (t & 1);
      if (dropout) {
        uint32_t mine = 0;
#pragma unroll
        for (int n = 0; n < 2; ++n)
          mine |= klab::keep_nibble(pkey, (uint32_t)((kc + 8 * n) >> 2) + (t >> 1),
                                    p.q_offset + row0 + 8 * (t & 1),
                                    h + p.head_offset, b,
                                    p.threshold)
                  << (4 * n);
        const uint32_t theirs = __shfl_xor_sync(kFull, mine, 1);
        bits[0] = (t & 1) ? theirs : mine;
        bits[1] = (t & 1) ? mine : theirs;
      }
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const int kt_c = 16 * c + 8 * n + 2 * t;  // key within the tile
#pragma unroll
        for (int r = 0; r < 2; ++r) {
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int e = 2 * r + u;
            const float bv = u ? bias_cur[n][r].y : bias_cur[n][r].x;
            const float sv = (s[n][e] + bv) + add[kt_c + u];
            const float pr = klab::exp2_approx((sv - m[r]) * kLog2e) * il[r];
            float d = dp[n][e];
            if (dropout)
              d = ((bits[r] >> (4 * n + sel + u)) & 1u) ? d * p.inv_keep : 0.f;
            if (second)
              s[n][e] = pr * (d - delta[r]);  // dS, fp32
            else
              delta[r] = fmaf(d, pr, delta[r]);
          }
        }
      }
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int r = 0; r < 2; ++r) bias_cur[n][r] = bias_next[n][r];
      if (second) {
        if (p.ds != nullptr) {
#pragma unroll
          for (int n = 0; n < 2; ++n)
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const int row = row0 + 8 * r;
              const int key = kc + 8 * n + 2 * t;
              if (row >= p.Q || key >= p.K) continue;
              float* dst = p.ds + (bh * p.Q + row) * p.K + key;
              if (p.pair_vec) {
                *reinterpret_cast<float2*>(dst) =
                    make_float2(s[n][2 * r], s[n][2 * r + 1]);
              } else {
                dst[0] = s[n][2 * r];
                if (key + 1 < p.K) dst[1] = s[n][2 * r + 1];
              }
            }
        }
        // dq += dS K, dS rounded to bf16 straight from the accumulators.
        uint32_t da[4];
        klab::acc_to_a(da, s[0], s[1]);
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t kb[4];
          klab::ldmatrix_x4_trans(
              kb, kt + (16 * c + (lane & 7) + (((lane >> 3) & 1) << 3)) * LD +
                      np * 16 + ((lane >> 4) << 3));
          klab::mma_bf16(dq[2 * np], da, kb[0], kb[1]);
          klab::mma_bf16(dq[2 * np + 1], da, kb[2], kb[3]);
        }
      }
    }
    if (j + 1 < 2 * nk && ti < kTcCols) add_s[(st ^ 1) * kTcCols + ti] = add_next;
    __syncthreads();  // the next iteration's copies refill this stage
  }

  bf16* os = q_s + warp * 16 * LD;  // this warp's rows only
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int n = 0; n < NT; ++n)
      *reinterpret_cast<uint32_t*>(os + (g + 8 * r) * LD + 8 * n + 2 * t) =
          klab::pack_bf16(dq[n][2 * r], dq[n][2 * r + 1]);
  __syncwarp();
  klab::store_tile_warp<16, DP>(p.dq + bh * p.Q * p.D, os, q0 + warp * 16,
                                p.Q, p.D, p.vec, lane);
}

// Row max, 1 / row sum and delta of query row q, or, past Q, P = 0 (max
// +inf) and delta 0. `st` and `dl` are the raw loads (`load_row_raw`), so
// that a prefetch waits for them only here.
struct RowRaw {
  float2 st;
  float dl;
};

__device__ __forceinline__ RowRaw load_row_raw(const TcParams& p, size_t bh,
                                               int q) {
  RowRaw r{make_float2(INFINITY, 1.f), 0.f};
  if (q < p.Q) {
    r.st = *reinterpret_cast<const float2*>(p.stats + (bh * p.Q + q) * 2);
    r.dl = p.delta[bh * p.Q + q];
  }
  return r;
}

__device__ __forceinline__ float4 row_stats(const RowRaw& r) {
  return make_float4(r.st.x, 1.f / r.st.y, r.dl, 0.f);
}

template <int DP>
__global__ void __launch_bounds__(kTcThreads)
    t5_bwd_dkdv_tc_kernel(TcParams p) {
  using bf16 = __nv_bfloat16;
  constexpr int LD = DP + 8;
  constexpr int KS = DP / 16;
  constexpr int NT = DP / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw);  // [64][LD], then dk
  bf16* v_s = k_s + kTcRows * LD;                 // [64][LD], then dv
  bf16* q_s = v_s + kTcRows * LD;                 // [2][64][LD]
  bf16* do_s = q_s + 2 * kTcCols * LD;            // [2][64][LD]
  float4* rs_s = reinterpret_cast<float4*>(do_s + 2 * kTcCols * LD);  // [2][64]

  const int k0 = blockIdx.x * kTcRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int key0 = k0 + warp * 16 + g;  // this lane's keys: key0, key0 + 8
  const size_t bh = (size_t)b * p.H + h;
  const bf16* qp = p.q + bh * p.Q * p.D;
  const bf16* dop = p.dout + bh * p.Q * p.D;
  const bool dropout = p.seed != nullptr;
  const uint2 pkey = klab::seed_key(p.seed);

  klab::load_tile<kTcRows, DP, kTcThreads>(k_s, p.k + bh * p.K * p.D, k0, p.K,
                                           p.D, p.vec);
  klab::load_tile<kTcRows, DP, kTcThreads>(v_s, p.v + bh * p.K * p.D, k0, p.K,
                                           p.D, p.vec);
  klab::load_tile<kTcCols, DP, kTcThreads>(q_s, qp, 0, p.Q, p.D, p.vec);
  klab::load_tile<kTcCols, DP, kTcThreads>(do_s, dop, 0, p.Q, p.D, p.vec);
  klab::cp_async_commit();
  const int ti = threadIdx.x;  // the query row of a tile whose stats it stages
  if (ti < kTcCols) rs_s[ti] = row_stats(load_row_raw(p, bh, ti));
  const float add[2] = {klab::key_addend(p.kmask, b, key0, p.K),
                        klab::key_addend(p.kmask, b, key0 + 8, p.K)};

  // This lane's bias entries of the 16-query chunk at row qc: entry e of
  // n-tile n is (query qc + 8n + 2t + (e & 1), key key0 + 8 (e >> 1)),
  // loaded one chunk ahead.
  const auto load_bias = [&](float (&dst)[2][4], int qc) {
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int q = qc + 8 * n + 2 * t + (e & 1);
        const int key = key0 + 8 * (e >> 1);
        dst[n][e] = (p.bias != nullptr && q < p.Q && key < p.K)
                        ? __ldg(p.bias + ((size_t)h * p.Q + q) * p.K + key)
                        : 0.f;
      }
  };
  float bias_cur[2][4];
  load_bias(bias_cur, 0);

  uint32_t kf[KS][4], vf[KS][4];
  float dk[NT][4], dv[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  const int nq = (p.Q + kTcCols - 1) / kTcCols;
  for (int j = 0; j < nq; ++j) {
    const int st = j & 1;
    const int q1 = (j + 1) * kTcCols;  // the next tile's first row
    RowRaw rs_next{};
    if (j + 1 < nq) {
      klab::load_tile<kTcCols, DP, kTcThreads>(q_s + (st ^ 1) * kTcCols * LD,
                                               qp, q1, p.Q, p.D, p.vec);
      klab::load_tile<kTcCols, DP, kTcThreads>(do_s + (st ^ 1) * kTcCols * LD,
                                               dop, q1, p.Q, p.D, p.vec);
      if (ti < kTcCols) rs_next = load_row_raw(p, bh, q1 + ti);
    }
    klab::cp_async_commit();
    klab::cp_async_wait<1>();
    __syncthreads();
    if (j == 0) {
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        const int off = (warp * 16 + (lane & 15)) * LD + ks * 16 + (lane >> 4) * 8;
        klab::ldmatrix_x4(kf[ks], k_s + off);
        klab::ldmatrix_x4(vf[ks], v_s + off);
      }
    }
    const bf16* qt = q_s + st * kTcCols * LD;
    const bf16* dt = do_s + st * kTcCols * LD;
    const float4* rs = rs_s + st * kTcCols;
    const int q0 = j * kTcCols;
    const int q_end = min(q0 + kTcCols, p.Q);

    for (int c = 0; q0 + 16 * c < q_end; ++c) {
      const int qc = q0 + 16 * c;
      float bias_next[2][4];
      load_bias(bias_next, qc + 16 < q_end ? qc + 16 : q1);
      // S^T = K Q^T and dP^T = V dO^T: rows are this lane's keys, columns
      // queries qc + 8n + 2t (+1).
      float s[2][4] = {}, dp[2][4] = {};
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t qb[4], ob[4];
        const int off = (16 * c + (lane & 7) + ((lane >> 4) << 3)) * LD +
                        ks * 16 + (((lane >> 3) & 1) << 3);
        klab::ldmatrix_x4(qb, qt + off);
        klab::ldmatrix_x4(ob, dt + off);
        klab::mma_bf16(s[0], kf[ks], qb[0], qb[1]);
        klab::mma_bf16(s[1], kf[ks], qb[2], qb[3]);
        klab::mma_bf16(dp[0], vf[ks], ob[0], ob[1]);
        klab::mma_bf16(dp[1], vf[ks], ob[2], ob[3]);
      }
      // Keep bits. Accumulator e of n-tile n is (key key0 + 8 (e >> 1),
      // query qc + 8n + 2t + (e & 1)); its counter is (key >> 2, query),
      // word key & 3 = g & 3. The lanes g = 4i' + 0..3 with this t need the
      // same four counters, one per e: lane i = g & 3 draws counter e = i,
      // and two shuffles (lanes ^ 4, ^ 8) gather all four nibbles.
      uint32_t bits = kFull;
      if (dropout) {
        const int i = g & 3;
        const uint32_t kc = (uint32_t)((key0 + 8 * (i >> 1)) >> 2);
        uint32_t x = 0;
#pragma unroll
        for (int n = 0; n < 2; ++n)
          x |= klab::keep_nibble(pkey, kc,
                                 p.q_offset + qc + 8 * n + 2 * t + (i & 1),
                                 h + p.head_offset, b, p.threshold)
               << (16 * n + 4 * i);
        x |= __shfl_xor_sync(kFull, x, 4);
        x |= __shfl_xor_sync(kFull, x, 8);
        bits = x;
      }
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float4 r = rs[16 * c + 8 * n + 2 * t + (e & 1)];  // max, 1/sum, delta
          const float sv = (s[n][e] + bias_cur[n][e]) + add[e >> 1];
          const float pr = klab::exp2_approx((sv - r.x) * kLog2e) * r.y;
          const bool kept = (bits >> (16 * n + 4 * e + (g & 3))) & 1u;
          float pd = pr, d = dp[n][e];
          if (dropout) {
            pd = kept ? pr * p.inv_keep : 0.f;
            d = kept ? d * p.inv_keep : 0.f;
          }
          s[n][e] = pd;               // Pd^T
          dp[n][e] = pr * (d - r.z);  // dS^T, fp32
          bias_cur[n][e] = bias_next[n][e];
        }
      // dV += Pd^T dO and dK += dS^T Q, A operands from the accumulators.
      uint32_t pa[4], da[4];
      klab::acc_to_a(pa, s[0], s[1]);
      klab::acc_to_a(da, dp[0], dp[1]);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t ob[4], qb[4];
        const int off = (16 * c + (lane & 7) + (((lane >> 3) & 1) << 3)) * LD +
                        np * 16 + ((lane >> 4) << 3);
        klab::ldmatrix_x4_trans(ob, dt + off);
        klab::ldmatrix_x4_trans(qb, qt + off);
        klab::mma_bf16(dv[2 * np], pa, ob[0], ob[1]);
        klab::mma_bf16(dv[2 * np + 1], pa, ob[2], ob[3]);
        klab::mma_bf16(dk[2 * np], da, qb[0], qb[1]);
        klab::mma_bf16(dk[2 * np + 1], da, qb[2], qb[3]);
      }
    }
    if (j + 1 < nq && ti < kTcCols)
      rs_s[(st ^ 1) * kTcCols + ti] = row_stats(rs_next);
    __syncthreads();  // the next iteration's copies refill this stage
  }

  bf16* ks_out = k_s + warp * 16 * LD;  // this warp's rows only
  bf16* vs_out = v_s + warp * 16 * LD;
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int off = (g + 8 * r) * LD + 8 * n + 2 * t;
      *reinterpret_cast<uint32_t*>(ks_out + off) =
          klab::pack_bf16(dk[n][2 * r], dk[n][2 * r + 1]);
      *reinterpret_cast<uint32_t*>(vs_out + off) =
          klab::pack_bf16(dv[n][2 * r], dv[n][2 * r + 1]);
    }
  __syncwarp();
  klab::store_tile_warp<16, DP>(p.dk + bh * p.K * p.D, ks_out, k0 + warp * 16,
                                p.K, p.D, p.vec, lane);
  klab::store_tile_warp<16, DP>(p.dv + bh * p.K * p.D, vs_out, k0 + warp * 16,
                                p.K, p.D, p.vec, lane);
}

template <int DP>
cudaError_t launch_tc(const TcParams& p, int B, float* dbias,
                      cudaStream_t stream) {
  const size_t smem_dq = bwd_tc_smem<DP>(1);
  const size_t smem_dkdv = bwd_tc_smem<DP>(4);
  auto dq_kernel = t5_bwd_dq_tc_kernel<DP>;
  auto dkdv_kernel = t5_bwd_dkdv_tc_kernel<DP>;
  cudaError_t e = set_smem(dq_kernel, smem_dq);
  if (e != cudaSuccess) return e;
  e = set_smem(dkdv_kernel, smem_dkdv);
  if (e != cudaSuccess) return e;

  dq_kernel<<<dim3((p.Q + kTcRows - 1) / kTcRows, p.H, B), kTcThreads,
              smem_dq, stream>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  dkdv_kernel<<<dim3((p.K + kTcRows - 1) / kTcRows, p.H, B), kTcThreads,
                smem_dkdv, stream>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess || dbias == nullptr) return e;
  return launch_dbias(p.ds, dbias, B, (size_t)p.H * p.Q * p.K, stream);
}

// The head dim padded to a multiple of 16: one instantiation each.
cudaError_t dispatch_tc(const TcParams& p, int B, float* dbias,
                        cudaStream_t stream) {
  switch ((p.D + 15) / 16) {
    case 1:
      return launch_tc<16>(p, B, dbias, stream);
    case 2:
      return launch_tc<32>(p, B, dbias, stream);
    case 3:
      return launch_tc<48>(p, B, dbias, stream);
    case 4:
      return launch_tc<64>(p, B, dbias, stream);
    case 5:
      return launch_tc<80>(p, B, dbias, stream);
    case 6:
      return launch_tc<96>(p, B, dbias, stream);
    case 7:
      return launch_tc<112>(p, B, dbias, stream);
    case 8:
      return launch_tc<128>(p, B, dbias, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

bool aligned(const void* p, uintptr_t n) {
  return reinterpret_cast<uintptr_t>(p) % n == 0;
}

}  // namespace

// q/dout/dq (B,H,Q,D), k/v/dk/dv (B,H,K,D): contiguous, fp32 (is_bf16=0:
// the scalar kernels) or bf16 (is_bf16=1: the tensor-core kernels). bias (H,Q,K) fp32 or NULL; kmask (B,K) int32 or NULL;
// seed: one int64 in device memory, or NULL for no dropout (then rate is
// ignored); rate in [0, 1). stats (B,H,Q,2) fp32: the forward's row max and
// sum (`t5_attention_fwd.cu` writes them). delta (B,H,Q) fp32 scratch. dbias
// (H,Q,K) fp32 or NULL; with dbias, ds is a (B,H,Q,K) fp32 scratch.
// head_offset: the global index of head 0, the head Philox is keyed on (a
// tensor-parallel rank holds heads head_offset .. head_offset + H - 1);
// q_offset: the global index of query row 0, the query Philox is keyed on
// (a sequence-parallel rank holds rows q_offset .. q_offset + Q - 1; bias
// and dbias hold those rows).
// Returns the first launch's cudaError_t that is not 0.
extern "C" int klab_t5_attention_bwd(
    const void* q, const void* k, const void* v, const void* dout,
    const void* bias, const void* kmask, const void* seed, const void* stats,
    void* delta, void* dq, void* dk, void* dv, void* ds, void* dbias, int B,
    int H, int Q, int K, int D, int is_bf16, int head_offset, int q_offset,
    double rate,
    void* stream) {
  if (B < 1 || H < 1 || Q < 1 || K < 1 || D < 1 || D > 128 || H > 65535 ||
      head_offset < 0 || q_offset < 0 ||
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
                 (uint32_t)(rate * 4294967296.0), (float)(1.0 - rate),
                 head_offset, q_offset};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    using bf16 = __nv_bfloat16;
    const TcParams t{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                     static_cast<const bf16*>(v),
                     static_cast<const bf16*>(dout), p.bias, p.kmask, p.seed,
                     p.stats, p.delta, static_cast<bf16*>(dq),
                     static_cast<bf16*>(dk), static_cast<bf16*>(dv), p.ds, H,
                     Q, K, D, p.threshold, (float)(1.0 / (1.0 - rate)),
                     D % 8 == 0 && aligned(q, 16) && aligned(k, 16) &&
                         aligned(v, 16) && aligned(dout, 16) &&
                         aligned(dq, 16) && aligned(dk, 16) && aligned(dv, 16),
                     K % 2 == 0 && aligned(bias, 8) && aligned(ds, 8),
                     head_offset, q_offset};
    return (int)dispatch_tc(t, B, p.dbias, s);
  }
  return (int)dispatch<float>(p, s);
}
