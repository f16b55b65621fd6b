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
// it, and only tensor cores keep the products off the critical path; with
// dropout the Philox draws are the largest integer work.
//
// Design, fp32 (captioning; TF32 stays off there, so no tensor cores): one
// block per (b, h, 32-query tile); key/value tiles of 32 rows are staged
// once in shared memory (fp32) and read by every query row of the block, so
// Q/K/V leave device memory once; an online (running max / sum) softmax over
// key tiles keeps any K within a fixed shared-memory footprint and never
// writes the logits out. Each lane owns one key of the tile for the logits
// and D/32 output columns for P V, as plain fp32 FMAs.
//
// Design, bf16 (training), FlashAttention-2's structure: one block per
// (b, h, 64-query tile), four warps of 16 query rows, each warp's Q
// fragments in registers for the whole key loop. K/V tiles of 64 keys, bf16
// in shared memory with the head dim zero-padded to DP (a multiple of 16),
// double-buffered with 16-byte cp.async so the next tile lands while this
// one is used, read by ldmatrix (.trans for V). S = Q K^T and O += Pd V run
// on mma.sync m16n8k16 (bf16 in, fp32 accumulators); the accumulators of S
// become the A operand of Pd V in registers, rounded to bf16 as the TPU
// kernel rounds P before its product. The online softmax runs in fp32 on the
// fragments. The head bias (fp32, (H, Q, K), found in L2 by the batch's
// blocks) is the largest input read per logit: it is loaded straight into
// the S accumulators as the C operand of Q K^T, issued as soon as the
// previous tile's P has gone into P V, so the load overlaps those products
// and costs no registers; the key addends of the next tile likewise reach
// shared memory through a register after this tile's work. The normalizer
// sums the probabilities before dropout; 1 / (1 - rate) and 1 / sum scale O
// once at the end. Dropout: one Philox call gives the keep bits of four keys
// of one row; lanes 4r and 4r+1 hold those four keys in rows g and g+8, so
// one draws row g, the other row g+8, and one shuffle swaps the halves each
// lacks (the same for lanes 4r+2, 4r+3).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma.cuh"
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

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

constexpr int kTcRows = 64;      // query rows per block: 4 warps x 16
constexpr int kTcKeys = 64;      // keys per K/V tile
constexpr int kTcThreads = 128;
constexpr float kLog2e = 1.4426950408889634f;

struct TcArgs {
  const __nv_bfloat16 *q, *k, *v;
  const float* bias;
  const int* kmask;
  const long long* seed;
  __nv_bfloat16* out;
  float* stats;
  int H, Q, K, D;
  uint32_t threshold;
  float inv_keep;  // 1 / (1 - rate)
  bool vec;        // D % 8 == 0 and 16-byte aligned q, k, v, out
  bool bias_vec;   // K even and an 8-byte aligned bias: float2 loads
};

// Shared memory: Q (then O), two K and two V tiles, two key-addend rows.
template <int DP>
constexpr size_t fwd_tc_smem() {
  return sizeof(__nv_bfloat16) * (size_t)(kTcRows + 4 * kTcKeys) * (DP + 8) +
         sizeof(float) * 2 * kTcKeys;
}

template <int DP>
__global__ void __launch_bounds__(kTcThreads)
    t5_attention_fwd_tc_kernel(TcArgs a) {
  using bf16 = __nv_bfloat16;
  constexpr int LD = DP + 8;  // padded shared row (see mma.cuh)
  constexpr int KS = DP / 16;  // 16-wide steps over the head dim
  constexpr int NT = DP / 8;   // 8-wide n-tiles of the output
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);  // [64][LD], then O
  bf16* k_s = q_s + kTcRows * LD;                 // [2][64][LD]
  bf16* v_s = k_s + 2 * kTcKeys * LD;             // [2][64][LD]
  float* add_s = reinterpret_cast<float*>(v_s + 2 * kTcKeys * LD);  // [2][64]

  const int q0 = blockIdx.x * kTcRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int row0 = q0 + warp * 16 + g;  // this lane's rows: row0, row0 + 8
  const size_t bh = (size_t)b * a.H + h;
  const bf16* kp = a.k + bh * a.K * a.D;
  const bf16* vp = a.v + bh * a.K * a.D;
  const bool dropout = a.seed != nullptr;
  const uint2 pkey = klab::seed_key(a.seed);

  // No load waits inside a tile's work: Q, K and V come by cp.async one
  // tile ahead; the key addends of the next tile go through a register and
  // reach shared memory after this tile's work; the head bias of the next
  // tile is loaded into the S accumulators (the C operand of Q K^T) as soon
  // as this tile's P has gone into P V.
  klab::load_tile<kTcRows, DP, kTcThreads>(q_s, a.q + bh * a.Q * a.D, q0,
                                           a.Q, a.D, a.vec);
  klab::load_tile<kTcKeys, DP, kTcThreads>(k_s, kp, 0, a.K, a.D, a.vec);
  klab::load_tile<kTcKeys, DP, kTcThreads>(v_s, vp, 0, a.K, a.D, a.vec);
  klab::cp_async_commit();
  const int ti = threadIdx.x;  // the key of a tile whose addend it stages
  if (ti < kTcKeys) add_s[ti] = klab::key_addend(a.kmask, b, ti, a.K);

  uint32_t qf[KS][4];
  float o[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};  // this lane's part of the row sums
  // S of the coming tile, 16 rows x 64 keys (n-tile n: keys k0 + 8n .. +7),
  // starting as its head bias (0 without one).
  float s[8][4];
  const auto load_bias = [&](int k0) {
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float2 bv = klab::bias_pair(a.bias, h, a.Q, a.K, row0 + 8 * r,
                                          k0 + 8 * n + 2 * t, a.bias_vec);
        s[n][2 * r] = bv.x;
        s[n][2 * r + 1] = bv.y;
      }
  };
  load_bias(0);

  const int nk = (a.K + kTcKeys - 1) / kTcKeys;
  for (int j = 0; j < nk; ++j) {
    const int st = j & 1;
    float add_next = 0.f;
    if (j + 1 < nk) {  // the next tile into the other stage
      const int k1 = (j + 1) * kTcKeys;
      klab::load_tile<kTcKeys, DP, kTcThreads>(k_s + (st ^ 1) * kTcKeys * LD,
                                               kp, k1, a.K, a.D, a.vec);
      klab::load_tile<kTcKeys, DP, kTcThreads>(v_s + (st ^ 1) * kTcKeys * LD,
                                               vp, k1, a.K, a.D, a.vec);
      if (ti < kTcKeys) add_next = klab::key_addend(a.kmask, b, k1 + ti, a.K);
    }
    klab::cp_async_commit();
    klab::cp_async_wait<1>();  // Q and this tile have landed
    __syncthreads();
    if (j == 0) {
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
        klab::ldmatrix_x4(qf[ks], q_s + (warp * 16 + (lane & 15)) * LD +
                                      ks * 16 + (lane >> 4) * 8);
    }
    const bf16* kt = k_s + st * kTcKeys * LD;
    const bf16* vt = v_s + st * kTcKeys * LD;
    const float* add = add_s + st * kTcKeys;
    const int k0 = j * kTcKeys;

    // S = bias + Q K^T.
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t kb[4];
        klab::ldmatrix_x4(kb, kt + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) *
                                       LD +
                                   ks * 16 + (((lane >> 3) & 1) << 3));
        klab::mma_bf16(s[2 * np], qf[ks], kb[0], kb[1]);
        klab::mma_bf16(s[2 * np + 1], qf[ks], kb[2], kb[3]);
      }
    }

    // + key addend; row maxima.
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int c = 8 * n + 2 * t;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        s[n][2 * r] += add[c];
        s[n][2 * r + 1] += add[c + 1];
        mx[r] = fmaxf(mx[r], fmaxf(s[n][2 * r], s[n][2 * r + 1]));
      }
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 2));
      // Key k0 < K is in the tile, so the new max is finite; corr is 0 on
      // the first tile.
      const float m_new = fmaxf(m[r], mx[r]);
      corr[r] = klab::exp2_approx((m[r] - m_new) * kLog2e);
      m[r] = m_new;
      l[r] *= corr[r];
    }
    // P = exp(S - m); the normalizer sums it before dropout.
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = klab::exp2_approx((s[n][e] - m[e >> 1]) * kLog2e);
        l[e >> 1] += s[n][e];
      }
    if (dropout) {
      // Keys k0 + 8n + 4u .. + 3 (u = t >> 1) share a counter: this lane
      // draws it for row0 (t even) or row0 + 8 (t odd) and swaps nibbles
      // with lane ^ 1, which holds the same keys' other halves.
      uint32_t mine = 0;
      const int qrow = row0 + 8 * (t & 1);
#pragma unroll
      for (int n = 0; n < 8; ++n)
        mine |= klab::keep_nibble(pkey, (uint32_t)((k0 + 8 * n) >> 2) + (t >> 1),
                                  qrow, h, b, a.threshold)
                << (4 * n);
      const uint32_t theirs = __shfl_xor_sync(kFull, mine, 1);
      const uint32_t bits[2] = {(t & 1) ? theirs : mine,
                                (t & 1) ? mine : theirs};
      const int sel = 2 * (t & 1);  // keys 2t, 2t + 1 within the nibble
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (!((bits[e >> 1] >> (4 * n + sel + (e & 1))) & 1u)) s[n][e] = 0.f;
    }

    // O = O * corr + Pd V, Pd in bf16 straight from the S accumulators.
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      o[n][0] *= corr[0];
      o[n][1] *= corr[0];
      o[n][2] *= corr[1];
      o[n][3] *= corr[1];
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t pa[4];
      klab::acc_to_a(pa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t vb[4];
        klab::ldmatrix_x4_trans(
            vb, vt + (kk * 16 + (lane & 7) + (((lane >> 3) & 1) << 3)) * LD +
                    np * 16 + ((lane >> 4) << 3));
        klab::mma_bf16(o[2 * np], pa, vb[0], vb[1]);
        klab::mma_bf16(o[2 * np + 1], pa, vb[2], vb[3]);
      }
    }
    if (j + 1 < nk) {
      load_bias(k0 + kTcKeys);
      if (ti < kTcKeys) add_s[(st ^ 1) * kTcKeys + ti] = add_next;
    }
    __syncthreads();  // the next iteration's copies refill this stage
  }

  // O / (sum * (1 - rate)) to bf16, through this warp's 16 rows of q_s (it
  // read no other rows), then out in 16-byte stores.
  bf16* os = q_s + warp * 16 * LD;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(kFull, l[r], 1);
    l[r] += __shfl_xor_sync(kFull, l[r], 2);
    const float inv = a.inv_keep / l[r];
#pragma unroll
    for (int n = 0; n < NT; ++n)
      *reinterpret_cast<uint32_t*>(os + (g + 8 * r) * LD + 8 * n + 2 * t) =
          klab::pack_bf16(o[n][2 * r] * inv, o[n][2 * r + 1] * inv);
  }
  __syncwarp();
  klab::store_tile_warp<16, DP>(a.out + bh * a.Q * a.D, os, q0 + warp * 16,
                                a.Q, a.D, a.vec, lane);
  if (a.stats != nullptr && t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row < a.Q)
        *reinterpret_cast<float2*>(a.stats + (bh * a.Q + row) * 2) =
            make_float2(m[r], l[r]);
    }
  }
}

template <int DP>
cudaError_t launch_tc(const TcArgs& a, int B, cudaStream_t stream) {
  const size_t smem = fwd_tc_smem<DP>();
  auto kernel = t5_attention_fwd_tc_kernel<DP>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((a.Q + kTcRows - 1) / kTcRows, a.H, B);
  kernel<<<grid, kTcThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// The head dim padded to a multiple of 16: one instantiation each.
cudaError_t dispatch_tc(const TcArgs& a, int B, cudaStream_t stream) {
  switch ((a.D + 15) / 16) {
    case 1:
      return launch_tc<16>(a, B, stream);
    case 2:
      return launch_tc<32>(a, B, stream);
    case 3:
      return launch_tc<48>(a, B, stream);
    case 4:
      return launch_tc<64>(a, B, stream);
    case 5:
      return launch_tc<80>(a, B, stream);
    case 6:
      return launch_tc<96>(a, B, stream);
    case 7:
      return launch_tc<112>(a, B, stream);
    case 8:
      return launch_tc<128>(a, B, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

bool aligned(const void* p, uintptr_t n) {
  return reinterpret_cast<uintptr_t>(p) % n == 0;
}

}  // namespace

// q (B,H,Q,D), k/v (B,H,K,D), out (B,H,Q,D): contiguous, fp32 (is_bf16=0:
// the scalar kernel) or bf16 (is_bf16=1: the tensor-core kernel). bias (H,Q,K) fp32 or NULL; kmask (B,K) int32 or NULL.
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
  if (is_bf16) {
    using bf16 = __nv_bfloat16;
    const TcArgs t{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                   static_cast<const bf16*>(v), static_cast<const float*>(bias),
                   static_cast<const int*>(kmask),
                   static_cast<const long long*>(seed), static_cast<bf16*>(out),
                   static_cast<float*>(stats), H, Q, K, D, a.threshold,
                   (float)(1.0 / (1.0 - rate)),
                   D % 8 == 0 && aligned(q, 16) && aligned(k, 16) &&
                       aligned(v, 16) && aligned(out, 16),
                   K % 2 == 0 && aligned(bias, 8)};
    return (int)dispatch_tc(t, B, s);
  }
  return (int)dispatch<float>(a, s);
}
