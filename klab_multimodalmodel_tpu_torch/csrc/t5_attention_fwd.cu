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
// (`philox.cuh`): a pure function of (seed, b, head_offset + h,
// q_offset + q, k), which
// the backward (`t5_attention_bwd.cu`) draws again. With `stats` given, the
// row max and the row sum of exp(logit - max) go out as (B, H, Q, 2) fp32
// for the backward. (A single log-sum-exp would lose a fully masked row:
// -1e9 + log K rounds to -1e9 in fp32, and exp(logit - lse) would give 1,
// not 1/K.)
//
// What bounds it on this card: at the serving shapes (B=8, H=16, D=64,
// L=32 or 96, fp32) one (b, h) moves 4*L*D*4 bytes of q/k/v/o for 4*L*L*D
// FLOP of products: L/4 FLOP per byte, 8 at L=32 and 24 at L=96, either side
// of the fp32 ridge (67 TFLOP/s over 3.35 TB/s = 20). A whole call is 4 or
// 13 MB and 8 or 75 MFLOP, a few microseconds either way: what sets its
// time is how much of the card it fills and how long each thread's chain
// of dependent loads and FMAs is. At the training shapes (B=32,
// L=128..320, bf16) the ratio is L/2 = 64..160 FLOP per byte, under the
// bf16 tensor-core ridge (989 TFLOP/s over 3.35 TB/s = 295): bytes bound
// it, and only tensor cores keep the products off the critical path; with
// dropout the Philox draws are the largest integer work.
//
// Design, fp32 (captioning; TF32 stays off there, so no tensor cores): one
// block of 128 threads per (b, h, 16-query tile), so the text tower (L=32)
// launches 256 blocks and the encoder (L=96) 768 on 132 SMs, seven to an
// SM (31.5 KB of shared memory each), so the encoder runs in one wave. Key
// and value tiles of 32 keys reach shared memory by 16-byte cp.async and
// are read by every query row of the block: the next key tile while this
// one computes, this tile's values under its Q K^T (one value stage).
// Each thread owns two query rows: a 2 x 2 register tile of the logits
// (keys j, j + 16) and a 2 x 4 tile of the output per 64 head-dim columns,
// both fed by float4 shared reads (each word feeds two to four FMAs). The
// 16 lanes that share two rows reduce the row max in four shuffle steps; an
// online softmax (running max, per-lane running sum, expf) over key tiles
// keeps any K within a fixed footprint and never writes the logits out;
// only P crosses shared memory between the two products. The head bias and
// the key addends of a tile come from L2 during the previous tile's P V,
// so no load waits between the two products. Dropout: one
// Philox call per lane and tile gives four keep bits, handed to the lanes
// that hold those keys by shuffles. Each dot product and each output sum
// runs in the order of d and of the keys, as the scalar kernel's did.
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

constexpr unsigned kFull = 0xffffffffu;

// ---------------------------------------------------------------------------
// fp32: register-tiled SIMT (captioning keeps TF32 off)
// ---------------------------------------------------------------------------

constexpr int kF32Rows = 16;  // query rows per block: 8 row pairs
constexpr int kF32Keys = 32;  // keys per K/V tile
constexpr int kF32Threads = 128;

struct F32Args {
  const float *q, *k, *v, *bias;
  const int* kmask;
  const long long* seed;
  float *out, *stats;
  int H, Q, K, D;
  uint32_t threshold;
  float inv_keep;  // 1 / (1 - rate)
  bool vec;        // D % 4 == 0 and 16-byte aligned q, k, v, out
  int head_offset;  // the global index of head 0 (Philox's head)
  int q_offset;     // the global index of query row 0 (Philox's query)
};

// Shared memory: Q and two K tiles (rows of DP + 4 floats), one V tile (rows
// of DP), P: 31.5 KB at DP = 64, so seven blocks fit an SM.
template <int DP>
constexpr size_t fwd_f32_smem() {
  return sizeof(float) * ((size_t)(kF32Rows + 2 * kF32Keys) * (DP + 4) +
                          (size_t)kF32Keys * DP +
                          (size_t)kF32Rows * (kF32Keys + 4));
}

// Thread t owns block rows 2 (t >> 4) and 2 (t >> 4) + 1 in both products:
// keys j and j + 16 of each tile in S (j = t & 15), float4 column chunks
// j + 16 c in O. The 16 lanes of a half-warp share the two rows, so the
// row max is a 4-step shuffle and the running max and sum never leave the
// registers; only P crosses shared memory, between the two products.
template <int DP>
__global__ void __launch_bounds__(kF32Threads)
    t5_attention_fwd_f32_kernel(F32Args a) {
  constexpr int LD = DP + 4;         // 16-byte rows, odd in 16-byte units
  constexpr int LP = kF32Keys + 4;
  constexpr int NC = (DP / 4 + 15) / 16;  // column chunks per thread
  extern __shared__ __align__(16) float smem_f[];
  float* q_s = smem_f;                   // [16][LD]
  float* k_s = q_s + kF32Rows * LD;      // [2][32][LD]
  float* v_s = k_s + 2 * kF32Keys * LD;  // [32][DP]: rows read whole
  float* p_s = v_s + kF32Keys * DP;      // [16][LP]

  const int q0 = blockIdx.x * kF32Rows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int j = tid & 15;
  const int row0 = 2 * (tid >> 4);  // this thread's rows: row0, row0 + 1
  const size_t bh = (size_t)b * a.H + h;
  const float* kg = a.k + bh * a.K * a.D;
  const float* vg = a.v + bh * a.K * a.D;
  const bool dropout = a.seed != nullptr;
  const uint2 pkey = klab::seed_key(a.seed);

  klab::load_rows<float, DP>(q_s, LD, a.q + bh * a.Q * a.D, q0, kF32Rows,
                             a.Q, a.D, a.vec, tid, kF32Threads);
  klab::load_rows<float, DP>(k_s, LD, kg, 0, kF32Keys, a.K, a.D, a.vec, tid,
                             kF32Threads);
  klab::load_rows<float, DP>(v_s, DP, vg, 0, kF32Keys, a.K, a.D, a.vec, tid,
                             kF32Threads);
  klab::cp_async_commit();

  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};  // this lane's part of the row sums
  float4 o[2][NC];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int c = 0; c < NC; ++c) o[r][c] = make_float4(0.f, 0.f, 0.f, 0.f);

  // The addends of this thread's four logits for the tile at k0: the head
  // bias, then the key's (0, -1e9 masked, -inf past K). They come from L2,
  // so each tile's are loaded during the previous tile's P V.
  float bs[2][2], add[2];
  const auto load_addends = [&](int k0) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int key = k0 + j + 16 * c;
      add[c] = klab::key_addend(a.kmask, b, key, a.K);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int qi = q0 + row0 + r;
        bs[r][c] = (a.bias != nullptr && qi < a.Q && key < a.K)
                       ? __ldg(a.bias + ((size_t)h * a.Q + qi) * a.K + key)
                       : 0.f;
      }
    }
  };
  load_addends(0);

  const int nk = (a.K + kF32Keys - 1) / kF32Keys;
  for (int t = 0; t < nk; ++t) {
    const int st = t & 1;
    const int k0 = t * kF32Keys;
    klab::cp_async_wait<0>();
    __syncthreads();  // K tile t has landed; tile t - 1's V and P are used up
    if (t > 0) {  // V tile t, under this tile's Q K^T (tile 0 came with Q)
      klab::load_rows<float, DP>(v_s, DP, vg, k0, kF32Keys, a.K, a.D, a.vec,
                                 tid, kF32Threads);
      klab::cp_async_commit();
    }
    if (t + 1 < nk) {  // the next K tile into the other stage
      klab::load_rows<float, DP>(k_s + (st ^ 1) * kF32Keys * LD, LD, kg,
                                 k0 + kF32Keys, kF32Keys, a.K, a.D, a.vec, tid,
                                 kF32Threads);
      klab::cp_async_commit();
    }
    const float* kt = k_s + st * kF32Keys * LD;

    // S = Q K^T, each dot product summed in the order of d.
    float s[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
    for (int d = 0; d < DP; d += 4) {
      const float4 qa = *reinterpret_cast<const float4*>(q_s + row0 * LD + d);
      const float4 qb =
          *reinterpret_cast<const float4*>(q_s + (row0 + 1) * LD + d);
      const float4 ka = *reinterpret_cast<const float4*>(kt + j * LD + d);
      const float4 kb =
          *reinterpret_cast<const float4*>(kt + (j + 16) * LD + d);
      s[0][0] = klab::fma4(qa, ka, s[0][0]);
      s[0][1] = klab::fma4(qa, kb, s[0][1]);
      s[1][0] = klab::fma4(qb, ka, s[1][0]);
      s[1][1] = klab::fma4(qb, kb, s[1][1]);
    }

    // Online softmax: the normalizer sums the probabilities before dropout.
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        s[r][c] = (s[r][c] + bs[r][c]) + add[c];
        mx = fmaxf(mx, s[r][c]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
      // Key k0 < K is in the tile, so the new max is finite; corr is 0 on
      // the first tile.
      const float m_new = fmaxf(m[r], mx);
      corr[r] = expf(m[r] - m_new);
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < 2; ++c) s[r][c] = expf(s[r][c] - m_new);
      l[r] = l[r] * corr[r] + (s[r][0] + s[r][1]);
    }
    if (t + 1 < nk) load_addends(k0 + kF32Keys);
    if (dropout) {
      // Lane j of each half-warp draws the keep bits of keys
      // k0 + 4 (j & 7) .. + 3 of row row0 + (j >> 3); key k0 + j + 16 c of
      // row row0 + r is bit j & 3 of lane 8 r + 4 c + (j >> 2)'s draw.
      const uint32_t mine = klab::keep_nibble(
          pkey, (uint32_t)(k0 >> 2) + (j & 7),
          a.q_offset + q0 + row0 + (j >> 3),
          h + a.head_offset, b, a.threshold);
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const uint32_t bits = __shfl_sync(
              kFull, mine, (lane & 16) + 8 * r + 4 * c + (j >> 2));
          if (!((bits >> (j & 3)) & 1u)) s[r][c] = 0.f;
        }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int c = 0; c < 2; ++c) p_s[(row0 + r) * LP + j + 16 * c] = s[r][c];
    if (t > 0) {  // V tile t has landed (the next K tile may still be coming)
      if (t + 1 < nk)
        klab::cp_async_wait<1>();
      else
        klab::cp_async_wait<0>();
    }
    __syncthreads();

    // O = O * corr + Pd V, each sum in the order of the keys.
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        o[r][c].x *= corr[r];
        o[r][c].y *= corr[r];
        o[r][c].z *= corr[r];
        o[r][c].w *= corr[r];
      }
#pragma unroll
    for (int kk = 0; kk < kF32Keys; kk += 4) {
      const float4 pa = *reinterpret_cast<const float4*>(p_s + row0 * LP + kk);
      const float4 pb =
          *reinterpret_cast<const float4*>(p_s + (row0 + 1) * LP + kk);
      const float pr[2][4] = {{pa.x, pa.y, pa.z, pa.w},
                              {pb.x, pb.y, pb.z, pb.w}};
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const int col = 4 * (j + 16 * c);
          if (col < DP) {
            const float4 vv =
                *reinterpret_cast<const float4*>(v_s + (kk + u) * DP + col);
            o[0][c] = klab::fma4s(pr[0][u], vv, o[0][c]);
            o[1][c] = klab::fma4s(pr[1][u], vv, o[1][c]);
          }
        }
    }
  }

  // O / (sum * (1 - rate)); the row stats for the backward.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      l[r] += __shfl_xor_sync(kFull, l[r], off);
    const int qi = q0 + row0 + r;
    if (qi >= a.Q) continue;
    const float inv = a.inv_keep / l[r];
    float* orow = a.out + (bh * a.Q + qi) * a.D;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = 4 * (j + 16 * c);
      if (col >= a.D) continue;
      const float4 y = make_float4(o[r][c].x * inv, o[r][c].y * inv,
                                   o[r][c].z * inv, o[r][c].w * inv);
      if (a.vec) {
        *reinterpret_cast<float4*>(orow + col) = y;
      } else {
        const float ys[4] = {y.x, y.y, y.z, y.w};
        for (int e = 0; e < 4 && col + e < a.D; ++e) orow[col + e] = ys[e];
      }
    }
    if (a.stats != nullptr && j == 0)
      *reinterpret_cast<float2*>(a.stats + (bh * a.Q + qi) * 2) =
          make_float2(m[r], l[r]);
  }
}

template <int DP>
cudaError_t launch_f32(const F32Args& a, int B, cudaStream_t stream) {
  const size_t smem = fwd_f32_smem<DP>();
  auto kernel = t5_attention_fwd_f32_kernel<DP>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((a.Q + kF32Rows - 1) / kF32Rows, a.H, B);
  kernel<<<grid, kF32Threads, smem, stream>>>(a);
  return cudaGetLastError();
}

// The head dim padded to a multiple of 32: one instantiation each.
cudaError_t dispatch_f32(const F32Args& a, int B, cudaStream_t stream) {
  switch ((a.D + 31) / 32) {
    case 1:
      return launch_f32<32>(a, B, stream);
    case 2:
      return launch_f32<64>(a, B, stream);
    case 3:
      return launch_f32<96>(a, B, stream);
    case 4:
      return launch_f32<128>(a, B, stream);
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
  int head_offset;  // the global index of head 0 (Philox's head)
  int q_offset;     // the global index of query row 0 (Philox's query)
};

// Shared memory: Q (then O), two K and two V tiles, two key-addend rows.
template <int DP>
constexpr size_t fwd_tc_smem() {
  return sizeof(__nv_bfloat16) * (size_t)(kTcRows + 4 * kTcKeys) * (DP + 8) +
         sizeof(float) * 2 * kTcKeys;
}

// Four blocks an SM at DP <= 64 (128 registers a thread): without the bound
// ptxas gives DP = 64 130 registers once q_offset joins the keep bits, so
// three blocks fit an SM and the forward slows (PERF.md, the kernel table;
// tools/t5_fwd_ab.py holds two builds of this source against each other).
template <int DP>
__global__ void __launch_bounds__(kTcThreads, DP <= 64 ? 4 : 1)
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
                                  a.q_offset + qrow, h + a.head_offset, b,
                                  a.threshold)
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
// the register-tiled SIMT kernel) or bf16 (is_bf16=1: the tensor-core
// kernel). bias (H,Q,K) fp32 or NULL; kmask (B,K) int32 or NULL.
// seed: one int64 in device memory, or NULL for no dropout; rate in [0, 1)
// is the dropout rate (ignored without a seed). stats (B,H,Q,2) fp32 or
// NULL. head_offset: the global index of head 0, the head Philox is keyed
// on (a tensor-parallel rank holds heads head_offset .. head_offset + H - 1);
// q_offset: the global index of query row 0, the query Philox is keyed on (a
// sequence-parallel rank holds rows q_offset .. q_offset + Q - 1; bias holds
// those rows).
// Returns the cudaError_t of the launch (0 = success).
extern "C" int klab_t5_attention_fwd(const void* q, const void* k,
                                     const void* v, const void* bias,
                                     const void* kmask, const void* seed,
                                     void* out, void* stats, int B, int H,
                                     int Q, int K, int D, int is_bf16,
                                     int head_offset, int q_offset,
                                     double rate,
                                     void* stream) {
  if (B < 1 || H < 1 || Q < 1 || K < 1 || D < 1 || D > 128 || H > 65535 ||
      head_offset < 0 || q_offset < 0 ||
      B > 65535 || !(rate >= 0.0 && rate < 1.0))
    return (int)cudaErrorInvalidValue;
  // floor(rate * 2^32), as the TPU kernel forms it.
  const uint32_t threshold = (uint32_t)(rate * 4294967296.0);
  const float inv_keep = (float)(1.0 / (1.0 - rate));
  const bool vec = aligned(q, 16) && aligned(k, 16) && aligned(v, 16) &&
                   aligned(out, 16);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    using bf16 = __nv_bfloat16;
    const TcArgs t{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                   static_cast<const bf16*>(v), static_cast<const float*>(bias),
                   static_cast<const int*>(kmask),
                   static_cast<const long long*>(seed), static_cast<bf16*>(out),
                   static_cast<float*>(stats), H, Q, K, D, threshold, inv_keep,
                   D % 8 == 0 && vec, K % 2 == 0 && aligned(bias, 8),
                   head_offset, q_offset};
    return (int)dispatch_tc(t, B, s);
  }
  const F32Args f{static_cast<const float*>(q), static_cast<const float*>(k),
                  static_cast<const float*>(v), static_cast<const float*>(bias),
                  static_cast<const int*>(kmask),
                  static_cast<const long long*>(seed), static_cast<float*>(out),
                  static_cast<float*>(stats), H, Q, K, D, threshold, inv_keep,
                  D % 4 == 0 && vec, head_offset, q_offset};
  return (int)dispatch_f32(f, B, s);
}
