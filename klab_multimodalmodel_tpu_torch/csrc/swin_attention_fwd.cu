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
// The chain from the logits to P runs in fp32, or in bf16 (`SM_BF16`, the
// reference's `swin_softmax_dtype='bfloat16'`): then every step rounds to
// bf16 as the TPU kernel's does in `sm_dtype` -- the logits, the scale, the
// product, each added table, the max-subtracted logits, their exp, the row
// sum and the quotient -- while sums and products are formed in fp32. In
// both chains the logit is ((dot * scale) + bias) + mask, each step rounded
// on its own (no contraction into an FMA), as the plain version forms it.
// A probability whose exp is subnormal (a logit over 87 below its row's
// max) is 0 here, where the plain version's is under 2^-126.
//
// What bounds it on this card: per (window, head) at N = 64, D = 32 the
// function moves 16 KB of bf16 q, k, v and o (32 KB in fp32) for 0.5 MFLOP
// of products: 32 FLOP per byte in bf16, far under the tensor cores' ridge
// (295), so the bytes bound a training step (0.31 ms over 1 GB); in fp32,
// 16 FLOP per byte sits near the SIMT ridge (20), so bytes and fp32 FMAs
// bound captioning about equally. The head bias and the window mask (16 KB
// each in fp32 at N = 64) are the same for every window that shares a head
// and a window position: read once per window, they would cost as much
// traffic as q, k, v and o together.
// Design: one block of four warps per (head h, window position w, group of
// G images), over windows b = g nW + w (nW = 1 without a mask); G grows
// with the launch (`group_size`) as long as the grid keeps about
// KLAB_SWIN_TARGET_BLOCKS blocks. The bias slice of head h and the mask of
// position w are staged in shared memory once per block where G > 1 (read
// from L2 where a block takes one window); each window's q,
// k, v arrive by 16-byte cp.async, the next window's while this one
// computes (two stages). The copies land, q and k rows are normalized in
// place, then each warp takes 16 query rows at a time (N padded to a
// multiple of 16; padded keys get -inf, padded rows are not stored), holds
// the whole row of logits in registers and runs the exact softmax there.
// bf16 inputs: S and O on mma.sync m16n8k16 (bf16 in, fp32 accumulators),
// P rounded to bf16 from the accumulators as the A operand of P V, V by
// ldmatrix.trans, O out through shared memory in 16-byte stores. fp32
// inputs: register-tiled fp32 FMAs (4 rows x N/8 keys of S and 4 rows x 4
// columns of O per lane, float4 shared reads), P through a per-warp shared
// row block; no TF32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

#include "mma.cuh"

// The grid a launch aims at when it groups windows into blocks (see
// `group_size`); a build may set it (the host-emulation test sets it small
// so that tiny launches group windows too).
#ifndef KLAB_SWIN_TARGET_BLOCKS
#define KLAB_SWIN_TARGET_BLOCKS 1024
#endif

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;  // four warps
constexpr int kMaxN = 144;     // window tokens: 12 x 12
constexpr int kMaxGroup = 8;   // windows per block
constexpr size_t kMaxSmem = 227 * 1024;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kLogMaxScale = 4.605170185988091f;  // ln(100)
constexpr float kMinNormal = 1.17549435e-38f;       // 2^-126

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(bf16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ bf16 from_float<bf16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// One step of the softmax chain: rounds to bf16 when the chain runs in bf16.
template <bool SM_BF16>
__device__ __forceinline__ float chain(float x) {
  return SM_BF16 ? bf16_round(x) : x;
}

// ((dot * scale) + bias) + mask in the chain's dtype, each step rounded.
template <bool SM_BF16>
__device__ __forceinline__ float logit(float dot, float scale, float bias,
                                       bool masked, float mask) {
  float x = chain<SM_BF16>(__fmul_rn(chain<SM_BF16>(dot), scale));
  x = chain<SM_BF16>(__fadd_rn(x, chain<SM_BF16>(bias)));
  if (masked) x = chain<SM_BF16>(__fadd_rn(x, chain<SM_BF16>(mask)));
  return x;
}

// P = e / sum in the chain's dtype, but 0 where e is subnormal: such an e
// comes from a logit over 87 below its row's max (a masked key), its exact
// quotient is under 2^-126 and moves no output, and a subnormal dividend
// would send the IEEE division down its slow path.
template <bool SM_BF16>
__device__ __forceinline__ float quotient(float e, float sum) {
  return e >= kMinNormal ? chain<SM_BF16>(e / sum) : 0.f;
}

struct Args {
  const void *q, *k, *v;
  const float *scale, *bias, *wmask;
  void* out;
  int H, N, D;
  int nw;      // window positions: the mask's nW, 1 without a mask
  int images;  // windows per position: Bn / nw
  int group;   // G: windows per block
  int lb;      // row stride of the staged tables (floats)
  bool vec;    // D a multiple of a 16-byte chunk, 16-byte aligned q, k, v, out
  bool tvec;   // N % 4 == 0 and 16-byte aligned tables: 16-byte copies
  bool staged;     // bias and mask in shared memory (else read from L2)
  bool two_stage;  // the next window's q, k, v land while this one computes
  size_t tables_bytes, stage_bytes;
};

// The row stride of a staged N x N table: the least odd multiple of 8
// floats >= N, so that the rows a warp reads together fall on distinct
// banks.
int table_ld(int N) {
  const int m = (N + 7) / 8;
  return 8 * (m | 1);
}

// Normalizes rows [0, n) of q and of k in place: x * rsqrt(sum x^2 + 1e-24)
// in fp32, rounded back to T; one thread per row, 16-byte shared accesses.
template <typename T, int DP, int LD>
__device__ __forceinline__ void normalize_rows(T* q_s, T* k_s, int n) {
  constexpr int kE = 16 / sizeof(T);
  for (int r = threadIdx.x; r < 2 * n; r += kThreads) {
    T* row = r < n ? q_s + r * LD : k_s + (r - n) * LD;
    float ss = 0.f;
#pragma unroll
    for (int c = 0; c < DP; c += kE) {
      uint4 u = *reinterpret_cast<const uint4*>(row + c);
      const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
      for (int i = 0; i < kE; ++i) ss = fmaf(to_float(e[i]), to_float(e[i]), ss);
    }
    const float inv = 1.f / sqrtf(ss + 1e-24f);
#pragma unroll
    for (int c = 0; c < DP; c += kE) {
      uint4 u = *reinterpret_cast<const uint4*>(row + c);
      T* e = reinterpret_cast<T*>(&u);
#pragma unroll
      for (int i = 0; i < kE; ++i) e[i] = from_float<T>(to_float(e[i]) * inv);
      *reinterpret_cast<uint4*>(row + c) = u;
    }
  }
}

// The tables one block reads, in the chain's order of additions.
struct Tables {
  const float* bias;  // row r of the (N, N) head-bias slice at bias + r*ld
  const float* mask;  // the same for the window mask, or nullptr
  int ld;
  bool pairs;  // N and ld even, 8-byte aligned tables: float2 reads
};

// Entries (row, col) and (row, col + 1) of a table, 0 past N.
__device__ __forceinline__ float2 table_pair(const float* t, int ld, int row,
                                             int col, int N, bool pairs) {
  const float* p = t + row * ld + col;
  if (pairs) return *reinterpret_cast<const float2*>(p);
  return make_float2(p[0], col + 1 < N ? p[1] : 0.f);
}

// One window, bf16 inputs: each warp takes row tiles of 16 query rows; S of
// the whole row stays in its accumulators (n-tile n: keys 8n .. 8n + 7).
template <int DP, int NPMAX, bool SM_BF16>
__device__ __forceinline__ void window_mma(const Args& a, bf16* q_s,
                                           const bf16* k_s, const bf16* v_s,
                                           const Tables& tb, float sc,
                                           bf16* out, int np) {
  constexpr int LD = DP + 8;  // padded shared row (see mma.cuh)
  constexpr int KS = DP / 16;
  constexpr int NT = DP / 8;
  constexpr int NN = NPMAX / 8;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int nn = np / 8;
  for (int rt = warp; rt < np / 16; rt += kThreads / 32) {
    uint32_t qf[KS][4];
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
      klab::ldmatrix_x4(qf[ks], q_s + (16 * rt + (lane & 15)) * LD + ks * 16 +
                                    (lane >> 4) * 8);
    float s[NN][4];
#pragma unroll
    for (int n = 0; n < NN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int n2 = 0; n2 < NN / 2; ++n2) {
      if (2 * n2 >= nn) break;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t kb[4];
        klab::ldmatrix_x4(
            kb, k_s + (n2 * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD +
                    ks * 16 + (((lane >> 3) & 1) << 3));
        klab::mma_bf16(s[2 * n2], qf[ks], kb[0], kb[1]);
        klab::mma_bf16(s[2 * n2 + 1], qf[ks], kb[2], kb[3]);
      }
    }

    // Logits, exact row softmax; rows g and g + 8 of the tile, four lanes
    // (t) to a row.
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < NN; ++n) {
      if (n >= nn) break;
      const int col = 8 * n + 2 * t;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = 16 * rt + g + 8 * r;
        float2 bv = make_float2(0.f, 0.f), mv = bv;  // padded rows: none
        if (row < a.N && col < a.N) {
          bv = table_pair(tb.bias, tb.ld, row, col, a.N, tb.pairs);
          if (tb.mask) mv = table_pair(tb.mask, tb.ld, row, col, a.N, tb.pairs);
        }
        const float b2[2] = {bv.x, bv.y}, m2[2] = {mv.x, mv.y};
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float& x = s[n][2 * r + c];
          x = col + c < a.N ? logit<SM_BF16>(x, sc, b2[c], tb.mask != nullptr,
                                             m2[c])
                            : -INFINITY;  // padded keys
          mx[r] = fmaxf(mx[r], x);
        }
      }
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 2));
    }
#pragma unroll
    for (int n = 0; n < NN; ++n) {
      if (n >= nn) break;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = chain<SM_BF16>(expf(chain<SM_BF16>(s[n][e] - mx[e >> 1])));
        sum[e >> 1] += s[n][e];
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(kFull, sum[r], 1);
      sum[r] += __shfl_xor_sync(kFull, sum[r], 2);
      sum[r] = chain<SM_BF16>(sum[r]);
    }
    // P in the chain's dtype; acc_to_a rounds it to bf16 for P V.
#pragma unroll
    for (int n = 0; n < NN; ++n) {
      if (n >= nn) break;
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = quotient<SM_BF16>(s[n][e], sum[e >> 1]);
    }

    float o[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NN / 2; ++kk) {
      if (2 * kk >= nn) break;
      uint32_t pa[4];
      klab::acc_to_a(pa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int n2 = 0; n2 < NT / 2; ++n2) {
        uint32_t vb[4];
        klab::ldmatrix_x4_trans(
            vb, v_s + (kk * 16 + (lane & 7) + (((lane >> 3) & 1) << 3)) * LD +
                    n2 * 16 + ((lane >> 4) << 3));
        klab::mma_bf16(o[2 * n2], pa, vb[0], vb[1]);
        klab::mma_bf16(o[2 * n2 + 1], pa, vb[2], vb[3]);
      }
    }

    // O to bf16 through this warp's 16 rows of q_s (it read no other
    // rows), then out in 16-byte stores.
    bf16* os = q_s + 16 * rt * LD;
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int n = 0; n < NT; ++n)
        *reinterpret_cast<uint32_t*>(os + (g + 8 * r) * LD + 8 * n + 2 * t) =
            klab::pack_bf16(o[n][2 * r], o[n][2 * r + 1]);
    __syncwarp();
    klab::store_tile_warp<16, DP>(out, os, 16 * rt, a.N, a.D, a.vec, lane);
  }
}

// One window, fp32 inputs: each warp takes row tiles of 16 query rows; lane
// (rg, kg) = (lane >> 3, lane & 7) holds rows 4 rg .. 4 rg + 3 of the tile
// against keys kg + 8 j in S, and the same rows against columns
// 4 kg + 32 c in O. P crosses this warp's block of shared rows (row i of
// group rg at 4 i + rg, so the four groups read distinct banks).
template <int DP, int NPMAX, bool SM_BF16>
__device__ __forceinline__ void window_simt(const Args& a, const float* q_s,
                                            const float* k_s,
                                            const float* v_s,
                                            const Tables& tb, float sc,
                                            float* p_s, float* out, int np) {
  constexpr int LD = DP + 4;
  constexpr int NJ = NPMAX / 8;
  constexpr int NC = DP / 32;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int rg = lane >> 3;
  const int kg = lane & 7;
  const int lp = np + 4;
  const int nj = np / 8;
  float* ps = p_s + warp * 16 * lp;
  for (int rt = warp; rt < np / 16; rt += kThreads / 32) {
    const int r0 = 16 * rt + 4 * rg;
    float s[4][NJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) s[i][jj] = 0.f;
    // Unrolled by two only: the body is already 4 + N/8 loads and 2N FMAs,
    // and a full unroll of the wide tile makes the build minutes long.
#pragma unroll 2
    for (int d = 0; d < DP; d += 4) {
      float4 qv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(q_s + (r0 + i) * LD + d);
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) {
        if (jj >= nj) break;
        const float4 kv =
            *reinterpret_cast<const float4*>(k_s + (kg + 8 * jj) * LD + d);
#pragma unroll
        for (int i = 0; i < 4; ++i) s[i][jj] = klab::fma4(qv[i], kv, s[i][jj]);
      }
    }

    // Logits and the exact row softmax; eight lanes (kg) to a row.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = r0 + i;
      const bool in = row < a.N;
      float mx = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) {
        if (jj >= nj) break;
        const int col = kg + 8 * jj;
        float x = -INFINITY;  // padded keys
        if (col < a.N)
          x = logit<SM_BF16>(s[i][jj], sc,
                             in ? tb.bias[row * tb.ld + col] : 0.f,
                             tb.mask != nullptr,
                             in && tb.mask ? tb.mask[row * tb.ld + col] : 0.f);
        s[i][jj] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
      float sum = 0.f;
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) {
        if (jj >= nj) break;
        s[i][jj] = chain<SM_BF16>(expf(chain<SM_BF16>(s[i][jj] - mx)));
        sum += s[i][jj];
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        sum += __shfl_xor_sync(kFull, sum, off);
      sum = chain<SM_BF16>(sum);
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) {
        if (jj >= nj) break;
        ps[(4 * i + rg) * lp + kg + 8 * jj] = quotient<SM_BF16>(s[i][jj], sum);
      }
    }
    __syncwarp();

    // O = P V, each sum in the order of the keys.
    float4 o[4][NC];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < NC; ++c) o[i][c] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int j4 = 0; j4 < np; j4 += 4) {
      float pv[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 p =
            *reinterpret_cast<const float4*>(ps + (4 * i + rg) * lp + j4);
        pv[i][0] = p.x;
        pv[i][1] = p.y;
        pv[i][2] = p.z;
        pv[i][3] = p.w;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const float4 vv = *reinterpret_cast<const float4*>(
              v_s + (j4 + u) * LD + 4 * kg + 32 * c);
#pragma unroll
          for (int i = 0; i < 4; ++i) o[i][c] = klab::fma4s(pv[i][u], vv, o[i][c]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (r0 + i >= a.N) break;
      float* orow = out + (size_t)(r0 + i) * a.D;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int col = 4 * kg + 32 * c;
        if (col >= a.D) continue;
        if (a.vec) {
          *reinterpret_cast<float4*>(orow + col) = o[i][c];
        } else {
          const float y[4] = {o[i][c].x, o[i][c].y, o[i][c].z, o[i][c].w};
          for (int e = 0; e < 4 && col + e < a.D; ++e) orow[col + e] = y[e];
        }
      }
    }
    __syncwarp();  // the next row tile rewrites ps
  }
}

// Starts copying the N x N fp32 table at src into shared rows of ld floats.
__device__ __forceinline__ void load_table(float* dst, const float* src,
                                           int N, int ld, bool vec) {
  const int chunks = (N + 3) / 4;
  for (int i = threadIdx.x; i < N * chunks; i += kThreads) {
    const int r = i / chunks;
    const int c = (i % chunks) * 4;
    if (vec) {
      klab::cp_async16(dst + r * ld + c, src + (size_t)r * N + c);
    } else {
      for (int e = 0; e < 4 && c + e < N; ++e)
        dst[r * ld + c + e] = src[(size_t)r * N + c + e];
    }
  }
}

template <typename T, int DP, int NPMAX, bool SM_BF16>
__global__ void __launch_bounds__(kThreads)
    swin_attention_fwd_kernel(Args a) {
  constexpr int LD = DP + 16 / sizeof(T);  // 16-byte pad per shared row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int w = blockIdx.x % a.nw;
  const int grp = blockIdx.x / a.nw;
  const int h = blockIdx.y;
  const int np = (a.N + 15) & ~15;
  const size_t nd = (size_t)a.N * a.D;
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  T* out = static_cast<T*>(a.out);

  // Shared memory: [bias, mask tables] [one or two stages of q, k, v]
  // [per-warp P rows, fp32 inputs only].
  float* bias_s = reinterpret_cast<float*>(smem_raw);
  float* mask_s = bias_s + a.N * a.lb;
  T* stages = reinterpret_cast<T*>(smem_raw + a.tables_bytes);
  float* p_s = reinterpret_cast<float*>(
      smem_raw + a.tables_bytes + (a.two_stage ? 2 : 1) * a.stage_bytes);
  const auto stage = [&](int st) {
    return reinterpret_cast<T*>(reinterpret_cast<unsigned char*>(stages) +
                                st * a.stage_bytes);
  };
  const int first = grp * a.group;
  const int nwin = min(a.group, a.images - first);
  const auto window = [&](int i) { return (size_t)(first + i) * a.nw + w; };
  const auto load_window = [&](int i, int st) {
    const size_t base = (window(i) * a.H + h) * nd;
    T* s = stage(st);
    klab::load_rows<T, DP>(s, LD, q + base, 0, np, a.N, a.D, a.vec,
                           threadIdx.x, kThreads);
    klab::load_rows<T, DP>(s + np * LD, LD, k + base, 0, np, a.N, a.D, a.vec,
                           threadIdx.x, kThreads);
    klab::load_rows<T, DP>(s + 2 * np * LD, LD, v + base, 0, np, a.N, a.D,
                           a.vec, threadIdx.x, kThreads);
  };

  const float* bias_g = a.bias + (size_t)h * a.N * a.N;
  const float* mask_g =
      a.wmask != nullptr ? a.wmask + (size_t)w * a.N * a.N : nullptr;
  Tables tb{bias_g, mask_g, a.N, a.tvec};
  if (a.staged) {
    load_table(bias_s, bias_g, a.N, a.lb, a.tvec);
    if (mask_g != nullptr) load_table(mask_s, mask_g, a.N, a.lb, a.tvec);
    tb = Tables{bias_s, mask_g != nullptr ? mask_s : nullptr, a.lb,
                a.N % 2 == 0};
  }
  load_window(0, 0);
  klab::cp_async_commit();
  const float sc = chain<SM_BF16>(expf(fminf(a.scale[h], kLogMaxScale)));

  for (int i = 0; i < nwin; ++i) {
    const int st = a.two_stage ? (i & 1) : 0;
    klab::cp_async_wait<0>();
    __syncthreads();  // window i has landed; window i - 1 is done
    if (a.two_stage && i + 1 < nwin) {
      load_window(i + 1, st ^ 1);
      klab::cp_async_commit();
    }
    T* q_s = stage(st);
    T* k_s = q_s + np * LD;
    const T* v_s = k_s + np * LD;
    normalize_rows<T, DP, LD>(q_s, k_s, a.N);
    __syncthreads();
    T* o = out + (window(i) * a.H + h) * nd;
    if constexpr (sizeof(T) == 2)
      window_mma<DP, NPMAX, SM_BF16>(a, q_s, k_s, v_s, tb, sc, o, np);
    else
      window_simt<DP, NPMAX, SM_BF16>(a, q_s, k_s, v_s, tb, sc, p_s, o, np);
    if (!a.two_stage && i + 1 < nwin) {
      __syncthreads();  // every warp is done with the one stage
      load_window(i + 1, 0);
      klab::cp_async_commit();
    }
  }
}

// Windows per block: as many as keep the grid at about
// KLAB_SWIN_TARGET_BLOCKS blocks, 1 to kMaxGroup, at most the windows that
// share a position.
int group_size(int Bn, int H, int images) {
  const long long g = (long long)Bn * H / KLAB_SWIN_TARGET_BLOCKS;
  return (int)std::max(1LL, std::min<long long>({g, kMaxGroup, images}));
}

template <typename T, int DP, int NPMAX, bool SM_BF16>
cudaError_t launch(Args a, cudaStream_t stream) {
  const int np = (a.N + 15) & ~15;
  const size_t tables =
      sizeof(float) * (a.wmask != nullptr ? 2 : 1) * a.N * a.lb;
  const size_t scratch =
      sizeof(T) == 4 ? sizeof(float) * (kThreads / 32) * 16 * (np + 4) : 0;
  a.stage_bytes = sizeof(T) * 3 * np * (DP + 16 / sizeof(T));
  // The tables are staged where a block reuses them and they fit.
  a.staged = a.group > 1 && a.stage_bytes + tables + scratch <= kMaxSmem;
  a.tables_bytes = a.staged ? tables : 0;
  a.two_stage = a.group > 1 &&
                2 * a.stage_bytes + a.tables_bytes + scratch <= kMaxSmem;
  const size_t smem =
      (a.two_stage ? 2 : 1) * a.stage_bytes + a.tables_bytes + scratch;
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  auto kernel = swin_attention_fwd_kernel<T, DP, NPMAX, SM_BF16>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const int groups = (a.images + a.group - 1) / a.group;
  const dim3 grid(a.nw * groups, a.H);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// N padded to 64 or to 144 (the register tile of a row), the head dim to a
// multiple of 16 (bf16, the mma.sync depth) or of 32 (fp32, eight float4
// columns a lane group).
template <typename T, bool SM_BF16>
cudaError_t dispatch(const Args& a, cudaStream_t stream) {
  constexpr int kStep = sizeof(T) == 2 ? 16 : 32;
  const bool wide = a.N > 64;
  const int dp = (a.D + kStep - 1) / kStep * kStep;
#define KLAB_SWIN_CASE(DPV)                                                  \
  case DPV:                                                                  \
    return wide ? launch<T, (DPV), kMaxN, SM_BF16>(a, stream)                \
                : launch<T, (DPV), 64, SM_BF16>(a, stream);
  if constexpr (sizeof(T) == 2) {
    switch (dp) {
      KLAB_SWIN_CASE(16)
      KLAB_SWIN_CASE(32)
      KLAB_SWIN_CASE(48)
      KLAB_SWIN_CASE(64)
      KLAB_SWIN_CASE(80)
      KLAB_SWIN_CASE(96)
      KLAB_SWIN_CASE(112)
      KLAB_SWIN_CASE(128)
    }
  } else {
    switch (dp) {
      KLAB_SWIN_CASE(32)
      KLAB_SWIN_CASE(64)
      KLAB_SWIN_CASE(96)
      KLAB_SWIN_CASE(128)
    }
  }
#undef KLAB_SWIN_CASE
  return cudaErrorInvalidValue;
}

bool aligned(const void* p, uintptr_t n) {
  return reinterpret_cast<uintptr_t>(p) % n == 0;
}

}  // namespace

// q/k/v/out (Bn,H,N,D) contiguous, fp32 (is_bf16=0) or bf16 (is_bf16=1),
// N <= 144 and D <= 128; scale (H,) fp32 raw logit scale; bias (H,N,N) fp32;
// wmask (nW,N,N) fp32 or NULL (then nW is ignored); sm_bf16: the softmax
// chain in bf16 (1) or fp32 (0). Returns the launch's cudaError_t
// (cudaErrorInvalidValue for a shape outside these limits).
extern "C" int klab_swin_attention_fwd(const void* q, const void* k,
                                       const void* v, const void* scale,
                                       const void* bias, const void* wmask,
                                       void* out, int Bn, int H, int N, int D,
                                       int nW, int is_bf16, int sm_bf16,
                                       void* stream) {
  if (Bn < 1 || H < 1 || N < 1 || N > kMaxN || D < 1 || D > 128 ||
      H > 65535 || (wmask != nullptr && (nW < 1 || Bn % nW != 0)))
    return (int)cudaErrorInvalidValue;
  Args a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.scale = static_cast<const float*>(scale);
  a.bias = static_cast<const float*>(bias);
  a.wmask = static_cast<const float*>(wmask);
  a.out = out;
  a.H = H;
  a.N = N;
  a.D = D;
  a.nw = wmask != nullptr ? nW : 1;
  a.images = Bn / a.nw;
  a.group = group_size(Bn, H, a.images);
  a.lb = table_ld(N);
  a.vec = D % (is_bf16 ? 8 : 4) == 0 && aligned(q, 16) && aligned(k, 16) &&
          aligned(v, 16) && aligned(out, 16);
  a.tvec = N % 4 == 0 && aligned(bias, 16) &&
           (wmask == nullptr || aligned(wmask, 16));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return (int)(sm_bf16 ? dispatch<bf16, true>(a, s)
                         : dispatch<bf16, false>(a, s));
  return (int)(sm_bf16 ? dispatch<float, true>(a, s)
                       : dispatch<float, false>(a, s));
}
