// Tensor-core and asynchronous-copy building blocks (sm_80 and later; built
// here for sm_90a) and the loads of the attention inputs, shared by the
// attention kernels (`t5_attention_fwd.cu`, `t5_attention_bwd.cu`,
// `swin_attention_fwd.cu`).
//
// Fragment layouts of mma.sync.m16n8k16 (bf16 in, fp32 accumulators), for
// lane = 4 * g + t (g = lane >> 2 in 0..7, t = lane & 3):
//   A (16 x 16, row-major)  a0: (row g,   cols 2t, 2t+1)   a1: (row g+8, ...)
//                           a2: (row g,   cols 2t+8, +9)   a3: (row g+8, ...)
//   B (16 x 8, k x n)       b0: (k 2t, 2t+1; col g)        b1: (k 2t+8, +9)
//   C (16 x 8, fp32)        c0, c1: (row g, cols 2t, 2t+1)
//                           c2, c3: (row g+8, cols 2t, 2t+1)
// so the accumulators of two neighbouring n-tiles, rounded to bf16 in pairs,
// are the A fragment of the next product over those 16 columns, in
// registers. Tiles in shared memory are row-major with a row of DP + 8
// bf16 (DP a multiple of 16): the 16-byte pad staggers the eight rows one
// ldmatrix phase reads across all 32 banks.

#pragma once

#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace klab {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy from global to shared memory, bypassing L1.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed groups of this thread are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8x8 b16 matrices; lanes 8j..8j+7 give the row addresses of matrix j,
// and lane 4g+t receives elements (g, 2t) and (g, 2t+1) of each.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// The same, transposed: lane 4g+t receives elements (2t, g) and (2t+1, g).
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// d += A b on the tensor cores: m16n8k16, bf16 operands, fp32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats rounded to bf16 (nearest even), lo in the low half: the order
// of a fragment register.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The A fragment of a 16x16 product from the accumulators of two 16x8
// n-tiles (columns 0..7 and 8..15), rounded to bf16.
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&c0)[4],
                                         const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// Starts copying rows [r0, r0 + rows) of a row-major (n, D) matrix of T
// (fp32 or bf16) into shared rows of `ld` elements covering DP columns (DP
// a multiple of a 16-byte chunk), zero past row n and past column D, with
// `nthreads` threads numbered from `tid`. A chunk inside the matrix goes by
// cp.async when `vec` (D a multiple of a chunk and a 16-byte aligned
// matrix), any other chunk by plain loads. The caller commits, waits and
// synchronizes.
template <typename T, int DP>
__device__ __forceinline__ void load_rows(T* dst, int ld, const T* src,
                                          int r0, int rows, int n, int D,
                                          bool vec, int tid, int nthreads) {
  constexpr int kE = 16 / sizeof(T);
  constexpr int kChunks = DP / kE;
  for (int i = tid; i < rows * kChunks; i += nthreads) {
    const int r = i / kChunks;
    const int c = (i % kChunks) * kE;
    const int row = r0 + r;
    T* d = dst + r * ld + c;
    const T* s = src + (size_t)row * D + c;
    if (vec && row < n && c < D) {
      cp_async16(d, s);
    } else {
      uint4 z = make_uint4(0u, 0u, 0u, 0u);
      T* e = reinterpret_cast<T*>(&z);
      if (row < n)
        for (int j = 0; j < kE && c + j < D; ++j) e[j] = s[j];
      *reinterpret_cast<uint4*>(d) = z;
    }
  }
}

// Starts copying rows [r0, r0 + ROWS) of a row-major (n, D) bf16 matrix into
// a shared tile of ROWS x DP with row stride DP + 8 (see above), with the
// THREADS threads of the block.
template <int ROWS, int DP, int THREADS>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src, int r0,
                                          int n, int D, bool vec) {
  load_rows<__nv_bfloat16, DP>(dst, DP + 8, src, r0, ROWS, n, D, vec,
                               threadIdx.x, THREADS);
}

// Writes rows [r0, r0 + ROWS) of a row-major (n, D) bf16 matrix from a
// shared tile laid out as `load_tile`'s, rows past n skipped, with the 32
// lanes of one warp: 16-byte stores where `vec`, element stores otherwise.
template <int ROWS, int DP>
__device__ __forceinline__ void store_tile_warp(__nv_bfloat16* dst,
                                                const __nv_bfloat16* src,
                                                int r0, int n, int D,
                                                bool vec, int lane) {
  constexpr int kChunks = DP / 8;
  constexpr int kLd = DP + 8;
  for (int i = lane; i < ROWS * kChunks; i += 32) {
    const int r = i / kChunks;
    const int c = (i % kChunks) * 8;
    const int row = r0 + r;
    if (row >= n || c >= D) continue;
    const __nv_bfloat16* s = src + r * kLd + c;
    __nv_bfloat16* d = dst + (size_t)row * D + c;
    if (vec && c + 8 <= D) {
      *reinterpret_cast<uint4*>(d) = *reinterpret_cast<const uint4*>(s);
    } else {
      for (int e = 0; e < 8 && c + e < D; ++e) d[e] = s[e];
    }
  }
}

// acc + a . b, summed in the order of the components (fp32 SIMT products).
__device__ __forceinline__ float fma4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// acc + s v, component by component.
__device__ __forceinline__ float4 fma4s(float s, float4 v, float4 acc) {
  return make_float4(fmaf(s, v.x, acc.x), fmaf(s, v.y, acc.y),
                     fmaf(s, v.z, acc.z), fmaf(s, v.w, acc.w));
}

// 2^x on the special-function unit (ex2.approx.ftz: relative error below
// 2^-22, results under 2^-126 flushed to 0).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// bias[h, row, key] and bias[h, row, key + 1] of an (H, Q, K) fp32 head
// bias: the pair an accumulator register pair holds. 0 where there is no
// bias or the entry lies outside (Q, K); one 8-byte load where `vec` (K even
// and an 8-byte aligned bias; key is even in every caller).
__device__ __forceinline__ float2 bias_pair(const float* bias, int h, int Q,
                                           int K, int row, int key,
                                           bool vec) {
  float2 r = make_float2(0.f, 0.f);
  if (bias == nullptr || row >= Q || key >= K) return r;
  const float* p = bias + ((size_t)h * Q + row) * K + key;
  if (vec) return __ldg(reinterpret_cast<const float2*>(p));
  r.x = __ldg(p);
  if (key + 1 < K) r.y = __ldg(p + 1);
  return r;
}

// The logit addend of one key for batch row b: 0 to attend, -1e9 (the TPU
// kernel's NEG) where the (B, K) key mask is <= 0, -inf past K (probability
// exactly 0).
__device__ __forceinline__ float key_addend(const int* kmask, int b, int key,
                                            int K) {
  if (key >= K) return -INFINITY;
  return (kmask != nullptr && kmask[(size_t)b * K + key] <= 0) ? -1e9f : 0.f;
}

}  // namespace klab
