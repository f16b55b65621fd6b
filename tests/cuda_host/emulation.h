// Host emulation of the CUDA features the attention kernels use, so that
// `tests/test_torch_cuda_emulation.py` can compile `csrc/*.cu` with g++ and
// hold the kernels' logic (fragment layouts, lane exchanges, tile edges)
// against the plain PyTorch versions on the CPU. Each CUDA thread is a
// ucontext fiber; warp collectives (shuffles, ldmatrix, mma.sync) and
// __syncthreads are rendezvous points that a scheduler resolves once every
// thread involved has arrived. cp.async copies at once; blocks run one after
// another; shared memory starts filled with bf16 NaNs, so a read of an
// unwritten element shows in the result. It says nothing about speed, the
// PTX, or races between warps.
#pragma once
#include <ucontext.h>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __restrict__ __restrict
#define __launch_bounds__(...)
#define __align__(n) alignas(n)

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned x_ = 1, unsigned y_ = 1, unsigned z_ = 1) : x(x_), y(y_), z(z_) {}
};
struct uint2 { uint32_t x, y; };
struct uint4 { uint32_t x, y, z, w; };
struct float2 { float x, y; };
struct float4 { float x, y, z, w; };
inline uint2 make_uint2(uint32_t a, uint32_t b) { return {a, b}; }
inline uint4 make_uint4(uint32_t a, uint32_t b, uint32_t c, uint32_t d) { return {a, b, c, d}; }
inline float2 make_float2(float a, float b) { return {a, b}; }
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }

struct __nv_bfloat16 { uint16_t x; };
struct __nv_bfloat162 { __nv_bfloat16 x, y; };
inline __nv_bfloat16 __float2bfloat16(float f) {
  uint32_t u; std::memcpy(&u, &f, 4);
  if (std::isnan(f)) return {(uint16_t)0x7fc0};
  u += 0x7fff + ((u >> 16) & 1);
  return {(uint16_t)(u >> 16)};
}
inline float __bfloat162float(__nv_bfloat16 h) {
  uint32_t u = (uint32_t)h.x << 16; float f; std::memcpy(&f, &u, 4); return f;
}
inline __nv_bfloat162 __floats2bfloat162_rn(float a, float b) {
  return {__float2bfloat16(a), __float2bfloat16(b)};
}
inline uint32_t __umulhi(uint32_t a, uint32_t b) { return (uint32_t)(((uint64_t)a * b) >> 32); }
template <typename T> inline T __ldg(const T* p) { return *p; }
inline int min(int a, int b) { return a < b ? a : b; }
// Round-to-nearest product and sum (x86-64 without -mfma never contracts).
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }

typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
typedef void* cudaStream_t;
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
template <typename F> inline cudaError_t cudaFuncSetAttribute(F, int, int) { return cudaSuccess; }

enum EmuOp { OP_NONE, OP_SYNC, OP_SYNCWARP, OP_SHFL_XOR, OP_SHFL, OP_LDM, OP_LDM_T, OP_MMA };

struct EmuFiber {
  ucontext_t ctx;
  std::vector<char> stack;
  bool done = false;
  EmuOp op = OP_NONE;
  uint32_t u_in = 0, u_out = 0;
  int arg = 0;
  const void* addr = nullptr;
  uint32_t r[4];
  uint32_t a[4], b[2];
  float c[4];
};

struct Emu {
  dim3 grid, block, bidx;
  std::vector<EmuFiber> fibers;
  ucontext_t sched;
  int cur = 0;
  std::vector<unsigned char> smem = std::vector<unsigned char>(256 * 1024);
  std::function<void()> body;
  long long switches = 0;
};
inline Emu g_emu;

inline void emu_yield(EmuOp op) {
  EmuFiber& f = g_emu.fibers[g_emu.cur];
  f.op = op;
  ++g_emu.switches;
  swapcontext(&f.ctx, &g_emu.sched);
}

inline dim3 emu_thread_idx() {
  const int t = g_emu.cur;
  const dim3& b = g_emu.block;
  return dim3(t % b.x, (t / b.x) % b.y, t / (b.x * b.y));
}
#define threadIdx (emu_thread_idx())
#define blockIdx (g_emu.bidx)
#define blockDim (g_emu.block)
#define gridDim (g_emu.grid)

inline unsigned char* emu_smem() { return g_emu.smem.data(); }

inline void __syncthreads() { emu_yield(OP_SYNC); }
inline void __syncwarp(unsigned = 0xffffffffu) { emu_yield(OP_SYNCWARP); }

template <typename T>
inline T emu_shfl(T v, int arg, EmuOp op) {
  static_assert(sizeof(T) == 4, "32-bit shuffles only");
  EmuFiber& f = g_emu.fibers[g_emu.cur];
  std::memcpy(&f.u_in, &v, 4);
  f.arg = arg;
  emu_yield(op);
  T out;
  std::memcpy(&out, &g_emu.fibers[g_emu.cur].u_out, 4);
  return out;
}
template <typename T> inline T __shfl_xor_sync(unsigned, T v, int m) { return emu_shfl(v, m, OP_SHFL_XOR); }
template <typename T> inline T __shfl_sync(unsigned, T v, int s) { return emu_shfl(v, s, OP_SHFL); }

inline void emu_ldmatrix(uint32_t (&r)[4], const void* p, bool trans) {
  EmuFiber& f = g_emu.fibers[g_emu.cur];
  f.addr = p;
  emu_yield(trans ? OP_LDM_T : OP_LDM);
  EmuFiber& g = g_emu.fibers[g_emu.cur];
  for (int i = 0; i < 4; ++i) r[i] = g.r[i];
}
inline void emu_mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  EmuFiber& f = g_emu.fibers[g_emu.cur];
  for (int i = 0; i < 4; ++i) { f.a[i] = a[i]; f.c[i] = d[i]; }
  f.b[0] = b0; f.b[1] = b1;
  emu_yield(OP_MMA);
  EmuFiber& g = g_emu.fibers[g_emu.cur];
  for (int i = 0; i < 4; ++i) d[i] = g.c[i];
}

inline float emu_bf(uint32_t w, int hi) {
  return __bfloat162float(__nv_bfloat16{(uint16_t)(hi ? w >> 16 : w & 0xffff)});
}

inline void emu_resolve_warp(EmuFiber* L, EmuOp op) {
  if (op == OP_SHFL_XOR) {
    for (int l = 0; l < 32; ++l) L[l].u_out = L[l ^ (L[l].arg & 31)].u_in;
  } else if (op == OP_SHFL) {
    for (int l = 0; l < 32; ++l) L[l].u_out = L[L[l].arg & 31].u_in;
  } else if (op == OP_LDM || op == OP_LDM_T) {
    for (int l = 0; l < 32; ++l) {
      const int g = l >> 2, t = l & 3;
      for (int j = 0; j < 4; ++j) {
        uint16_t e0, e1;
        if (op == OP_LDM) {
          const uint16_t* row = static_cast<const uint16_t*>(L[8 * j + g].addr);
          e0 = row[2 * t]; e1 = row[2 * t + 1];
        } else {
          e0 = static_cast<const uint16_t*>(L[8 * j + 2 * t].addr)[g];
          e1 = static_cast<const uint16_t*>(L[8 * j + 2 * t + 1].addr)[g];
        }
        L[l].r[j] = (uint32_t)e0 | ((uint32_t)e1 << 16);
      }
    }
  } else if (op == OP_MMA) {
    float A[16][16], B[16][8], C[16][8];
    for (int l = 0; l < 32; ++l) {
      const int g = l >> 2, t = l & 3;
      const uint32_t* a = L[l].a;
      A[g][2 * t] = emu_bf(a[0], 0); A[g][2 * t + 1] = emu_bf(a[0], 1);
      A[g + 8][2 * t] = emu_bf(a[1], 0); A[g + 8][2 * t + 1] = emu_bf(a[1], 1);
      A[g][2 * t + 8] = emu_bf(a[2], 0); A[g][2 * t + 9] = emu_bf(a[2], 1);
      A[g + 8][2 * t + 8] = emu_bf(a[3], 0); A[g + 8][2 * t + 9] = emu_bf(a[3], 1);
      B[2 * t][g] = emu_bf(L[l].b[0], 0); B[2 * t + 1][g] = emu_bf(L[l].b[0], 1);
      B[2 * t + 8][g] = emu_bf(L[l].b[1], 0); B[2 * t + 9][g] = emu_bf(L[l].b[1], 1);
      C[g][2 * t] = L[l].c[0]; C[g][2 * t + 1] = L[l].c[1];
      C[g + 8][2 * t] = L[l].c[2]; C[g + 8][2 * t + 1] = L[l].c[3];
    }
    for (int l = 0; l < 32; ++l) {
      const int g = l >> 2, t = l & 3;
      const int rows[4] = {g, g, g + 8, g + 8}, cols[4] = {2 * t, 2 * t + 1, 2 * t, 2 * t + 1};
      for (int e = 0; e < 4; ++e) {
        float acc = 0.f;
        for (int k = 0; k < 16; ++k) acc += A[rows[e]][k] * B[k][cols[e]];
        L[l].c[e] = C[rows[e]][cols[e]] + acc;
      }
    }
  }
}

inline void emu_fiber_entry() {
  g_emu.body();
  g_emu.fibers[g_emu.cur].done = true;
}

inline void emu_run_block(int n) {
  if ((int)g_emu.fibers.size() < n) g_emu.fibers.resize(n);
  std::memset(g_emu.smem.data(), 0xff, g_emu.smem.size());  // NaN bf16: catches reads of unwritten smem
  for (int i = 0; i < n; ++i) {
    EmuFiber& f = g_emu.fibers[i];
    f.stack.resize(256 * 1024);
    f.done = false;
    f.op = OP_NONE;
    getcontext(&f.ctx);
    f.ctx.uc_stack.ss_sp = f.stack.data();
    f.ctx.uc_stack.ss_size = f.stack.size();
    f.ctx.uc_link = &g_emu.sched;
    makecontext(&f.ctx, emu_fiber_entry, 0);
  }
  while (true) {
    bool any = false;
    for (int i = 0; i < n; ++i) {
      EmuFiber& f = g_emu.fibers[i];
      if (f.done || f.op != OP_NONE) continue;
      g_emu.cur = i;
      swapcontext(&g_emu.sched, &f.ctx);
      any = true;
    }
    int done = 0, at_sync = 0;
    for (int i = 0; i < n; ++i) {
      done += g_emu.fibers[i].done;
      at_sync += !g_emu.fibers[i].done && g_emu.fibers[i].op == OP_SYNC;
    }
    if (done == n) return;
    for (int w = 0; w * 32 < n; ++w) {
      EmuFiber* L = &g_emu.fibers[32 * w];
      const EmuOp op = L[0].op;
      if (L[0].done || op == OP_NONE || op == OP_SYNC) continue;
      bool same = true;
      for (int l = 1; l < 32; ++l) same &= !L[l].done && L[l].op == op;
      if (!same) continue;
      emu_resolve_warp(L, op);
      for (int l = 0; l < 32; ++l) L[l].op = OP_NONE;
      any = true;
    }
    if (at_sync + done == n && at_sync > 0) {
      if (done) { std::fprintf(stderr, "emu: __syncthreads with exited threads\n"); std::abort(); }
      for (int i = 0; i < n; ++i) g_emu.fibers[i].op = OP_NONE;
      any = true;
    }
    if (!any) {
      std::fprintf(stderr, "emu: deadlock in block (%u,%u,%u)\n", g_emu.bidx.x, g_emu.bidx.y, g_emu.bidx.z);
      for (int i = 0; i < n; ++i) std::fprintf(stderr, " t%d:%d%s", i, g_emu.fibers[i].op, g_emu.fibers[i].done ? "D" : "");
      std::fprintf(stderr, "\n");
      std::abort();
    }
  }
}

template <typename F>
inline void emu_launch(dim3 grid, dim3 block, size_t smem, cudaStream_t, F f) {
  if (smem > g_emu.smem.size()) { std::fprintf(stderr, "emu: smem %zu too large\n", smem); std::abort(); }
  const int n = block.x * block.y * block.z;
  if (n % 32) { std::fprintf(stderr, "emu: block of %d threads\n", n); std::abort(); }
  g_emu.grid = grid;
  g_emu.block = block;
  g_emu.body = f;
  for (unsigned z = 0; z < grid.z; ++z)
    for (unsigned y = 0; y < grid.y; ++y)
      for (unsigned x = 0; x < grid.x; ++x) {
        g_emu.bidx = dim3(x, y, z);
        emu_run_block(n);
      }
}
