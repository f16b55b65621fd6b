"""The T5 attention kernels' logic on the CPU: ``csrc/t5_attention_fwd.cu``
and ``csrc/t5_attention_bwd.cu`` compiled with g++ against a host emulation
of the CUDA features they use (``tests/cuda_host/emulation.h``: one fiber per
thread, warp collectives resolved when the whole warp has arrived), then
called through their C entry points on CPU tensors and held against the
plain PyTorch versions. This checks what the card-only tests check of the
kernels' arithmetic (fragment layouts of ``mma.sync`` and ``ldmatrix``, the
lanes' exchange of Philox keep bits, ragged tiles, padded head dims, masked
rows) without the card; it says nothing of the PTX, of speed or of races
between warps. Skipped where g++ is missing.

Tolerances are the card-only tests': 2e-2 absolute plus 2e-2 relative for a
bf16 output, 1e-4 absolute in fp32; gradients by their largest error over
their largest value, 2e-2 in bf16, 1e-4 in fp32 and for the bias gradient.
"""

import concurrent.futures
import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import pytest
import torch

from klab_multimodalmodel_tpu_torch.ops import cuda_build
from klab_multimodalmodel_tpu_torch.ops.fused_attention import (
    t5_attention_bwd_plain, t5_attention_plain)

HOST = Path(__file__).resolve().parent / "cuda_host"
SOURCES = ("t5_attention_fwd", "t5_attention_bwd")
# The inline-PTX helpers of csrc/mma.cuh and their host versions.
HOST_HELPERS = {
    "smem_u32": "",
    "cp_async16": "inline void cp_async16(void* dst, const void* src) "
                  "{ std::memcpy(dst, src, 16); }",
    "cp_async_commit": "inline void cp_async_commit() {}",
    "cp_async_wait": "template <int N> inline void cp_async_wait() {}",
    "ldmatrix_x4": "inline void ldmatrix_x4(uint32_t (&r)[4], const void* p)"
                   " { emu_ldmatrix(r, p, false); }",
    "ldmatrix_x4_trans": "inline void ldmatrix_x4_trans(uint32_t (&r)[4], "
                         "const void* p) { emu_ldmatrix(r, p, true); }",
    "mma_bf16": "inline void mma_bf16(float (&d)[4], const uint32_t (&a)[4],"
                " uint32_t b0, uint32_t b1) { emu_mma(d, a, b0, b1); }",
    "exp2_approx": "inline float exp2_approx(float x) { const float y = "
                   "std::exp2(x); return y < 1.17549435e-38f ? 0.f : y; }",
}
TOLS = {torch.float32: dict(rtol=0.0, atol=1e-4),
        torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}
GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def _replace_function(src: str, name: str, repl: str) -> str:
    m = re.search(r"(template <int N>\s*)?__device__ __forceinline__ "
                  r"[\w\s]+?\b" + name + r"\(", src)
    assert m, f"csrc/mma.cuh has no {name}"
    i = src.index("{", m.end())
    depth = 0
    while True:
        depth += {"{": 1, "}": -1}.get(src[i], 0)
        if depth == 0:
            return src[:m.start()] + repl + src[i + 1:]
        i += 1


def _host_launches(src: str) -> str:
    """``kernel<<<grid, block, smem, stream>>>(args);`` becomes
    ``emu_launch(grid, block, smem, stream, [&] { kernel(args); });``."""
    out, pos = [], 0
    for m in re.finditer(r"(\w+)\s*<<<", src):
        if m.start() < pos:
            continue
        end_cfg = src.index(">>>", m.end())
        i = src.index("(", end_cfg)
        j, depth = i, 0
        while True:
            depth += {"(": 1, ")": -1}.get(src[j], 0)
            if depth == 0:
                break
            j += 1
        out += [src[pos:m.start()],
                f"emu_launch({src[m.end():end_cfg]}, [&] {{ "
                f"{m.group(1)}({src[i + 1:j]}); }})"]
        pos = j + 1
    return "".join(out + [src[pos:]])


def _host_source(src: str) -> str:
    src = re.sub(r"extern __shared__ (?:__align__\(\d+\) )?([\w ]+?) "
                 r"(\w+)\[\];",
                 r"\1* \2 = reinterpret_cast<\1*>(emu_smem());", src)
    return _host_launches(src)


@pytest.fixture(scope="module")
def kernels(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the kernels for the host")
    out = tmp_path_factory.mktemp("cuda_host")
    mma = (cuda_build.CSRC_DIR / "mma.cuh").read_text()
    for name, repl in HOST_HELPERS.items():
        mma = _replace_function(mma, name, repl)
    (out / "mma.cuh").write_text(mma)
    shutil.copy(cuda_build.CSRC_DIR / "philox.cuh", out / "philox.cuh")

    def build(name):
        (out / f"{name}.cpp").write_text(
            _host_source((cuda_build.CSRC_DIR / f"{name}.cu").read_text()))
        lib = out / f"lib{name}.so"
        proc = subprocess.run(
            [gxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-w", "-I",
             str(HOST), "-include", "emulation.h", "-o", str(lib),
             str(out / f"{name}.cpp")], capture_output=True, text=True)
        assert proc.returncode == 0, proc.stderr[-4000:]
        symbol, argtypes = cuda_build._SIGNATURES[name]
        fn = getattr(ctypes.CDLL(str(lib)), symbol)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        return name, fn

    with concurrent.futures.ThreadPoolExecutor(len(SOURCES)) as pool:
        return dict(pool.map(build, SOURCES))


def _ptr(t):
    return None if t is None else t.data_ptr()


def _forward(fn, q, k, v, bias, kmask, rate, seed):
    B, H, Q, D = q.shape
    out = torch.full_like(q, float("nan"))
    stats = torch.full((B, H, Q, 2), float("nan"))
    err = fn(_ptr(q), _ptr(k), _ptr(v), _ptr(bias), _ptr(kmask),
             _ptr(seed) if rate > 0 else None, _ptr(out), _ptr(stats), B, H,
             Q, k.shape[2], D, int(q.dtype == torch.bfloat16), rate, None)
    assert err == 0
    return out, stats


def _backward(fn, q, k, v, do, bias, kmask, rate, seed, stats, need_dbias):
    B, H, Q, D = q.shape
    K = k.shape[2]
    delta = torch.full((B, H, Q), float("nan"))
    dq, dk, dv = (torch.full_like(t, float("nan")) for t in (q, k, v))
    ds = torch.full((B, H, Q, K), float("nan")) if need_dbias else None
    dbias = torch.full((H, Q, K), float("nan")) if need_dbias else None
    err = fn(_ptr(q), _ptr(k), _ptr(v), _ptr(do), _ptr(bias), _ptr(kmask),
             _ptr(seed) if rate > 0 else None, _ptr(stats), _ptr(delta),
             _ptr(dq), _ptr(dk), _ptr(dv), _ptr(ds), _ptr(dbias), B, H, Q, K,
             D, int(q.dtype == torch.bfloat16), rate, None)
    assert err == 0
    return dq, dk, dv, dbias


def _rel_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max())


@pytest.mark.parametrize("dtype,B,H,Q,K,D,rate,bias,mask,causal", [
    # bf16: the tensor-core kernels
    (torch.bfloat16, 1, 2, 5, 7, 8, 0.1, True, True, False),  # tiny, D 8
    (torch.bfloat16, 2, 2, 40, 70, 48, 0.1, True, True, False),  # D 48
    (torch.bfloat16, 2, 1, 65, 127, 64, 0.0, True, True, False),
    (torch.bfloat16, 2, 1, 65, 127, 64, 0.1, True, True, False),
    (torch.bfloat16, 2, 1, 130, 66, 64, 0.1, False, True, False),
    (torch.bfloat16, 1, 1, 33, 17, 128, 0.1, True, True, False),  # D 128
    (torch.bfloat16, 1, 2, 9, 13, 21, 0.1, True, True, False),  # D, K odd
    (torch.bfloat16, 1, 1, 70, 70, 64, 0.1, True, False, True),  # causal
    # fp32: the scalar kernels
    (torch.float32, 2, 1, 40, 70, 48, 0.1, True, True, False),
])
def test_t5_kernels_on_host_match_plain(kernels, dtype, B, H, Q, K, D, rate,
                                        bias, mask, causal):
    """Forward, row stats and backward (dq, dk, dv, dBias) of the kernels
    against the plain versions; with dropout also on uniform probabilities,
    where one keep bit that differed would move an output far past the
    tolerance. With a key mask, the last batch row is fully masked."""
    g = torch.Generator().manual_seed(B * 1000 + Q * 10 + D)
    q, k, v, do = (torch.randn(s, generator=g).to(dtype) for s in (
        (B, H, Q, D), (B, H, K, D), (B, H, K, D), (B, H, Q, D)))
    b = torch.randn(H, Q, K, generator=g) if bias else None
    if causal:
        i = torch.arange(Q)
        b = b + torch.where(i[:, None] >= i[None, :K], 0.0, -1e9)
    m = None
    if mask:
        m = torch.ones(B, K, dtype=torch.int32)
        m[0, K // 2:] = 0
        m[-1, :] = 0
    seed = torch.tensor([0x1234_5678_9ABC_DEF], dtype=torch.int64)

    out, stats = _forward(kernels["t5_attention_fwd"], q, k, v, b, m, rate,
                          seed)
    want = t5_attention_plain(q, k, v, b, m, rate, seed)
    torch.testing.assert_close(out.float(), want.float(), **TOLS[dtype])
    if rate:
        z = torch.zeros_like(q)
        got, _ = _forward(kernels["t5_attention_fwd"], z, k, v, None, None,
                          rate, seed)
        want = t5_attention_plain(z, k, v, None, None, rate, seed)
        torch.testing.assert_close(got.float(), want.float(), **TOLS[dtype])

    got = _backward(kernels["t5_attention_bwd"], q, k, v, do, b, m, rate,
                    seed, stats, bias)
    want = t5_attention_bwd_plain(q, k, v, do, b, m, rate, seed, bias)
    for name, x, w in zip(("dq", "dk", "dv", "dbias"), got, want):
        if w is None:
            assert x is None
            continue
        tol = GRAD_TOL[torch.float32 if name == "dbias" else dtype]
        assert x.dtype == w.dtype
        assert _rel_err(x, w) <= tol, (name, _rel_err(x, w))
