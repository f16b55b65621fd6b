"""The attention kernels' logic on the CPU: ``csrc/t5_attention_fwd.cu``,
``csrc/t5_attention_bwd.cu`` and ``csrc/swin_attention_fwd.cu`` compiled
with g++ against a host emulation
of the CUDA features they use (``tests/cuda_host/emulation.h``: one fiber per
thread, warp collectives resolved when the whole warp has arrived), then
called through their C entry points on CPU tensors and held against the
plain PyTorch versions. This checks what the card-only tests check of the
kernels' arithmetic (fragment layouts of ``mma.sync`` and ``ldmatrix``, the
lanes' exchange of Philox keep bits, ragged tiles, padded head dims, masked
rows, the Swin kernel's grouping of windows into blocks) without the card;
it says nothing of the PTX, of speed or of races between warps. Skipped
where g++ is missing. The Swin source is built with
``KLAB_SWIN_TARGET_BLOCKS=4``, so that these tiny launches group two
windows to a block, with a last group of one.

Tolerances are the card-only tests': 2e-2 absolute plus 2e-2 relative for a
bf16 output, 1e-4 absolute in fp32; gradients by their largest error over
their largest value, 2e-2 in bf16, 1e-4 in fp32 and for the bias gradient.
The fp32 T5 forward's row stats: the max within 1e-4, the sum within 1e-5
relative (summation order). The Swin kernel with a bf16 softmax chain: a
logit can round one bf16 ulp apart from the plain version's (fp32 dot
products summed in another order), which moves one probability by up to
~28 %; at most one row of outputs in a hundred may fall outside the bf16
tolerance, and the mean error stays under 1e-3 (the card's tests, at
larger sizes, allow 1e-4 of the outputs).
"""

import concurrent.futures
import ctypes
import math
import re
import shutil
import subprocess
from pathlib import Path

import pytest
import torch

from klab_multimodalmodel_tpu_torch.ops import cuda_build
from klab_multimodalmodel_tpu_torch.ops.fused_attention import (
    NEG, swin_attention_plain, t5_attention_bwd_plain, t5_attention_plain)

HOST = Path(__file__).resolve().parent / "cuda_host"
SOURCES = ("t5_attention_fwd", "t5_attention_bwd", "swin_attention_fwd")
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
             str(HOST), "-include", "emulation.h",
             "-DKLAB_SWIN_TARGET_BLOCKS=4", "-o", str(lib),
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


def _forward(fn, q, k, v, bias, kmask, rate, seed, head_offset=0,
             q_offset=0):
    B, H, Q, D = q.shape
    out = torch.full_like(q, float("nan"))
    stats = torch.full((B, H, Q, 2), float("nan"))
    err = fn(_ptr(q), _ptr(k), _ptr(v), _ptr(bias), _ptr(kmask),
             _ptr(seed) if rate > 0 else None, _ptr(out), _ptr(stats), B, H,
             Q, k.shape[2], D, int(q.dtype == torch.bfloat16), head_offset,
             q_offset, rate, None)
    assert err == 0
    return out, stats


def _backward(fn, q, k, v, do, bias, kmask, rate, seed, stats, need_dbias,
              head_offset=0, q_offset=0):
    B, H, Q, D = q.shape
    K = k.shape[2]
    delta = torch.full((B, H, Q), float("nan"))
    dq, dk, dv = (torch.full_like(t, float("nan")) for t in (q, k, v))
    ds = torch.full((B, H, Q, K), float("nan")) if need_dbias else None
    dbias = torch.full((H, Q, K), float("nan")) if need_dbias else None
    err = fn(_ptr(q), _ptr(k), _ptr(v), _ptr(do), _ptr(bias), _ptr(kmask),
             _ptr(seed) if rate > 0 else None, _ptr(stats), _ptr(delta),
             _ptr(dq), _ptr(dk), _ptr(dv), _ptr(ds), _ptr(dbias), B, H, Q, K,
             D, int(q.dtype == torch.bfloat16), head_offset, q_offset, rate,
             None)
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


@pytest.mark.parametrize("dtype,D", [(torch.bfloat16, 128),
                                     (torch.bfloat16, 64),
                                     (torch.float32, 48)])
def test_t5_kernels_on_host_take_head_offset(kernels, dtype, D):
    """A tensor-parallel rank's heads: the kernels on heads 2..3 of four
    with ``head_offset`` 2 give the plain version's full call on those
    heads, forward and backward, with dropout on; without the offset the
    keep bits are heads 0..1's, so the output moves."""
    g = torch.Generator().manual_seed(D)
    B, H, Q, K, rate, off = 2, 4, 20, 24, 0.3, 2
    q, k, v, do = (torch.randn(s, generator=g).to(dtype) for s in (
        (B, H, Q, D), (B, H, K, D), (B, H, K, D), (B, H, Q, D)))
    b = torch.randn(H, Q, K, generator=g)
    seed = torch.tensor([0x7777_1234_5678_9ABC], dtype=torch.int64)
    part = [t[:, off:].contiguous() for t in (q, k, v, do)]
    out, stats = _forward(kernels["t5_attention_fwd"], *part[:3],
                          b[off:].contiguous(), None, rate, seed, off)
    want = t5_attention_plain(q, k, v, b, None, rate, seed)[:, off:]
    torch.testing.assert_close(out.float(), want.float(), **TOLS[dtype])
    shifted, _ = _forward(kernels["t5_attention_fwd"], *part[:3],
                          b[off:].contiguous(), None, rate, seed)
    assert _rel_err(shifted, want) > 0.1
    got = _backward(kernels["t5_attention_bwd"], *part, b[off:].contiguous(),
                    None, rate, seed, stats, True, off)
    full = t5_attention_bwd_plain(q, k, v, do, b, None, rate, seed, True)
    for name, x, w in zip(("dq", "dk", "dv", "dbias"), got, full):
        w = w[off:] if name == "dbias" else w[:, off:]
        tol = GRAD_TOL[torch.float32 if name == "dbias" else dtype]
        assert _rel_err(x, w) <= tol, (name, _rel_err(x, w))


@pytest.mark.parametrize("dtype,D", [(torch.bfloat16, 64),
                                     (torch.float32, 48)])
def test_t5_kernels_on_host_take_q_offset(kernels, dtype, D):
    """A sequence-parallel rank's query rows: the kernels on rows 24..47
    of 48 (not a tile's start: the bf16 tiles hold 64 rows) against all 48
    keys, with ``q_offset`` 24 and those rows of the bias, give the plain
    version's full call on those rows, forward and backward, with dropout
    on; without the offset the keep bits are rows 0..23's."""
    g = torch.Generator().manual_seed(D + 1)
    B, H, L, rate, off = 2, 2, 48, 0.3, 24
    q, k, v, do = (torch.randn(s, generator=g).to(dtype) for s in (
        (B, H, L, D), (B, H, L, D), (B, H, L, D), (B, H, L, D)))
    b = torch.randn(H, L, L, generator=g)
    seed = torch.tensor([0x0123_4567_89AB_CDEF], dtype=torch.int64)
    rows = [t[:, :, off:].contiguous() for t in (q, do)]
    out, stats = _forward(kernels["t5_attention_fwd"], rows[0], k, v,
                          b[:, off:].contiguous(), None, rate, seed,
                          q_offset=off)
    want = t5_attention_plain(q, k, v, b, None, rate, seed)[:, :, off:]
    torch.testing.assert_close(out.float(), want.float(), **TOLS[dtype])
    shifted, _ = _forward(kernels["t5_attention_fwd"], rows[0], k, v,
                          b[:, off:].contiguous(), None, rate, seed)
    assert _rel_err(shifted, want) > 0.1
    got = _backward(kernels["t5_attention_bwd"], rows[0], k, v, rows[1],
                    b[:, off:].contiguous(), None, rate, seed, stats, True,
                    q_offset=off)
    # The rows' share of the whole call's gradients: the upstream gradient
    # zero outside them.
    do_rows = torch.zeros_like(do)
    do_rows[:, :, off:] = do[:, :, off:]
    full = t5_attention_bwd_plain(q, k, v, do_rows, b, None, rate, seed,
                                  True)
    for name, x, w in zip(("dq", "dk", "dv", "dbias"), got, full):
        w = (w[:, off:] if name == "dbias" else
             w[:, :, off:] if name == "dq" else w)
        tol = GRAD_TOL[torch.float32 if name == "dbias" else dtype]
        assert _rel_err(x, w) <= tol, (name, _rel_err(x, w))


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("B,H,Q,K,D", [
    (2, 2, 32, 32, 64),   # captioning text tower, small B and H
    (1, 2, 96, 96, 64),   # captioning encoder: three key tiles
    (1, 2, 5, 7, 8),      # ragged, D 8
    (2, 1, 40, 70, 48),   # D 48: a part-filled column chunk
    (1, 1, 33, 17, 128),  # widest head dim
])
def test_t5_fp32_forward_on_host_matches_plain(kernels, rate, B, H, Q, K,
                                               D):
    """The fp32 (captioning) forward: output against the plain version,
    the row stats against the plain logits' row max and sum of exp(logit -
    max), and with dropout the keep bits on uniform probabilities. The last
    batch row is fully masked."""
    g = torch.Generator().manual_seed(B * 1000 + Q * 10 + D)
    q, k, v = (torch.randn(s, generator=g) for s in (
        (B, H, Q, D), (B, H, K, D), (B, H, K, D)))
    b = torch.randn(H, Q, K, generator=g)
    m = torch.ones(B, K, dtype=torch.int32)
    m[0, K // 2:] = 0
    m[-1, :] = 0
    seed = torch.tensor([0x0FED_CBA9_8765_4321], dtype=torch.int64)
    out, stats = _forward(kernels["t5_attention_fwd"], q, k, v, b, m, rate,
                          seed)
    want = t5_attention_plain(q, k, v, b, m, rate, seed)
    torch.testing.assert_close(out, want, **TOLS[torch.float32])
    logits = q @ k.transpose(-1, -2) + b + torch.where(
        m[:, None, None, :] > 0, 0.0, NEG)
    row_max = logits.amax(-1)
    row_sum = torch.exp(logits - row_max[..., None]).sum(-1)
    torch.testing.assert_close(stats[..., 0], row_max, rtol=0.0, atol=1e-4)
    torch.testing.assert_close(stats[..., 1], row_sum, rtol=1e-5, atol=0.0)
    if rate:
        z = torch.zeros_like(q)
        got, _ = _forward(kernels["t5_attention_fwd"], z, k, v, None, None,
                          rate, seed)
        want = t5_attention_plain(z, k, v, None, None, rate, seed)
        torch.testing.assert_close(got, want, **TOLS[torch.float32])


def _swin(fn, q, k, v, scale, bias, wmask, sm_bf16):
    Bn, H, N, D = q.shape
    out = torch.full_like(q, float("nan"))
    nW = 0 if wmask is None else wmask.shape[0]
    err = fn(_ptr(q), _ptr(k), _ptr(v), _ptr(scale), _ptr(bias), _ptr(wmask),
             _ptr(out), Bn, H, N, D, nW, int(q.dtype == torch.bfloat16),
             int(sm_bf16), None)
    assert err == 0
    return out


@pytest.mark.parametrize("sm_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("N,D", [
    (16, 20),   # the tests' window 4; D not a multiple of 8 (bf16 loads
                # element by element)
    (36, 32),   # swinv2-large's last stage: window 6, N padded to 48
    (64, 32),   # window 8: every stage of swinv2-base
    (144, 32),  # swinv2-large's window 12: the wide register tile
])
def test_swin_kernel_on_host_matches_plain(kernels, sm_dtype, dtype, masked,
                                           N, D):
    """The Swin forward against the plain version. Unmasked: 5 windows of 2
    heads; masked: 10 windows (two mask positions) of 1 head. Either way
    blocks take 2 windows each and the last block 1."""
    g = torch.Generator().manual_seed(N * 10 + D)
    Bn, H = (10, 1) if masked else (5, 2)
    q, k, v = (torch.randn(Bn, H, N, D, generator=g).to(dtype)
               for _ in range(3))
    scale = math.log(10.0) + 0.5 * torch.randn(H, generator=g)
    bias = 16 * torch.sigmoid(torch.randn(H, N, N, generator=g))
    wmask = None
    if masked:
        wmask = torch.where(torch.rand(2, N, N, generator=g) < 0.3, -100.0,
                            0.0)
        wmask[:, torch.arange(N), torch.arange(N)] = 0.0
    got = _swin(kernels["swin_attention_fwd"], q, k, v, scale, bias, wmask,
                sm_dtype == torch.bfloat16)
    want = swin_attention_plain(q, k, v, scale, bias, wmask, sm_dtype)
    assert got.dtype == dtype
    if sm_dtype == torch.float32:
        torch.testing.assert_close(got.float(), want.float(), **TOLS[dtype])
        return
    err = (got.float() - want.float()).abs()
    tol = TOLS[torch.bfloat16]
    outside = err > tol["atol"] + tol["rtol"] * want.float().abs()
    assert float(outside.float().mean()) <= 1e-2, float(outside.float().mean())
    assert float(err.mean()) <= 1e-3, float(err.mean())
