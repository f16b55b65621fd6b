"""The hand-written CUDA kernels against their plain PyTorch versions, on the
card, at small shapes and at the captioning and training paths' shapes.
Skipped without a card; run them there with ``python -m pytest --noconftest
-m cuda tests/test_torch_cuda_kernels.py``.

Tolerances (summation order; bf16 also rounds q, k, the probabilities and
the output, so two near-equal results can round one bf16 ulp apart): 1e-4
absolute in fp32, 2e-2 absolute plus 2e-2 relative in bf16. Gradients are
held by their largest error over their largest value: 1e-4 in fp32, 2e-2 in
bf16 (dS and the dropped probabilities are rounded to bf16 before their
products, and a near-tie can round one bf16 ulp apart), 1e-4 for the bias
gradient in both (it sums the fp32 dS). The forward's row stats: the max
within 1e-4, the sum within 1e-5 relative. The Swin kernel with a bf16
softmax chain: see ``test_swin_bf16_chain_matches_plain``. The Swin
kernel's gradients: see ``test_swin_kernel_gradients_match_the_recompute``.
"""

import pytest
import torch

from klab_multimodalmodel_tpu_torch.models.swinv2 import shifted_window_mask
from klab_multimodalmodel_tpu_torch.ops import (draw_seed, swin_attention,
                                                swin_attention_plain,
                                                swin_attention_reference,
                                                t5_attention,
                                                t5_attention_bwd,
                                                t5_attention_bwd_plain,
                                                t5_attention_fwd,
                                                t5_attention_plain)
from klab_multimodalmodel_tpu_torch.ops.fused_attention import NEG

pytestmark = pytest.mark.cuda
TOLS = {torch.float32: dict(rtol=0.0, atol=1e-4),
        torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}


@pytest.fixture
def cuda():
    # Decided here, never at import: every xdist worker collects the same
    # tests whether or not it sees a card.
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def _rand(gen, shape, dtype, device):
    return torch.randn(shape, generator=gen, device=device).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,Q,K,D", [
    (2, 3, 5, 7, 8),        # small, ragged tiles, D < 32
    (3, 2, 40, 70, 48),     # several query and key tiles, D not /32
    (2, 2, 16, 16, 128),    # widest head dim
    (8, 16, 32, 32, 64),    # text tower
    (8, 16, 96, 96, 64),    # main encoder (64 image + 32 text tokens)
])
def test_t5_kernel_matches_plain(cuda, dtype, B, H, Q, K, D):
    gen = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (_rand(gen, s, dtype, cuda)
               for s in ((B, H, Q, D), (B, H, K, D), (B, H, K, D)))
    bias = _rand(gen, (H, Q, K), torch.float32, cuda)
    kmask = torch.ones(B, K, dtype=torch.int32, device=cuda)
    kmask[0, K // 2:] = 0
    kmask[-1, 1:] = 0
    for b, m in ((bias, kmask), (None, kmask), (bias, None), (None, None)):
        before = t5_attention.launches
        got = t5_attention(q, k, v, b, m)
        torch.cuda.synchronize()
        assert t5_attention.launches == before + 1
        want = t5_attention_plain(q, k, v, b, m)
        assert got.dtype == dtype
        torch.testing.assert_close(got.float(), want.float(), **TOLS[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Bn,H,w,side", [
    (8, 2, 4, 8),       # small: N=16, nW=4
    (512, 4, 8, 64),    # stage 0 at 256 px, batch 8: nW=64
    (128, 8, 8, 32),    # stage 1: nW=16
    (32, 16, 8, 16),    # stage 2: nW=4
    (8, 32, 8, 8),      # stage 3: one window per image, never shifted
])
def test_swin_kernel_matches_plain(cuda, dtype, Bn, H, w, side):
    gen = torch.Generator(device=cuda).manual_seed(1)
    N, D = w * w, 32
    q, k, v = (_rand(gen, (Bn, H, N, D), dtype, cuda) for _ in range(3))
    scale = torch.log(torch.tensor(10.0, device=cuda)) + torch.randn(
        H, generator=gen, device=cuda)
    bias = 16 * torch.sigmoid(_rand(gen, (H, N, N), torch.float32, cuda))
    masks = [None]
    if side > w:
        masks.append(torch.tensor(shifted_window_mask(side, side, w, w // 2),
                                  device=cuda))
    for wm in masks:
        before = swin_attention.launches
        got = swin_attention(q, k, v, scale, bias, wm)
        torch.cuda.synchronize()
        assert swin_attention.launches == before + 1
        want = swin_attention_plain(q, k, v, scale, bias, wm)
        assert got.dtype == dtype
        torch.testing.assert_close(got.float(), want.float(), **TOLS[dtype])


def test_kernel_wrappers_raise_on_bad_inputs(cuda):
    q = torch.zeros(2, 2, 8, 16, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        t5_attention(q.transpose(2, 3).contiguous().transpose(2, 3), q, q)
    with pytest.raises(ValueError, match="kmask"):
        t5_attention(q, q, q, kmask=torch.ones(2, 8, device=cuda))
    with pytest.raises(ValueError):
        t5_attention(q, q.cpu(), q)
    with pytest.raises(ValueError, match="seed"):
        t5_attention(q, q, q, dropout_rate=0.1)
    with pytest.raises(ValueError, match="seed"):
        t5_attention(q, q, q, dropout_rate=0.1,
                     seed=torch.zeros(1, dtype=torch.int32, device=cuda))
    with pytest.raises(ValueError, match="dout"):
        t5_attention_bwd(q, q, q, q[:1])
    with pytest.raises(ValueError, match="stats"):
        t5_attention_bwd(q, q, q, q)  # the forward's row stats are required
    x = torch.zeros(1, 2, 4, 16, device=cuda)
    with pytest.raises(ValueError, match="multiple"):
        swin_attention(x, x, x, torch.zeros(2, device=cuda),
                       torch.zeros(2, 4, 4, device=cuda),
                       torch.zeros(2, 4, 4, device=cuda))
    x = torch.zeros(1, 2, 169, 16, device=cuda)  # a 13 x 13 window
    with pytest.raises(ValueError, match="at most 144 tokens"):
        swin_attention(x, x, x, torch.zeros(2, device=cuda),
                       torch.zeros(2, 169, 169, device=cuda))


def _rel_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max())


GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def _case(gen, cuda, dtype, B, H, Q, K, D, bias, mask):
    q, k, v, do = (_rand(gen, s, dtype, cuda) for s in (
        (B, H, Q, D), (B, H, K, D), (B, H, K, D), (B, H, Q, D)))
    b = _rand(gen, (H, Q, K), torch.float32, cuda) if bias else None
    m = None
    if mask:
        m = torch.ones(B, K, dtype=torch.int32, device=cuda)
        m[0, K // 2:] = 0
        m[-1, :] = 0  # a fully masked row: uniform P, as on the TPU
    return q, k, v, do, b, m


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,Q,K,D", [
    (2, 3, 5, 7, 8),         # ragged tiles, D < 32
    (3, 2, 40, 70, 48),      # several tiles, D not /32
    (2, 2, 16, 16, 128),     # widest head dim
    (4, 16, 128, 128, 64),   # decoder self-attention
    (4, 16, 128, 320, 64),   # cross-attention
    (4, 16, 320, 320, 64),   # main encoder self-attention
])
def test_t5_dropout_forward_matches_plain(cuda, dtype, B, H, Q, K, D):
    gen = torch.Generator(device=cuda).manual_seed(2)
    q, k, v, _, b, m = _case(gen, cuda, dtype, B, H, Q, K, D, True, True)
    seed = draw_seed(gen)
    before = (t5_attention.launches, t5_attention.launches_dropout)
    got = t5_attention(q, k, v, b, m, 0.1, seed)
    torch.cuda.synchronize()
    assert (t5_attention.launches, t5_attention.launches_dropout) == (
        before[0] + 1, before[1] + 1)
    want = t5_attention_plain(q, k, v, b, m, 0.1, seed)
    torch.testing.assert_close(got.float(), want.float(), **TOLS[dtype])
    # Uniform probabilities (q = 0, no bias or mask): every key weighs
    # 1/(0.9 K), so one keep bit that differed from the plain version's
    # would move the output by ~|v|/(0.9 K), far above the tolerance.
    z = torch.zeros_like(q)
    got = t5_attention(z, k, v, None, None, 0.1, seed)
    want = t5_attention_plain(z, k, v, None, None, 0.1, seed)
    torch.testing.assert_close(got.float(), want.float(), **TOLS[dtype])


def test_t5_dropout_keep_fraction(cuda):
    """With q = 0 and v = 1 each output is (kept keys)/(0.9 K): the kernel's
    keep fraction over 8*16*320*320 = 13.1 M probabilities is 0.9 within
    0.001 (1000 standard deviations of a binomial: a wrong threshold or a
    stuck generator, not chance, fails it)."""
    B, H, L, D = 8, 16, 320, 64
    z = torch.zeros(B, H, L, D, device=cuda)
    seed = torch.tensor([12345], dtype=torch.int64, device=cuda)
    out = t5_attention(z, z, torch.ones_like(z), None, None, 0.1, seed)
    frac = float(out[..., 0].double().mean() * 0.9)
    assert abs(frac - 0.9) < 1e-3, frac


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("B,H,Q,K,D,bias,mask", [
    (2, 3, 5, 7, 8, True, True),
    (3, 2, 40, 70, 48, True, True),
    (2, 2, 16, 16, 128, False, True),
    (4, 16, 128, 128, 64, True, False),   # decoder self (relpos + causal)
    (4, 16, 128, 320, 64, False, True),   # cross: key mask, no bias
    (4, 16, 320, 320, 64, True, True),    # main encoder self
])
def test_t5_backward_matches_plain(cuda, dtype, rate, B, H, Q, K, D, bias,
                                   mask):
    gen = torch.Generator(device=cuda).manual_seed(3)
    q, k, v, do, b, m = _case(gen, cuda, dtype, B, H, Q, K, D, bias, mask)
    seed = draw_seed(gen) if rate else None
    want = t5_attention_bwd_plain(q, k, v, do, b, m, rate, seed, bias)
    before = (t5_attention_bwd.launches, t5_attention_bwd.launches_dbias)
    # Directly with the forward's row stats, and through autograd.
    _, stats = t5_attention_fwd(q, k, v, b, m, rate, seed, with_stats=True)
    got = t5_attention_bwd(q, k, v, do, b, m, rate, seed, stats, bias)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    if b is not None:
        leaves.append(b.clone().requires_grad_())
    out = t5_attention(*leaves[:3], leaves[3] if bias else None, m, rate,
                       seed)
    out.backward(do)
    torch.cuda.synchronize()
    assert t5_attention_bwd.launches == before[0] + 2
    assert t5_attention_bwd.launches_dbias == before[1] + 2 * bool(bias)
    auto = [t.grad for t in leaves] + ([] if bias else [None])
    for name, w, g, a in zip(("dq", "dk", "dv", "dbias"), want, got, auto):
        if w is None:
            assert g is None and a is None
            continue
        # dS is fp32 in both versions, so dbias is held at the fp32
        # tolerance in bf16 too.
        tol = GRAD_TOL[torch.float32 if name == "dbias" else dtype]
        assert g.dtype == w.dtype and a.dtype == w.dtype
        assert _rel_err(g, w) <= tol, (name, _rel_err(g, w))
        assert _rel_err(a, w) <= tol, (name, _rel_err(a, w))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,Q,K,D,off", [
    (2, 4, 40, 70, 48, 2),       # ragged tiles
    (4, 16, 320, 320, 128, 16),  # t5-3b's encoder under tensor 2
    (4, 8, 128, 320, 64, 8),     # the text tower's d_kv under tensor 2
])
def test_t5_head_offset_matches_the_full_call(cuda, dtype, B, H, Q, K, D,
                                              off):
    """A tensor rank's heads: the kernels on heads ``off ..`` with
    ``head_offset`` give the plain full call's heads, forward and
    backward, with dropout on."""
    gen = torch.Generator(device=cuda).manual_seed(6)
    q, k, v, do, b, m = _case(gen, cuda, dtype, B, 2 * H, Q, K, D, True,
                              True)
    seed = draw_seed(gen)
    part = [t[:, off:off + H].contiguous() for t in (q, k, v, do)]
    bh = b[off:off + H].contiguous()
    want = t5_attention_plain(q, k, v, b, m, 0.1, seed)[:, off:off + H]
    out, stats = t5_attention_fwd(*part[:3], bh, m, 0.1, seed,
                                  with_stats=True, head_offset=off)
    torch.testing.assert_close(out.float(), want.float(), **TOLS[dtype])
    full = t5_attention_bwd_plain(q, k, v, do, b, m, 0.1, seed, True)
    got = t5_attention_bwd(*part, bh, m, 0.1, seed, stats, True,
                           head_offset=off)
    for name, x, w in zip(("dq", "dk", "dv", "dbias"), got, full):
        w = w[off:off + H] if name == "dbias" else w[:, off:off + H]
        tol = GRAD_TOL[torch.float32 if name == "dbias" else dtype]
        assert _rel_err(x, w) <= tol, (name, _rel_err(x, w))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,Q,K,D,lo", [
    (2, 4, 40, 70, 48, 17),      # ragged tiles, an odd first row
    (4, 16, 320, 320, 64, 160),  # t5-large's encoder, seq rank 1 of 2
    (4, 16, 128, 128, 64, 64),   # its decoder, seq rank 1 of 2
    (4, 16, 128, 320, 64, 64),   # its cross-attention, seq rank 1 of 2
])
def test_t5_q_offset_matches_the_full_call(cuda, dtype, B, H, Q, K, D, lo):
    """A seq rank's query rows: the kernels on rows ``lo ..`` with
    ``q_offset`` and those rows of the bias give the plain full call's
    rows, forward and backward, with dropout on (dk and dv: the share of
    those rows, the full call's with the other rows' upstream gradient
    0)."""
    gen = torch.Generator(device=cuda).manual_seed(8)
    q, k, v, do, b, m = _case(gen, cuda, dtype, B, H, Q, K, D, True, True)
    seed = draw_seed(gen)
    qr, dor = (t[:, :, lo:].contiguous() for t in (q, do))
    br = b[:, lo:].contiguous()
    want = t5_attention_plain(q, k, v, b, m, 0.1, seed)[:, :, lo:]
    out, stats = t5_attention_fwd(qr, k, v, br, m, 0.1, seed,
                                  with_stats=True, q_offset=lo)
    torch.testing.assert_close(out.float(), want.float(), **TOLS[dtype])
    do_rows = torch.zeros_like(do)
    do_rows[:, :, lo:] = do[:, :, lo:]
    full = t5_attention_bwd_plain(q, k, v, do_rows, b, m, 0.1, seed, True)
    got = t5_attention_bwd(qr, k, v, dor, br, m, 0.1, seed, stats, True,
                           q_offset=lo)
    for name, x, w in zip(("dq", "dk", "dv", "dbias"), got, full):
        w = (w[:, lo:] if name == "dbias" else
             w[:, :, lo:] if name == "dq" else w)
        tol = GRAD_TOL[torch.float32 if name == "dbias" else dtype]
        assert _rel_err(x, w) <= tol, (name, _rel_err(x, w))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,Q,K,D,off,lo", [
    (2, 4, 40, 70, 48, 2, 17),       # ragged tiles, an odd first row
    (4, 8, 160, 320, 64, 8, 160),    # t5-large's encoder, tensor x seq rank
    (4, 8, 64, 128, 64, 8, 64),      # its decoder
    (4, 8, 64, 320, 64, 8, 64),      # its cross-attention
])
def test_t5_head_and_q_offsets_match_the_full_call(cuda, dtype, B, H, Q, K,
                                                   D, off, lo):
    """A tensor x seq rank's heads at its query rows: the kernels on heads
    ``off ..`` and rows ``lo ..`` with ``head_offset`` and ``q_offset`` at
    once give the plain full call's heads and rows, forward and backward,
    with dropout on (dk and dv: those rows' share)."""
    gen = torch.Generator(device=cuda).manual_seed(9)
    q, k, v, do, b, m = _case(gen, cuda, dtype, B, 2 * H, lo + Q, K, D,
                              True, True)
    seed = draw_seed(gen)
    heads, rows = slice(off, off + H), slice(lo, lo + Q)
    qr, dor = (t[:, heads, rows].contiguous() for t in (q, do))
    kr, vr = (t[:, heads].contiguous() for t in (k, v))
    br = b[heads, rows].contiguous()
    want = t5_attention_plain(q, k, v, b, m, 0.1, seed)[:, heads, rows]
    out, stats = t5_attention_fwd(qr, kr, vr, br, m, 0.1, seed,
                                  with_stats=True, head_offset=off,
                                  q_offset=lo)
    torch.testing.assert_close(out.float(), want.float(), **TOLS[dtype])
    do_rows = torch.zeros_like(do)
    do_rows[:, :, rows] = do[:, :, rows]
    full = t5_attention_bwd_plain(q, k, v, do_rows, b, m, 0.1, seed, True)
    got = t5_attention_bwd(qr, kr, vr, dor, br, m, 0.1, seed, stats, True,
                           head_offset=off, q_offset=lo)
    for name, x, w in zip(("dq", "dk", "dv", "dbias"), got, full):
        w = (w[heads, rows] if name == "dbias" else
             w[:, heads, rows] if name == "dq" else w[:, heads])
        tol = GRAD_TOL[torch.float32 if name == "dbias" else dtype]
        assert _rel_err(x, w) <= tol, (name, _rel_err(x, w))


def test_t5_dbias_is_bitwise_reproducible(cuda):
    gen = torch.Generator(device=cuda).manual_seed(4)
    q, k, v, do, b, m = _case(gen, cuda, torch.bfloat16, 8, 16, 320, 320,
                              64, True, True)
    seed = draw_seed(gen)
    _, stats = t5_attention_fwd(q, k, v, b, m, 0.1, seed, with_stats=True)
    one = t5_attention_bwd(q, k, v, do, b, m, 0.1, seed, stats, True)
    two = t5_attention_bwd(q, k, v, do, b, m, 0.1, seed, stats, True)
    for x, y in zip(one, two):
        assert torch.equal(x, y)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("B,H,Q,K,D,bias,mask,causal", [
    (2, 2, 65, 65, 64, True, True, False),    # one row and one key past 64
    (2, 2, 127, 321, 64, True, True, False),  # ragged both ways
    (2, 2, 321, 127, 48, True, True, False),  # head dim padded to 48
    (2, 3, 65, 127, 8, False, True, False),   # head dim 8 padded to 16
    (2, 2, 127, 127, 64, True, False, True),  # causal bias, no key mask
])
def test_t5_tensor_core_edges_match_plain(cuda, rate, B, H, Q, K, D, bias,
                                          mask, causal):
    """The bf16 tensor-core kernels (64-row tiles, head dim zero-padded to a
    multiple of 16) at ragged tile edges, with a fully masked row (``_case``
    masks every key of the last batch row) or a causal bias: forward and
    backward against the plain versions at the tolerances above."""
    gen = torch.Generator(device=cuda).manual_seed(6)
    q, k, v, do, b, m = _case(gen, cuda, torch.bfloat16, B, H, Q, K, D, bias,
                              mask)
    if causal:
        i = torch.arange(Q, device=cuda)
        b = b + torch.where(i[:, None] >= i[None, :], 0.0, -1e9)
    seed = draw_seed(gen) if rate else None
    got = t5_attention(q, k, v, b, m, rate, seed)
    torch.cuda.synchronize()
    want = t5_attention_plain(q, k, v, b, m, rate, seed)
    torch.testing.assert_close(got.float(), want.float(),
                               **TOLS[torch.bfloat16])
    _, stats = t5_attention_fwd(q, k, v, b, m, rate, seed, with_stats=True)
    got = t5_attention_bwd(q, k, v, do, b, m, rate, seed, stats, bias)
    torch.cuda.synchronize()
    want = t5_attention_bwd_plain(q, k, v, do, b, m, rate, seed, bias)
    for name, g, w in zip(("dq", "dk", "dv", "dbias"), got, want):
        if w is None:
            assert g is None
            continue
        tol = GRAD_TOL[torch.float32 if name == "dbias" else torch.bfloat16]
        assert g.dtype == w.dtype
        assert _rel_err(g, w) <= tol, (name, _rel_err(g, w))


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_t5_gradients_bitwise_reproducible_at_encoder_shape(cuda, rate):
    """dq, dk, dv and dBias of the bf16 backward at the training encoder's
    shape (batch 32, 16 heads, 320 x 320): no float atomics, so two runs
    give the same bits."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    q, k, v, do, b, m = _case(gen, cuda, torch.bfloat16, 32, 16, 320, 320,
                              64, True, True)
    seed = draw_seed(gen) if rate else None
    _, stats = t5_attention_fwd(q, k, v, b, m, rate, seed, with_stats=True)
    one = t5_attention_bwd(q, k, v, do, b, m, rate, seed, stats, True)
    two = t5_attention_bwd(q, k, v, do, b, m, rate, seed, stats, True)
    for x, y in zip(one, two):
        assert torch.equal(x, y)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Bn,H,w,side", [
    (8, 2, 4, 8),       # small: N=16, nW=4
    (512, 4, 8, 64),    # stage 0 at 256 px, batch 8: nW=64
    (128, 8, 8, 32),    # stage 1: nW=16
    (32, 16, 8, 16),    # stage 2: nW=4
    (8, 32, 8, 8),      # stage 3: one window per image, never shifted
])
def test_swin_bf16_chain_matches_plain(cuda, dtype, Bn, H, w, side):
    """The softmax chain in bf16 (``swin_softmax_dtype='bfloat16'``).
    Both versions round after every step of the chain, but the fp32 dot
    products are summed in another order, so a logit can round one bf16 ulp
    apart; in [32, 64) that ulp (0.25) moves one probability by up to 28 %.
    Such flips are rare. Tolerance: at most 1e-4 of the outputs outside the
    bf16 tolerance (2e-2 + 2e-2 relative), mean error under 1e-3."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    N, D = w * w, 32
    q, k, v = (_rand(gen, (Bn, H, N, D), dtype, cuda) for _ in range(3))
    scale = torch.log(torch.tensor(10.0, device=cuda)) + torch.randn(
        H, generator=gen, device=cuda)
    bias = 16 * torch.sigmoid(_rand(gen, (H, N, N), torch.float32, cuda))
    masks = [None]
    if side > w:
        masks.append(torch.tensor(shifted_window_mask(side, side, w, w // 2),
                                  device=cuda))
    for wm in masks:
        got = swin_attention(q, k, v, scale, bias, wm,
                             softmax_dtype=torch.bfloat16)
        torch.cuda.synchronize()
        want = swin_attention_plain(q, k, v, scale, bias, wm,
                                    softmax_dtype=torch.bfloat16)
        _assert_bf16_chain_close(got, want)


def _assert_bf16_chain_close(got, want):
    err = (got.float() - want.float()).abs()
    outside = float((err > 2e-2 + 2e-2 * want.float().abs()).float().mean())
    assert outside <= 1e-4 and float(err.mean()) <= 1e-3, (
        outside, float(err.mean()), float(err.max()))


@pytest.mark.parametrize("sm_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Bn,H,w,side", [
    (32, 4, 6, 12),    # swinv2-large's last stage: N=36 (padded to 48), nW=4
    (32, 4, 12, 24),   # swinv2-large's window 12: N=144, nW=4
    (132, 16, 8, 16),  # Bn H = 2112: two windows a block, 33 a mask
                       # position, so the last block of each takes one
    (65, 32, 8, 8),    # unmasked, 65 windows two a block: the last takes one
])
def test_swin_kernel_wide_windows_and_grouping_match_plain(
        cuda, sm_dtype, dtype, Bn, H, w, side):
    """Window sizes beyond swinv2-base's (N = 36 and 144, the second in the
    kernel's wide register tile) and launches that group windows into
    blocks with a ragged last group, in both chains, against the plain
    version at the tolerances above."""
    gen = torch.Generator(device=cuda).manual_seed(8)
    N, D = w * w, 32
    q, k, v = (_rand(gen, (Bn, H, N, D), dtype, cuda) for _ in range(3))
    scale = torch.log(torch.tensor(10.0, device=cuda)) + torch.randn(
        H, generator=gen, device=cuda)
    bias = 16 * torch.sigmoid(_rand(gen, (H, N, N), torch.float32, cuda))
    masks = [None]
    if side > w:
        masks.append(torch.tensor(shifted_window_mask(side, side, w, w // 2),
                                  device=cuda))
    for wm in masks:
        got = swin_attention(q, k, v, scale, bias, wm, softmax_dtype=sm_dtype)
        torch.cuda.synchronize()
        want = swin_attention_plain(q, k, v, scale, bias, wm, sm_dtype)
        assert got.dtype == dtype
        if sm_dtype == torch.bfloat16:
            _assert_bf16_chain_close(got, want)
        else:
            torch.testing.assert_close(got.float(), want.float(),
                                       **TOLS[dtype])


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("B,H,Q,K,D", [
    (2, 3, 5, 7, 8),        # ragged, D 8
    (8, 16, 32, 32, 64),    # captioning text tower
    (8, 16, 96, 96, 64),    # captioning encoder
])
def test_t5_fp32_forward_stats_and_dropout(cuda, rate, B, H, Q, K, D):
    """The fp32 forward at the captioning geometry: output against the plain
    version, the row stats against the plain logits' row max and sum of
    exp(logit - max) (the last batch row fully masked), and at rate 0.1 the
    keep bits on uniform probabilities."""
    gen = torch.Generator(device=cuda).manual_seed(9)
    q, k, v, _, b, m = _case(gen, cuda, torch.float32, B, H, Q, K, D, True,
                             True)
    seed = draw_seed(gen) if rate else None
    got, stats = t5_attention_fwd(q, k, v, b, m, rate, seed, with_stats=True)
    torch.cuda.synchronize()
    want = t5_attention_plain(q, k, v, b, m, rate, seed)
    torch.testing.assert_close(got, want, **TOLS[torch.float32])
    logits = q @ k.transpose(-1, -2) + b + torch.where(
        m[:, None, None, :] > 0, 0.0, NEG)
    row_max = logits.amax(-1)
    row_sum = torch.exp(logits - row_max[..., None]).sum(-1)
    torch.testing.assert_close(stats[..., 0], row_max, rtol=0.0, atol=1e-4)
    torch.testing.assert_close(stats[..., 1], row_sum, rtol=1e-5, atol=0.0)
    if rate:
        z = torch.zeros_like(q)
        got = t5_attention(z, k, v, None, None, rate, seed)
        want = t5_attention_plain(z, k, v, None, None, rate, seed)
        torch.testing.assert_close(got, want, **TOLS[torch.float32])


@pytest.mark.parametrize("sm_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Bn,H,side", [
    (2048, 4, 64),   # stage 0 of a batch-32 training step: nW=64
    (128, 16, 16),   # stage 2: nW=4
])
def test_swin_kernel_gradients_match_the_recompute(cuda, sm_dtype, Bn, H,
                                                   side):
    """``swin_attention`` on bf16 CUDA tensors that require grad (the
    training tower): the forward launches the kernel once and holds its
    plain version's tolerance; the gradients (``SwinAttentionFn``'s
    backward, autograd of ``swin_attention_reference``) equal autograd of
    the recompute on the same inputs within 1e-6 of their largest value:
    the same operations, so only the order of a reduction could differ."""
    gen = torch.Generator(device=cuda).manual_seed(10)
    w, D = 8, 32
    N = w * w
    q, k, v, do = (_rand(gen, (Bn, H, N, D), torch.bfloat16, cuda)
                   for _ in range(4))
    scale = torch.log(torch.tensor(10.0, device=cuda)) + torch.randn(
        H, generator=gen, device=cuda)
    bias = 16 * torch.sigmoid(_rand(gen, (H, N, N), torch.float32, cuda))
    wmask = torch.tensor(shifted_window_mask(side, side, w, w // 2),
                         device=cuda)
    for wm in (None, wmask):
        leaves = [t.clone().requires_grad_() for t in (q, k, v, scale, bias)]
        before = swin_attention.launches
        out = swin_attention(*leaves, wm, softmax_dtype=sm_dtype)
        assert swin_attention.launches == before + 1
        assert out.grad_fn is not None
        got = torch.autograd.grad(out, leaves, do)
        torch.cuda.synchronize()
        want_out = swin_attention_plain(q, k, v, scale, bias, wm, sm_dtype)
        if sm_dtype == torch.bfloat16:
            _assert_bf16_chain_close(out.detach(), want_out)
        else:
            torch.testing.assert_close(out.detach().float(), want_out.float(),
                                       **TOLS[torch.bfloat16])
        ref = [t.clone().requires_grad_() for t in (q, k, v, scale, bias)]
        want = torch.autograd.grad(
            swin_attention_reference(*ref, wm, sm_dtype), ref, do)
        for name, g, w_ in zip(("dq", "dk", "dv", "dscale", "dbias"), got,
                               want):
            assert g.dtype == w_.dtype and g.shape == w_.shape, name
            assert _rel_err(g, w_) <= 1e-6, (name, _rel_err(g, w_))
