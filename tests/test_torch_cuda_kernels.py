"""The hand-written CUDA kernels against their plain PyTorch versions, on the
card, at small shapes and at the captioning path's shapes. Skipped without
a card; run them there with ``python -m pytest -m cuda
tests/test_torch_cuda_kernels.py``.

Tolerances (summation order; bf16 also rounds q, k, the probabilities and
the output, so two near-equal results can round one bf16 ulp apart): 1e-4
absolute in fp32, 2e-2 absolute plus 2e-2 relative in bf16.
"""

import pytest
import torch

from klab_multimodalmodel_tpu_torch.models.swinv2 import shifted_window_mask
from klab_multimodalmodel_tpu_torch.ops import (swin_attention,
                                                swin_attention_plain,
                                                t5_attention,
                                                t5_attention_plain)

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
    with pytest.raises(NotImplementedError):
        t5_attention(q, q, q, dropout_rate=0.1)
    x = torch.zeros(1, 2, 4, 16, device=cuda)
    with pytest.raises(ValueError, match="multiple"):
        swin_attention(x, x, x, torch.zeros(2, device=cuda),
                       torch.zeros(2, 4, 4, device=cuda),
                       torch.zeros(2, 4, 4, device=cuda))
