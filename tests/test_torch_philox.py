"""The attention dropout's random bits: the plain Philox4x32-10 against
Random123's known-answer vectors, the keep bits' fraction and their
independence from the shape they are drawn at, the plain backward at rate
0.1 against autograd of the plain forward under the same mask, the SwinV2
bf16 softmax chain against the JAX package's, and the ``dropout`` helper of
the layers. The CUDA kernels draw the same bits on the card
(tests/test_torch_cuda_kernels.py)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from klab_multimodalmodel_tpu.ops import set_interpret, swin_fused_attention
from klab_multimodalmodel_tpu_torch.models.layers import (
    dot_product_attention, dropout)
from klab_multimodalmodel_tpu_torch.models.swinv2 import shifted_window_mask
from klab_multimodalmodel_tpu_torch.ops import (draw_seed, dropout_keep_mask,
                                                philox4x32_10,
                                                swin_attention_plain,
                                                t5_attention_bwd_plain,
                                                t5_attention_plain)
from klab_multimodalmodel_tpu_torch.ops.fused_attention import (
    dropout_threshold)

# Random123 kat_vectors, philox4x32_10: (counter, key, output).
KAT = [
    ((0, 0, 0, 0), (0, 0),
     (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]


def _words(vals):
    return tuple(torch.tensor(v, dtype=torch.int64) for v in vals)


@pytest.mark.parametrize("counter,key,want", KAT)
def test_philox_known_answers(counter, key, want):
    got = philox4x32_10(_words(counter), _words(key))
    assert tuple(int(w) for w in got) == want


def test_philox_broadcasts_like_elementwise_calls():
    """A batched call gives, element by element, the words of scalar
    calls (the plain keep mask relies on broadcasting the counter)."""
    g = np.random.default_rng(0)
    ctr = g.integers(0, 2 ** 32, (4, 16), dtype=np.int64)
    key = g.integers(0, 2 ** 32, (2,), dtype=np.int64)
    batched = philox4x32_10(tuple(torch.from_numpy(c) for c in ctr),
                            _words(key))
    for j in (0, 7, 15):
        one = philox4x32_10(_words(ctr[:, j]), _words(key))
        assert [int(w[j]) for w in batched] == [int(w) for w in one]


def test_keep_fraction_and_threshold():
    assert dropout_threshold(0.1) == 429496729  # floor(0.1 * 2^32)
    seed = torch.tensor([987654321012345], dtype=torch.int64)
    keep = dropout_keep_mask(seed, 0.1, (4, 8, 128, 160))  # 655,360 bits
    frac = float(keep.double().mean())
    # Binomial standard deviation sqrt(0.09 / 655360) = 3.7e-4.
    assert abs(frac - 0.9) < 2e-3, frac


def test_keep_bits_do_not_depend_on_the_shape_drawn():
    """The bit of (b, h, q, k) is a function of (seed, b, h, q, k) alone:
    a smaller draw is a corner of a larger one (the forward and backward
    kernels tile differently and must agree)."""
    seed = torch.tensor([42], dtype=torch.int64)
    big = dropout_keep_mask(seed, 0.1, (3, 4, 10, 13))
    small = dropout_keep_mask(seed, 0.1, (2, 3, 7, 6))
    assert torch.equal(big[:2, :3, :7, :6], small)
    other = dropout_keep_mask(seed + 1, 0.1, (3, 4, 10, 13))
    assert not torch.equal(big, other)


def test_seed_comes_from_the_generator():
    a = draw_seed(torch.Generator().manual_seed(5))
    b = draw_seed(torch.Generator().manual_seed(5))
    assert a.dtype == torch.int64 and a.shape == (1,) and torch.equal(a, b)
    assert int(a) >= 0


@pytest.mark.parametrize("with_bias", [True, False])
def test_plain_backward_with_dropout_matches_autograd(with_bias):
    """At rate 0.1 the plain backward (the kernel's math, written out) gives
    autograd's gradients of the plain forward under the same mask; the
    forward and the backward draw the same bits. fp32, tolerance 1e-5
    (summation order)."""
    g = torch.Generator().manual_seed(0)
    B, H, Q, K, D = 3, 2, 9, 14, 8
    q, k, v, do = (torch.randn(s, generator=g, dtype=torch.float64).float()
                   for s in ((B, H, Q, D), (B, H, K, D), (B, H, K, D),
                             (B, H, Q, D)))
    bias = torch.randn(H, Q, K, generator=g) if with_bias else None
    km = torch.ones(B, K, dtype=torch.int32)
    km[2, 4:] = 0
    seed = draw_seed(g)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    if with_bias:
        leaves.append(bias.clone().requires_grad_())
    out = t5_attention_plain(*leaves[:3], leaves[3] if with_bias else None,
                             km, 0.1, seed)
    auto = torch.autograd.grad(out, leaves, do)
    got = t5_attention_bwd_plain(q, k, v, do, bias, km, 0.1, seed,
                                 with_bias)
    for a, w in zip(auto, got):
        torch.testing.assert_close(w, a, rtol=1e-5, atol=1e-5)
    # The mask changes the output: rate 0.1 is not rate 0.
    assert not torch.allclose(out, t5_attention_plain(q, k, v, bias, km))


@pytest.mark.parametrize("shift", [0, 2])
def test_swin_bf16_chain_matches_pallas(rng, shift):
    """``softmax_dtype=bfloat16`` of the plain Swin attention against the
    JAX kernel's bf16 chain (interpret mode). Both round after every step,
    in another summation order: a logit can round one bf16 ulp apart, which
    moves its probability by up to ~28 % at logits in [32, 64). Such flips
    are rare. Tolerance: at most 1 % of these 1,024 outputs outside the bf16
    tolerance (2e-2 + 2e-2 relative), mean error under 5e-3."""
    set_interpret(True)
    try:
        Bn, H, w, D = 8, 2, 4, 8
        N = w * w
        q, k, v = (rng.standard_normal((Bn, H, N, D)).astype(np.float32)
                   for _ in range(3))
        scale = (np.log(10.0) + rng.standard_normal(H)).astype(np.float32)
        bias = (16.0 / (1 + np.exp(-rng.standard_normal((H, N, N))))
                ).astype(np.float32)
        wmask = shifted_window_mask(2 * w, 2 * w, w, shift) if shift else None
        want = swin_fused_attention(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), jnp.asarray(scale),
                                    jnp.asarray(bias), wmask,
                                    softmax_dtype=jnp.bfloat16)
    finally:
        set_interpret(False)
    t = torch.from_numpy
    got = swin_attention_plain(t(q), t(k), t(v), t(scale), t(bias),
                               None if wmask is None else t(wmask),
                               softmax_dtype=torch.bfloat16)
    want = np.asarray(want, np.float32)
    err = np.abs(got.numpy() - want)
    outside = float((err > 2e-2 + 2e-2 * np.abs(want)).mean())
    assert outside <= 1e-2 and err.mean() <= 5e-3, (outside, err.mean(),
                                                    err.max())


def test_dropout_helper():
    x = torch.ones(200, 500, dtype=torch.bfloat16)
    assert dropout(x, 0.0, None) is x
    with pytest.raises(ValueError, match="generator"):
        dropout(x, 0.1, None)
    a = dropout(x, 0.1, torch.Generator().manual_seed(3))
    b = dropout(x, 0.1, torch.Generator().manual_seed(3))
    assert a.dtype == torch.bfloat16 and torch.equal(a, b)
    kept = a != 0
    assert abs(float(kept.float().mean()) - 0.9) < 5e-3
    # Kept values are x / (1 - rate) with 1 - rate formed in x's dtype, as
    # flax divides by the weakly typed keep probability.
    scale = torch.tensor(0.9, dtype=torch.bfloat16)
    assert torch.equal(a[kept], (x / scale)[kept])


def test_reference_attention_drops_the_probabilities():
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 2, 6, 4, generator=g) for _ in range(3))
    plain = dot_product_attention(q, k, v)
    assert torch.equal(dot_product_attention(q, k, v, dropout_rate=0.0,
                                             generator=g), plain)
    a = dot_product_attention(q, k, v, dropout_rate=0.5,
                              generator=torch.Generator().manual_seed(1))
    b = dot_product_attention(q, k, v, dropout_rate=0.5,
                              generator=torch.Generator().manual_seed(1))
    assert torch.equal(a, b) and not torch.allclose(a, plain)
