"""The port's plain attention forwards against the JAX package's Pallas
kernels (interpret mode on the CPU), and the wrappers' refusals (the
backward and dropout: tests/test_torch_attention_bwd.py). The CUDA
kernels themselves are held against these plain versions on the card
(tests/test_torch_cuda_kernels.py, chip_smoke.py)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from klab_multimodalmodel_tpu.ops import (set_interpret, swin_fused_attention,
                                          t5_fused_attention)
from klab_multimodalmodel_tpu_torch.models.swinv2 import shifted_window_mask
from klab_multimodalmodel_tpu_torch.ops import (swin_attention,
                                                swin_attention_plain,
                                                t5_attention,
                                                t5_attention_bwd,
                                                t5_attention_plain)

TOL = 2e-5  # fp32, summation order (as tests/test_fused_attention.py)


@pytest.fixture(autouse=True)
def interpret_mode():
    set_interpret(True)
    yield
    set_interpret(False)


def _t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.mark.parametrize("B,H,Q,K,D,bias,mask", [
    (4, 2, 16, 16, 8, True, True),     # self-attention, key mask
    (4, 2, 8, 24, 8, True, True),      # Q != K (cross-attention shape)
    (2, 3, 12, 20, 16, False, True),   # mask only, odd lengths
    (3, 2, 10, 10, 8, True, False),    # bias only
])
def test_t5_plain_matches_pallas(rng, B, H, Q, K, D, bias, mask):
    q = rng.standard_normal((B, H, Q, D)).astype(np.float32)
    k = rng.standard_normal((B, H, K, D)).astype(np.float32)
    v = rng.standard_normal((B, H, K, D)).astype(np.float32)
    b = rng.standard_normal((H, Q, K)).astype(np.float32) if bias else None
    km = None
    if mask:
        km = np.ones((B, K), np.int32)
        km[0, K // 2:] = 0
        km[-1, 1:] = 0
    want = t5_fused_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              None if b is None else jnp.asarray(b),
                              None if km is None else jnp.asarray(km))
    got = t5_attention_plain(_t(q), _t(k), _t(v),
                             None if b is None else _t(b),
                             None if km is None else _t(km))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    # On CPU tensors the wrapper is the plain version.
    via_wrapper = t5_attention(_t(q), _t(k), _t(v),
                               None if b is None else _t(b),
                               None if km is None else _t(km))
    np.testing.assert_array_equal(via_wrapper.numpy(), got.numpy())


@pytest.mark.parametrize("Bn,H,w,shift", [
    (8, 2, 4, 0),     # unshifted
    (8, 2, 4, 2),     # shifted: nW=4 masks over 8 windows
    (4, 3, 4, 2),     # shifted, one image
    (8, 4, 2, 1),     # N=4 windows, nW=4
])
def test_swin_plain_matches_pallas(rng, Bn, H, w, shift):
    N, D = w * w, 8
    q = rng.standard_normal((Bn, H, N, D)).astype(np.float32)
    k = rng.standard_normal((Bn, H, N, D)).astype(np.float32)
    v = rng.standard_normal((Bn, H, N, D)).astype(np.float32)
    scale = (np.log(10.0) + rng.standard_normal(H)).astype(np.float32)
    scale[0] = 6.0  # above ln(100): exercises the clamp
    bias = (16.0 / (1 + np.exp(-rng.standard_normal((H, N, N))))).astype(
        np.float32)
    wmask = shifted_window_mask(2 * w, 2 * w, w, shift) if shift else None
    want = swin_fused_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), jnp.asarray(scale),
                                jnp.asarray(bias), wmask)
    got = swin_attention_plain(_t(q), _t(k), _t(v), _t(scale), _t(bias),
                               None if wmask is None else _t(wmask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


def test_bf16_plain_matches_pallas(rng):
    """bf16 inputs: fp32 logits/softmax, output in bf16 (tolerance: bf16
    rounding of the probabilities and output, 2e-2)."""
    B, H, L, D = 2, 2, 16, 8
    arrs = [rng.standard_normal((B, H, L, D)).astype(np.float32)
            for _ in range(3)]
    bias = rng.standard_normal((H, L, L)).astype(np.float32)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in arrs)
    tq, tk, tv = (_t(a).to(torch.bfloat16) for a in arrs)
    want = t5_fused_attention(jq, jk, jv, jnp.asarray(bias))
    got = t5_attention_plain(tq, tk, tv, _t(bias))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=2e-2,
                               rtol=2e-2)
    scale = np.full(H, np.log(10.0), np.float32)
    want = swin_fused_attention(jq, jk, jv, jnp.asarray(scale),
                                jnp.asarray(bias))
    got = swin_attention_plain(tq, tk, tv, _t(scale), _t(bias))
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=2e-2,
                               rtol=2e-2)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    x = torch.zeros(1, 1, 4, 8)
    seed = torch.zeros(1, dtype=torch.int64)
    with pytest.raises(ValueError, match="seed"):
        t5_attention(x, x, x, dropout_rate=0.1)  # rate > 0 needs a seed
    for rate in (-0.1, 1.0):
        with pytest.raises(ValueError, match="rate"):
            t5_attention(x, x, x, dropout_rate=rate, seed=seed)
    with pytest.raises(ValueError, match="need_dbias"):
        t5_attention_bwd(x, x, x, x, need_dbias=True)  # no bias given
    with pytest.raises(ValueError, match="softmax_dtype"):
        swin_attention(x, x, x, torch.zeros(1), torch.zeros(1, 4, 4),
                       softmax_dtype=torch.float16)
    # A tensor that is neither on the CPU nor on a card is refused, never
    # handed to the plain version.
    m = torch.zeros(1, 1, 4, 8, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        t5_attention(m, m, m)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        t5_attention_bwd(m, m, m, m)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        swin_attention(m, m, m, torch.zeros(1, device="meta"),
                       torch.zeros(1, 4, 4, device="meta"))
