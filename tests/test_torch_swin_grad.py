"""The Swin kernel's gradient: ``SwinAttentionFn`` on CPU tensors (the plain
forward, then autograd of the recompute ``swin_attention_reference``)
against ``jax.vjp`` of the JAX package's ``swin_fused_attention`` (its
Pallas forward in interpret mode, its custom VJP's XLA recompute), on the
same numpy inputs: the output, and dq, dk, dv, d(logit scale), d(bias).

Tolerances, each the largest error over the largest value: 1e-5 with fp32
inputs and an fp32 softmax chain (summation order); with bf16 inputs or a
bf16 chain 2e-2 (the bf16 tolerance of the port's other kernel tests: the
two frameworks round the bf16 products and casts at other places, and one
bf16 ulp is 2^-8 of a value). With a bf16 chain, the logit scale's and the
bias's gradients sum bf16 logit gradients over windows (and positions) that
largely cancel: they are held at 1e-1, and the bias's mean error at 2e-2
(the scale's has one value a head, so its mean is its largest). The JAX
package's own recompute, jitted against run op by op, differs on these
inputs by up to 6.8e-2 (the bias's gradient, masked windows) and 1.9e-2
(the scale's)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from klab_multimodalmodel_tpu.ops import set_interpret, swin_fused_attention
from klab_multimodalmodel_tpu_torch.models.swinv2 import shifted_window_mask
from klab_multimodalmodel_tpu_torch.ops import (SwinAttentionFn,
                                                swin_attention,
                                                swin_attention_plain)

TOL_FP32, TOL_BF16 = 1e-5, 2e-2
TOL_BF16_CHAIN_SUMS = dict(max=1e-1, mean=2e-2)  # dscale, dbias (mean)
NAMES = ("out", "dq", "dk", "dv", "dscale", "dbias")


@pytest.fixture(autouse=True)
def interpret_mode():
    set_interpret(True)
    yield
    set_interpret(False)


def _inputs(seed, Bn, H, w, shift):
    g = np.random.default_rng(seed)
    N, D = w * w, 8
    q, k, v, do = (g.standard_normal((Bn, H, N, D)).astype(np.float32)
                   for _ in range(4))
    scale = (np.log(10.0) + g.standard_normal(H)).astype(np.float32)
    scale[0] = 5.0  # above ln(100): the clamp passes no gradient there
    bias = (16.0 / (1 + np.exp(-g.standard_normal((H, N, N))))).astype(
        np.float32)
    wmask = shifted_window_mask(2 * w, 2 * w, w, shift) if shift else None
    return q, k, v, do, scale, bias, wmask


def _rel(got, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.abs(np.asarray(got, np.float32) - want).max()
                 / np.abs(want).max())


@pytest.mark.parametrize("sm", ["float32", "bfloat16"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shift", [0, 2], ids=["unmasked", "masked"])
def test_swin_gradients_match_jax(sm, dtype, shift):
    q, k, v, do, scale, bias, wmask = _inputs(7, 8, 2, 4, shift)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jsm = jnp.bfloat16 if sm == "bfloat16" else jnp.float32
    jq, jk, jv, jdo = (jnp.asarray(a, jdt) for a in (q, k, v, do))
    out, vjp = jax.vjp(
        lambda q, k, v, s, b: swin_fused_attention(q, k, v, s, b, wmask,
                                                   softmax_dtype=jsm),
        jq, jk, jv, jnp.asarray(scale), jnp.asarray(bias))
    want = (out, *vjp(jdo))

    tdt = getattr(torch, dtype)
    tq, tk, tv, tdo = (torch.from_numpy(a).to(tdt) for a in (q, k, v, do))
    leaves = [t.clone().requires_grad_() for t in (
        tq, tk, tv, torch.from_numpy(scale), torch.from_numpy(bias))]
    tmask = None if wmask is None else torch.from_numpy(wmask)
    got_out = swin_attention(*leaves, tmask, softmax_dtype=getattr(torch, sm))
    assert got_out.grad_fn is not None
    assert type(got_out.grad_fn).__name__.startswith("SwinAttentionFn")
    grads = torch.autograd.grad(got_out, leaves, tdo)
    got = (got_out.detach(), *grads)
    for name, g, w in zip(NAMES, got, want):
        assert g.dtype == (tdt if name in ("out", "dq", "dk", "dv")
                           else torch.float32), name
        g = g.float().numpy()
        tol = TOL_FP32 if dtype == sm == "float32" else TOL_BF16
        if sm == "bfloat16" and name in ("dscale", "dbias"):
            tol = TOL_BF16_CHAIN_SUMS["max"]
        if sm == "bfloat16" and name == "dbias":
            w = np.asarray(w, np.float32)
            mean = float(np.abs(g - w).mean() / np.abs(w).max())
            assert mean <= TOL_BF16_CHAIN_SUMS["mean"], (name, mean)
        assert _rel(g, w) <= tol, (name, _rel(g, w))
    # The clamped head's scale takes no gradient, as in JAX.
    assert float(grads[3][0]) == 0.0 and float(np.asarray(want[4])[0]) == 0.0


def test_swin_attention_without_grad_takes_no_function():
    """Without a gradient to compute, the wrapper is the plain forward; with
    one, ``SwinAttentionFn`` gives the same values and only the inputs that
    need a gradient get one."""
    q, k, v, _, scale, bias, wmask = _inputs(8, 8, 2, 4, 2)
    args = [torch.from_numpy(a) for a in (q, k, v, scale, bias, wmask)]
    plain = swin_attention_plain(*args)
    with torch.no_grad():
        assert torch.equal(swin_attention(*args), plain)
    leaves = [a.clone().requires_grad_(i == 4) for i, a in
              enumerate(args[:5])]
    out = SwinAttentionFn.apply(*leaves, args[5], torch.float32)
    assert torch.equal(out.detach(), plain)
    out.sum().backward()
    assert [t.grad is not None for t in leaves] == [False] * 4 + [True]
