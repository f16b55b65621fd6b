"""The port's plain T5 attention backward against the JAX package's Pallas
backward kernel (``jax.vjp`` of ``t5_fused_attention``, interpret mode on the
CPU), and the autograd wiring of ``t5_attention`` on CPU tensors. The CUDA
backward is held against this plain version on the card
(tests/test_torch_cuda_kernels.py, chip_smoke.py).

Tolerances, as the largest error over the largest value of each gradient:
1e-5 in fp32 (summation order), 2e-2 in bf16 (dS and the probabilities are
rounded to bf16 before their products, in another summation order).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from klab_multimodalmodel_tpu.ops import (pick_group, set_interpret,
                                          t5_fused_attention)
from klab_multimodalmodel_tpu_torch.ops import (draw_seed, t5_attention,
                                                t5_attention_bwd,
                                                t5_attention_bwd_plain)

TOL = {np.float32: 1e-5, jnp.bfloat16: 2e-2}


@pytest.fixture(autouse=True)
def interpret_mode():
    set_interpret(True)
    yield
    set_interpret(False)


def _rel(got: torch.Tensor, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.abs(got.float().numpy() - want).max()
                 / np.abs(want).max())


CASES = {
    # B, H, Q, K, D, bias, key mask, a fully masked row
    "self_grouped": (4, 2, 16, 16, 8, True, True, False),
    "cross_no_bias": (4, 2, 8, 24, 8, False, True, False),
    "cross_bias": (4, 2, 8, 24, 8, True, True, False),
    "fully_masked_row": (3, 2, 200, 200, 8, True, True, True),
    "bias_only": (2, 3, 12, 20, 16, True, False, False),
    "neither": (3, 2, 10, 10, 8, False, False, False),
}


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", list(CASES))
def test_plain_backward_matches_pallas_vjp(rng, case, dtype):
    B, H, Q, K, D, bias, mask, full = CASES[case]
    if case == "self_grouped":
        assert pick_group(B, Q, K) > 1  # the TPU kernel packs batch rows
    if full:
        # A fully masked row is uniform only without batch packing.
        assert pick_group(B, Q, K) == 1
    arrs = [rng.standard_normal(s).astype(np.float32) for s in (
        (B, H, Q, D), (B, H, K, D), (B, H, K, D), (B, H, Q, D))]
    b = rng.standard_normal((H, Q, K)).astype(np.float32) if bias else None
    km = None
    if mask:
        km = np.ones((B, K), np.int32)
        km[0, K // 2:] = 0
        if full:
            km[-1, :] = 0
    jq, jk, jv, jdo = (jnp.asarray(a, dtype) for a in arrs)
    jkm = None if km is None else jnp.asarray(km)
    if bias:
        _, vjp = jax.vjp(lambda q, k, v, b: t5_fused_attention(
            q, k, v, b, jkm), jq, jk, jv, jnp.asarray(b))
    else:
        _, vjp = jax.vjp(lambda q, k, v: t5_fused_attention(
            q, k, v, None, jkm), jq, jk, jv)
    want = vjp(jdo)

    tdt = torch.float32 if dtype == np.float32 else torch.bfloat16
    tq, tk, tv, tdo = (torch.from_numpy(a).to(tdt) for a in arrs)
    tb = None if b is None else torch.from_numpy(b)
    tkm = None if km is None else torch.from_numpy(km)
    got = t5_attention_bwd_plain(tq, tk, tv, tdo, tb, tkm,
                                 need_dbias=bias)
    tol = TOL[dtype]
    for name, g, w in zip(("dq", "dk", "dv", "dbias"), got, want):
        assert g.dtype == (torch.float32 if name == "dbias" else tdt)
        # dbias sums the fp32 dS in both packages.
        t = TOL[np.float32] if name == "dbias" else tol
        assert _rel(g, w) <= t, (name, _rel(g, w))
    if not bias:
        assert got[3] is None


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("with_bias", [True, False])
def test_autograd_on_cpu_runs_the_plain_backward(rate, with_bias):
    """``t5_attention`` on CPU tensors that need a gradient goes through
    ``T5AttentionFn``: its gradients are exactly the plain backward's, the
    bias gradient included, and the wrapper's own backward is the same
    function."""
    g = torch.Generator().manual_seed(0)
    B, H, Q, K, D = 2, 3, 6, 9, 8
    q, k, v, do = (torch.randn(s, generator=g) for s in (
        (B, H, Q, D), (B, H, K, D), (B, H, K, D), (B, H, Q, D)))
    bias = torch.randn(H, Q, K, generator=g) if with_bias else None
    km = torch.ones(B, K, dtype=torch.int32)
    km[1, 5:] = 0
    seed = draw_seed(g) if rate else None
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    b_leaf = None if bias is None else bias.clone().requires_grad_()
    out = t5_attention(*leaves, b_leaf, km, rate, seed)
    assert out.grad_fn is not None
    out.backward(do)
    want = t5_attention_bwd_plain(q, k, v, do, bias, km, rate, seed,
                                  with_bias)
    via_wrapper = t5_attention_bwd(q, k, v, do, bias, km, rate, seed,
                                   need_dbias=with_bias)
    grads = [t.grad for t in leaves] + [None if b_leaf is None
                                        else b_leaf.grad]
    for got, w, wr in zip(grads, want, via_wrapper):
        if w is None:
            assert got is None and wr is None
            continue
        assert torch.equal(got, w) and torch.equal(wr, w)


def test_no_graph_without_gradients():
    """Inputs that need no gradient take the forward alone: no autograd
    node, and the same values as with one."""
    g = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn(2, 2, 5, 8, generator=g) for _ in range(3))
    out = t5_attention(q, k, v)
    assert out.grad_fn is None
    with_grad = t5_attention(q.clone().requires_grad_(), k, v)
    assert with_grad.grad_fn is not None
    assert torch.equal(out, with_grad.detach())
