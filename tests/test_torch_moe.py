"""The port's MoE routing and expert FFN (``ops/moe.py``, ``T5MoeMlp``)
against the JAX package's, on seeded inputs in fp32.

- ``moe_capacity`` equal over a grid;
- ``topk_routing`` for top-k 1 and 2, with and without a token mask (one
  group all padding), at the factor's capacity and at one that overflows:
  the assignments (``combine > 0``) exactly, ``combine`` and the aux loss
  within 1e-6, the router's gradient within 1e-5;
- ``moe_ffn`` within 1e-5; ``T5MoeMlp`` (router, capacity, FFN) within 1e-5;
- the anchor: one expert at full capacity is the dense ``T5Mlp``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import klab_multimodalmodel_tpu.config as jcfg
import klab_multimodalmodel_tpu.models.t5 as jt5
from klab_multimodalmodel_tpu.ops import moe as jmoe
from klab_multimodalmodel_tpu_torch.config import T5Size
from klab_multimodalmodel_tpu_torch.models import t5 as tt5
from klab_multimodalmodel_tpu_torch.ops import moe as tmoe

SIZE = dict(d_model=32, d_kv=8, d_ff=64, num_layers=2, num_decoder_layers=2,
            num_heads=4, vocab_size=128, relative_attention_num_buckets=8,
            relative_attention_max_distance=16, dropout_rate=0.0)
G, S, E, D, FF = 3, 16, 4, 16, 24


@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_capacity_matches_jax(top_k):
    for tokens in (1, 2, 5, 16, 128, 320):
        for experts in (1, 2, 3, 4, 8):
            for factor in (0.25, 0.5, 1.0, 1.25, 2.0, 8.0):
                assert (tmoe.moe_capacity(tokens, experts, top_k, factor)
                        == jmoe.moe_capacity(tokens, experts, top_k, factor))


def _routing_inputs(masked: bool):
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((G, S, E)).astype(np.float32) * 2
    mask = None
    if masked:
        mask = np.ones((G, S), np.float32)
        mask[1, 11:] = 0
        mask[1, 3] = 0
        mask[2] = 0  # an all-padding group (a phantom row)
    return logits, mask


@pytest.mark.parametrize("capacity", ["factor", "overflow"])
@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("top_k", [1, 2])
def test_topk_routing_matches_jax(top_k, masked, capacity):
    logits, mask = _routing_inputs(masked)
    cap = (jmoe.moe_capacity(S, E, top_k, 1.25) if capacity == "factor"
           else 2)
    w = np.random.default_rng(2).standard_normal(
        (G, S, E, cap)).astype(np.float32)

    def jax_fn(lg):
        c, aux = jmoe.topk_routing(
            lg, top_k, cap, mask=None if mask is None else jnp.asarray(mask))
        return jnp.sum(c * w) + aux, (c, aux)

    (_, (jc, jaux)), jgrad = jax.value_and_grad(jax_fn, has_aux=True)(
        jnp.asarray(logits))
    lg = torch.tensor(logits, requires_grad=True)
    c, aux = tmoe.topk_routing(
        lg, top_k, cap, mask=None if mask is None else torch.tensor(mask))
    ((c * torch.from_numpy(w)).sum() + aux).backward()
    jc = np.asarray(jc)
    np.testing.assert_array_equal(c.detach().numpy() > 0, jc > 0)
    np.testing.assert_allclose(c.detach().numpy(), jc, rtol=0, atol=1e-6)
    np.testing.assert_allclose(aux.item(), float(jaux), rtol=1e-6)
    np.testing.assert_allclose(lg.grad.numpy(), np.asarray(jgrad), rtol=0,
                               atol=1e-5)
    routed = (jc > 0).any(axis=3).sum(axis=1)  # tokens per (group, expert)
    assert routed.max() <= cap
    if capacity == "overflow":  # some token lost an expert to the capacity
        assert (jc > 0).sum() < top_k * (G * S if mask is None
                                         else mask.sum())
    if masked:
        assert not c[2].any() and not c[1, 11:].any() and not c[1, 3].any()


@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_ffn_matches_jax(top_k):
    rng = np.random.default_rng(3)
    logits, mask = _routing_inputs(True)
    cap = jmoe.moe_capacity(S, E, top_k, 1.0)
    x = rng.standard_normal((G, S, D)).astype(np.float32)
    wi = (rng.standard_normal((E, D, FF)) * D ** -0.5).astype(np.float32)
    wo = (rng.standard_normal((E, FF, D)) * FF ** -0.5).astype(np.float32)
    jc, _ = jmoe.topk_routing(jnp.asarray(logits), top_k, cap,
                              mask=jnp.asarray(mask))
    want = jmoe.moe_ffn(jnp.asarray(x), jc, jnp.asarray(wi), jnp.asarray(wo))
    got = tmoe.moe_ffn(torch.from_numpy(x), torch.from_numpy(np.array(jc)),
                       torch.from_numpy(wi), torch.from_numpy(wo))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
    assert not got[2].any()  # the all-padding group routed nowhere


def test_moe_ffn_dropout_draws_from_the_generator():
    """Dropout in the experts: a property, not JAX's stream. The same
    generator state gives the same output; rate 0.5 zeroes about half of
    the hidden units, so the output moves."""
    rng = np.random.default_rng(4)
    logits, _ = _routing_inputs(False)
    c, _ = tmoe.topk_routing(torch.from_numpy(logits), 1, S)
    x = torch.from_numpy(rng.standard_normal((G, S, D)).astype(np.float32))
    wi = torch.from_numpy(rng.standard_normal((E, D, FF)).astype(np.float32))
    wo = torch.from_numpy(rng.standard_normal((E, FF, D)).astype(np.float32))
    plain = tmoe.moe_ffn(x, c, wi, wo)
    a = tmoe.moe_ffn(x, c, wi, wo, 0.5, torch.Generator().manual_seed(7))
    b = tmoe.moe_ffn(x, c, wi, wo, 0.5, torch.Generator().manual_seed(7))
    assert torch.equal(a, b) and not torch.allclose(a, plain)
    with pytest.raises(ValueError, match="generator"):
        tmoe.moe_ffn(x, c, wi, wo, 0.5, None)


def _mlp_pair(num_experts, top_k, factor):
    """(JAX T5MoeMlp, its params, the port's T5MoeMlp with the same
    weights)."""
    x0 = jnp.zeros((2, S, SIZE["d_model"]), jnp.float32)
    jm = jt5.T5MoeMlp(jcfg.T5Size(**SIZE), num_experts, top_k, factor)
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0),
                                              x0)["params"])
    tm = tt5.T5MoeMlp(T5Size(**SIZE), num_experts, top_k, factor)
    tm.load_state_dict({
        "router.weight": torch.from_numpy(params["router"]["kernel"].T
                                          .copy()),
        "experts_wi": torch.from_numpy(params["experts_wi"]),
        "experts_wo": torch.from_numpy(params["experts_wo"])}, strict=True)
    return jm, params, tm


@pytest.mark.parametrize("top_k", [1, 2])
def test_t5_moe_mlp_matches_jax(top_k):
    jm, params, tm = _mlp_pair(E, top_k, 1.25)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, S, SIZE["d_model"])).astype(np.float32)
    mask = np.ones((2, S), np.float32)
    mask[1, 9:] = 0
    y, aux = jm.apply({"params": params}, jnp.asarray(x),
                      mask=jnp.asarray(mask))
    ty, taux = tm(torch.from_numpy(x), mask=torch.from_numpy(mask))
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(y), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(taux.item(), float(aux), rtol=1e-6)


def test_one_expert_at_full_capacity_is_the_dense_mlp():
    """The anchor (the JAX package's test_moe.py:60): E = 1, capacity S,
    gate 1 for every token: the dense ``T5Mlp`` on the expert's weights,
    and a balance loss of exactly 1."""
    _, params, tm = _mlp_pair(1, 1, 8.0)
    dense = tt5.T5Mlp(T5Size(**SIZE))
    dense.load_state_dict({
        "wi.weight": torch.from_numpy(params["experts_wi"][0].T.copy()),
        "wo.weight": torch.from_numpy(params["experts_wo"][0].T.copy())},
        strict=True)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 8, SIZE["d_model"])).astype(np.float32))
    y, aux = tm(x)
    np.testing.assert_allclose(y.detach().numpy(), dense(x).detach().numpy(),
                               rtol=1e-6, atol=1e-7)
    assert aux.item() == pytest.approx(1.0, rel=1e-6)
