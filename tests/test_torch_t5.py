"""The port's T5 against the JAX package's, on tiny v1.0 (tied, ReLU) and
v1.1 (gated tanh-GELU, untied head) sizes, with the kernel flag on (the
JAX side in Pallas interpret mode, the port on its plain version) and off.
fp32, tolerance 1e-5 (summation order)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import _torch_port as tp
import klab_multimodalmodel_tpu.config as jcfg
import klab_multimodalmodel_tpu.models.layers as jlayers
import klab_multimodalmodel_tpu.models.t5 as jt5
from klab_multimodalmodel_tpu.ops import set_interpret
from klab_multimodalmodel_tpu_torch.checkpoint.from_jax import (
    convert_t5_encoder, convert_t5_lm)
from klab_multimodalmodel_tpu_torch.models import layers as tlayers
from klab_multimodalmodel_tpu_torch.models import t5 as tt5
from klab_multimodalmodel_tpu_torch.config import T5Size

TOL = 1e-5


@pytest.fixture(autouse=True)
def interpret_mode():
    set_interpret(True)
    yield
    set_interpret(False)


def _sizes(name):
    kw = tp.T5_NAMES[name][1]
    return jcfg.T5Size(**kw), T5Size(**kw)


def _torch_sd(sd):
    return {k: torch.tensor(v)
            for k, v in sd.items()}


def _batch(rng, B=3, L=12, vocab=512):
    ids = rng.integers(2, vocab, (B, L)).astype(np.int32)
    mask = np.ones((B, L), np.int32)
    mask[1, 7:] = 0
    mask[2, 3:] = 0
    return ids, mask


def test_rmsnorm_matches_jax(rng):
    """Same formula and order (fp32 mean of squares, rsqrt, weight); not
    bit-exact only because XLA's CPU sum and rsqrt round differently from
    torch's, by at most a few ulp (measured ~2e-7 relative)."""
    x = rng.standard_normal((3, 5, 32)).astype(np.float32) * 3
    w = rng.standard_normal(32).astype(np.float32)
    want = jlayers.RMSNorm().apply({"params": {"weight": jnp.asarray(w)}},
                                   jnp.asarray(x))
    norm = tlayers.RMSNorm(32)
    with torch.no_grad():
        norm.weight.copy_(torch.from_numpy(w))
        got = norm(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=0)


@pytest.mark.parametrize("bidirectional", [True, False])
@pytest.mark.parametrize("num_buckets,max_distance", [(32, 128), (8, 16)])
def test_relative_position_bucket_exact(bidirectional, num_buckets,
                                        max_distance):
    rel = np.arange(-300, 301, dtype=np.int32)
    want = jt5.relative_position_bucket(jnp.asarray(rel), bidirectional,
                                        num_buckets, max_distance)
    got = tt5.relative_position_bucket(torch.from_numpy(rel), bidirectional,
                                       num_buckets, max_distance)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("kernels", [True, False])
@pytest.mark.parametrize("name", ["v10", "v11"])
def test_t5_encoder_matches_jax(rng, name, kernels):
    jsize, tsize = _sizes(name)
    ids, mask = _batch(rng)
    jmodel = jt5.T5Encoder(jsize, use_pallas=kernels)
    params = jt5.T5Encoder(jsize).init(jax.random.PRNGKey(1), ids)["params"]
    want = jmodel.apply({"params": params}, ids, attention_mask=mask)

    tmodel = tt5.T5Encoder(tsize, use_pallas=kernels, device="cpu")
    tmodel.load_state_dict(_torch_sd(convert_t5_encoder(
        jax.tree.map(np.asarray, params), tsize)), strict=True)
    with torch.no_grad():
        got = tmodel(torch.from_numpy(ids), attention_mask=torch.from_numpy(
            mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("kernels", [True, False])
@pytest.mark.parametrize("name", ["v10", "v11"])
def test_t5_encode_and_decode_steps_match_jax(rng, name, kernels):
    """``encode``, then ``decode_step`` logits over several steps of a KV
    cache (the first step primes it), each side on its own encoder
    output."""
    jsize, tsize = _sizes(name)
    ids, mask = _batch(rng)
    B, max_len, steps = ids.shape[0], 6, 4
    tokens = rng.integers(0, 512, (B, steps)).astype(np.int32)
    jmodel = jt5.T5ForConditionalGeneration(jsize, use_pallas=kernels)
    params = jt5.T5ForConditionalGeneration(jsize).init(
        jax.random.PRNGKey(2), ids, decoder_input_ids=tokens)["params"]
    tmodel = tt5.T5ForConditionalGeneration(tsize, use_pallas=kernels,
                                            device="cpu")
    tmodel.load_state_dict(_torch_sd(convert_t5_lm(
        jax.tree.map(np.asarray, params), tsize)), strict=True)

    jenc = jmodel.apply({"params": params}, ids, attention_mask=mask,
                        method=jmodel.encode)
    with torch.no_grad():
        tenc = tmodel.encode(torch.from_numpy(ids),
                             attention_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(tenc.numpy(), np.asarray(jenc), rtol=TOL,
                               atol=TOL)

    variables = {"params": params}
    cache = None
    for step in range(steps):
        tok = tokens[:, step:step + 1]
        jlogits, mods = jmodel.apply(
            variables, tok, jnp.asarray(step, jnp.int32), jenc, max_len,
            mask, method=jmodel.decode_step, mutable=["cache"])
        variables = {"params": params, "cache": mods["cache"]}
        with torch.no_grad():
            tlogits, cache = tmodel.decode_step(
                torch.from_numpy(tok), step, tenc, max_len,
                torch.from_numpy(mask), cache=cache)
        np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                                   rtol=TOL, atol=TOL,
                                   err_msg=f"decode step {step}")
