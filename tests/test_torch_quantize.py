"""The port's int8 weight-only decode (``infer/quantize.py``,
``KlabDense``'s ``qscale``, the int8 tied head) against the JAX package's
``infer/quantize.py``:

- ``Q`` and ``s`` of every dense weight, and of the tied head, equal the
  JAX package's bitwise (after the (in, out) -> (out, in) transpose);
- int8 decode logits (bf16-cast remaining leaves, fp32 compute) against
  the JAX package's int8 decode within ``INT8_VS_JAX_TOL``: both compute
  the same fp32 products, so the gap is the frameworks' fp32 summation
  order, as for the fp32 decode;
- int8 decode against the same model holding ``Q s`` as fp32 weights
  within ``DEQUANT_TOL`` (``x (Q s)^T`` against ``(x Q^T) s``: float
  rounding only);
- the engine and the Captioner on the int8 copy.
"""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import _torch_port as tp
from klab_multimodalmodel_tpu_torch.checkpoint.from_jax import convert_t5_lm
from klab_multimodalmodel_tpu_torch.infer import generate as tgen
from klab_multimodalmodel_tpu_torch.infer import quantize as tq
from klab_multimodalmodel_tpu_torch.infer.captioner import Captioner
from klab_multimodalmodel_tpu_torch.infer.engine import DecodeEngine
from klab_multimodalmodel_tpu_torch.models.t5 import KlabDense
from klab_multimodalmodel_tpu_torch.text import ByteTokenizer

jq = importlib.import_module("klab_multimodalmodel_tpu.infer.quantize")
jgen = importlib.import_module("klab_multimodalmodel_tpu.infer.generate")

INT8_VS_JAX_TOL = 1e-4
DEQUANT_TOL = 1e-5
SRC, D, L = 6, 32, 8


@pytest.fixture(scope="module", params=["v10", "v11"])
def lm(request):
    return tp.jax_t5_lm(request.param, seed=7, src=SRC)


def test_quantize_kernel_bitwise_and_zero_rows():
    rng = np.random.default_rng(0)
    w = rng.standard_normal((3, 24, 40)).astype(np.float32)  # (.., out, in)
    w[1, 5] = 0.0
    q, s = tq.quantize_kernel(w)
    jq_, js = jq.quantize_kernel(np.swapaxes(w, -1, -2))
    assert q.dtype == np.int8 and s.dtype == np.float32
    np.testing.assert_array_equal(q, np.swapaxes(jq_, -1, -2))
    np.testing.assert_array_equal(s, js)
    assert s[1, 5] == 1.0 and (q[1, 5] == 0).all()
    np.testing.assert_array_equal(tq.dequantize_kernel(q, s),
                                  np.swapaxes(jq.dequantize_kernel(jq_, js),
                                              -1, -2))


def test_int8_tree_and_head_bitwise_match_jax(lm):
    _, params, model = lm
    jparams_q, jscale = jq.quantize_transformer_int8(params, int8_head=True)
    qmodel = tq.quantize_for_decode(model, int8_head=True)
    want_q = convert_t5_lm(jparams_q, model.size)  # int8 grids as float
    n = 0
    for name, mod in qmodel.named_modules():
        if isinstance(mod, KlabDense):
            assert mod.weight.dtype == torch.int8, name
            np.testing.assert_array_equal(mod.weight.float().numpy(),
                                          want_q[f"{name}.weight"])
            orig = model.get_submodule(name).weight.detach().numpy()
            np.testing.assert_array_equal(mod.qscale.numpy(),
                                          jq.quantize_kernel(orig.T)[1])
            n += 1
    mlp = 3 if model.size.feed_forward_proj.startswith("gated") else 2
    tied = model.size.tie_word_embeddings
    assert n == (4 + mlp) * 2 + (8 + mlp) * 2 + (0 if tied else 1)
    if model.size.tie_word_embeddings:
        np.testing.assert_array_equal(qmodel.head_q.numpy(),
                                      jscale["head_q"])
        np.testing.assert_array_equal(qmodel.head_scale.numpy(),
                                      jscale["head_scale"])
    # Every other parameter is bf16; the original model is untouched.
    others = [p for n_, p in qmodel.named_parameters()
              if not n_.endswith((".q.weight", ".k.weight", ".v.weight",
                                  ".o.weight", ".wi.weight", ".wi_0.weight",
                                  ".wi_1.weight", ".wo.weight",
                                  "lm_head.weight"))]
    assert others and all(p.dtype == torch.bfloat16 for p in others)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert tq.decode_bytes(qmodel) < tq.decode_bytes(model) / 2


@pytest.mark.parametrize("int8_head", [False, True])
def test_int8_decode_logits_match_jax(lm, int8_head):
    """Four decode steps' logits from the same int8 weights (an untied
    head has no int8 variant: ``int8_head`` leaves it as it is)."""
    jmodel, params, model = lm
    rng = np.random.default_rng(1)
    enc = rng.standard_normal((2, SRC, D)).astype(np.float32)
    mask = np.ones((2, SRC), np.int32)
    mask[1, 4:] = 0
    tokens = rng.integers(2, 512, (2, L)).astype(np.int32)

    variables = jgen._variables(jq.quantize_for_decode(params,
                                                       int8_head=int8_head))

    @jax.jit
    def jstep(cache, tok, s):
        return jmodel.apply(dict(variables, cache=cache), tok, s, enc, L,
                            mask, method=jmodel.decode_step,
                            mutable=["cache"])

    logits, mods = jmodel.apply(variables, tokens[:, :1], jnp.asarray(0),
                                enc, L, mask, method=jmodel.decode_step,
                                mutable=["cache"])
    want = [np.asarray(logits)]
    for s in range(1, 4):
        logits, mods = jstep(mods["cache"], tokens[:, s:s + 1],
                             jnp.asarray(s, jnp.int32))
        want.append(np.asarray(logits))

    qmodel = tq.quantize_for_decode(model, int8_head=int8_head)
    got, cache = [], None
    with torch.inference_mode():
        for s in range(4):
            logits, cache = qmodel.decode_step(
                torch.from_numpy(tokens[:, s:s + 1]), s,
                torch.from_numpy(enc), L, torch.from_numpy(mask),
                cache=cache)
            got.append(logits.numpy())
    print(f"int8 decode logits vs JAX: max abs diff "
          f"{np.abs(np.stack(got) - np.stack(want)).max():.3e}")
    np.testing.assert_allclose(np.stack(got), np.stack(want),
                               rtol=INT8_VS_JAX_TOL, atol=INT8_VS_JAX_TOL)


def test_int8_equals_dequantized_fp32_weights(lm):
    """Decode steps, and the int8 tied head alone (the lookup keeps the
    bf16 embedding, so a dequantized copy cannot stand for both)."""
    _, _, model = lm
    qmodel = tq.quantize_for_decode(model)
    deq = tq.quantize_for_decode(model)
    with torch.no_grad():
        for name, mod in deq.named_modules():
            if isinstance(mod, KlabDense):
                w = tq.dequantize_kernel(mod.weight.numpy(),
                                         mod.qscale.numpy())
                mod.weight = torch.nn.Parameter(torch.from_numpy(w),
                                                requires_grad=False)
                mod.qscale = None
    rng = np.random.default_rng(2)
    enc = torch.from_numpy(rng.standard_normal((2, SRC, D)).astype(
        np.float32))
    tokens = torch.from_numpy(rng.integers(2, 512, (2, L)).astype(np.int32))
    c1 = c2 = None
    with torch.inference_mode():
        for s in range(4):
            a, c1 = qmodel.decode_step(tokens[:, s:s + 1], s, enc, L, None,
                                       cache=c1)
            b, c2 = deq.decode_step(tokens[:, s:s + 1], s, enc, L, None,
                                    cache=c2)
            torch.testing.assert_close(a, b, rtol=DEQUANT_TOL,
                                       atol=DEQUANT_TOL)
    if model.size.tie_word_embeddings:
        head = tq.quantize_for_decode(model, int8_head=True)
        h = torch.from_numpy(rng.standard_normal((2, 3, D)).astype(
            np.float32))
        w = torch.from_numpy(tq.dequantize_kernel(head.head_q.numpy(),
                                                  head.head_scale.numpy()))
        torch.testing.assert_close(
            head._lm_logits(h), (h * D ** -0.5) @ w.T, rtol=DEQUANT_TOL,
            atol=DEQUANT_TOL)


def test_engine_and_captioner_on_the_int8_copy(lm):
    _, _, model = lm
    qmodel = tq.quantize_for_decode(model)
    rng = np.random.default_rng(3)
    enc = torch.from_numpy(rng.standard_normal((1, SRC, D)).astype(
        np.float32))
    mask = torch.ones(1, SRC, dtype=torch.int32)
    with torch.inference_mode():
        want = tgen.greedy_decode(qmodel, enc, mask, L)[0].numpy()
    engine = DecodeEngine(qmodel, slots=2, source_width=SRC, d_model=D,
                          max_length=L, chunk=3)
    engine.insert(engine.prefill(enc, mask), enc, mask, 0, tag="q")
    got = {}
    for _ in range(20):
        if not engine.has_live():
            break
        engine.tick()
        got.update({t: r for t, r, _ in engine.reap()})
    np.testing.assert_array_equal(got["q"], want)

    tcfg, state = tp.port_cascade_state()
    cap = Captioner(tcfg, state, ByteTokenizer(), device="cpu",
                    decode_int8=True)
    assert cap.decode_model is not cap.model.transformer
    assert cap.decode_model.decoder.block[0].layer[0][
        "SelfAttention"].q.weight.dtype == torch.int8
    images = rng.integers(0, 256, (2, 32, 32, 3), dtype=np.uint8)
    ids = cap.caption_launch(images)
    with torch.inference_mode():
        enc, emask = cap._encode_prefill(images, None)  # full precision
        want = tgen.greedy_decode(cap.decode_model, enc, emask, 8)
    torch.testing.assert_close(ids, want, rtol=0, atol=0)
