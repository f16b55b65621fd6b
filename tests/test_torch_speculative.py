"""The port's prompt-lookup speculative decoding (``infer/speculative.py``)
against the JAX package's:

- ``_ngram_draft`` bitwise on seeded token rows, with and without a
  ``lookup_prefix``;
- ``speculative_greedy_decode`` tokens against the port's greedy (equal, or
  a knife edge: the top-2 margin at the first differing step under
  ``KNIFE_EDGE`` relative, printed) and against the JAX package's
  speculative tokens, with its pass and accept counts;
- the ``generate`` route and the Captioner's ``KLAB_DECODE_SPECULATIVE``,
  which refuses a malformed or negative value by name.
"""

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import _torch_port as tp
from klab_multimodalmodel_tpu_torch.infer import generate as tgen
from klab_multimodalmodel_tpu_torch.infer import speculative as tspec
from klab_multimodalmodel_tpu_torch.infer.captioner import Captioner
from klab_multimodalmodel_tpu_torch.text import ByteTokenizer

jspec = importlib.import_module("klab_multimodalmodel_tpu.infer.speculative")

KNIFE_EDGE = 1e-5
B, SRC, D, MAX_LEN = 4, 6, 32, 14


@pytest.mark.parametrize("ngram", [1, 2, 3])
@pytest.mark.parametrize("prefix", [False, True])
def test_ngram_draft_bitwise_matches_jax(ngram, prefix):
    rng = np.random.default_rng(ngram + 10 * prefix)
    L, K = 16, 3
    tokens = rng.integers(0, 4, (8, L)).astype(np.int32)  # repetitive
    step = rng.integers(0, L - 1, 8).astype(np.int32)
    src = (rng.integers(0, 4, (8, 5)).astype(np.int32) if prefix else None)
    want = np.asarray(jspec._ngram_draft(
        jnp.asarray(tokens), jnp.asarray(step), K, ngram, 0,
        lookup_prefix=None if src is None else jnp.asarray(src)))
    got = tspec._ngram_draft(
        torch.from_numpy(tokens), torch.from_numpy(step).long(), K, ngram,
        0, lookup_prefix=None if src is None else torch.from_numpy(src))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want != 0).any()  # some rows found a continuation


@pytest.fixture(scope="module")
def lm():
    jmodel, params, model = tp.jax_t5_lm("v10", seed=5, src=SRC)
    rng = np.random.default_rng(0)
    enc = rng.standard_normal((B, SRC, D)).astype(np.float32)
    mask = np.ones((B, SRC), np.int32)
    mask[2, 4:] = 0
    src = rng.integers(2, 40, (B, SRC)).astype(np.int32)
    return jmodel, params, model, enc, mask, src


@pytest.mark.parametrize("draft_len,source", [(3, False), (2, True)])
def test_tokens_and_counts_match_greedy_and_jax(lm, draft_len, source):
    jmodel, params, model, enc, mask, src = lm
    jtok, jpasses, jacc = jspec.speculative_greedy_decode_with_stats(
        jmodel, params, jnp.asarray(enc), jnp.asarray(mask), MAX_LEN,
        draft_len, 2, jnp.asarray(src) if source else None)
    t_enc, t_mask = torch.from_numpy(enc), torch.from_numpy(mask)
    with torch.inference_mode():
        tok, passes, acc = tspec.speculative_greedy_decode_with_stats(
            model, t_enc, t_mask, MAX_LEN, draft_len, 2,
            torch.from_numpy(src) if source else None)
        greedy = tgen.greedy_decode(model, t_enc, t_mask, MAX_LEN)
    assert tok.dtype == torch.int32 and tok.shape == (B, MAX_LEN)
    for b in range(B):
        if not torch.equal(tok[b], greedy[b]):
            s, margin = tp.first_difference_margin(
                model, t_enc[b:b + 1], t_mask[b:b + 1], tok[b].numpy(),
                greedy[b].numpy())
            assert margin < KNIFE_EDGE, (b, s, margin)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
    assert passes == int(jpasses)
    np.testing.assert_array_equal(acc.numpy(), np.asarray(jacc))
    # Drafts were accepted: fewer passes than greedy's max_length - 2.
    assert int(acc.sum()) > 0 and passes < MAX_LEN - 2


def test_generate_routes_plain_greedy_only(lm):
    _, _, model, enc, mask, _ = lm
    t_enc, t_mask = torch.from_numpy(enc), torch.from_numpy(mask)
    with torch.inference_mode():
        spec = tspec.speculative_greedy_decode(model, t_enc, t_mask,
                                               MAX_LEN, draft_len=3)
        torch.testing.assert_close(
            tgen.generate(model, t_enc, t_mask, MAX_LEN,
                          speculative_draft=3), spec, rtol=0, atol=0)
        # Processors take the sequential loop, as in the JAX package.
        torch.testing.assert_close(
            tgen.generate(model, t_enc, t_mask, MAX_LEN, min_length=4,
                          speculative_draft=3),
            tgen.greedy_decode(model, t_enc, t_mask, MAX_LEN, 4),
            rtol=0, atol=0)
    with pytest.raises(ValueError, match="draft_len"):
        tspec.speculative_greedy_decode(model, t_enc, t_mask, MAX_LEN,
                                        draft_len=0)
    with pytest.raises(ValueError, match="speculative_draft"):
        tgen.generate(model, t_enc, t_mask, MAX_LEN, speculative_draft=-1)


@pytest.fixture(scope="module")
def state():
    """A seeded port cascade (no JAX needed: the Captioner's own lever)."""
    return tp.port_cascade_state()


def test_captioner_reads_the_environment_and_refuses_bad_values(
        state, monkeypatch):
    tcfg, sd = state
    images = np.random.default_rng(1).integers(0, 256, (2, 32, 32, 3),
                                               dtype=np.uint8)
    monkeypatch.delenv("KLAB_DECODE_SPECULATIVE", raising=False)
    plain = Captioner(tcfg, sd, ByteTokenizer(), device="cpu")
    assert plain.speculative_draft == 0
    monkeypatch.setenv("KLAB_DECODE_SPECULATIVE", "3")
    spec = Captioner(tcfg, sd, ByteTokenizer(), device="cpu")
    assert spec.speculative_draft == 3
    assert spec.caption(images) == plain.caption(images)
    explicit = Captioner(tcfg, sd, ByteTokenizer(), device="cpu",
                         speculative_draft=0)
    assert explicit.speculative_draft == 0
    for bad in ("two", "-1", "2.5", ""):
        monkeypatch.setenv("KLAB_DECODE_SPECULATIVE", bad)
        with pytest.raises(ValueError, match="KLAB_DECODE_SPECULATIVE"):
            Captioner(tcfg, sd, ByteTokenizer(), device="cpu")
    with pytest.raises(ValueError, match="speculative_draft"):
        Captioner(tcfg, sd, ByteTokenizer(), device="cpu",
                  speculative_draft=-2)
