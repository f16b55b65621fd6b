"""The port's beam search against the JAX package's ``beam_search_decode``
on tiny T5 models (fp32, the same seeded weights and encoder output):
tokens exactly, and the port's best score against the JAX model's rescoring
of the same hypothesis within ``SCORE_TOL``. A row whose tokens differ must
be a knife edge: the JAX scores of the two hypotheses within
``SCORE_TOL`` of each other (fp32 drift between the frameworks is ~1e-6).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import _torch_port as tp
import klab_multimodalmodel_tpu.config as jcfg
import klab_multimodalmodel_tpu.models.t5 as jt5
from klab_multimodalmodel_tpu.infer.generate import (
    beam_search_decode as j_beam, process_logits as j_process_logits)
from klab_multimodalmodel_tpu_torch.checkpoint.from_jax import convert_t5_lm
from klab_multimodalmodel_tpu_torch.config import T5Size
from klab_multimodalmodel_tpu_torch.infer import generate as tgen
from klab_multimodalmodel_tpu_torch.models import t5 as tt5

SCORE_TOL = 1e-5
B, SRC, EOS, PAD = 3, 6, 1, 0


@functools.lru_cache(maxsize=None)
def _jax_lm(name):
    """(JAX module, seeded JAX params as numpy, port size) of a tiny T5 LM;
    one init per geometry, shared by the tests (they copy before editing)."""
    kw = tp.T5_NAMES[name][1]
    jmodel = jt5.T5ForConditionalGeneration(jcfg.T5Size(**kw))
    ids = np.zeros((1, SRC), np.int32)
    params = jax.tree.map(np.array, jax.jit(jmodel.init)(
        jax.random.PRNGKey(3), ids, decoder_input_ids=ids)["params"])
    return jmodel, params, T5Size(**kw)


def _lm(name, eos_scale=1.0):
    """(JAX module, JAX params, port model); the untied head's eos column
    scaled by ``eos_scale``."""
    jmodel, params, tsize = _jax_lm(name)
    params = jax.tree.map(np.copy, params)
    if eos_scale != 1.0:
        params["lm_head"]["kernel"][:, EOS] *= eos_scale
    return jmodel, params, _port(params, tsize)


def _port(params, tsize):
    model = tt5.T5ForConditionalGeneration(tsize, device="cpu")
    model.load_state_dict({k: torch.tensor(v) for k, v in convert_t5_lm(
        params, tsize).items()}, strict=True)
    return model.eval()


def _encoder_output(seed):
    rng = np.random.default_rng(seed)
    enc = rng.standard_normal((B, SRC, 32)).astype(np.float32)
    mask = np.ones((B, SRC), np.int32)
    mask[1, 4:] = 0
    return enc, mask


def _gen_len(row, max_length):
    """Generated tokens of a hypothesis: up to and including its eos, or
    every position after the start token."""
    hits = np.where(row[1:] == EOS)[0]
    return int(hits[0]) + 1 if len(hits) else max_length - 1


@functools.lru_cache(maxsize=None)
def _decode_train(jmodel):
    return jax.jit(lambda p, *a: jmodel.apply(
        {"params": p}, *a, method=jmodel.decode_train))


def jax_scores(jmodel, params, enc, mask, tokens, length_penalty, proc):
    """The JAX model's beam score of each row of ``tokens``: processed
    log-softmax of the teacher-forced logits summed over the generated
    tokens, over gen_len ** length_penalty (HF's normalization). The
    processors see each step's prefix (one call, per-row steps)."""
    logits = _decode_train(jmodel)(params, jnp.asarray(tokens[:, :-1]),
                                   jnp.asarray(enc), jnp.asarray(mask))
    n_b, L = tokens.shape
    logp = jax.nn.log_softmax(logits.astype(jnp.float32)).reshape(
        n_b * (L - 1), -1)
    steps = np.tile(np.arange(L - 1), n_b)
    prefixes = np.repeat(tokens, L - 1, axis=0)
    logp = np.asarray(j_process_logits(logp, jnp.asarray(prefixes),
                                       jnp.asarray(steps), EOS, **proc))
    picked = logp[np.arange(len(steps)), prefixes[np.arange(len(steps)),
                                                  steps + 1]]
    picked = picked.reshape(n_b, L - 1)
    out = []
    for b, row in enumerate(tokens):
        n = _gen_len(row, L)
        total = np.float32(0)
        for s in range(n):
            total = np.float32(total + picked[b, s])
        out.append(total / np.float32(n) ** np.float32(length_penalty))
    return np.array(out)


def check_against_jax(lm, max_length, K, length_penalty, proc, seed=0):
    jmodel, params, tmodel = lm
    enc, mask = _encoder_output(seed)
    want = np.asarray(j_beam(jmodel, params, jnp.asarray(enc),
                             jnp.asarray(mask), max_length, K, length_penalty,
                             proc["min_length"], proc["repetition_penalty"],
                             proc["no_repeat_ngram_size"]))
    with torch.no_grad():
        got, scores = tgen.beam_search_decode(
            tmodel, torch.from_numpy(enc), torch.from_numpy(mask),
            max_length, K, length_penalty, return_scores=True, **proc)
    got = got.numpy()
    assert got.shape == (B, max_length) and got.dtype == np.int32
    assert (got[:, 0] == PAD).all()
    j_got = jax_scores(jmodel, params, enc, mask, got, length_penalty, proc)
    same = (got == want).all(axis=1)
    # The port's own score of its best hypothesis is the JAX model's.
    np.testing.assert_allclose(scores[:, 0].numpy(), j_got, rtol=0,
                               atol=SCORE_TOL)
    if not same.all():
        j_want = jax_scores(jmodel, params, enc, mask, want, length_penalty,
                            proc)
        gap = np.abs(j_got - j_want)[~same]
        assert (gap <= SCORE_TOL).all(), (
            f"rows {np.where(~same)[0]} differ and are no knife edge: "
            f"JAX score gaps {gap}\nport {got}\njax {want}")
    return got, want, same


NO_PROC = dict(min_length=0, repetition_penalty=1.0, no_repeat_ngram_size=0)


@pytest.fixture(scope="module")
def tied_lm():
    return _lm("v10")


@pytest.fixture(scope="module")
def untied_lm():
    return _lm("v11")


@pytest.mark.parametrize("K,length_penalty", [
    (2, 1.0), (4, 0.0), (4, 1.0), (4, 2.0)])
def test_beam_matches_jax(tied_lm, K, length_penalty):
    _, _, same = check_against_jax(tied_lm, 12, K, length_penalty, NO_PROC)
    assert same.all()


@pytest.mark.parametrize("proc", [
    dict(NO_PROC, min_length=6),
    dict(NO_PROC, repetition_penalty=1.5),
    dict(NO_PROC, no_repeat_ngram_size=2),
    dict(min_length=4, repetition_penalty=0.8, no_repeat_ngram_size=3)],
    ids=["min_length", "repetition", "ngram", "all"])
def test_beam_processors_match_jax(untied_lm, proc):
    """Processors run on the log-probs of the flat running beams."""
    _, _, same = check_against_jax(untied_lm, 12, 4, 1.0, proc, seed=1)
    assert same.all()


@pytest.fixture(scope="module")
def eos_heavy_lm():
    return _lm("v11", eos_scale=3.0)


@pytest.mark.parametrize("seed,length_penalty", [(5, 1.0), (8, 0.6),
                                                 (22, 1.4)])
def test_beam_eos_heavy_matches_jax(eos_heavy_lm, seed, length_penalty):
    """An eos-prone head (the eos column x3) exercises the store every
    step: the top-num_beams rank filter, the refill of running beams from
    the 2K candidates and the early-stop heuristic."""
    got, want, same = check_against_jax(eos_heavy_lm, 14, 4, length_penalty,
                                        NO_PROC, seed=seed)
    assert (want[:, 1:] == EOS).any(), "eos boost too weak"
    assert same.all()
    for row in got:  # pads after eos
        hits = np.where(row[1:] == EOS)[0]
        if len(hits):
            assert (row[hits[0] + 2:] == PAD).all()


def test_beam_first_step_eos_hypothesis_kept():
    """The tie case: a hypothesis that finishes at the first expansion
    ([start, eos]) enters a store of -1e9 entries through exact ties and
    must keep its tokens. Row 0's first step is forced to eos by aligning
    the untied head's eos column with its step-0 decoder state."""
    jmodel, params, tmodel = _lm("v11")
    enc, mask = _encoder_output(7)
    captured = []
    hook = tmodel.decoder.register_forward_hook(
        lambda mod, args, out: captured.append(out))
    with torch.no_grad():
        tmodel.decode_step(torch.zeros((B, 1), dtype=torch.int32), 0,
                           torch.from_numpy(enc), 8,
                           torch.from_numpy(mask))
    hook.remove()
    h0 = captured[0][0, 0].numpy().astype(np.float32)
    params["lm_head"]["kernel"][:, EOS] = 40.0 * h0 / (h0 @ h0)
    lm = (jmodel, params, _port(params, _jax_lm("v11")[2]))
    got, want, same = check_against_jax(lm, 10, 4, 1.0, NO_PROC, seed=7)
    assert want[0, 1] == EOS, "the forced first-step eos no longer wins"
    assert (got[0, 2:] == PAD).all()
    assert same.all()


def test_stable_top_k_matches_lax_top_k():
    """``_top_k`` orders ties as ``jax.lax.top_k`` does (lower index
    first), on rows full of exact ties like the beam store's."""
    rng = np.random.default_rng(0)
    x = rng.choice(np.array([-2e9, -1e9, -3.0, 0.5], np.float32), (6, 40))
    for k in (1, 4, 8, 40):
        jv, ji = jax.lax.top_k(jnp.asarray(x), k)
        tv, ti = tgen._top_k(torch.from_numpy(x), k)
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def test_cross_kv_gather_changes_nothing(tied_lm, monkeypatch):
    """Beam search reorders only the self-attention K/V: each row's K
    copies of the cross-attention K/V are equal, so gathering them too
    gives the same tokens."""
    _, _, tmodel = tied_lm
    enc, mask = _encoder_output(2)
    K = 4

    def run():
        with torch.no_grad():
            return tgen.beam_search_decode(
                tmodel, torch.from_numpy(enc), torch.from_numpy(mask), 12, K)

    skipped = run()
    reorder = tgen._reorder_self_kv

    def reorder_both(cache, rows):
        reorder(cache, rows)
        for layer in cache:
            kv = layer["cross"]
            for key in ("cached_key", "cached_value"):
                copies = kv[key].reshape(B, K, *kv[key].shape[1:])
                assert (copies == copies[:, :1]).all()
                kv[key] = kv[key].index_select(0, rows)

    monkeypatch.setattr(tgen, "_reorder_self_kv", reorder_both)
    torch.testing.assert_close(run(), skipped, rtol=0, atol=0)
