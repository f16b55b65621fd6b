"""Sampling in the port: ``warp_logits`` against the JAX package's (the
kept sets and ``-inf`` positions exactly, the kept values within 1e-6, ties
at the top-k threshold included), and the sampling loop's properties on a
tiny T5 (the draws are torch's, so tokens are not compared with JAX's):
top_k=1 is greedy, one generator state gives one sequence and others
differ, every token lies in the warped support, finished rows emit pad.
Also the router's refusals."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import _torch_port as tp
from klab_multimodalmodel_tpu.infer.generate import (
    warp_logits as j_warp_logits)
from klab_multimodalmodel_tpu_torch.config import T5Size
from klab_multimodalmodel_tpu_torch.infer import generate as tgen
from klab_multimodalmodel_tpu_torch.models import t5 as tt5

EOS, PAD = 1, 0
VALUE_TOL = 1e-6  # fp32 division and softmax, framework against framework


@pytest.mark.parametrize("temperature,top_k,top_p", [
    (0.7, 0, 1.0), (1.0, 5, 1.0), (1.0, 0, 0.9), (0.8, 7, 0.92),
    (1.3, 3, 0.5), (1.0, 64, 0.3)])
@pytest.mark.parametrize("ties", [False, True])
def test_warp_logits_matches_jax(temperature, top_k, top_p, ties):
    """``ties``: logits from eight values, so the k-th largest is shared by
    several tokens, all of which survive top-k."""
    rng = np.random.default_rng(17)
    if ties:
        logits = rng.choice(np.linspace(-2, 2, 8).astype(np.float32),
                            (4, 64))
    else:
        logits = rng.normal(size=(4, 64)).astype(np.float32) * 2.0
    want = np.asarray(j_warp_logits(jnp.asarray(logits), temperature, top_k,
                                    top_p))
    got = tgen.warp_logits(torch.from_numpy(logits), temperature, top_k,
                           top_p).numpy()
    removed = np.isneginf(want)
    np.testing.assert_array_equal(np.isneginf(got), removed)
    np.testing.assert_allclose(got[~removed], want[~removed], rtol=VALUE_TOL,
                               atol=VALUE_TOL)
    if ties and top_k and top_p == 1.0:
        kth = np.sort(logits, axis=-1)[:, -top_k]
        assert ((~removed).sum(-1) >= top_k).all()
        assert (~removed == (logits >= kth[:, None])).all()


@pytest.fixture(scope="module")
def lm():
    """A tiny seeded T5 with an untied head whose eos row is boosted, so
    sampled rows finish early; and a seeded encoder output."""
    model = tt5.T5ForConditionalGeneration(
        T5Size(**tp.T5_NAMES["v11"][1]), device="cpu")
    model.init_weights(torch.Generator().manual_seed(0))
    with torch.no_grad():
        model.lm_head.weight[EOS] *= 6.0
    model.eval()
    enc = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (4, 6, 32)).astype(np.float32))
    return model, enc


def _sample(model, enc, seed, max_length=14, **kw):
    with torch.no_grad():
        return tgen.sample_decode(model, enc, None, max_length,
                                  torch.Generator().manual_seed(seed), **kw)


def test_sample_topk1_equals_greedy(lm):
    model, enc = lm
    with torch.no_grad():
        greedy = tgen.greedy_decode(model, enc, None, 14)
    for seed in (0, 7):
        torch.testing.assert_close(_sample(model, enc, seed, top_k=1),
                                   greedy, rtol=0, atol=0)


def test_sample_deterministic_per_generator_and_varies(lm):
    model, enc = lm
    a = _sample(model, enc, 3)
    torch.testing.assert_close(_sample(model, enc, 3), a, rtol=0, atol=0)
    others = [_sample(model, enc, s) for s in range(4, 8)]
    assert any(not torch.equal(a, o) for o in others), \
        "four other generator seeds all drew the same tokens"


def test_sample_tokens_stay_in_warped_support(lm):
    """Rescore each sampled prefix with the teacher-forced decoder,
    re-apply the warpers, and require every drawn token's warped logit to
    be finite."""
    model, enc = lm
    temperature, top_k, top_p = 0.9, 4, 0.8
    toks = _sample(model, enc, 11, temperature=temperature, top_k=top_k,
                   top_p=top_p)
    with torch.no_grad():
        logits = model.decode_train(toks[:, :-1], enc)
    warped = tgen.warp_logits(logits, temperature, top_k, top_p)
    checked = 0
    for b, row in enumerate(toks.tolist()):
        for t in range(len(row) - 1):
            if row[t] in (EOS, PAD) and t > 0:
                break  # finished: pads are forced, not drawn
            assert torch.isfinite(warped[b, t, row[t + 1]]), (b, t, row)
            checked += 1
    assert checked >= toks.shape[0]


def test_sample_finished_rows_emit_pad(lm):
    model, enc = lm
    out = _sample(model, enc, 5, max_length=16, temperature=1.2)
    assert (out[:, 0] == PAD).all()
    finished = 0
    for row in out.tolist():
        if EOS in row[1:]:
            e = row.index(EOS, 1)
            assert all(t == PAD for t in row[e + 1:])
            finished += 1
    assert finished, "no row finished: the eos boost is too weak"


def test_generate_routes_and_refuses(lm):
    model, enc = lm
    with torch.no_grad():
        torch.testing.assert_close(
            tgen.generate(model, enc, None, 10, do_sample=True,
                          generator=torch.Generator().manual_seed(2)),
            _sample(model, enc, 2, max_length=10), rtol=0, atol=0)
        torch.testing.assert_close(
            tgen.generate(model, enc, None, 10, num_beams=2),
            tgen.beam_search_decode(model, enc, None, 10, 2), rtol=0, atol=0)
        # No generator: seeded with 0, as the JAX package's PRNGKey(0).
        torch.testing.assert_close(
            tgen.generate(model, enc, None, 10, do_sample=True),
            _sample(model, enc, 0, max_length=10), rtol=0, atol=0)
    with pytest.raises(ValueError, match="beam-search sampling"):
        tgen.generate(model, enc, None, 10, num_beams=2, do_sample=True)
    # Speculative decoding (ROADMAP A10) takes plain greedy only.
    from klab_multimodalmodel_tpu_torch.infer.speculative import (
        speculative_greedy_decode)
    with torch.no_grad():
        torch.testing.assert_close(
            tgen.generate(model, enc, None, 10, speculative_draft=4),
            speculative_greedy_decode(model, enc, None, 10, draft_len=4),
            rtol=0, atol=0)
    with pytest.raises(ValueError, match="speculative_draft"):
        tgen.generate(model, enc, None, 10, speculative_draft=-4)
