"""The port's ``ContinuousCaptionService`` against the JAX package's on the
same weights (``convert_jax_params``): the same engine text width and
buffer, the same engine-or-fallback decision for every generation setting
and prompt width, and, for requests sent through both, the same captions
and the same engine and fallback request counts. Every wait has its own
timeout."""

import numpy as np
import pytest

import _torch_port as tp
from klab_multimodalmodel_tpu.serve import continuous as jcontinuous
from klab_multimodalmodel_tpu.serve import service as jservice
from klab_multimodalmodel_tpu.text import ByteTokenizer as JByteTokenizer
from klab_multimodalmodel_tpu_torch.checkpoint.from_jax import (
    convert_jax_params)
from klab_multimodalmodel_tpu_torch.data.datasets import COCO_PROMPT
from klab_multimodalmodel_tpu_torch.serve import continuous as tcontinuous
from klab_multimodalmodel_tpu_torch.serve import service as tservice
from klab_multimodalmodel_tpu_torch.text import ByteTokenizer

WAIT = 30  # seconds: the bound on every wait in this file
SHORT = "a photo"
WIDE = "describe every object in this picture, one after another, please"

GENS = [
    dict(), dict(num_beams=2), dict(min_length=3),
    dict(repetition_penalty=1.3), dict(no_repeat_ngram_size=2),
    dict(do_sample=True), dict(do_sample=True, temperature=0.7, top_k=20),
    dict(max_length=1), dict(max_length=2), dict(max_length=8),
    dict(max_length=9),
]


@pytest.fixture(scope="module")
def services():
    """(JAX service, port service) on the same seeded weights; the JAX side
    with its kernel flags off (the port's CPU path is the plain one). The
    source length is 64, so a prompt can be wider than the engine's 32."""
    jcfg, tcfg = tp.configs("v10", kernels=False, max_source_length=64)
    params = tp.jax_multimodal_params(jcfg, seed=0)
    state = convert_jax_params(params, tcfg)
    kw = dict(max_batch=1, window_ms=5.0, slots=2, engine_chunk=2,
              max_prefill=1)
    jsvc = jcontinuous.ContinuousCaptionService(jcfg, params,
                                                JByteTokenizer(), **kw)
    tsvc = tcontinuous.ContinuousCaptionService(tcfg, state, ByteTokenizer(),
                                                device="cpu", **kw)
    yield jsvc, tsvc
    tsvc.close()
    jsvc.close()


def _gen(module, kw):
    return module.normalize_gen_params(
        module.GenParams(**{"max_length": 8, "num_beams": 1, **kw}), 128)


def test_engine_width_buffer_and_routing_match_jax(services):
    jsvc, tsvc = services
    assert tsvc.engine_text_width == jsvc.engine_text_width
    assert tsvc._scheduler.max_length == jsvc._scheduler.max_length
    for kw in GENS:
        assert (tsvc._engine_eligible(_gen(tservice, kw))
                == jsvc._engine_eligible(_gen(jservice, kw))), kw
    for prompt in (COCO_PROMPT, SHORT, WIDE):
        ids, mask, fits = tsvc._tokenize_for_engine(prompt)
        jids, jmask, jfits = jsvc._tokenize_for_engine(prompt)
        assert fits == jfits, prompt
        np.testing.assert_array_equal(ids, np.asarray(jids))
        np.testing.assert_array_equal(mask, np.asarray(jmask))
    assert not tsvc._tokenize_for_engine(WIDE)[2]


def test_requests_route_and_caption_as_jax(services):
    """Two engine requests (the default and a short prompt) and three
    fallbacks (beams, a processor, a prompt wider than the engine)."""
    jsvc, tsvc = services
    png = tp.png_bytes(np.random.default_rng(7))
    sent = [(None, {}), (SHORT, {}), (None, dict(num_beams=2)),
            (None, dict(repetition_penalty=1.3)), (WIDE, {})]

    def counts(svc):
        snap = svc.stats.snapshot()
        return snap["requests"], snap["fallback"]["requests"]

    for prompt, kw in sent:
        before = counts(tsvc), counts(jsvc)
        got = tsvc.caption_bytes(png, prompt=prompt,
                                 gen=_gen(tservice, kw), timeout=WAIT)
        want = jsvc.caption_bytes(png, prompt=prompt,
                                  gen=_gen(jservice, kw), timeout=WAIT)
        assert got == want, (prompt, kw)
        after = counts(tsvc), counts(jsvc)
        moved = [tuple(a - b for a, b in zip(x, y))
                 for x, y in zip(after, before)]
        assert moved[0] == moved[1], (prompt, kw, moved)
    assert counts(tsvc) == counts(jsvc) == (2, 3)
