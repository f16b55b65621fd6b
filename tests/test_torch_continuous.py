"""The port's continuous-batching service (``serve/continuous.py``) on a
seeded tiny cascade, the port alone: the engine serves the default greedy
path with ``CaptionService``'s captions, beams, processors, mismatched
sampling and prompts wider than the engine's text width fall back to the
dynamic batcher, a sampling engine takes matching requests; timeouts,
``close`` and HTTP. Every wait has its own timeout."""

import base64

import numpy as np
import pytest

import _torch_port as tp
from klab_multimodalmodel_tpu_torch.data.datasets import (
    COCO_PROMPT, load_image_bytes_resized)
from klab_multimodalmodel_tpu_torch.serve.continuous import (
    ContinuousCaptionService)
from klab_multimodalmodel_tpu_torch.serve.http import CaptionHTTPServer
from klab_multimodalmodel_tpu_torch.serve.service import (CaptionService,
                                                          GenParams)
from klab_multimodalmodel_tpu_torch.text import ByteTokenizer

WAIT = 30  # seconds: the bound on every wait in this file
SHORT = "a photo"  # fits a 16-wide engine; the COCO prompt (30) does not


@pytest.fixture(scope="module")
def cascade():
    return tp.port_cascade_state()


@pytest.fixture(scope="module")
def svc(cascade):
    cfg, state = cascade
    service = ContinuousCaptionService(
        cfg, state, ByteTokenizer(), max_batch=2, window_ms=5.0,
        device="cpu", slots=3, engine_chunk=2, max_prefill=2)
    yield service
    service.close()


def _solo(service, png, prompt=COCO_PROMPT, **kw):
    img = load_image_bytes_resized(png, service.config.swin.image_size)
    return service.captioner.caption(img[None], [prompt], **kw)[0]


def _counts(service):
    snap = service.stats.snapshot()
    return snap["requests"], snap["fallback"]["requests"]


def test_engine_path_matches_the_captioner_under_concurrency(svc):
    rng = np.random.default_rng(0)
    pngs = [tp.png_bytes(rng) for _ in range(5)]
    got = [None] * 5
    before = _counts(svc)
    tp.run_threads([lambda i=i: got.__setitem__(
        i, svc.caption_bytes(pngs[i], timeout=WAIT)) for i in range(5)])
    assert got == [_solo(svc, p) for p in pngs]
    engine, fallback = _counts(svc)
    assert (engine - before[0], fallback - before[1]) == (5, 0)
    snap = svc.stats.snapshot()
    assert snap["engine_slots"] == 3 and snap["errors"] == 0
    assert svc.scheduler.engine.max_length == svc.config.generate_max_length


@pytest.mark.parametrize("gen", [
    dict(num_beams=2), dict(min_length=3), dict(repetition_penalty=1.3),
    dict(do_sample=True),
    dict(max_length=12),  # past the engine's buffer (8)
])
def test_ineligible_requests_fall_back(svc, gen):
    png = tp.png_bytes(np.random.default_rng(1))
    g = GenParams(**{"max_length": 8, "num_beams": 1, **gen})
    before = _counts(svc)
    got = svc.caption_bytes(png, gen=g, timeout=WAIT)
    after = _counts(svc)
    assert (after[0] - before[0], after[1] - before[1]) == (0, 1)
    if not g.do_sample:
        assert got == _solo(svc, png, **gen)


def test_prompt_width_decides_the_route(cascade):
    """With a 16-wide engine the COCO prompt falls back and a short one
    takes the engine; both give the Captioner's caption."""
    cfg, state = cascade
    service = ContinuousCaptionService(
        cfg, state, ByteTokenizer(), max_batch=2, device="cpu", slots=2,
        engine_chunk=3, engine_text_width=16)
    try:
        png = tp.png_bytes(np.random.default_rng(2))
        assert service.caption_bytes(png, timeout=WAIT) == _solo(service,
                                                                 png)
        assert _counts(service) == (0, 1)
        got = service.caption_bytes(png, prompt=SHORT, timeout=WAIT)
        assert got == _solo(service, png, prompt=SHORT)
        assert _counts(service) == (1, 1)
    finally:
        service.close()


def test_sampling_engine_routes_matching_requests(cascade):
    cfg, state = cascade
    service = ContinuousCaptionService(
        cfg, state, ByteTokenizer(), max_batch=2, device="cpu", slots=2,
        engine_do_sample=True, engine_temperature=0.7, engine_top_k=20)
    try:
        png = tp.png_bytes(np.random.default_rng(3))
        match = GenParams(max_length=8, num_beams=1, do_sample=True,
                          temperature=0.7, top_k=20)
        assert isinstance(service.caption_bytes(png, gen=match,
                                                timeout=WAIT), str)
        assert _counts(service) == (1, 0)
        for other in (GenParams(max_length=8, num_beams=1),
                      GenParams(max_length=8, num_beams=1, do_sample=True,
                                temperature=0.9, top_k=20)):
            service.caption_bytes(png, gen=other, timeout=WAIT)
        assert _counts(service) == (1, 2)
        # Explicit seeds: the same seed, the same row.
        img = load_image_bytes_resized(png, cfg.swin.image_size)
        ids, mask, fits = service._tokenize_for_engine(COCO_PROMPT)
        rows = [service.scheduler.submit(img, ids, mask, 8, WAIT, seed=s)
                for s in (5, 5)]
        np.testing.assert_array_equal(rows[0][0], rows[1][0])
        with pytest.raises(ValueError, match="seed"):
            service.scheduler.submit(img, ids, mask, 8, WAIT, seed=-1)
    finally:
        service.close()


def test_timeout_abandons_and_close_fails_waiters(cascade):
    cfg, state = cascade
    service = ContinuousCaptionService(cfg, state, ByteTokenizer(),
                                       device="cpu", slots=2)
    png = tp.png_bytes(np.random.default_rng(4))
    img = load_image_bytes_resized(png, cfg.swin.image_size)
    ids, mask, _ = service._tokenize_for_engine(COCO_PROMPT)
    try:
        with pytest.raises(TimeoutError):
            service.scheduler.submit(img, ids, mask, 8, timeout=0.0)
        # The abandoned request is dropped before its prefill.
        service.caption_bytes(png, timeout=WAIT)
        assert service.stats.snapshot()["abandoned"] == 1
    finally:
        service.close()
    with pytest.raises(RuntimeError, match="closed"):
        service.scheduler.submit(img, ids, mask, 8, timeout=WAIT)
    assert not service.scheduler._thread.is_alive()


def test_http_end_to_end_continuous(svc):
    server = CaptionHTTPServer(svc, host="127.0.0.1", port=0)
    base = f"http://127.0.0.1:{server.port}"
    png = tp.png_bytes(np.random.default_rng(5))
    b64 = base64.b64encode(png).decode()
    try:
        server.start(warmup=False)
        code, body = tp.http_post(base, "/caption", {"image_b64": b64})
        assert (code, body) == (200, {"caption": _solo(svc, png)})
        code, beams = tp.http_post(base, "/caption", {"image_b64": b64,
                                                      "num_beams": 2})
        assert code == 200 and beams["caption"] == _solo(svc, png,
                                                         num_beams=2)
        code, raw = tp.http_post(base, "/caption_stream", {"image_b64": b64},
                                 raw=True)
        assert tp.sse_events(raw)[-1] == {"caption": body["caption"],
                                          "done": True}
        code, snap = tp.http_get(base, "/stats")
        assert code == 200 and snap["engine_slots"] == 3
        assert snap["requests"] >= 1 and snap["fallback"]["requests"] >= 1
        assert snap["engine_slots_live"] == 0
    finally:
        server.httpd.shutdown()
        server.httpd.server_close()


def test_warmup_runs_every_prefill_bucket(cascade):
    cfg, state = cascade
    service = ContinuousCaptionService(
        cfg, state, ByteTokenizer(), max_batch=2, device="cpu", slots=4,
        max_prefill=4)
    try:
        assert service.warmup() == [1, 2]
        snap = service.stats.snapshot()
        assert (snap["requests"], snap["batches"]) == (0, 0)
        assert service.scheduler.engine is not None
    finally:
        service.close()
    assert isinstance(service, CaptionService)
