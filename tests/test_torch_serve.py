"""The serving slice as a whole: the same PNG bytes and the same weights
(``convert_jax_params``) through the JAX package's ``CaptionService`` and
the port's give equal captions for greedy, beams and a stream (the JAX side
with its Pallas kernels in interpret mode, the port on its plain versions);
then the port's ``CaptionHTTPServer`` on 127.0.0.1: ``/healthz`` 503 then
200, ``/caption``, the SSE events of ``/caption_stream``, ``/stats``, and 400
on bad generation parameters. Every wait has its own timeout."""

import base64
import threading

import numpy as np
import pytest

import _torch_port as tp
from klab_multimodalmodel_tpu.ops import set_interpret
from klab_multimodalmodel_tpu.serve import service as jservice
from klab_multimodalmodel_tpu.text import ByteTokenizer as JByteTokenizer
from klab_multimodalmodel_tpu_torch.checkpoint.from_jax import (
    convert_jax_params)
from klab_multimodalmodel_tpu_torch.data.datasets import (
    COCO_PROMPT, load_image_bytes_resized)
from klab_multimodalmodel_tpu_torch.serve import service as tservice
from klab_multimodalmodel_tpu_torch.serve.http import CaptionHTTPServer
from klab_multimodalmodel_tpu_torch.text import ByteTokenizer

WAIT = 30  # seconds: the bound on every wait in this file


@pytest.fixture(scope="module")
def services():
    """(JAX service, port service, port state dict, port config). The JAX
    service is built once, without its all-bucket warmup."""
    set_interpret(True)
    jcfg, tcfg = tp.configs("v10")
    params = tp.jax_multimodal_params(jcfg, seed=0)
    state = convert_jax_params(params, tcfg)
    jsvc = jservice.CaptionService(jcfg, params, JByteTokenizer(),
                                   max_batch=4, window_ms=5.0)
    tsvc = tservice.CaptionService(tcfg, state, ByteTokenizer(),
                                   max_batch=4, window_ms=5.0, device="cpu")
    yield jsvc, tsvc, state, tcfg
    tsvc.close()
    jsvc.close()
    set_interpret(False)


def test_captions_equal_jax_service(services):
    """Greedy (three requests at once, one batch), beams and a stream."""
    jsvc, tsvc, _, _ = services
    rng = np.random.default_rng(0)
    pngs = [tp.png_bytes(rng) for _ in range(3)]
    got = [None] * 3
    tp.run_threads([lambda i=i: got.__setitem__(
        i, tsvc.caption_bytes(pngs[i], timeout=WAIT)) for i in range(3)])
    want = [jsvc.caption_bytes(p, timeout=WAIT) for p in pngs]
    assert got == want
    assert all(isinstance(c, str) for c in got)

    beam = tservice.GenParams(max_length=8, num_beams=2)
    assert (tsvc.caption_bytes(pngs[0], gen=beam, timeout=WAIT)
            == jsvc.caption_bytes(pngs[0], gen=jservice.GenParams(
                max_length=8, num_beams=2), timeout=WAIT))

    events = list(tsvc.caption_stream_bytes(pngs[1], chunk_size=2,
                                            timeout=WAIT))
    jevents = list(jsvc.caption_stream_bytes(pngs[1], chunk_size=2,
                                             timeout=WAIT))
    assert events == jevents
    assert events[-1] == (want[1], True)
    assert [done for _, done in events] == [False] * (len(events) - 1) + [
        True]


def test_service_equals_direct_captioner_and_pads_invisibly(services):
    """Bucket padding (3 rows -> bucket 4) never changes a row."""
    _, tsvc, _, tcfg = services
    rng = np.random.default_rng(1)
    pngs = [tp.png_bytes(rng) for _ in range(3)]
    images = np.stack([load_image_bytes_resized(p, tcfg.swin.image_size)
                       for p in pngs])
    direct = tsvc.captioner.caption(images, [COCO_PROMPT] * 3)
    padded = tsvc._finish_batch(
        tsvc.default_params,
        tsvc._run_batch(tsvc.default_params,
                        [(im, COCO_PROMPT) for im in images]),
        [None] * 3)
    assert padded == direct
    assert [tsvc.caption_bytes(p, timeout=WAIT) for p in pngs] == direct


@pytest.mark.parametrize("gen", [
    dict(max_length=8, num_beams=1, temperature=0.5, top_k=7, top_p=0.3),
    dict(max_length=8, num_beams=1, do_sample=True, temperature=0.5),
    dict(max_length=0, num_beams=1), dict(max_length=999, num_beams=1),
    dict(max_length=8, num_beams=0), dict(max_length=8, num_beams=64),
    dict(max_length=8, num_beams=4, do_sample=True),
    dict(max_length=8, num_beams=1, min_length=9),
    dict(max_length=8, num_beams=1, repetition_penalty=0.0),
    dict(max_length=8, num_beams=1, no_repeat_ngram_size=-1),
    dict(max_length=8, num_beams=1, do_sample=True, temperature=0.0),
    dict(max_length=8, num_beams=1, do_sample=True, top_p=0.0),
    dict(max_length=8, num_beams=1, do_sample=True, top_k=-1)])
def test_normalize_gen_params_matches_jax(gen):
    def run(module):
        try:
            return "ok", module.normalize_gen_params(
                module.GenParams(**gen), 16).__dict__
        except ValueError as e:
            return "error", str(e)

    assert run(tservice) == run(jservice)


def test_http_server_end_to_end(services, monkeypatch):
    _, tsvc, _, _ = services
    gate = threading.Event()
    warmed = []
    real_warmup = tsvc.warmup

    def gated_warmup():
        gate.wait(WAIT)
        warmed.append(real_warmup())
        return warmed[-1]

    monkeypatch.setattr(tsvc, "warmup", gated_warmup)
    monkeypatch.setattr(tsvc, "close", lambda: None)  # the fixture closes
    server = CaptionHTTPServer(tsvc, host="127.0.0.1", port=0)
    base = f"http://127.0.0.1:{server.port}"
    starter = threading.Thread(target=server.start)
    try:
        starter.start()
        assert tp.http_get(base, "/healthz") == (503, {"status": "warming up"})
        png = tp.png_bytes(np.random.default_rng(2))
        b64 = base64.b64encode(png).decode()
        assert tp.http_post(base, "/caption", {"image_b64": b64})[0] == 503
        gate.set()
        starter.join(timeout=WAIT)
        assert warmed == [[1, 2, 4]]
        assert tp.http_get(base, "/healthz") == (200, {"status": "ok"})

        code, body = tp.http_post(base, "/caption", {"image_b64": b64})
        assert code == 200 and isinstance(body["caption"], str)
        assert body["caption"] == tsvc.caption_bytes(png, timeout=WAIT)

        code, raw = tp.http_post(base, "/caption_stream",
                          {"image_b64": b64, "chunk_size": 3}, raw=True)
        events = tp.sse_events(raw)
        assert code == 200 and len(events) >= 2
        assert events[-1] == {"caption": body["caption"], "done": True}
        assert all(not e["done"] for e in events[:-1])

        code, short = tp.http_post(base, "/caption", {"image_b64": b64,
                                               "max_length": 3})
        assert code == 200 and isinstance(short["caption"], str)

        code, snap = tp.http_get(base, "/stats")
        assert code == 200 and snap["requests"] >= 2 and snap["calls"] >= 2
        assert snap["errors"] == 0

        for bad in ({"image_b64": b64, "max_length": 999},
                    {"image_b64": b64, "num_beams": 0},
                    {"image_b64": b64, "do_sample": "yes"},
                    {"image_b64": b64, "do_sample": True, "num_beams": 2},
                    {"image_b64": "!!!not-base64!!!"}, {}):
            code, err = tp.http_post(base, "/caption", bad)
            assert code == 400 and "bad request" in err["error"], bad
        code, err = tp.http_post(base, "/caption", {
            "image_b64": base64.b64encode(b"not an image").decode()})
        assert code == 400 and "bad image" in err["error"]
        code, err = tp.http_post(base, "/caption_stream", {"image_b64": b64,
                                                    "num_beams": 2})
        assert code == 400
        assert tp.http_get(base, "/nope")[0] == 404
    finally:
        gate.set()
        starter.join(timeout=WAIT)
        server.stop()
