"""The port's replica router (``serve/replicas.py``) with two replicas on
the CPU, the port alone: each replica builds its own model and gives the
single service's captions, the router picks the least-loaded replica
(ties round-robin), a stream holds one replica until it ends, the
aggregate stats sum the replicas', and HTTP serves the router. Every wait
has its own timeout."""

import base64

import numpy as np
import pytest
import torch

import _torch_port as tp
from klab_multimodalmodel_tpu_torch.serve.http import CaptionHTTPServer
from klab_multimodalmodel_tpu_torch.serve.replicas import (
    ReplicatedCaptionService)
from klab_multimodalmodel_tpu_torch.serve.service import CaptionService
from klab_multimodalmodel_tpu_torch.text import ByteTokenizer

WAIT = 30  # seconds: the bound on every wait in this file


@pytest.fixture(scope="module")
def replicated():
    cfg, state = tp.port_cascade_state()
    service = ReplicatedCaptionService(cfg, state, ByteTokenizer(),
                                       devices=["cpu", "cpu"], max_batch=2,
                                       window_ms=2.0)
    single = CaptionService(cfg, state, ByteTokenizer(), max_batch=2,
                            device="cpu")
    yield service, single
    service.close()
    single.close()


def test_replicas_own_their_models_and_match_one_service(replicated):
    service, single = replicated
    a, b = (r.captioner.model for r in service.replicas)
    assert a is not b
    assert all(torch.equal(x, y) for x, y in zip(a.state_dict().values(),
                                                 b.state_dict().values()))
    assert service.devices == [torch.device("cpu")] * 2
    rng = np.random.default_rng(0)
    pngs = [tp.png_bytes(rng) for _ in range(4)]
    got = [None] * 4
    tp.run_threads([lambda i=i: got.__setitem__(
        i, service.caption_bytes(pngs[i], timeout=WAIT)) for i in range(4)])
    assert got == [single.caption_bytes(p, timeout=WAIT) for p in pngs]
    per = [r.stats.snapshot()["requests"] for r in service.replicas]
    assert sum(per) == 4 and min(per) >= 1  # the load spread
    snap = service.stats.snapshot()
    assert snap["replicas"] == 2 and snap["requests"] == 4
    assert [p["requests"] for p in snap["per_replica"]] == per
    assert service._inflight == [0, 0]


def test_router_prefers_least_loaded_then_round_robin(replicated):
    service, _ = replicated
    service._inflight = [0, 0]
    service._rr = 0
    assert [service._acquire() for _ in range(2)] == [0, 1]
    assert service._acquire() == 0      # tie at 1-1: round-robin from 0
    assert service._inflight == [2, 1]
    assert service._acquire() == 1      # least loaded
    service._release(0)
    service._release(0)
    assert service._acquire() == 0
    for i in (0, 1, 1):
        service._release(i)
    assert service._inflight == [0, 0]


def test_stream_holds_one_replica_until_it_ends(replicated):
    service, single = replicated
    png = tp.png_bytes(np.random.default_rng(1))
    stream = service.caption_stream_bytes(png, chunk_size=2, timeout=WAIT)
    assert service._inflight == [0, 0]  # not acquired before iteration
    first = next(stream)
    assert sum(service._inflight) == 1
    events = [first, *stream]
    assert service._inflight == [0, 0]
    assert events[-1] == (single.caption_bytes(png, timeout=WAIT), True)


def test_http_over_the_router(replicated):
    service, single = replicated
    server = CaptionHTTPServer(service, host="127.0.0.1", port=0)
    base = f"http://127.0.0.1:{server.port}"
    png = tp.png_bytes(np.random.default_rng(2))
    try:
        server.start(warmup=False)
        code, body = tp.http_post(
            base, "/caption", {"image_b64": base64.b64encode(png).decode()})
        assert code == 200
        assert body["caption"] == single.caption_bytes(png, timeout=WAIT)
        code, snap = tp.http_get(base, "/stats")
        assert code == 200 and snap["replicas"] == 2
    finally:
        server.httpd.shutdown()
        server.httpd.server_close()


def test_warmup_and_refusals(replicated):
    service, _ = replicated
    assert service.warmup() == [1, 2]
    cfg, state = tp.port_cascade_state()
    with pytest.raises(ValueError, match="non-empty"):
        ReplicatedCaptionService(cfg, state, ByteTokenizer(), devices=[])
    from klab_multimodalmodel_tpu_torch.models.multimodal import (
        MultiModalModel)
    with pytest.raises(ValueError, match="state dict"):
        ReplicatedCaptionService(cfg, MultiModalModel(cfg, device="cpu"),
                                 ByteTokenizer(), devices=["cpu"])


def test_router_counts_hold_under_thread_stress(replicated):
    """24 threads acquire and release 200 times each with a short switch
    interval: the in-flight counts never go negative and end at zero."""
    import sys

    service, _ = replicated
    service._inflight = [0, 0]
    seen_negative = []

    def worker():
        for _ in range(200):
            i = service._acquire()
            if min(service._inflight) < 0:
                seen_negative.append(list(service._inflight))
            service._release(i)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        tp.run_threads([worker] * 24)
    finally:
        sys.setswitchinterval(interval)
    assert service._inflight == [0, 0] and not seen_negative
