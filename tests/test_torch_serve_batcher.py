"""The port's ``serve/batcher.py`` alone (no model): the JAX package's
batcher cases of ``tests/test_serve.py`` against the port's copy, and the
``submit_call`` lane. Every wait has its own timeout."""

import threading
import time

import pytest

from klab_multimodalmodel_tpu_torch.serve.batcher import DynamicBatcher
from klab_multimodalmodel_tpu_torch.serve.service import (batch_buckets,
                                                          pow2_batch)

WAIT = 30  # seconds: the bound on every wait in this file


def _echo_batcher(batches, **kw):
    def run(key, payloads):
        batches.append((key, list(payloads)))
        return [f"{key}:{p}" for p in payloads]
    return DynamicBatcher(run, **kw)


def _run_threads(targets):
    threads = [threading.Thread(target=t) for t in targets]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=WAIT)
        assert not t.is_alive(), "a submitting thread hung"


def test_single_request_roundtrip_and_stats():
    batches = []
    b = _echo_batcher(batches, max_batch=4, window_ms=1.0)
    try:
        assert b.submit("k", "x", timeout=WAIT) == "k:x"
        assert batches == [("k", ["x"])]
        snap = b.stats.snapshot()
        assert (snap["requests"], snap["batches"], snap["errors"],
                snap["calls"], snap["abandoned"]) == (1, 1, 0, 0, 0)
        assert snap["mean_batch_occupancy"] == 1.0
        assert 0 < snap["p50_latency_ms"] <= snap["p90_latency_ms"]
    finally:
        b.close()


def test_coalesces_concurrent_same_key():
    """Concurrent same-key submits share batches, and every caller gets
    its own row back."""
    batches = []
    b = _echo_batcher(batches, max_batch=8, window_ms=200.0)
    results = {}
    try:
        _run_threads([lambda i=i: results.update(
            {i: b.submit("k", i, timeout=WAIT)}) for i in range(8)])
        assert results == {i: f"k:{i}" for i in range(8)}
        assert sum(len(p) for _, p in batches) == 8
        assert len(batches) <= 4
        snap = b.stats.snapshot()
        assert snap["mean_batch_occupancy"] == 8 / len(batches)
    finally:
        b.close()


def test_full_batch_dispatches_before_window():
    batches = []
    b = _echo_batcher(batches, max_batch=2, window_ms=60_000.0)
    try:
        t0 = time.perf_counter()
        _run_threads([lambda i=i: b.submit("k", i, timeout=WAIT)
                      for i in range(4)])
        assert time.perf_counter() - t0 < 10
        assert all(len(p) == 2 for _, p in batches)
    finally:
        b.close()


def test_keys_never_share_a_batch():
    batches = []
    b = _echo_batcher(batches, max_batch=8, window_ms=100.0)
    res = {"a": [], "b": []}
    try:
        _run_threads([lambda k=k, i=i: res[k].append(
            b.submit(k, i, timeout=WAIT)) for k in "ab" for i in range(3)])
        for key in "ab":
            assert sorted(res[key]) == [f"{key}:{i}" for i in range(3)]
        for key, payloads in batches:
            assert all(f"{key}:{p}" in res[key] for p in payloads)
    finally:
        b.close()


def test_error_fails_only_its_batch_and_propagates_to_each_waiter():
    def run(key, payloads):
        if key == "boom":
            raise ValueError("kernel exploded")
        return list(payloads)

    b = DynamicBatcher(run, max_batch=4, window_ms=100.0)
    errors = []

    def doomed():
        try:
            b.submit("boom", 1, timeout=WAIT)
        except ValueError as e:
            errors.append(str(e))

    try:
        _run_threads([doomed] * 3)
        assert errors == ["kernel exploded"] * 3
        assert b.stats.snapshot()["errors"] == 3
        assert b.submit("ok", 2, timeout=WAIT) == 2
    finally:
        b.close()


def test_result_count_mismatch_is_an_error():
    b = DynamicBatcher(lambda k, p: [], max_batch=2, window_ms=1.0)
    try:
        with pytest.raises(RuntimeError, match="returned 0 results"):
            b.submit("k", "x", timeout=WAIT)
    finally:
        b.close()


def test_rejects_after_close():
    b = _echo_batcher([], max_batch=2, window_ms=1.0)
    b.close()
    with pytest.raises(RuntimeError, match="closed"):
        b.submit("k", "x", timeout=1)
    with pytest.raises(RuntimeError, match="closed"):
        b.submit_call(lambda: 1, timeout=1)


def test_timed_out_request_is_cancelled_not_executed():
    release = threading.Event()
    seen = []

    def run(key, payloads):
        seen.extend(payloads)
        release.wait(WAIT)  # hold the dispatcher so the next item queues
        return ["r"] * len(payloads)

    b = DynamicBatcher(run, max_batch=1, window_ms=1.0)
    try:
        t = threading.Thread(target=lambda: b.submit("k", "first",
                                                     timeout=WAIT))
        t.start()
        deadline = time.perf_counter() + WAIT
        while not seen and time.perf_counter() < deadline:
            time.sleep(0.005)
        with pytest.raises(TimeoutError):
            b.submit("k", "doomed", timeout=0.05)
        release.set()
        t.join(timeout=WAIT)
        assert b.submit("k", "after", timeout=WAIT) == "r"
        assert "doomed" not in seen
        assert b.stats.snapshot()["abandoned"] == 1
    finally:
        release.set()
        b.close()


def test_submit_call_interleaves_with_batches_on_the_dispatcher():
    """Call jobs run on the dispatcher thread, in arrival order between
    batches, never inside one; their errors reach only their caller."""
    order = []

    def run(key, payloads):
        order.append(("batch", threading.current_thread().name,
                      list(payloads)))
        return list(payloads)

    b = DynamicBatcher(run, max_batch=4, window_ms=1.0)
    try:
        assert b.submit("k", 1, timeout=WAIT) == 1
        assert b.submit_call(lambda: order.append(
            ("call", threading.current_thread().name)) or "c",
            timeout=WAIT) == "c"
        assert b.submit("k", 2, timeout=WAIT) == 2

        def bad():
            raise KeyError("call failed")

        with pytest.raises(KeyError, match="call failed"):
            b.submit_call(bad, timeout=WAIT)
        assert b.submit("k", 3, timeout=WAIT) == 3
        assert [o[0] for o in order] == ["batch", "call", "batch", "batch"]
        assert {o[1] for o in order} == {"klab-serve-dispatch"}
        snap = b.stats.snapshot()
        assert (snap["calls"], snap["errors"], snap["batches"]) == (2, 1, 3)
    finally:
        b.close()


def test_pipelined_launch_finalize_overlap():
    """With ``finalize``: a second batch launches while the first is
    unfinalized; errors in either stage fail only their batch."""
    import queue as q

    launched = q.Queue()
    gate = threading.Event()

    def launch(key, payloads):
        if payloads[0] == "boom-launch":
            raise RuntimeError("launch failed")
        launched.put(list(payloads))
        return ("handle", list(payloads))

    def finalize(key, handle, payloads):
        assert handle == ("handle", list(payloads))
        gate.wait(WAIT)
        if payloads[0] == "boom-finalize":
            raise RuntimeError("finalize failed")
        return [f"{key}:{p}!" for p in payloads]

    b = DynamicBatcher(launch, max_batch=2, window_ms=1.0,
                       finalize=finalize, pipeline_depth=2)
    try:
        results = {}
        threads = [threading.Thread(
            target=lambda i=i: results.update(
                {i: b.submit("k", f"p{i}", timeout=WAIT)}))
            for i in range(2)]
        for t in threads:
            t.start()
        total = list(launched.get(timeout=WAIT))
        while len(total) < 2:
            total += launched.get(timeout=WAIT)
        gate.set()
        for t in threads:
            t.join(timeout=WAIT)
        assert results == {0: "k:p0!", 1: "k:p1!"}
        with pytest.raises(RuntimeError, match="launch failed"):
            b.submit("k", "boom-launch", timeout=WAIT)
        with pytest.raises(RuntimeError, match="finalize failed"):
            b.submit("k", "boom-finalize", timeout=WAIT)
        assert b.submit("k", "alive", timeout=WAIT) == "k:alive!"
        assert b.stats.snapshot()["errors"] == 2
    finally:
        gate.set()
        b.close()


@pytest.mark.parametrize("bad", [dict(max_batch=0),
                                 dict(pipeline_depth=0,
                                      finalize=lambda *a: [])])
def test_constructor_refuses_bad_sizes(bad):
    with pytest.raises(ValueError):
        DynamicBatcher(lambda k, p: list(p), **bad)


def test_pow2_batch_and_buckets():
    assert [pow2_batch(n, 8) for n in (1, 2, 3, 4, 5, 7, 8, 9)] == [
        1, 2, 4, 4, 8, 8, 8, 8]
    assert pow2_batch(3, 4) == 4
    assert [pow2_batch(n, 6) for n in (3, 5, 6)] == [4, 6, 6]
    assert batch_buckets(8) == [1, 2, 4, 8]
    assert batch_buckets(6) == [1, 2, 4, 6]
    assert batch_buckets(1) == [1]
