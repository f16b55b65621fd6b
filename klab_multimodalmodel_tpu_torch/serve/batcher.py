"""Dynamic request batching for online inference.

The port's copy of the JAX package's ``serve/batcher.py``. Model-agnostic:
the batcher owns a queue and ONE dispatcher thread that drains it into
batches and calls a user ``run_batch(key, payloads)`` callable. Requests
carry a *group key* (generation parameters); only requests with equal keys
share a batch, since they must share one decode loop (beam width, sampling
chain and max length are fixed per call of ``infer/generate.py``).

Design notes:
  * a single dispatcher thread serializes device work — launches from many
    HTTP threads would interleave unrelated work and destroy the batching
    win;
  * the batching window starts at the FIRST queued request of a batch, so
    an idle service adds at most ``window_ms`` latency and a loaded service
    fills batches without waiting;
  * a request whose key differs from the batch being collected is held
    back (one-slot peek buffer) and seeds the next batch — no reordering
    within a key, no starvation across keys.
"""

from __future__ import annotations

import collections
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Hashable, Optional, Sequence


@dataclass
class BatchStats:
    """Counters for the /stats endpoint. All mutation happens under
    ``lock`` (the batcher shares its own lock in), and ``snapshot()``
    takes it too — the latency deque is mutated by the dispatcher thread,
    so an unlocked ``sorted()`` over it can raise mid-iteration."""

    requests: int = 0
    batches: int = 0
    rows: int = 0  # sum of real (unpadded) batch occupancy
    calls: int = 0  # submit_call jobs (streaming chunk advances)
    errors: int = 0
    abandoned: int = 0  # timed-out submits cancelled before device work
    latencies_ms: collections.deque = field(
        default_factory=lambda: collections.deque(maxlen=1024))
    lock: threading.Lock = field(default_factory=threading.Lock)

    def snapshot(self) -> dict:
        with self.lock:
            return self._snapshot_locked()

    def _snapshot_locked(self) -> dict:
        lat = sorted(self.latencies_ms)
        pct = (lambda q: lat[min(len(lat) - 1, int(q * len(lat)))]
               if lat else 0.0)
        return {
            "requests": self.requests,
            "batches": self.batches,
            "calls": self.calls,
            "errors": self.errors,
            "abandoned": self.abandoned,
            "mean_batch_occupancy": (self.rows / self.batches
                                     if self.batches else 0.0),
            "p50_latency_ms": pct(0.50),
            "p90_latency_ms": pct(0.90),
        }


class _Pending:
    __slots__ = ("key", "payload", "event", "result", "error", "t_enqueue",
                 "abandoned", "is_call")

    def __init__(self, key: Hashable, payload: Any, is_call: bool = False):
        self.key = key
        self.payload = payload
        self.event = threading.Event()
        self.result: Any = None
        self.error: Optional[BaseException] = None
        self.t_enqueue = time.perf_counter()
        self.abandoned = False  # set (under the batcher lock) on timeout
        self.is_call = is_call  # payload is a 0-arg callable, not a request


class DynamicBatcher:
    """Coalesce concurrent ``submit()`` calls into ``run_batch`` calls.

    ``run_batch(key, payloads) -> results`` must return one result per
    payload, in order. Exceptions fail every request in that batch (the
    callers get the exception re-raised) and the batcher keeps serving.

    Pipelined mode (``finalize`` given): ``run_batch(key, payloads)``
    becomes the LAUNCH stage — it should enqueue device work and return a
    handle without blocking on results where the work allows it —
    and ``finalize(key, handle, payloads) -> results`` runs on a separate
    completer thread, blocking on the device read and doing the host-side
    result work. The dispatcher can then collect/stack/launch batch N+1
    while the device computes batch N and the completer detokenizes N-1:
    steady-state throughput is set by max(host stage, device stage)
    instead of their sum. ``pipeline_depth`` bounds launched-but-
    unfinalized batches (device queue depth == latency bound).
    """

    def __init__(self, run_batch: Callable[[Hashable, Sequence[Any]], Sequence[Any]],
                 max_batch: int = 8, window_ms: float = 5.0,
                 finalize: Optional[Callable[..., Sequence[Any]]] = None,
                 pipeline_depth: int = 2):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if pipeline_depth < 1:
            raise ValueError(
                f"pipeline_depth must be >= 1, got {pipeline_depth}")
        self._run_batch = run_batch
        self._finalize = finalize
        self.max_batch = max_batch
        self.window_s = window_ms / 1000.0
        self._lock = threading.Lock()
        # One lock for queue AND stats: snapshot() serializes against the
        # dispatcher's counter/deque mutation.
        self.stats = BatchStats(lock=self._lock)
        self._not_empty = threading.Condition(self._lock)
        self._queue: collections.deque[_Pending] = collections.deque()
        self._held: Optional[_Pending] = None  # different-key peek slot
        self._closed = False
        self._completer: Optional[threading.Thread] = None
        if finalize is not None:
            import queue as _queue

            self._inflight: _queue.Queue = _queue.Queue(
                maxsize=pipeline_depth)
            self._completer = threading.Thread(
                target=self._complete_loop, name="klab-serve-complete",
                daemon=True)
            self._completer.start()
        self._thread = threading.Thread(target=self._dispatch_loop,
                                        name="klab-serve-dispatch",
                                        daemon=True)
        self._thread.start()

    # -- producer side -----------------------------------------------------
    def submit(self, key: Hashable, payload: Any,
               timeout: Optional[float] = None) -> Any:
        """Enqueue one request and block until its batch completes."""
        item = _Pending(key, payload)
        with self._lock:
            if self._closed:
                raise RuntimeError("batcher is closed")
            self.stats.requests += 1
            self._queue.append(item)
            self._not_empty.notify()
        if not item.event.wait(timeout):
            # Cancel rather than orphan: if the item is still queued (or
            # collected but not yet dispatched) the dispatcher drops it, so
            # timed-out clients don't keep consuming device decodes —
            # otherwise a 504 storm would hold the card at 100% on dead work.
            with self._lock:
                item.abandoned = True
            raise TimeoutError("request timed out waiting for a batch slot")
        if item.error is not None:
            raise item.error
        return item.result

    def submit_call(self, fn: Callable[[], Any],
                    timeout: Optional[float] = None) -> Any:
        """Run ``fn()`` on the dispatcher thread and return its result.

        The lane for device work that must share the single device owner
        but doesn't batch — one streaming chunk advance is one call. Call
        jobs interleave with batches in arrival order (each carries a
        unique key, so the fill loop never merges them into a batch), so
        a long-lived stream occupies the device one chunk at a time
        instead of starving batched traffic — and a stream abandoned by
        its client simply stops submitting chunks.
        """
        item = _Pending(object(), fn, is_call=True)
        with self._lock:
            if self._closed:
                raise RuntimeError("batcher is closed")
            self.stats.calls += 1
            self._queue.append(item)
            self._not_empty.notify()
        if not item.event.wait(timeout):
            with self._lock:
                item.abandoned = True
            raise TimeoutError("call timed out waiting for the dispatcher")
        if item.error is not None:
            raise item.error
        return item.result

    def close(self) -> None:
        with self._lock:
            self._closed = True
            self._not_empty.notify()
        self._thread.join(timeout=10)
        if self._completer is not None:
            self._inflight.put(None)  # sentinel after the last real batch
            self._completer.join(timeout=30)

    # -- dispatcher side ----------------------------------------------------
    def _take_first(self) -> Optional[_Pending]:
        """Block for the request that opens the next batch."""
        with self._lock:
            while True:
                if self._held is not None:
                    item, self._held = self._held, None
                else:
                    while not self._queue and not self._closed:
                        self._not_empty.wait()
                    if not self._queue:
                        return None
                    item = self._queue.popleft()
                if item.abandoned:
                    self.stats.abandoned += 1
                    continue
                return item

    def _fill(self, batch: list[_Pending], deadline: float) -> None:
        """Collect same-key requests until the window closes or the batch
        is full. A different-key arrival is parked in ``_held`` and ends
        the batch (it will open the next one immediately)."""
        key = batch[0].key
        while len(batch) < self.max_batch:
            with self._lock:
                while not self._queue:
                    remaining = deadline - time.perf_counter()
                    if remaining <= 0 or self._closed:
                        return
                    self._not_empty.wait(remaining)
                if self._queue[0].key != key:
                    self._held = self._queue.popleft()
                    return
                item = self._queue.popleft()
                if item.abandoned:
                    self.stats.abandoned += 1
                    continue
                batch.append(item)

    def _settle(self, batch: list[_Pending],
                results: Optional[Sequence[Any]],
                error: Optional[BaseException]) -> None:
        """Assign results/error, record stats, release the waiters."""
        if error is None:
            assert results is not None
            for item, res in zip(batch, results):
                item.result = res
        done = time.perf_counter()
        with self._lock:
            if error is not None:
                self.stats.errors += len(batch)
            self.stats.batches += 1
            self.stats.rows += len(batch)
            for item in batch:
                self.stats.latencies_ms.append(
                    (done - item.t_enqueue) * 1000.0)
        for item in batch:
            if error is not None:
                item.error = error
            item.event.set()

    @staticmethod
    def _check_counts(results: Sequence[Any], batch: list[_Pending]) -> None:
        if len(results) != len(batch):
            raise RuntimeError(
                f"run_batch returned {len(results)} results for "
                f"{len(batch)} payloads")

    def _dispatch_loop(self) -> None:
        while True:
            first = self._take_first()
            if first is None:
                return  # closed and drained
            if first.is_call:
                # Call jobs run inline on the dispatcher (they block on
                # their own device read), never enter a batch, and never
                # ride the finalize pipeline.
                try:
                    result = first.payload()
                except BaseException as e:  # noqa: BLE001 — fail the call, keep serving
                    first.error = e
                    with self._lock:
                        self.stats.errors += 1
                    first.event.set()
                    continue
                first.result = result
                with self._lock:
                    self.stats.latencies_ms.append(
                        (time.perf_counter() - first.t_enqueue) * 1000.0)
                first.event.set()
                continue
            batch = [first]
            self._fill(batch, first.t_enqueue + self.window_s)
            with self._lock:
                # Last look before paying for device work: drop anything
                # whose submitter timed out while the batch was collecting.
                alive = [b for b in batch if not b.abandoned]
                self.stats.abandoned += len(batch) - len(alive)
            batch = alive
            if not batch:
                continue
            payloads = [b.payload for b in batch]
            if self._finalize is not None:
                try:
                    handle = self._run_batch(first.key, payloads)
                except BaseException as e:  # noqa: BLE001 — fail, keep serving
                    self._settle(batch, None, e)
                    continue
                # Blocks when pipeline_depth batches are already in flight:
                # backpressure, not unbounded device queueing.
                self._inflight.put((first.key, batch, handle))
                continue
            try:
                results = self._run_batch(first.key, payloads)
                self._check_counts(results, batch)
            except BaseException as e:  # noqa: BLE001 — fail the batch, keep serving
                self._settle(batch, None, e)
                continue
            self._settle(batch, results, None)

    def _complete_loop(self) -> None:
        while True:
            task = self._inflight.get()
            if task is None:
                return
            key, batch, handle = task
            try:
                results = self._finalize(key, handle,
                                         [b.payload for b in batch])
                self._check_counts(results, batch)
            except BaseException as e:  # noqa: BLE001 — fail the batch, keep serving
                self._settle(batch, None, e)
                continue
            self._settle(batch, results, None)
