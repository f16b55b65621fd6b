"""Continuous-batching caption serving on the slot engine of
``infer/engine.py``.

The port of the JAX package's ``serve/continuous.py``. ``CaptionService``'s
dynamic batcher dispatches whole requests together: a request that arrives
while a batch decodes waits for that batch's whole loop, and a batch whose
rows finish early still pays every pass at full width.
:class:`ContinuousCaptionService` keeps ONE resident decode batch on the
device; requests join a free slot at the next chunk boundary and leave the
moment they emit eos.

The engine decodes the default generation config (greedy, no processors)
and, with ``engine_do_sample``, sampled requests whose warpers match the
engine's. Everything else (beams, other sampling configs, processors,
prompts wider than the engine's text width, ``max_length`` past the engine
buffer) falls back to the inherited dynamic batcher, so the public API is
unchanged.
"""

from __future__ import annotations

import collections
import os
import threading
import time
from typing import Any, Optional

import numpy as np
import torch

from ..config import Config
from ..data.datasets import COCO_PROMPT, load_image_bytes_resized
from ..infer.engine import DecodeEngine
from ..text.tokenizer import TokenizerBase
from ..utils.bucketing import pow2_bucket_width
from .batcher import BatchStats
from .service import (CaptionService, GenParams, normalize_gen_params,
                      pow2_batch)

_ADMIT_IDLE_WAIT_S = 0.050  # idle scheduler wake-up bound (cv-notified)


class _EngineRequest:
    __slots__ = ("image", "src_ids", "src_mask", "max_length", "seed",
                 "event", "result", "error", "t_enqueue", "abandoned")

    def __init__(self, image: np.ndarray, src_ids: np.ndarray,
                 src_mask: np.ndarray, max_length: int,
                 seed: Optional[int] = None):
        self.image = image
        self.src_ids = src_ids
        self.src_mask = src_mask
        self.max_length = max_length
        self.seed = seed
        self.event = threading.Event()
        self.result: Any = None
        self.error: Optional[BaseException] = None
        self.t_enqueue = time.perf_counter()
        self.abandoned = False


class EngineScheduler:
    """Owns a :class:`DecodeEngine` and its one scheduler thread.

    The thread loops admit -> prefill -> insert -> tick -> reap; every
    device call of the engine happens on it. ``submit`` blocks the request
    thread until its row is reaped (detokenization then runs on the request
    thread)."""

    def __init__(self, captioner, text_width: int, slots: int = 16,
                 chunk: int = 4, max_prefill: int = 8,
                 max_length: int = 20, do_sample: bool = False,
                 temperature: float = 1.0, top_k: int = 0,
                 top_p: float = 1.0):
        self.captioner = captioner
        self.text_width = text_width
        self.slots = slots
        self.chunk = chunk
        self.max_prefill = max_prefill
        self.max_length = max_length
        # Engine-wide sampling config; each request still draws from its
        # own generator, seeded with its own seed.
        self.sample = (do_sample, temperature, top_k, top_p)
        self._seed_counter = 0
        # Mixed into automatic seeds only: without it a restarted service
        # replays the same sampled captions for the same request order.
        # Explicit seeds stay pure, so seeded requests reproduce.
        self._seed_nonce = int.from_bytes(os.urandom(4), "little")
        self._lock = threading.Lock()
        self.stats = BatchStats(lock=self._lock)
        self._cv = threading.Condition(self._lock)
        self._queue: collections.deque[_EngineRequest] = collections.deque()
        self._closed = False
        self._engine: Optional[DecodeEngine] = None
        self._thread = threading.Thread(target=self._loop,
                                        name="klab-serve-engine",
                                        daemon=True)
        self._thread.start()

    @property
    def engine(self) -> Optional[DecodeEngine]:
        return self._engine

    # -- request side --------------------------------------------------------
    def submit(self, image: np.ndarray, src_ids: np.ndarray,
               src_mask: np.ndarray, max_length: int,
               timeout: Optional[float],
               seed: Optional[int] = None) -> tuple[np.ndarray, int]:
        """Returns (token_row, n_valid); raises on timeout or an engine
        failure. ``seed`` seeds a sampling engine's generator for this
        request (a fresh one when omitted); a greedy engine ignores it."""
        req = _EngineRequest(image, src_ids, src_mask, max_length, seed)
        with self._cv:
            if self._closed:
                raise RuntimeError("scheduler is closed")
            if req.seed is None:
                self._seed_counter += 1
                req.seed = (self._seed_counter
                            + self._seed_nonce) % (1 << 32)
            else:
                req.seed = int(req.seed)
                if not 0 <= req.seed < (1 << 32):
                    raise ValueError(
                        f"seed must be in [0, 2**32), got {req.seed}")
            self.stats.requests += 1
            self._queue.append(req)
            self._cv.notify()
        if not req.event.wait(timeout):
            with self._lock:
                req.abandoned = True
            raise TimeoutError("request timed out waiting for a decode slot")
        if req.error is not None:
            raise req.error
        return req.result

    def warmup(self) -> None:
        """Build the engine and run every prefill bucket and the tick before
        traffic arrives (one dummy request per bucket, run to its reap),
        through the scheduler thread."""
        size = self.captioner.config.swin.image_size
        dummy = np.zeros((size, size, 3), np.uint8)
        ids = np.zeros((1, self.text_width), np.int32)
        mask = np.ones((1, self.text_width), np.int32)
        b = 1
        while True:
            reqs = [_EngineRequest(dummy, ids, mask, self.max_length, 0)
                    for _ in range(b)]
            with self._cv:
                self._queue.extend(reqs)
                self._cv.notify()
            for r in reqs:
                if not r.event.wait(300):
                    raise RuntimeError("engine warmup timed out")
                if r.error is not None:
                    raise r.error
            if b >= min(self.max_prefill, self.slots):
                break
            b *= 2
        # Warmup does not count in the serving stats.
        with self._lock:
            self.stats.requests = 0
            self.stats.batches = 0
            self.stats.rows = 0
            self.stats.latencies_ms.clear()

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify()
        self._thread.join(timeout=30)

    # -- scheduler thread --------------------------------------------------
    def _ensure_engine(self) -> None:
        """Build the engine (scheduler thread only). Its source width is the
        encoder's concatenated length (image tokens + text width), found
        from one dummy encode."""
        if self._engine is not None:
            return
        cap = self.captioner
        size = cap.config.swin.image_size
        dummy = np.zeros((1, size, size, 3), np.uint8)
        ids = np.zeros((1, self.text_width), np.int32)
        mask = np.ones((1, self.text_width), np.int32)
        enc, _ = cap.encode_tokens(dummy, ids, mask)
        ds, t, k, p = self.sample
        self._engine = DecodeEngine(
            cap.decode_model, slots=self.slots, source_width=enc.shape[1],
            d_model=enc.shape[2], max_length=self.max_length,
            chunk=self.chunk, enc_dtype=enc.dtype, do_sample=ds,
            temperature=t, top_k=k, top_p=p)

    def _take_admission(self) -> list[_EngineRequest]:
        """Pop up to min(free slots, max_prefill) live requests."""
        out: list[_EngineRequest] = []
        cap = min(self._engine.free_slots(), self.max_prefill)
        with self._lock:
            while self._queue and len(out) < cap:
                req = self._queue.popleft()
                if req.abandoned:
                    self.stats.abandoned += 1
                    continue
                out.append(req)
        return out

    def _admit(self, reqs: list[_EngineRequest]) -> None:
        """Encode a pow2-padded arrival batch and insert the real rows."""
        n = len(reqs)
        bucket = pow2_batch(n, self.max_prefill)

        def padded(rows):
            x = np.concatenate(rows, axis=0)
            if bucket > n:
                x = np.concatenate([x, np.broadcast_to(
                    x[:1], (bucket - n,) + x.shape[1:])], axis=0)
            return x

        images = padded([r.image[None] for r in reqs])
        ids = padded([r.src_ids for r in reqs])
        mask = padded([r.src_mask for r in reqs])
        enc, emask = self.captioner.encode_tokens(images, ids, mask)
        gens = None
        if self.sample[0]:
            dev = self.captioner.device
            gens = [torch.Generator(device=dev).manual_seed(r.seed)
                    for r in reqs] + [None] * (bucket - n)
        pre = self._engine.prefill(enc, emask, gens)
        for j, req in enumerate(reqs):
            self._engine.insert(pre, enc, emask, j, tag=req,
                                max_length=req.max_length,
                                generator=None if gens is None else gens[j])
        with self._lock:
            self.stats.batches += 1
            self.stats.rows += n

    def _fail_all_active(self, error: BaseException) -> None:
        """An engine step failed: fail every in-flight request, free the
        slots."""
        for req in self._engine.fail_all():
            if req is not None:
                req.error = error
                req.event.set()
        with self._lock:
            self.stats.errors += 1

    def _loop(self) -> None:
        while True:
            with self._cv:
                while (not self._queue
                       and (self._engine is None
                            or not self._engine.has_live())
                       and not self._closed):
                    self._cv.wait(_ADMIT_IDLE_WAIT_S)
                closing = self._closed
                if closing:
                    for req in self._queue:
                        req.error = RuntimeError("scheduler closed")
                        req.event.set()
                    self._queue.clear()
                has_queue = bool(self._queue)
            if closing:
                # In-flight rows fail too: close() must not orphan them.
                if self._engine is not None and self._engine.has_live():
                    self._fail_all_active(RuntimeError("scheduler closed"))
                return
            if has_queue:
                try:
                    self._ensure_engine()
                except BaseException as e:  # noqa: BLE001 — fail, keep serving
                    with self._lock:
                        reqs = list(self._queue)
                        self._queue.clear()
                        self.stats.errors += len(reqs)
                    for req in reqs:
                        req.error = e
                        req.event.set()
                    continue
            # Tick first (its flags start their copy to the host), then
            # admit while the card computes, then reap.
            ticked = self._engine is not None and self._engine.has_live()
            if ticked:
                try:
                    self._engine.tick()
                except BaseException as e:  # noqa: BLE001 — keep serving
                    self._fail_all_active(e)
                    continue
            while True:
                reqs = self._take_admission() if self._engine else []
                if not reqs:
                    break
                try:
                    self._admit(reqs)
                except BaseException as e:  # noqa: BLE001 — fail batch, keep serving
                    for req in reqs:
                        req.error = e
                        req.event.set()
                    with self._lock:
                        self.stats.errors += len(reqs)
                if self._engine.free_slots() == 0:
                    break
            if not ticked:
                continue
            try:
                reaped = self._engine.reap()
            except BaseException as e:  # noqa: BLE001 — fail in-flight, keep serving
                self._fail_all_active(e)
                continue
            done = time.perf_counter()
            for req, row, n_valid in reaped:
                req.result = (row, n_valid)
                with self._lock:
                    self.stats.latencies_ms.append(
                        (done - req.t_enqueue) * 1000.0)
                req.event.set()


class _MergedStats:
    """``/stats`` over the engine scheduler and the fallback batcher."""

    def __init__(self, engine_stats: BatchStats, fallback_stats: BatchStats,
                 scheduler: EngineScheduler):
        self._engine = engine_stats
        self._fallback = fallback_stats
        self._scheduler = scheduler

    def snapshot(self) -> dict:
        snap = self._engine.snapshot()
        eng = self._scheduler.engine
        snap["engine_slots"] = self._scheduler.slots
        snap["engine_slots_live"] = (int(eng.active.sum())
                                     if eng is not None else 0)
        snap["fallback"] = self._fallback.snapshot()
        return snap


class ContinuousCaptionService(CaptionService):
    """:class:`CaptionService` with continuous batching for the default
    greedy path (``klab-torch-serve --continuous``). Requests the engine
    cannot serve fall back to the inherited dynamic batcher, so every
    CaptionService behaviour (``/caption_stream`` included) keeps working.
    The engine decodes one token per slot per pass: a speculative draft
    length applies to the fallback's greedy requests only (the command
    line refuses ``--continuous`` with ``--speculative_draft``)."""

    def __init__(self, config: Config, state_dict_or_model: Any,
                 tokenizer: TokenizerBase, max_batch: int = 8,
                 window_ms: float = 5.0, decode_int8: bool = False,
                 max_gen_length: int = 128, stream_chunk: int = 4,
                 device=None, slots: int = 16, engine_chunk: int = 4,
                 max_prefill: int = 8,
                 engine_text_width: Optional[int] = None,
                 engine_do_sample: bool = False,
                 engine_temperature: float = 1.0, engine_top_k: int = 0,
                 engine_top_p: float = 1.0,
                 speculative_draft: Optional[int] = None):
        super().__init__(config, state_dict_or_model, tokenizer,
                         max_batch=max_batch, window_ms=window_ms,
                         decode_int8=decode_int8,
                         max_gen_length=max_gen_length,
                         stream_chunk=stream_chunk, device=device,
                         speculative_draft=speculative_draft)
        if engine_text_width is None:
            # The pow2 bucket of the default prompt (Captioner's width
            # policy), capped at max_source_length.
            enc = tokenizer([COCO_PROMPT],
                            max_length=config.max_source_length)
            engine_text_width = pow2_bucket_width(
                np.asarray(enc.attention_mask), 16)
        self.engine_text_width = int(engine_text_width)
        self._scheduler = EngineScheduler(
            self.captioner, text_width=self.engine_text_width, slots=slots,
            chunk=engine_chunk, max_prefill=max_prefill,
            max_length=config.generate_max_length,
            do_sample=engine_do_sample, temperature=engine_temperature,
            top_k=engine_top_k, top_p=engine_top_p)
        self._stats_view = _MergedStats(self._scheduler.stats,
                                        self._batcher.stats,
                                        self._scheduler)

    @property
    def stats(self):
        return self._stats_view

    @property
    def scheduler(self) -> EngineScheduler:
        return self._scheduler

    def _engine_eligible(self, gen: GenParams) -> bool:
        # Sampling goes to the engine only when the request's warpers are
        # the engine's (engine-wide); the draws are per request either way.
        ds, t, k, p = self._scheduler.sample
        sample_ok = (gen.do_sample == ds
                     and (not ds or (gen.temperature, gen.top_k,
                                     gen.top_p) == (t, k, p)))
        return (gen.num_beams == 1 and sample_ok
                and gen.min_length == 0 and gen.repetition_penalty == 1.0
                and gen.no_repeat_ngram_size == 0
                and 2 <= gen.max_length <= self._scheduler.max_length)

    def _tokenize_for_engine(self, prompt: str):
        """(ids, mask, fits): tokenize at full length, then check the real
        tokens fit the engine's text width (only pad columns are trimmed,
        so truncation never changes)."""
        enc = self.tokenizer([prompt],
                             max_length=self.config.max_source_length)
        ids = np.asarray(enc.input_ids)
        mask = np.asarray(enc.attention_mask)
        w = self.engine_text_width
        if mask.shape[1] > w and mask[:, w:].any():
            return ids, mask, False
        if ids.shape[1] >= w:
            return ids[:, :w], mask[:, :w], True
        pad = w - ids.shape[1]
        ids = np.pad(ids, ((0, 0), (0, pad)))
        mask = np.pad(mask, ((0, 0), (0, pad)))
        return ids, mask, True

    def caption_bytes(self, image_bytes: bytes,
                      prompt: Optional[str] = None,
                      gen: Optional[GenParams] = None,
                      timeout: Optional[float] = 120.0) -> str:
        g = normalize_gen_params(gen or self.default_params,
                                 self.max_gen_length)
        if self._engine_eligible(g):
            ids, mask, fits = self._tokenize_for_engine(
                prompt or COCO_PROMPT)
            if fits:
                image = load_image_bytes_resized(
                    image_bytes, self.config.swin.image_size)
                row, n_valid = self._scheduler.submit(
                    image, ids, mask, g.max_length, timeout)
                return self.tokenizer.batch_decode(
                    row[None, :n_valid], skip_special_tokens=True)[0]
        return super().caption_bytes(image_bytes, prompt=prompt, gen=g,
                                     timeout=timeout)

    def warmup(self) -> list[int]:
        buckets = super().warmup()
        self._scheduler.warmup()
        return buckets

    def close(self) -> None:
        self._scheduler.close()
        super().close()
