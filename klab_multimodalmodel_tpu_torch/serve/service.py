"""Caption service: request bytes -> batched model call -> strings.

The port of the JAX package's ``serve/service.py``. Bridges the HTTP layer
to :class:`infer.captioner.Captioner` through a :class:`DynamicBatcher`.
Real occupancy is padded up to the next power-of-two batch bucket (<=
``max_batch``) by repeating row 0, so the batch shapes the card sees are
{1, 2, 4, ..., max_batch} per generation-parameter group; ``warmup()`` runs
every bucket of the default group, and one stream, before the server
reports healthy (the first call at a shape pays cuBLAS's and the
allocator's set-up).

The batcher's launch/finish split is kept: ``_run_batch`` runs the encoders
and the decode loop and returns the ids on the device, ``_finish_batch``
reads them back and detokenizes on the completer thread. The port's decode
loop reads a flag back every pass, so the launch returns once decoding is
done; only the detokenization overlaps the next batch.
"""

from __future__ import annotations

import dataclasses
import threading
from dataclasses import dataclass
from typing import Any, Optional, Sequence

import numpy as np
import torch

from ..config import Config
from ..data.datasets import COCO_PROMPT, load_image_bytes_resized
from ..infer.captioner import Captioner
from ..text.tokenizer import TokenizerBase
from .batcher import DynamicBatcher


@dataclass(frozen=True)
class GenParams:
    """Generation parameters that select the decode loop: requests may
    share a batch iff their GenParams are equal (the batcher group key)."""

    max_length: int
    num_beams: int
    do_sample: bool = False
    temperature: float = 1.0
    top_k: int = 0
    top_p: float = 1.0
    min_length: int = 0
    repetition_penalty: float = 1.0
    no_repeat_ngram_size: int = 0


def normalize_gen_params(gen: GenParams, max_gen_length: int) -> GenParams:
    """Validate client generation params and canonicalize no-op fields.

    Hard bounds, rejected with ``ValueError`` (HTTP 400): an unbounded
    ``max_length`` or beam width would let one request allocate an
    arbitrary cache on the single dispatcher. Fields the selected decode
    path never reads (the sampling warpers under greedy or beams) reset to
    their defaults so cosmetically different requests share a batch."""
    if not 1 <= gen.max_length <= max_gen_length:
        raise ValueError(f"max_length must be in [1, {max_gen_length}], "
                         f"got {gen.max_length}")
    if not 1 <= gen.num_beams <= 16:
        raise ValueError(f"num_beams must be in [1, 16], got {gen.num_beams}")
    if gen.do_sample and gen.num_beams > 1:
        raise ValueError("beam-search sampling is not supported; use "
                         "num_beams=1 with do_sample=true")
    if not 0 <= gen.min_length <= gen.max_length:
        raise ValueError(f"min_length must be in [0, max_length], "
                         f"got {gen.min_length}")
    if gen.repetition_penalty <= 0:
        raise ValueError("repetition_penalty must be > 0")
    if gen.no_repeat_ngram_size < 0:
        raise ValueError("no_repeat_ngram_size must be >= 0")
    if gen.do_sample:
        if gen.temperature <= 0:
            raise ValueError("temperature must be > 0")
        if not 0 < gen.top_p <= 1.0:
            raise ValueError("top_p must be in (0, 1]")
        if gen.top_k < 0:
            raise ValueError("top_k must be >= 0")
        return gen
    if (gen.temperature, gen.top_k, gen.top_p) != (1.0, 0, 1.0):
        gen = dataclasses.replace(gen, temperature=1.0, top_k=0, top_p=1.0)
    return gen


def pow2_batch(n: int, cap: int) -> int:
    """Smallest power of two >= n, capped at ``cap`` (the batch-shape
    bucket). For a non-power-of-two cap the top bucket is ``cap`` itself,
    so batches never exceed the operator's ``--max_batch``."""
    b = 1
    while b < n and b < cap:
        b *= 2
    return min(b, cap)


def batch_buckets(cap: int) -> list[int]:
    """The full bucket set ``pow2_batch`` can return: powers of two below
    ``cap`` plus ``cap`` (warmup runs exactly these)."""
    out, b = [], 1
    while b < cap:
        out.append(b)
        b *= 2
    out.append(cap)
    return out


class CaptionService:
    """Thread-safe captioning with dynamic batching.

    ``caption_bytes`` is what HTTP handler threads call: it decodes the
    image on the CALLING thread (host work parallelizes across request
    threads) and submits the decoded array to the single device-owning
    dispatcher. ``state_dict_or_model`` and ``device`` are
    :class:`Captioner`'s (None: the card); ``speculative_draft`` is too
    (None reads ``KLAB_DECODE_SPECULATIVE``).
    """

    def __init__(self, config: Config, state_dict_or_model: Any,
                 tokenizer: TokenizerBase, max_batch: int = 8,
                 window_ms: float = 5.0, decode_int8: bool = False,
                 max_gen_length: int = 128, stream_chunk: int = 4,
                 device=None, speculative_draft: Optional[int] = None):
        self.config = config
        self.tokenizer = tokenizer
        self.captioner = Captioner(config, state_dict_or_model, tokenizer,
                                   device=device, decode_int8=decode_int8,
                                   speculative_draft=speculative_draft)
        self.device = self.captioner.device
        self.max_batch = max_batch
        # Default tokens per SSE event of /caption_stream.
        self.stream_chunk = stream_chunk
        # Upper bound on a client's max_length (the cache's size); never
        # below the configured default so default requests pass.
        self.max_gen_length = max(max_gen_length, config.generate_max_length)
        self._sample_lock = threading.Lock()
        self._sample_calls = 0
        self._batcher = DynamicBatcher(self._run_batch, max_batch=max_batch,
                                       window_ms=window_ms,
                                       finalize=self._finish_batch)
        self.default_params = GenParams(
            max_length=config.generate_max_length,
            num_beams=config.num_beams)

    @property
    def stats(self):
        return self._batcher.stats

    def _next_generator(self) -> torch.Generator:
        """A sampling generator on the service's device seeded with the
        call counter (the JAX package's ``PRNGKey(n)``): deterministic
        given the call order."""
        with self._sample_lock:
            self._sample_calls += 1
            n = self._sample_calls
        return torch.Generator(device=self.device).manual_seed(n)

    # -- request side -------------------------------------------------------
    def caption_bytes(self, image_bytes: bytes,
                      prompt: Optional[str] = None,
                      gen: Optional[GenParams] = None,
                      timeout: Optional[float] = 120.0) -> str:
        gen = normalize_gen_params(gen or self.default_params,
                                   self.max_gen_length)
        image = load_image_bytes_resized(image_bytes,
                                         self.config.swin.image_size)
        return self._batcher.submit(gen, (image, prompt or COCO_PROMPT),
                                    timeout=timeout)

    def caption_stream_bytes(self, image_bytes: bytes,
                             prompt: Optional[str] = None,
                             gen: Optional[GenParams] = None,
                             chunk_size: Optional[int] = None,
                             timeout: Optional[float] = 120.0):
        """Streaming captioning: a generator yielding ``(caption, done)``
        with the cumulative decoded caption after the first token and then
        after every ``chunk_size`` tokens.

        The image decodes on the CALLING thread; every advance is one
        dispatcher *call job* (``DynamicBatcher.submit_call``), so a stream
        holds the device for one chunk at a time and interleaves with
        batched /caption traffic, and a client that disconnects stops the
        generator and with it the device work. Greedy and sampling only (a
        beam's best hypothesis can be displaced at any step)."""
        gen = normalize_gen_params(gen or self.default_params,
                                   self.max_gen_length)
        if gen.num_beams > 1:
            raise ValueError("streaming supports greedy/sampling only "
                             "(num_beams must be 1)")
        chunk = chunk_size if chunk_size is not None else self.stream_chunk
        if not 1 <= chunk <= 64:
            raise ValueError(f"chunk_size must be in [1, 64], got {chunk}")
        image = load_image_bytes_resized(image_bytes,
                                         self.config.swin.image_size)
        generator = self._next_generator() if gen.do_sample else None

        # The captioner's generator launches device work, so it is only
        # ever advanced on the dispatcher thread: one next() per job.
        stream_holder = {}

        def _start():
            stream_holder["it"] = self.captioner.caption_stream(
                image[None], [prompt or COCO_PROMPT],
                max_length=gen.max_length, chunk_size=chunk,
                do_sample=gen.do_sample, temperature=gen.temperature,
                top_k=gen.top_k, top_p=gen.top_p, generator=generator,
                min_length=gen.min_length,
                repetition_penalty=gen.repetition_penalty,
                no_repeat_ngram_size=gen.no_repeat_ngram_size)
            return next(stream_holder["it"])

        texts, done = self._batcher.submit_call(_start, timeout=timeout)
        yield texts[0], done
        while not done:
            texts, done = self._batcher.submit_call(
                lambda: next(stream_holder["it"]), timeout=timeout)
            yield texts[0], done

    def close(self) -> None:
        self._batcher.close()

    # -- device side (dispatcher thread only) --------------------------------
    def _run_batch(self, gen: GenParams,
                   payloads: Sequence[tuple[np.ndarray, str]]):
        """LAUNCH stage: stack and pad to the bucket, run the encoders and
        the decode loop, return the (B, max_length) ids on the device."""
        n = len(payloads)
        bucket = pow2_batch(n, self.max_batch)
        images = np.stack([p[0] for p in payloads], axis=0)
        prompts = [p[1] for p in payloads]
        if bucket > n:
            # Pad rows repeat row 0; the finish stage slices them off.
            pad = np.broadcast_to(images[:1],
                                  (bucket - n,) + images.shape[1:])
            images = np.concatenate([images, pad], axis=0)
            prompts = prompts + [prompts[0]] * (bucket - n)
        generator = self._next_generator() if gen.do_sample else None
        return self.captioner.caption_launch(
            images, prompts, max_length=gen.max_length,
            num_beams=gen.num_beams, do_sample=gen.do_sample,
            temperature=gen.temperature, top_k=gen.top_k, top_p=gen.top_p,
            generator=generator, min_length=gen.min_length,
            repetition_penalty=gen.repetition_penalty,
            no_repeat_ngram_size=gen.no_repeat_ngram_size)

    def _finish_batch(self, gen: GenParams, ids,
                      payloads: Sequence[tuple[np.ndarray, str]]) -> list[str]:
        """FINISH stage (completer thread): read the ids back, detokenize,
        drop the bucket-padding rows."""
        return self.captioner.caption_finish(ids)[:len(payloads)]

    # -- startup -------------------------------------------------------------
    def warmup(self) -> list[int]:
        """Run every batch bucket of the default group, and one stream,
        before the server reports healthy. Returns the buckets run."""
        size = self.config.swin.image_size
        dummy = np.zeros((size, size, 3), np.uint8)
        buckets = batch_buckets(self.max_batch)
        for b in buckets:
            # Direct launch+finish (not via submit): runs before the server
            # accepts traffic, hits bucket b, stays out of the stats.
            payloads = [(dummy, COCO_PROMPT)] * b
            self._finish_batch(self.default_params,
                               self._run_batch(self.default_params,
                                               payloads), payloads)
        for _ in self.captioner.caption_stream(
                dummy[None], [COCO_PROMPT],
                max_length=self.default_params.max_length,
                chunk_size=self.stream_chunk):
            pass
        return buckets
