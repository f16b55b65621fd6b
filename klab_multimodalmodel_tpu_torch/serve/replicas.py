"""Scale-out serving: one replica per device, least-loaded routing.

The port of the JAX package's ``serve/replicas.py``. A model that fits one
card is served by N independent replicas, one per ``torch.device``, each
with its own dynamic batcher and dispatcher thread; the router only picks a
replica (the fewest in-flight requests, ties broken round-robin), and
batching, pipelining and streaming all happen inside the replica. Each
replica builds its own model on its device from the same state dict.
"""

from __future__ import annotations

import threading
from typing import Any, Mapping, Optional, Sequence

import torch

from ..config import Config
from ..text.tokenizer import TokenizerBase
from .service import CaptionService, GenParams


class _AggregateStats:
    """The ``stats.snapshot()`` surface the HTTP layer reads: counters
    summed across replicas, and each replica's own snapshot."""

    def __init__(self, replicas: Sequence[CaptionService]):
        self._replicas = replicas

    def snapshot(self) -> dict:
        per = [r.stats.snapshot() for r in self._replicas]
        out = {"replicas": len(per)}
        for key in ("requests", "batches", "calls", "errors", "abandoned"):
            out[key] = sum(p[key] for p in per)
        out["per_replica"] = per
        return out


class ReplicatedCaptionService:
    """N per-device :class:`CaptionService` replicas behind a least-loaded
    router, with the surface the HTTP front-end consumes
    (``caption_bytes`` / ``caption_stream_bytes`` / ``stats`` /
    ``default_params`` / ``max_gen_length`` / ``warmup`` / ``close``).
    ``state_dict``: a ``MultiModalModel`` state dict, loaded into a model
    on every device."""

    def __init__(self, config: Config,
                 state_dict: Mapping[str, torch.Tensor],
                 tokenizer: TokenizerBase, devices: Sequence[Any],
                 **service_kwargs):
        if not devices:
            raise ValueError("devices must be non-empty")
        if isinstance(state_dict, torch.nn.Module):
            raise ValueError("replicas need a state dict: each builds its "
                             "own model on its device")
        self.config = config
        self.replicas = [
            CaptionService(config, state_dict, tokenizer, device=d,
                           **service_kwargs) for d in devices]
        self.devices = [r.device for r in self.replicas]
        self.stats = _AggregateStats(self.replicas)
        self.default_params: GenParams = self.replicas[0].default_params
        self.max_gen_length = self.replicas[0].max_gen_length
        self._lock = threading.Lock()
        self._inflight = [0] * len(self.replicas)
        self._rr = 0  # round-robin tie-break cursor

    # -- routing -------------------------------------------------------------
    def _acquire(self) -> int:
        """The replica with the fewest in-flight requests; ties go
        round-robin so an idle fleet still spreads load."""
        with self._lock:
            n = len(self.replicas)
            best, best_load = None, None
            for off in range(n):
                i = (self._rr + off) % n
                if best_load is None or self._inflight[i] < best_load:
                    best, best_load = i, self._inflight[i]
            self._rr = (best + 1) % n
            self._inflight[best] += 1
            return best

    def _release(self, i: int) -> None:
        with self._lock:
            self._inflight[i] -= 1

    # -- request surface (mirrors CaptionService) ----------------------------
    def caption_bytes(self, image_bytes: bytes,
                      prompt: Optional[str] = None,
                      gen: Optional[GenParams] = None,
                      timeout: Optional[float] = 120.0) -> str:
        i = self._acquire()
        try:
            return self.replicas[i].caption_bytes(image_bytes, prompt=prompt,
                                                  gen=gen, timeout=timeout)
        finally:
            self._release(i)

    def caption_stream_bytes(self, image_bytes: bytes,
                             prompt: Optional[str] = None,
                             gen: Optional[GenParams] = None,
                             chunk_size: Optional[int] = None,
                             timeout: Optional[float] = 120.0):
        """A stream stays on ONE replica for its whole life (its cache lives
        on that device) and counts as in flight until it finishes or is
        dropped. The replica is acquired at the first iteration: a
        generator never started runs no code, not even ``finally``."""

        def gen_events():
            i = self._acquire()
            try:
                yield from self.replicas[i].caption_stream_bytes(
                    image_bytes, prompt=prompt, gen=gen,
                    chunk_size=chunk_size, timeout=timeout)
            finally:
                self._release(i)

        return gen_events()

    # -- lifecycle ------------------------------------------------------------
    def warmup(self) -> list[int]:
        """Warm every replica; returns the bucket list (the same for all)."""
        buckets: list[int] = []
        for r in self.replicas:
            buckets = r.warmup()
        return buckets

    def close(self) -> None:
        for r in self.replicas:
            r.close()
