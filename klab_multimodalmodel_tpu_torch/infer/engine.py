"""Continuous-batching decode engine (slot-based).

The port of the JAX package's ``infer/engine.py``. One resident decode batch
of ``slots`` rows stays on the device, every row at its own position (per-row
``cache_index`` tensors and per-row relative-position bias rows,
``models/t5.py`` ``decode_step``), and requests join and leave at chunk
boundaries:

* ``prefill``: ``generate.stream_init`` on the arrivals' encoder output
  (greedy's first step), batched over the arrivals;
* ``insert``: row ``j`` of a prefill written into a free slot of every
  cache entry, the token buffer and the flags;
* ``tick``: ``chunk`` decoder passes over every slot, with no read-back
  between them. A row runs while it is occupied, unfinished and below its
  own ``max_length - 1``; other rows ride along masked (their token writes
  write the old value back, their cache writes land past the buffer or in
  rows that are never read), so running exactly ``chunk`` passes gives the
  tokens of the JAX package's loop, which stops early once no row runs.
  The packed ``(steps, finished)`` flags are copied to pinned host memory
  behind an event, as the JAX package's ``copy_to_host_async``;
* ``reap``: rows that emitted eos or reached their ``max_length`` free
  their slot, read from those flags.

A row attends only its own cache row, so its tokens are greedy's on the same
encoder rows, as far as the fp32 products of a ``slots``-row batch round as
those of the request's own batch (a difference moves a token only at a knife
edge). Sampling draws per slot: each slot holds its request's
``torch.Generator``, and row ``i`` draws from its ``(1, V)`` row with it, as
a batch-1 ``sample_decode`` from the same seed draws.

Every method runs on one thread (the serving scheduler's) under
``torch.inference_mode``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence

import numpy as np
import torch

from ..models.t5 import Cache, T5ForConditionalGeneration
from .generate import (StreamState, _broadcast_cache_index, _Choice,
                       _prime, _select_next)


@dataclasses.dataclass
class EngineState:
    """Resident device state of the decode batch. ``steps[i]`` counts the
    tokens slot ``i`` has generated (positions ``0..steps[i]`` of
    ``tokens[i]`` are decided); ``cache`` carries (S,) ``cache_index``
    tensors; ``enc`` / ``enc_mask`` are the slots' encoder context (the
    cross-attention K/V in ``cache`` were computed from them)."""

    steps: torch.Tensor     # (S,) int64
    tokens: torch.Tensor    # (S, max_length) int32
    cache: Cache
    finished: torch.Tensor  # (S,) bool
    enc: torch.Tensor       # (S, W, d_model)
    enc_mask: torch.Tensor  # (S, W)


class DecodeEngine:
    """Slot manager over the resident decode batch (one owning thread).

    ``model``: the decoder to run (a ``T5ForConditionalGeneration``, or its
    int8 copy from ``infer/quantize.py``); the state lives on its device.
    Sampling is engine-wide
    (``do_sample`` and the warpers); the draws are per request, from the
    generator each ``prefill`` row and ``insert`` receive."""

    def __init__(self, model: T5ForConditionalGeneration, slots: int,
                 source_width: int, d_model: int, max_length: int,
                 chunk: int = 4, enc_dtype: torch.dtype = torch.float32,
                 min_length: int = 0, repetition_penalty: float = 1.0,
                 no_repeat_ngram_size: int = 0, do_sample: bool = False,
                 temperature: float = 1.0, top_k: int = 0,
                 top_p: float = 1.0):
        if chunk < 1:
            raise ValueError(f"chunk must be >= 1, got {chunk}")
        self.model = model
        self.slots = slots
        self.source_width = source_width
        self.max_length = max_length
        self.chunk = chunk
        self.gen = (min_length, repetition_penalty, no_repeat_ngram_size)
        self.sample = (do_sample, temperature, top_k, top_p)
        self.device = dev = next(model.parameters()).device
        size = model.size
        # Prime a zero batch for the state's structure; empty slots get a
        # ones mask so that their cross-attention stays finite.
        enc0 = torch.zeros(slots, source_width, d_model, dtype=enc_dtype,
                           device=dev)
        mask0 = torch.ones(slots, source_width, dtype=torch.int32,
                           device=dev)
        with torch.inference_mode():
            pre = _prime(model, enc0, mask0, max_length, _Choice())
            self.state = EngineState(
                steps=torch.zeros(slots, dtype=torch.int64, device=dev),
                tokens=torch.full((slots, max_length), size.pad_token_id,
                                  dtype=torch.int32, device=dev),
                cache=_broadcast_cache_index(pre.cache, slots),
                finished=torch.zeros(slots, dtype=torch.bool, device=dev),
                enc=enc0, enc_mask=mask0)
        # Occupancy and per-row max_length on the host (the scheduler's
        # decisions) and mirrored on the device (the tick's masks), so a
        # tick never copies from the host.
        self.active = np.zeros((slots,), bool)
        self.row_max = np.full((slots,), max_length, np.int64)
        self._active_dev = torch.zeros(slots, dtype=torch.bool, device=dev)
        self._row_max_dev = torch.full((slots,), max_length,
                                       dtype=torch.int64, device=dev)
        self._tags: list[Any] = [None] * slots
        self._generators: list[Optional[torch.Generator]] = [None] * slots
        # The last tick's (steps, finished), copied to pinned host memory
        # behind an event, and which slots were live when it was enqueued.
        pinned = dev.type == "cuda"
        self._flags_host = torch.zeros((2, slots), dtype=torch.int64,
                                       pin_memory=pinned)
        self._flags_event: Optional[torch.cuda.Event] = None
        self._flags_active: Optional[np.ndarray] = None

    # -- slot management ---------------------------------------------------
    def free_slots(self) -> int:
        return int((~self.active).sum())

    def has_live(self) -> bool:
        return bool(self.active.any())

    def _choice(self, generators: Optional[Sequence] = None) -> _Choice:
        ml, rp, nr = self.gen
        ds, t, k, p = self.sample
        return _Choice(ds, t, k, p, ml, rp, nr, None,
                       tuple(generators) if ds else None)

    @torch.inference_mode()
    def prefill(self, enc: torch.Tensor, enc_mask: torch.Tensor,
                generators: Optional[Sequence[torch.Generator]] = None
                ) -> StreamState:
        """Prime a W-row arrival batch (encoder output at the engine's
        source width): positions 0 (decoder start) and 1 filled. A sampling
        engine needs ``generators``, one per arrival row, on the device:
        token 1 is drawn from each request's own generator."""
        if enc.shape[1] != self.source_width:
            raise ValueError(
                f"prefill width {enc.shape[1]} != engine source width "
                f"{self.source_width}")
        if self.sample[0] and (generators is None
                               or len(generators) != enc.shape[0]):
            raise ValueError("sampling engine: prefill needs one generator "
                             "per arrival row (None for a padding row)")
        return _prime(self.model, enc, enc_mask, self.max_length,
                      self._choice(generators))

    @torch.inference_mode()
    def insert(self, pre: StreamState, enc: torch.Tensor,
               enc_mask: torch.Tensor, j: int, tag: Any,
               max_length: Optional[int] = None,
               generator: Optional[torch.Generator] = None) -> int:
        """Insert prefill row ``j`` into a free slot; returns the slot.
        ``generator``: the request's sampling generator (the one its prefill
        row drew from); ignored by a greedy engine."""
        free = np.flatnonzero(~self.active)
        if free.size == 0:
            raise RuntimeError("no free slot")
        m = self.max_length if max_length is None else int(max_length)
        if not 1 <= m <= self.max_length:
            raise ValueError(f"max_length must be in [1, {self.max_length}]"
                             f", got {m}")
        slot = int(free[0])
        st = self.state
        for eng, new in zip(st.cache, pre.cache):
            for kind in ("self", "cross"):
                for key in ("cached_key", "cached_value"):
                    eng[kind][key][slot] = new[kind][key][j]
            # Every prefill row sits at the same position.
            eng["self"]["cache_index"][slot] = new["self"]["cache_index"]
        st.tokens[slot] = pre.tokens[j]
        st.steps[slot] = pre.step
        st.finished[slot] = pre.finished[j]
        st.enc[slot] = enc[j].to(st.enc.dtype)
        st.enc_mask[slot] = enc_mask[j].to(st.enc_mask.dtype)
        self.active[slot] = True
        self.row_max[slot] = m
        self._active_dev[slot] = True
        self._row_max_dev[slot] = m
        self._tags[slot] = tag
        self._generators[slot] = generator
        # The last tick's flags describe the slot's previous occupant: a
        # reap before the next tick must not free the new request on them.
        if self._flags_active is not None:
            self._flags_active[slot] = False
        return slot

    @torch.inference_mode()
    def tick(self) -> None:
        """``chunk`` decoder passes over every slot (running rows advance
        one token each), with no read-back; then the packed flags start
        their copy to the host."""
        st = self.state
        dev = self.device
        size = self.model.size
        L = self.max_length
        active, row_max = self._active_dev, self._row_max_dev
        choice = self._choice(
            [g if a else None for g, a in zip(self._generators,
                                              self.active)])
        steps, tokens, finished = st.steps, st.tokens, st.finished
        for _ in range(self.chunk):
            running = active & ~finished & (steps < row_max - 1)
            cur = torch.gather(tokens, 1, steps[:, None])
            logits, st.cache = self.model.decode_step(
                cur, steps, st.enc, L, st.enc_mask, cache=st.cache)
            nxt = _select_next(logits[:, -1], tokens, steps, size, ~running,
                               choice)
            # Running rows write at steps + 1; the rest write back.
            pos = (steps + 1).clamp(0, L - 1)[:, None]
            old = torch.gather(tokens, 1, pos)[:, 0]
            tokens.scatter_(1, pos, torch.where(running, nxt, old)[:, None])
            finished = finished | (running & (nxt == size.eos_token_id))
            steps = steps + running.to(torch.int64)
        st.steps, st.finished = steps, finished
        flags = torch.stack([steps, finished.to(torch.int64)])
        self._flags_host.copy_(flags, non_blocking=True)
        if dev.type == "cuda":
            self._flags_event = torch.cuda.Event()
            self._flags_event.record()
        self._flags_active = self.active.copy()

    @torch.inference_mode()
    def reap(self) -> list[tuple[Any, np.ndarray, int]]:
        """Collect finished rows: ``[(tag, token_row, n_valid)]``; frees
        their slots. Reads the last tick's flags (waiting on their event);
        the token buffer is read only when some row is done."""
        if not self.active.any():
            return []
        if self._flags_active is not None:
            if self._flags_event is not None:
                self._flags_event.synchronize()
            f = self._flags_host.numpy()
            live = self._flags_active
        else:  # no tick since the first insert
            f = torch.stack([self.state.steps,
                             self.state.finished.to(torch.int64)]).cpu(
                                 ).numpy()
            live = self.active
        steps, finished = f[0], f[1].astype(bool)
        done = live & self.active & (finished | (steps >= self.row_max - 1))
        if not done.any():
            return []
        tokens = self.state.tokens.cpu().numpy()
        out = []
        for slot in np.flatnonzero(done):
            slot = int(slot)
            out.append((self._tags[slot], tokens[slot].copy(),
                        int(steps[slot]) + 1))
            self.active[slot] = False
            self._active_dev[slot] = False
            self._tags[slot] = None
            self._generators[slot] = None
        return out

    def fail_all(self) -> list[Any]:
        """Free every occupied slot; returns their tags."""
        tags = [self._tags[int(s)] for s in np.flatnonzero(self.active)]
        self.active[:] = False
        self._active_dev.fill_(False)
        self._tags = [None] * self.slots
        self._generators = [None] * self.slots
        return tags
