"""Autoregressive generation with a KV cache: greedy, beam search, sampling
and streaming.

HF ``generate`` defaults: ``max_length`` counts the decoder-start token,
decoder start = pad id, stop at eos, finished rows emit pad. Each loop runs
in Python, one incremental decoder pass per step, and reads one flag back
from the device per pass to stop early (the JAX package's
``lax.while_loop`` condition).

Beam search is HF's vectorized ``GenerationMixin._beam_search`` at its T5
defaults (``do_sample=False``, ``early_stopping=False``, one eos token, so
``2 * num_beams`` candidates per step): the K best non-finished candidates
continue as running beams; candidates that hit a stopping criterion (eos,
or the sequence reaching ``max_length``) and rank inside the top K merge
into a K-slot finished store under the length penalty
``sum(logp) / generated_len ** length_penalty`` (``generated_len``
excludes the decoder-start token); a per-row early-stop heuristic freezes
the store once the best running beam can no longer beat the worst stored
hypothesis. Beams fold into the batch dimension: the encoder runs once per
request, and its output is repeated K times before the decoder.

Sampling draws from an explicit ``torch.Generator`` on the model's device
(HF's softmax + multinomial), so a run is reproducible per generator state;
the draws are torch's, not the JAX package's threefry stream. The engine
(``infer/engine.py``) gives each row its own generator: row ``i`` draws
from its ``(1, V)`` row with generator ``i``, as a batch-1 loop would.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np
import torch

from ..models.t5 import Cache, T5ForConditionalGeneration

NEG9 = -1.0e9  # HF's additive masking of beams, bit for bit


def _broadcast_cache_index(cache: Cache, n_rows: int) -> Cache:
    """Int ``cache_index`` entries -> (n_rows,) int64 tensors, in place:
    ``decode_step`` then runs every row at its own position (the engine's
    slots, speculative decoding's per-row acceptance)."""
    for layer in cache:
        kv = layer["self"]
        kv["cache_index"] = torch.full((n_rows,), kv["cache_index"],
                                       dtype=torch.int64,
                                       device=kv["cached_key"].device)
    return cache


def _init_cache(model: T5ForConditionalGeneration,
                encoder_hidden: torch.Tensor, encoder_mask, start_tokens,
                max_length: int) -> tuple[torch.Tensor, Cache]:
    """Prime the cache with the first decode step (writes position 0)."""
    logits, cache = model.decode_step(start_tokens, 0, encoder_hidden,
                                      max_length, encoder_mask, cache=None)
    return logits[:, -1], cache


def _step(model, cache, token, step, encoder_hidden, encoder_mask,
          max_length) -> tuple[torch.Tensor, Cache]:
    logits, cache = model.decode_step(token, step, encoder_hidden,
                                      max_length, encoder_mask, cache=cache)
    return logits[:, -1], cache


def _top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` on the last axis: the k largest, descending, and
    on ties the lower index first. ``torch.topk`` promises no order among
    ties, and the beam store is full of exact ties (its -1e9 and -2e9
    entries), so this is a stable sort cut to k."""
    values, index = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], index[..., :k]


@dataclasses.dataclass(frozen=True)
class _Choice:
    """How the sequential loops choose a token: HF's processor chain, then
    argmax, or the warpers and a draw from ``generator``. ``generators``
    (one per row, None for a row that draws nothing) replaces
    ``generator`` with per-row draws."""

    do_sample: bool = False
    temperature: float = 1.0
    top_k: int = 0
    top_p: float = 1.0
    min_length: int = 0
    repetition_penalty: float = 1.0
    no_repeat_ngram_size: int = 0
    generator: Optional[torch.Generator] = None
    generators: Optional[tuple] = None


def _draw(probs: torch.Tensor, choice: _Choice) -> torch.Tensor:
    """(B,) draws from (B, V) probabilities: one multinomial over the batch
    from ``generator``, or row by row from ``generators`` (a row without a
    generator takes its argmax; the caller discards it)."""
    if choice.generators is None:
        return torch.multinomial(probs, 1, generator=choice.generator)[:, 0]
    rows = [torch.multinomial(probs[i:i + 1], 1, generator=g)[:, 0]
            if g is not None else probs[i:i + 1].argmax(-1)
            for i, g in enumerate(choice.generators)]
    return torch.cat(rows)


def _select_next(logits, tokens, step, size, finished,
                 choice: _Choice) -> torch.Tensor:
    """One token choice from raw step logits, shared by greedy, sampling
    and the streaming loop (so chunked and monolithic runs choose the same
    tokens): the processor chain, then argmax or a warped draw; finished
    rows emit pad. A draw is made for every row, finished or not, so the
    generator advances the same way however the loop is chunked."""
    logits = process_logits(logits, tokens, step, size.eos_token_id,
                            choice.min_length, choice.repetition_penalty,
                            choice.no_repeat_ngram_size)
    if choice.do_sample:
        logits = warp_logits(logits, choice.temperature, choice.top_k,
                             choice.top_p)
        nxt = _draw(torch.softmax(logits, dim=-1), choice)
    else:
        nxt = torch.argmax(logits, dim=-1)
    return torch.where(finished, size.pad_token_id, nxt).to(torch.int32)


@dataclasses.dataclass
class StreamState:
    """Resumable state of the sequential loops: ``step`` counts tokens
    generated so far (positions ``0..step`` of ``tokens`` are decided);
    ``cache`` is advanced through position ``step``; ``finished`` marks
    rows that emitted eos. ``tokens``, ``cache`` and ``finished`` are
    updated in place as the loop advances."""

    step: int
    tokens: torch.Tensor
    cache: Cache
    finished: torch.Tensor


def _prime(model, encoder_hidden, encoder_mask, max_length,
           choice: _Choice) -> StreamState:
    """Prime the cache and choose token 1: positions 0 (decoder start)
    and 1 filled, ``step`` 1."""
    size = model.size
    B = encoder_hidden.shape[0]
    device = encoder_hidden.device
    start = torch.full((B, 1), size.decoder_start_token_id, dtype=torch.int32,
                       device=device)
    logits0, cache = _init_cache(model, encoder_hidden, encoder_mask, start,
                                 max_length)
    tokens = torch.full((B, max_length), size.pad_token_id, dtype=torch.int32,
                        device=device)
    tokens[:, 0] = start[:, 0]
    tok1 = _select_next(logits0, tokens, 0, size,
                        torch.zeros(B, dtype=torch.bool, device=device),
                        choice)
    tokens[:, 1] = tok1
    return StreamState(1, tokens, cache, tok1 == size.eos_token_id)


def _advance(model, state: StreamState, encoder_hidden, encoder_mask,
             max_length, choice: _Choice, limit: int) -> StreamState:
    """Decode passes while ``step < limit`` and some row is unfinished:
    the one loop body of greedy, sampling and streaming."""
    size = model.size
    while state.step < limit and not bool(state.finished.all()):
        s = state.step
        logits, state.cache = _step(model, state.cache,
                                    state.tokens[:, s:s + 1], s,
                                    encoder_hidden, encoder_mask, max_length)
        nxt = _select_next(logits, state.tokens, s, size, state.finished,
                           choice)
        state.tokens[:, s + 1] = nxt
        state.finished |= nxt == size.eos_token_id
        state.step = s + 1
    return state


def greedy_decode(model: T5ForConditionalGeneration,
                  encoder_hidden: torch.Tensor,
                  encoder_mask: Optional[torch.Tensor],
                  max_length: int = 20, min_length: int = 0,
                  repetition_penalty: float = 1.0,
                  no_repeat_ngram_size: int = 0) -> torch.Tensor:
    """Returns (B, max_length) int32 token ids laid out as HF ``generate``
    does: ``[decoder_start, t1, t2, ..., eos, pad, pad...]``. Logits
    processors apply to the raw fp32 logits before the argmax, where HF's
    ``_sample`` runs them."""
    choice = _Choice(min_length=min_length,
                     repetition_penalty=repetition_penalty,
                     no_repeat_ngram_size=no_repeat_ngram_size)
    state = _prime(model, encoder_hidden, encoder_mask, max_length, choice)
    return _advance(model, state, encoder_hidden, encoder_mask, max_length,
                    choice, max_length - 1).tokens


def _reorder_self_kv(cache: Cache, rows: torch.Tensor) -> None:
    """Point each cache row at its new parent's self-attention K/V
    (``rows``: the flat parent row of every row)."""
    for layer in cache:
        kv = layer["self"]
        kv["cached_key"] = kv["cached_key"].index_select(0, rows)
        kv["cached_value"] = kv["cached_value"].index_select(0, rows)


def beam_search_decode(model: T5ForConditionalGeneration,
                       encoder_hidden: torch.Tensor,
                       encoder_mask: Optional[torch.Tensor],
                       max_length: int = 20, num_beams: int = 4,
                       length_penalty: float = 1.0, min_length: int = 0,
                       repetition_penalty: float = 1.0,
                       no_repeat_ngram_size: int = 0,
                       return_scores: bool = False):
    """HF-exact beam search; returns the best hypothesis, (B, max_length)
    int32, and with ``return_scores`` also the finished store's
    length-normalized scores (B, num_beams), best first.

    Loop variable ``s`` counts tokens generated so far; a pass writes the
    candidate tokens at index ``s + 1`` and normalizes finished candidates
    by ``(s + 1) ** length_penalty``. Logits processors run on the per-beam
    log-softmax scores over the flat running sequences, after the
    log-softmax, as HF's ``_beam_search`` runs them.

    Only the decoder's self-attention K/V follow the beams' parents each
    pass. The cross-attention K/V are computed from the encoder output
    repeated K times, so a row's K copies are equal and a gather would copy
    them unchanged."""
    size = model.size
    B = encoder_hidden.shape[0]
    K = num_beams
    V = size.vocab_size
    K2 = 2 * K  # HF beams_to_keep = max(2, 1 + n_eos_tokens) * num_beams
    L = max_length
    device = encoder_hidden.device

    enc = encoder_hidden.repeat_interleave(K, dim=0)
    mask = (None if encoder_mask is None
            else encoder_mask.repeat_interleave(K, dim=0))
    start = torch.full((B * K, 1), size.decoder_start_token_id,
                       dtype=torch.int32, device=device)
    logits0, cache = _init_cache(model, enc, mask, start, L)

    # Running beams: beam 0 scores 0, the rest -1e9, so the first
    # expansion draws every candidate from beam 0's distribution.
    run_seq = torch.full((B, K, L), size.pad_token_id, dtype=torch.int32,
                         device=device)
    run_seq[:, :, 0] = size.decoder_start_token_id
    run_scores = torch.zeros(B, K, device=device)
    run_scores[:, 1:] = NEG9
    # Finished store: K slots per row, kept sorted (slot 0 best).
    seq = run_seq.clone()
    scores = torch.full((B, K), NEG9, device=device)
    finished = torch.zeros(B, K, dtype=torch.bool, device=device)
    # Rows whose best running beam can still beat the worst stored one.
    unsat = torch.ones(B, dtype=torch.bool, device=device)
    rank_lt_k = (torch.arange(K2, device=device) < K)[None, :]
    batch_base = (torch.arange(B, device=device) * K)[:, None]

    def process_logp(logits, s):
        logp = torch.log_softmax(logits.float(), dim=-1)
        return process_logits(logp, run_seq.reshape(B * K, L), s,
                              size.eos_token_id, min_length,
                              repetition_penalty,
                              no_repeat_ngram_size).reshape(B, K, V)

    def gather_rows(x, index):
        """x (B, n, L) rows picked by index (B, m) -> (B, m, L)."""
        return torch.gather(x, 1, index[:, :, None].expand(-1, -1, L))

    def advance(s, logp):
        """One step of HF's bookkeeping from this step's log-probs;
        returns the parents of the next running beams."""
        nonlocal run_seq, run_scores, seq, scores, finished, unsat
        cand = run_scores[:, :, None] + logp                   # (B, K, V)
        top_s, top_i = _top_k(cand.reshape(B, K * V), K2)
        parent = top_i // V
        tok = (top_i % V).to(torch.int32)
        cand_seq = gather_rows(run_seq, parent)
        cand_seq[:, :, s + 1] = tok
        # Stopping criteria per candidate: eos, or the sequence at
        # max_length (HF folds the max-length finalization into the merge).
        hits = (tok == size.eos_token_id) | (s + 2 >= L)

        # Next running beams: the top K candidates that did not stop.
        new_run_scores, order = _top_k(top_s + hits.float() * NEG9, K)
        new_parent = torch.gather(parent, 1, order)
        run_seq = gather_rows(cand_seq, order)
        run_scores = new_run_scores

        # Store: stopped candidates ranked inside the top K (HF's
        # top_num_beam_mask), length-normalized, unless the row's
        # heuristic is satisfied; merged with the stored K, best K kept
        # (stored entries win exact ties).
        norm = float(np.float32(s + 1) ** np.float32(length_penalty))
        eligible = hits & rank_lt_k
        fin = top_s / norm
        fin = fin + (~unsat[:, None]).float() * NEG9
        fin = fin + (~eligible).float() * NEG9
        scores, sel = _top_k(torch.cat([scores, fin], dim=1), K)
        seq = gather_rows(torch.cat([seq, cand_seq], dim=1), sel)
        finished = torch.gather(torch.cat([finished, eligible], dim=1), 1,
                                sel)

        # Early-stop heuristic (early_stopping=False), sticky: once every
        # slot holds a finished hypothesis and the best running beam,
        # normalized at the current length, cannot beat the worst of them.
        best_possible = run_scores[:, 0] / norm
        improvable = (~finished.all(dim=1)) | (
            best_possible > scores.min(dim=1).values)
        unsat = unsat & improvable
        return new_parent

    def reorder_cache(parent):
        _reorder_self_kv(cache, (parent + batch_base).reshape(-1))

    reorder_cache(advance(0, process_logp(logits0, 0)))
    s = 1
    while s < L - 1 and bool(unsat.any()):
        cur = run_seq.reshape(B * K, L)[:, s:s + 1]
        logits, cache = _step(model, cache, cur, s, enc, mask, L)
        reorder_cache(advance(s, process_logp(logits, s)))
        s += 1
    # Slot 0 is the best hypothesis (live beams entered the store at
    # max_length through the stopping criterion).
    return (seq[:, 0], scores) if return_scores else seq[:, 0]


def process_logits(logits: torch.Tensor, tokens: torch.Tensor, step,
                   eos_token_id: int, min_length: int = 0,
                   repetition_penalty: float = 1.0,
                   no_repeat_ngram_size: int = 0) -> torch.Tensor:
    """HF logits-processor chain in HF's order: repetition penalty ->
    no-repeat-ngram -> min-length, on fp32 logits.

    ``tokens`` is the fixed-shape (B, max_length) decode buffer whose
    positions ``0..step`` hold the decoder prefix; later positions hold pad
    filler. ``step`` is an int or a (B,) tensor of per-row positions.
    """
    logits = logits.float()
    B, L = tokens.shape
    V = logits.shape[-1]
    device = logits.device
    tokens = tokens.long()
    step_col = torch.as_tensor(step, device=device).expand(B)[:, None]
    arange_l = torch.arange(L, device=device)

    if repetition_penalty != 1.0:
        valid = arange_l[None, :] <= step_col                 # (B, L)
        # Filler positions count as the start token, always in the prefix.
        seen = torch.where(valid, tokens, tokens[:, :1])
        present = torch.zeros(B, V, dtype=torch.bool, device=device)
        present.scatter_(1, seen, True)
        penalized = torch.where(logits < 0, logits * repetition_penalty,
                                logits / repetition_penalty)
        logits = torch.where(present, penalized, logits)

    if no_repeat_ngram_size and no_repeat_ngram_size > 1:
        n = int(no_repeat_ngram_size)
        # Window starts t cover every n-gram fully inside the prefix:
        # t + n - 1 <= step. The candidate completes the trailing
        # (n-1)-gram at positions step-n+2 .. step.
        win_idx = torch.clamp(arange_l[:, None]
                              + torch.arange(n - 1, device=device)[None, :],
                              0, L - 1)
        windows = tokens[:, win_idx]                          # (B, L, n-1)
        suf_pos = torch.clamp(step_col - (n - 2)
                              + torch.arange(n - 1, device=device)[None, :],
                              0, L - 1)                       # (B, n-1)
        suffix = torch.gather(tokens, 1, suf_pos)
        match = (windows == suffix[:, None, :]).all(-1)       # (B, L)
        valid_t = (arange_l[None, :] + n - 1) <= step_col     # (B, L)
        hit = match & valid_t
        banned_tok = tokens[:, torch.clamp(arange_l + n - 1, 0, L - 1)]
        ban = torch.zeros(B, V, dtype=torch.int32, device=device)
        ban.scatter_add_(1, banned_tok, hit.to(torch.int32))
        logits = logits.masked_fill(ban > 0, float("-inf"))

    if min_length and min_length > 0:
        mask_eos = (step_col + 1) < min_length                # (B, 1)
        eos_col = torch.arange(V, device=device)[None, :] == eos_token_id
        logits = logits.masked_fill(mask_eos & eos_col, float("-inf"))
    return logits


def warp_logits(logits: torch.Tensor, temperature: float = 1.0,
                top_k: int = 0, top_p: float = 1.0) -> torch.Tensor:
    """HF logits-warper chain in HF's order: temperature, top-k, top-p, on
    fp32 logits; removed positions get ``-inf``.

    - top-k removes tokens strictly below the k-th largest logit, so ties
      at the threshold all survive;
    - top-p sorts ascending (stably), removes where the inclusive ascending
      cumulative softmax is ``<= 1 - top_p``, and always keeps the largest
      slot (``min_tokens_to_keep = 1``).
    """
    logits = logits.float()
    if temperature != 1.0:
        logits = logits / temperature
    if top_k and top_k > 0:
        k = min(int(top_k), logits.shape[-1])
        kth = torch.topk(logits, k, dim=-1).values[..., -1:]
        logits = logits.masked_fill(logits < kth, float("-inf"))
    if top_p < 1.0:
        sorted_logits, sorted_idx = torch.sort(logits, dim=-1, stable=True)
        cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
        remove_sorted = cum <= 1.0 - top_p
        remove_sorted[..., -1] = False
        remove = torch.zeros_like(remove_sorted).scatter_(
            -1, sorted_idx, remove_sorted)
        logits = logits.masked_fill(remove, float("-inf"))
    return logits


def _default_generator(generator: Optional[torch.Generator],
                       device: torch.device) -> torch.Generator:
    """The caller's generator, or one seeded with 0 on ``device`` (the JAX
    package's ``PRNGKey(0)`` default)."""
    if generator is not None:
        return generator
    return torch.Generator(device=device).manual_seed(0)


def sample_decode(model: T5ForConditionalGeneration,
                  encoder_hidden: torch.Tensor,
                  encoder_mask: Optional[torch.Tensor],
                  max_length: int, generator: torch.Generator,
                  temperature: float = 1.0, top_k: int = 0,
                  top_p: float = 1.0, min_length: int = 0,
                  repetition_penalty: float = 1.0,
                  no_repeat_ngram_size: int = 0) -> torch.Tensor:
    """Ancestral sampling (HF ``do_sample=True``): per step the processed
    logits run through :func:`warp_logits`, and the next token is drawn
    from their softmax with ``generator`` (on the model's device). Row
    layout as :func:`greedy_decode`; finished rows emit pad."""
    choice = _Choice(True, temperature, top_k, top_p, min_length,
                     repetition_penalty, no_repeat_ngram_size, generator)
    state = _prime(model, encoder_hidden, encoder_mask, max_length, choice)
    return _advance(model, state, encoder_hidden, encoder_mask, max_length,
                    choice, max_length - 1).tokens


def stream_init(model: T5ForConditionalGeneration,
                encoder_hidden: torch.Tensor,
                encoder_mask: Optional[torch.Tensor], max_length: int,
                do_sample: bool = False, temperature: float = 1.0,
                top_k: int = 0, top_p: float = 1.0, min_length: int = 0,
                repetition_penalty: float = 1.0,
                no_repeat_ngram_size: int = 0,
                generator: Optional[torch.Generator] = None) -> StreamState:
    """Prime the cache and choose the first token; the state feeds
    :func:`stream_chunk`. The same first step as :func:`greedy_decode` /
    :func:`sample_decode`."""
    choice = _Choice(do_sample, temperature, top_k, top_p, min_length,
                     repetition_penalty, no_repeat_ngram_size, generator)
    return _prime(model, encoder_hidden, encoder_mask, max_length, choice)


def stream_chunk(model: T5ForConditionalGeneration,
                 encoder_hidden: torch.Tensor,
                 encoder_mask: Optional[torch.Tensor], max_length: int,
                 chunk: int, do_sample: bool = False,
                 temperature: float = 1.0, top_k: int = 0,
                 top_p: float = 1.0, min_length: int = 0,
                 repetition_penalty: float = 1.0,
                 no_repeat_ngram_size: int = 0,
                 state: StreamState = None,
                 generator: Optional[torch.Generator] = None) -> StreamState:
    """Advance ``state`` by up to ``chunk`` tokens (fewer when every row
    finishes or ``max_length`` is reached), through the same loop as the
    monolithic decoders: the chunks concatenate to exactly their tokens."""
    choice = _Choice(do_sample, temperature, top_k, top_p, min_length,
                     repetition_penalty, no_repeat_ngram_size, generator)
    return _advance(model, state, encoder_hidden, encoder_mask, max_length,
                    choice, min(state.step + chunk, max_length - 1))


def stream_decode(model: T5ForConditionalGeneration,
                  encoder_hidden: torch.Tensor,
                  encoder_mask: Optional[torch.Tensor], max_length: int = 20,
                  chunk_size: int = 4, do_sample: bool = False,
                  temperature: float = 1.0, top_k: int = 0,
                  top_p: float = 1.0,
                  generator: Optional[torch.Generator] = None,
                  min_length: int = 0, repetition_penalty: float = 1.0,
                  no_repeat_ngram_size: int = 0
                  ) -> Iterator[tuple[np.ndarray, int, bool]]:
    """Streaming generation: yields ``(tokens, n_valid, done)`` after the
    first token and then after every ``chunk_size`` further tokens;
    ``tokens`` is a host (B, max_length) copy whose first ``n_valid``
    positions are decided, ``done`` True on the final yield. The final
    tokens are :func:`greedy_decode` / :func:`sample_decode`'s for the same
    inputs and generator state.

    Each yield reads the token buffer back (the cache stays on the
    device). Unlike the JAX package, the next chunk is not enqueued before
    the read: the loop already reads a flag back every pass, so launching
    ahead would only delay each yield by a chunk. Greedy and sampling
    only: a beam's best hypothesis can be displaced at any step."""
    if chunk_size < 1:
        raise ValueError(f"chunk_size must be >= 1, got {chunk_size}")
    if do_sample:
        generator = _default_generator(generator, encoder_hidden.device)
    kw = dict(do_sample=do_sample, temperature=temperature, top_k=top_k,
              top_p=top_p, min_length=min_length,
              repetition_penalty=repetition_penalty,
              no_repeat_ngram_size=no_repeat_ngram_size, generator=generator)
    state = stream_init(model, encoder_hidden, encoder_mask, max_length, **kw)
    while True:
        tokens = state.tokens.cpu().numpy()
        done = (state.step >= max_length - 1
                or bool(state.finished.all()))
        yield tokens, state.step + 1, done
        if done:
            return
        state = stream_chunk(model, encoder_hidden, encoder_mask, max_length,
                             chunk_size, state=state, **kw)


def generate(model: T5ForConditionalGeneration,
             encoder_hidden: torch.Tensor,
             encoder_mask: Optional[torch.Tensor],
             max_length: int = 20, num_beams: int = 1,
             length_penalty: float = 1.0, do_sample: bool = False,
             temperature: float = 1.0, top_k: int = 0, top_p: float = 1.0,
             generator: Optional[torch.Generator] = None,
             min_length: int = 0, repetition_penalty: float = 1.0,
             no_repeat_ngram_size: int = 0,
             speculative_draft: int = 0) -> torch.Tensor:
    """HF-default-compatible entry: greedy for ``num_beams == 1`` and
    ``do_sample=False``, beam search for ``num_beams > 1``, ancestral
    sampling for ``do_sample=True`` (sampled beam search raises
    ``ValueError``, as in HF). ``generator``: the sampling draws' source,
    on the model's device (default: one seeded with 0).

    ``speculative_draft > 0`` takes plain greedy (no processors) through
    prompt-lookup speculative decoding with that draft length
    (``infer/speculative.py``: greedy's tokens, fewer decoder passes when
    drafts are accepted); other configurations ignore it."""
    if speculative_draft < 0:
        raise ValueError(f"speculative_draft must be >= 0, got "
                         f"{speculative_draft}")
    if do_sample:
        if num_beams > 1:
            raise ValueError("beam-search sampling is not supported; use "
                             "num_beams=1 with do_sample=True")
        return sample_decode(
            model, encoder_hidden, encoder_mask, max_length,
            _default_generator(generator, encoder_hidden.device),
            temperature, top_k, top_p, min_length, repetition_penalty,
            no_repeat_ngram_size)
    if num_beams <= 1:
        if (speculative_draft > 0 and min_length == 0
                and repetition_penalty == 1.0 and no_repeat_ngram_size == 0):
            from .speculative import speculative_greedy_decode

            return speculative_greedy_decode(model, encoder_hidden,
                                             encoder_mask, max_length,
                                             draft_len=speculative_draft)
        return greedy_decode(model, encoder_hidden, encoder_mask, max_length,
                             min_length, repetition_penalty,
                             no_repeat_ngram_size)
    return beam_search_decode(model, encoder_hidden, encoder_mask,
                              max_length, num_beams, length_penalty,
                              min_length, repetition_penalty,
                              no_repeat_ngram_size)
