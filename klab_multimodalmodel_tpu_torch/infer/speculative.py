"""Exact speculative greedy decoding (prompt-lookup self-drafting).

The port of the JAX package's ``infer/speculative.py``. Each pass feeds
``[last_token, d_1..d_K]`` (K + 1 tokens) at every row's own position, gets
K + 1 greedy choices back, accepts the longest prefix of drafts that match
the model's own argmax, and always banks one bonus token from the first
mismatch: a pass advances a row by 1 to K + 1 positions, never fewer than
greedy. Drafts come from n-gram lookup over the row's own generated prefix
(optionally preceded by the request's source ids): the most recent earlier
occurrence of the trailing ``ngram`` tokens proposes what followed it.

Rejected cache positions are handled by rewinding the per-row cache index
alone: the per-query validity mask hides K/V past a row's index until they
are overwritten. The buffers are padded to ``max_length + K + 1`` so that a
pass entered at ``max_length - 2`` still writes its whole chunk in bounds.

Accepted tokens are the argmax of logits whose prefix is entirely accepted
tokens, i.e. greedy's choices. As in the JAX package, that holds as far as a
position's logits do not depend on the chunk's width: fp32 products at K + 1
rows per request may round apart from greedy's one row, which moves a token
only at a knife edge. The loop reads one flag back per pass, as greedy's
does.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..models.t5 import Cache, T5ForConditionalGeneration
from .generate import _broadcast_cache_index, _init_cache


def _set_cache_index(cache: Cache, new_index: torch.Tensor) -> Cache:
    """Rewind or advance every layer's per-row ``cache_index`` to
    ``new_index`` (B,)."""
    for layer in cache:
        layer["self"]["cache_index"] = new_index.clone()
    return cache


def _ngram_draft(tokens: torch.Tensor, step: torch.Tensor, draft_len: int,
                 ngram: int, pad_id: int,
                 lookup_prefix: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
    """Prompt-lookup drafts: (B, draft_len) proposals per row.

    Finds the most recent position ``p <= step - ngram`` where
    ``tokens[p:p+ngram]`` equals the row's trailing n-gram
    ``tokens[step-ngram+1 : step+1]`` and proposes the ``draft_len`` tokens
    that followed it. With ``lookup_prefix`` (B, S) the corpus is
    ``[prefix | generated]`` (generated matches still win by recency). Rows
    with no match draft pads."""
    if lookup_prefix is not None:
        S = lookup_prefix.shape[1]
        buf = torch.cat([lookup_prefix.to(tokens.dtype), tokens], dim=1)
        return _ngram_draft(buf, step + S, draft_len, ngram, pad_id)
    B, L = tokens.shape
    n = ngram
    device = tokens.device
    step = step.long()
    gidx = step[:, None] - (n - 1) + torch.arange(n, device=device)[None, :]
    gram = torch.gather(tokens, 1, gidx.clamp(0, L - 1))
    Wn = L - n + 1
    match = torch.ones(B, Wn, dtype=torch.bool, device=device)
    for i in range(n):
        match = match & (tokens[:, i:Wn + i] == gram[:, i:i + 1])
    p = torch.arange(Wn, device=device)[None, :]
    # The window lies strictly before the trailing gram (p <= step - n).
    match = match & (p <= step[:, None] - n)
    best = torch.where(match, p, -1).max(dim=1).values          # (B,)
    has = best >= 0
    start = torch.where(has, best + n, 0)
    didx = start[:, None] + torch.arange(draft_len, device=device)[None, :]
    draft = torch.gather(tokens, 1, didx.clamp(0, L - 1))
    return torch.where(has[:, None], draft, torch.full_like(draft, pad_id))


def _speculative_core(model: T5ForConditionalGeneration,
                      encoder_hidden: torch.Tensor,
                      encoder_mask: Optional[torch.Tensor], max_length: int,
                      draft_len: int, ngram: int,
                      source_ids: Optional[torch.Tensor] = None):
    size = model.size
    B = encoder_hidden.shape[0]
    K = draft_len
    device = encoder_hidden.device
    L = max_length + K + 1
    start = torch.full((B, 1), size.decoder_start_token_id, dtype=torch.int32,
                       device=device)
    logits0, cache = _init_cache(model, encoder_hidden, encoder_mask, start,
                                 L)
    # Rows accept different draft counts, so each sits at its own position.
    cache = _broadcast_cache_index(cache, B)
    tokens = torch.full((B, L), size.pad_token_id, dtype=torch.int32,
                        device=device)
    tokens[:, 0] = start[:, 0]
    tok1 = logits0.argmax(-1).to(torch.int32)
    tokens[:, 1] = tok1
    step = torch.ones(B, dtype=torch.int64, device=device)
    finished = tok1 == size.eos_token_id
    accepted = torch.zeros(B, dtype=torch.int64, device=device)
    j_pos = torch.arange(K + 1, device=device)[None, :]
    l_pos = torch.arange(L, device=device)[None, :]
    passes = 0
    while bool((~finished & (step < max_length - 1)).any()):
        draft = _ngram_draft(tokens, step, K, ngram, size.pad_token_id,
                             lookup_prefix=source_ids)
        last = torch.gather(tokens, 1, step[:, None])
        chunk = torch.cat([last, draft], dim=1)               # (B, K+1)
        logits, cache = model.decode_step(chunk, step, encoder_hidden, L,
                                          encoder_mask, cache=cache)
        choice = logits.argmax(-1).to(torch.int32)            # (B, K+1)
        # choice[:, j] is greedy's token at step+1+j given the chunk's
        # prefix: valid while every draft before it was accepted.
        ok = (choice[:, :K] == draft).to(torch.int64)
        n_new = torch.cumprod(ok, dim=1).sum(dim=1) + 1       # + bonus
        eos_j = torch.where(choice == size.eos_token_id, j_pos,
                            K + 1).min(dim=1).values
        n_new = torch.minimum(n_new, eos_j + 1)               # stop at eos
        n_new = torch.minimum(n_new, (max_length - 1 - step).clamp(min=0))
        n_new = torch.where(finished, 0, n_new)
        rel = l_pos - (step[:, None] + 1)                     # (B, L)
        write = (rel >= 0) & (rel < n_new[:, None])
        vals = torch.gather(choice, 1, rel.clamp(0, K))
        tokens = torch.where(write, vals, tokens)
        step = step + n_new
        finished = finished | (eos_j < n_new)
        # Positions >= step hold rejected drafts' K/V; the per-query mask
        # hides them until they are overwritten.
        _set_cache_index(cache, step)
        accepted = accepted + (n_new - 1).clamp(min=0)
        passes += 1
    return tokens[:, :max_length], passes, accepted


def _check(draft_len: int, ngram: int) -> None:
    if draft_len < 1 or ngram < 1:
        raise ValueError(f"draft_len and ngram must be >= 1, got "
                         f"{draft_len}/{ngram}")


def speculative_greedy_decode(model: T5ForConditionalGeneration,
                              encoder_hidden: torch.Tensor,
                              encoder_mask: Optional[torch.Tensor],
                              max_length: int = 20, draft_len: int = 4,
                              ngram: int = 2,
                              source_ids: Optional[torch.Tensor] = None
                              ) -> torch.Tensor:
    """Greedy decode by self-speculation: (B, max_length) int32 ids laid out
    as :func:`~.generate.greedy_decode`'s. ``source_ids`` (B, S) extends
    the drafts' lookup corpus with the request's source ids; drafting never
    changes the tokens, only the pass count."""
    _check(draft_len, ngram)
    return _speculative_core(model, encoder_hidden, encoder_mask, max_length,
                             draft_len, ngram, source_ids)[0]


def speculative_greedy_decode_with_stats(
        model: T5ForConditionalGeneration, encoder_hidden: torch.Tensor,
        encoder_mask: Optional[torch.Tensor], max_length: int = 20,
        draft_len: int = 4, ngram: int = 2,
        source_ids: Optional[torch.Tensor] = None):
    """(tokens, decoder passes after the first, per-row accepted-draft
    totals (B,) int64)."""
    _check(draft_len, ngram)
    return _speculative_core(model, encoder_hidden, encoder_mask, max_length,
                             draft_len, ngram, source_ids)
