"""Greedy autoregressive generation with a KV cache.

HF ``generate`` defaults: greedy decoding, ``max_length`` counting the
decoder-start token, decoder start = pad id, stop at eos, finished rows emit
pad. The loop runs in Python; each step is one incremental decoder pass.
Beam search and sampling are not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..models.t5 import Cache, T5ForConditionalGeneration


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


def _select_next(logits, tokens, step, size, finished, min_length,
                 repetition_penalty, no_repeat_ngram_size) -> torch.Tensor:
    """Greedy token choice from raw step logits: HF's processor chain, then
    argmax; finished rows emit pad."""
    logits = process_logits(logits, tokens, step, size.eos_token_id,
                            min_length, repetition_penalty,
                            no_repeat_ngram_size)
    nxt = torch.argmax(logits, dim=-1).to(torch.int32)
    return torch.where(finished, size.pad_token_id, nxt).to(torch.int32)


def _prime(model, encoder_hidden, encoder_mask, max_length, min_length,
           repetition_penalty, no_repeat_ngram_size):
    """Prime the cache and choose token 1: ``(step=1, tokens, cache,
    finished)`` with positions 0 (decoder start) and 1 filled."""
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
                        min_length, repetition_penalty, no_repeat_ngram_size)
    tokens[:, 1] = tok1
    return 1, tokens, cache, tok1 == size.eos_token_id


def greedy_decode(model: T5ForConditionalGeneration,
                  encoder_hidden: torch.Tensor,
                  encoder_mask: Optional[torch.Tensor],
                  max_length: int = 20, min_length: int = 0,
                  repetition_penalty: float = 1.0,
                  no_repeat_ngram_size: int = 0) -> torch.Tensor:
    """Returns (B, max_length) int32 token ids laid out as HF ``generate``
    does: ``[decoder_start, t1, t2, ..., eos, pad, pad...]``. The loop runs
    while ``step < max_length - 1`` and some row is unfinished."""
    size = model.size
    step, tokens, cache, finished = _prime(
        model, encoder_hidden, encoder_mask, max_length, min_length,
        repetition_penalty, no_repeat_ngram_size)
    while step < max_length - 1 and not bool(finished.all()):
        cur = tokens[:, step:step + 1]
        logits, cache = _step(model, cache, cur, step, encoder_hidden,
                              encoder_mask, max_length)
        nxt = _select_next(logits, tokens, step, size, finished, min_length,
                           repetition_penalty, no_repeat_ngram_size)
        tokens[:, step + 1] = nxt
        finished = finished | (nxt == size.eos_token_id)
        step += 1
    return tokens


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


def generate(model: T5ForConditionalGeneration,
             encoder_hidden: torch.Tensor,
             encoder_mask: Optional[torch.Tensor],
             max_length: int = 20, num_beams: int = 1,
             do_sample: bool = False, min_length: int = 0,
             repetition_penalty: float = 1.0,
             no_repeat_ngram_size: int = 0) -> torch.Tensor:
    """HF-default-compatible entry: greedy decoding. Beam search and
    sampling are not ported yet and raise ``NotImplementedError``."""
    if do_sample:
        raise NotImplementedError("sampling is not ported yet")
    if num_beams > 1:
        raise NotImplementedError("beam search is not ported yet")
    return greedy_decode(model, encoder_hidden, encoder_mask, max_length,
                         min_length, repetition_penalty, no_repeat_ngram_size)
