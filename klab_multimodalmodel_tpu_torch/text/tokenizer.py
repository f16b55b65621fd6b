"""Tokenization: the batch interface and the byte tokenizer.

T5 vocabulary conventions: pad=0, eos=1 (``</s>``), unk=2, sentinel
``<extra_id_k>`` = vocab_size - 1 - k (so ``<extra_id_0>`` is the last id),
and an ``</s>`` appended to every encoded sequence.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

NUM_SENTINELS = 100


class BatchEncoding(dict):
    """Dict with attribute access: ``input_ids`` (B, L) and
    ``attention_mask`` (B, L) int32 numpy arrays, fixed shape."""

    @property
    def input_ids(self) -> np.ndarray:
        return self["input_ids"]

    @property
    def attention_mask(self) -> np.ndarray:
        return self["attention_mask"]


class TokenizerBase:
    pad_id: int = 0
    eos_id: int = 1
    unk_id: int = 2
    vocab_size: int
    # How many trailing vocab ids are <extra_id_k> sentinels.
    num_sentinels: int = NUM_SENTINELS

    # -- core single-sequence ops (implemented by subclasses) --------------
    def encode_ids(self, text: str) -> list[int]:
        raise NotImplementedError

    def decode_ids(self, ids: Sequence[int]) -> str:
        raise NotImplementedError

    def is_special(self, token_id: int) -> bool:
        return (token_id in (self.pad_id, self.eos_id, self.unk_id)
                or token_id >= self.vocab_size - self.num_sentinels)

    def sentinel_id(self, k: int) -> int:
        """``<extra_id_k>`` id — T5 convention: vocab_size - 1 - k."""
        if k >= self.num_sentinels:
            raise ValueError(
                f"<extra_id_{k}>: this vocabulary has "
                f"{self.num_sentinels} sentinel tokens")
        return self.vocab_size - 1 - k

    # -- batch interface ---------------------------------------------------
    def __call__(self, texts: Sequence[str], max_length: int,
                 padding: str = "max_length",
                 add_eos: bool = True) -> BatchEncoding:
        """Batch encode with truncation and fixed-shape padding
        (``padding='max_length'``) or padding to the longest row."""
        encoded = []
        for t in texts:
            ids = self.encode_ids(t)
            limit = max_length - (1 if add_eos else 0)
            ids = ids[:limit]
            if add_eos:
                ids = ids + [self.eos_id]
            encoded.append(ids)
        if padding == "longest":
            max_length = max(len(e) for e in encoded) if encoded else 1
        B = len(encoded)
        input_ids = np.full((B, max_length), self.pad_id, np.int32)
        mask = np.zeros((B, max_length), np.int32)
        for i, ids in enumerate(encoded):
            L = min(len(ids), max_length)
            input_ids[i, :L] = ids[:L]
            mask[i, :L] = 1
        return BatchEncoding(input_ids=input_ids, attention_mask=mask)

    def decode(self, ids: Sequence[int],
               skip_special_tokens: bool = True) -> str:
        ids = [int(i) for i in np.asarray(ids).reshape(-1)]
        if skip_special_tokens:
            ids = [i for i in ids if not self.is_special(i)]
        return self.decode_ids(ids)

    def batch_decode(self, batch, skip_special_tokens: bool = True
                     ) -> list[str]:
        return [self.decode(row, skip_special_tokens) for row in batch]


class ByteTokenizer(TokenizerBase):
    """UTF-8 bytes + T5 special-token layout. Zero-dependency fallback.

    id layout: 0=pad, 1=</s>, 2=<unk>, 3..258 = bytes 0..255,
    then padding ids, then 100 sentinels at the top (T5 convention).
    ``<extra_id_k>`` strings round-trip through encode/decode.
    """

    BYTE_OFFSET = 3

    def __init__(self, vocab_size: int = 384):
        if vocab_size < self.BYTE_OFFSET + 256 + NUM_SENTINELS:
            raise ValueError(f"vocab_size={vocab_size} is too small for "
                             "the byte layout plus 100 sentinels")
        self.vocab_size = vocab_size
        self._sentinel_strs = {
            f"<extra_id_{k}>": self.sentinel_id(k)
            for k in range(NUM_SENTINELS)}
        self._id_to_sentinel = {v: k for k, v in self._sentinel_strs.items()}

    def encode_ids(self, text: str) -> list[int]:
        out: list[int] = []
        i = 0
        while i < len(text):
            if text[i] == "<":
                end = text.find(">", i)
                if end != -1 and text[i:end + 1] in self._sentinel_strs:
                    out.append(self._sentinel_strs[text[i:end + 1]])
                    i = end + 1
                    continue
            out.extend(b + self.BYTE_OFFSET
                       for b in text[i].encode("utf-8"))
            i += 1
        return out

    def decode_ids(self, ids: Sequence[int]) -> str:
        parts: list[str] = []
        buf = bytearray()
        for i in ids:
            if self.BYTE_OFFSET <= i < self.BYTE_OFFSET + 256:
                buf.append(i - self.BYTE_OFFSET)
            else:
                if buf:
                    parts.append(buf.decode("utf-8", errors="replace"))
                    buf = bytearray()
                if i in self._id_to_sentinel:
                    parts.append(self._id_to_sentinel[i])
        if buf:
            parts.append(buf.decode("utf-8", errors="replace"))
        return "".join(parts)


def load_tokenizer(path: str = "") -> TokenizerBase:
    """Config-driven factory: '' gives the byte tokenizer. A tokenizer file
    (``tokenizer.json`` or ``spiece.model``) needs the unigram tokenizer,
    which is not ported yet (ROADMAP A6)."""
    if path:
        raise NotImplementedError(
            f"tokenizer_path={path!r}: the unigram tokenizer is not ported "
            "(ROADMAP A6); use '' for the byte tokenizer")
    return ByteTokenizer()
