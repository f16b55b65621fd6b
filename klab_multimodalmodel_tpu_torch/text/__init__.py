"""Tokenization."""

from .tokenizer import BatchEncoding, ByteTokenizer, TokenizerBase  # noqa: F401
