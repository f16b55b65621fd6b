"""Tokenization and span corruption."""

from .span_corruption import span_corrupt  # noqa: F401
from .tokenizer import (BatchEncoding, ByteTokenizer, TokenizerBase,  # noqa: F401
                        UnigramTokenizer, load_tokenizer,
                        train_unigram_tokenizer)
