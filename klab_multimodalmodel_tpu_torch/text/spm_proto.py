"""Minimal SentencePiece ``ModelProto`` reader (protobuf wire format).

``--tokenizer_path spiece.model`` must work with nothing beyond PyTorch and
numpy installed: the official T5 tokenizer artifact is the ``spiece.model``
proto. Rather than requiring ``transformers`` or the ``sentencepiece``
package, this module hand-parses the fields the tokenizer needs straight
from the protobuf wire format (the port's copy of the JAX package's
``text/spm_proto.py``):

  * ``pieces``            — ModelProto field 1: repeated {piece=1 (string),
                            score=2 (float)}
  * ``trainer_spec``      — field 2: {model_type=3, byte_fallback=35,
                            unk_id=40}
  * ``normalizer_spec``   — field 3: {precompiled_charsmap=2 (bytes)}

Unknown fields are skipped per wire type, so any spiece.model (old or new
sentencepiece versions) parses.
"""

from __future__ import annotations

import dataclasses
import struct


@dataclasses.dataclass
class SpmModel:
    pieces: list[tuple[str, float]]
    model_type: int  # 1 = UNIGRAM, 2 = BPE, 3 = WORD, 4 = CHAR
    unk_id: int
    byte_fallback: bool
    precompiled_charsmap: bytes


def _read_varint(buf: bytes, i: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[i]
        i += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, i
        shift += 7
        if shift > 70:
            raise ValueError("malformed varint")


def _skip(buf: bytes, i: int, wire_type: int) -> int:
    if wire_type == 0:  # varint
        _, i = _read_varint(buf, i)
        return i
    if wire_type == 1:  # 64-bit
        return i + 8
    if wire_type == 2:  # length-delimited
        n, i = _read_varint(buf, i)
        return i + n
    if wire_type == 5:  # 32-bit
        return i + 4
    raise ValueError(f"unsupported wire type {wire_type}")


def _fields(buf: bytes):
    """Yield (field_number, wire_type, value) over a message body.

    value: int for varint, bytes for length-delimited, 4/8-byte bytes for
    fixed-width.
    """
    i = 0
    n = len(buf)
    while i < n:
        tag, i = _read_varint(buf, i)
        field, wire_type = tag >> 3, tag & 7
        if wire_type == 0:
            v, i = _read_varint(buf, i)
        elif wire_type == 1:
            v, i = buf[i:i + 8], i + 8
        elif wire_type == 2:
            ln, i = _read_varint(buf, i)
            v, i = buf[i:i + ln], i + ln
        elif wire_type == 5:
            v, i = buf[i:i + 4], i + 4
        else:
            raise ValueError(f"unsupported wire type {wire_type}")
        yield field, wire_type, v


def _parse_piece(buf: bytes) -> tuple[str, float]:
    piece, score = "", 0.0
    for field, _, v in _fields(buf):
        if field == 1:
            piece = v.decode("utf-8")
        elif field == 2:
            score = struct.unpack("<f", v)[0]
    return piece, score


def parse_model_proto(data: bytes) -> SpmModel:
    pieces: list[tuple[str, float]] = []
    model_type, unk_id, byte_fallback = 1, 0, False  # proto defaults
    charsmap = b""
    for field, _, v in _fields(data):
        if field == 1:  # repeated SentencePiece pieces
            pieces.append(_parse_piece(v))
        elif field == 2:  # TrainerSpec
            for f2, _, v2 in _fields(v):
                if f2 == 3:
                    model_type = v2
                elif f2 == 35:
                    byte_fallback = bool(v2)
                elif f2 == 40:
                    unk_id = v2
        elif field == 3:  # NormalizerSpec
            for f3, _, v3 in _fields(v):
                if f3 == 2:
                    charsmap = v3
    return SpmModel(pieces=pieces, model_type=model_type, unk_id=unk_id,
                    byte_fallback=byte_fallback,
                    precompiled_charsmap=charsmap)


def load_model_proto(path: str) -> SpmModel:
    with open(path, "rb") as f:
        return parse_model_proto(f.read())
