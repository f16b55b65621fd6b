"""Build / parse SentencePiece ``precompiled_charsmap`` blobs.

The T5 tokenizer's normalizer carries an ``nmt_nfkc`` normalization table
serialized as a *precompiled charsmap*: a darts-clone double-array trie
mapping source UTF-8 byte strings to replacement strings. HF ``tokenizers``
applies it via ``normalizers.Precompiled``; the port's C++ tokenizer core
(``klab_multimodalmodel_tpu_torch/native/klab_host.cpp``) applies the same
blob. The port's copy of the JAX package's ``text/charsmap.py``.

This module provides:

  * ``build_charsmap(mapping)`` — compile a {source: replacement} dict into
    a format-correct blob (tests build tiny NFKC-style fixtures with it and
    pin BOTH consumers — HF's Rust ``Precompiled`` and the C++ core —
    against it);
  * ``parse_charsmap(blob)`` / ``Charsmap.longest_prefix`` — decode + longest-prefix
    query, the pure-Python reference implementation.

Blob layout (sentencepiece ``normalizer.cc::DecodePrecompiledCharsMap``):
``[uint32-LE trie_size][trie: uint32-LE units][normalized: NUL-joined
strings]``; a trie hit's value is a byte offset into ``normalized``.

Darts-clone unit encoding (darts.h ``DoubleArrayUnit``):
``label = unit & (0x80000000 | 0xFF)``; ``has_leaf = (unit >> 8) & 1``;
``offset = (unit >> 10) << ((unit & (1 << 9)) >> 6)``; a value unit stores
``0x80000000 | value``. Traversal XORs: child(base, c) sits at
``base ^ c``; the value unit of a terminal node sits at ``base ^ 0``.
"""

from __future__ import annotations

import struct


# ---------------------------------------------------------------------------
# Builder
# ---------------------------------------------------------------------------


class _Node:
    __slots__ = ("children", "value")

    def __init__(self):
        self.children: dict[int, _Node] = {}
        self.value: int | None = None


def build_charsmap(mapping: dict[str, str]) -> bytes:
    """Compile {source: replacement} into a precompiled_charsmap blob."""
    # normalized-strings blob; values are byte offsets
    normalized = bytearray()
    offsets: dict[str, int] = {}
    root = _Node()
    for src, repl in sorted(mapping.items()):
        if not src:
            raise ValueError("empty source string")
        if repl not in offsets:
            offsets[repl] = len(normalized)
            normalized += repl.encode("utf-8") + b"\0"
        node = root
        for b in src.encode("utf-8"):
            node = node.children.setdefault(b, _Node())
        node.value = offsets[repl]

    units: list[int] = [0]  # grows on demand; unit 0 is the root unit
    used = {0}
    # Darts invariant: a base may be owned by at most ONE node. The label
    # byte is the only transition check (label(unit[base^c]) == c), so two
    # nodes sharing a base would accept each other's children.
    used_bases: set[int] = set()

    def grow(to: int) -> None:
        while len(units) <= to:
            units.append(0)

    def find_base(labels: list[int]) -> int:
        base = 1
        while True:
            if (base not in used_bases
                    and all((base ^ c) not in used and (base ^ c) != 0
                            for c in labels)):
                used_bases.add(base)
                for c in labels:
                    used.add(base ^ c)
                return base
            base += 1

    def place(node: _Node, pos: int) -> None:
        """Choose this node's child base, write its offset into unit[pos],
        create child units, recurse."""
        labels = sorted(node.children)
        if node.value is not None:
            labels = [0] + labels
        if not labels:
            return
        base = find_base(labels)
        offset = pos ^ base
        if offset >= (1 << 21):
            raise ValueError("trie too large for direct offsets")
        grow(max(base ^ c for c in labels))
        units[pos] |= offset << 10
        if node.value is not None:
            units[base] = 0x80000000 | node.value
        for c, child in sorted(node.children.items()):
            q = base ^ c
            units[q] = c | (0x100 if child.value is not None else 0)
        for c, child in sorted(node.children.items()):
            place(child, base ^ c)

    place(root, 0)
    # Pad so every reachable probe index (base ^ c, c <= 0xFF) is in
    # bounds: consumers without bounds checks (HF's spm_precompiled Rust
    # crate) index unconditionally before comparing the label.
    if used_bases:
        grow(max(used_bases) | 0xFF)
    trie = b"".join(struct.pack("<I", u) for u in units)
    return struct.pack("<I", len(trie)) + trie + bytes(normalized)


# ---------------------------------------------------------------------------
# Parser / reference lookup
# ---------------------------------------------------------------------------


class Charsmap:
    def __init__(self, units: list[int], normalized: bytes):
        self.units = units
        self.normalized = normalized

    def longest_prefix(self, data: bytes) -> tuple[int, bytes] | None:
        """(matched_byte_len, replacement) of the longest trie prefix of
        ``data``, or None. Mirrors darts-clone commonPrefixSearch + the
        sentencepiece longest-match rule."""
        units = self.units
        if not units:
            return None
        unit = units[0]
        node_pos = (unit >> 10) << ((unit & (1 << 9)) >> 6)  # root base
        best = None
        for i, c in enumerate(data):
            node_pos ^= c
            if node_pos >= len(units):
                break
            unit = units[node_pos]
            if (unit & (0x80000000 | 0xFF)) != c:
                break
            node_pos ^= (unit >> 10) << ((unit & (1 << 9)) >> 6)
            if (unit >> 8) & 1:  # has_leaf
                value = units[node_pos] & 0x7FFFFFFF
                end = self.normalized.index(b"\0", value)
                best = (i + 1, self.normalized[value:end])
        return best


def parse_charsmap(blob: bytes) -> Charsmap:
    (trie_size,) = struct.unpack_from("<I", blob, 0)
    trie = blob[4:4 + trie_size]
    units = list(struct.unpack(f"<{trie_size // 4}I", trie))
    return Charsmap(units, blob[4 + trie_size:])
