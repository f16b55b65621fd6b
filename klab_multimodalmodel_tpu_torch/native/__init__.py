"""ctypes bindings of the port's C++ host runtime (``klab_host.cpp`` and
``klab_jpeg.cpp`` beside this file, one library): Pillow-compatible
multithreaded image resize (``resize_batch``) and the unigram tokenizer core
with the HF-T5 chain (``NativeUnigramEncoder``), the same API as the JAX
package's ``native`` module; and a JPEG decoder (``decode_jpeg``,
``jpeg_size``) that gives Pillow's pixels bit for bit, so that the port
decodes JPEGs without Pillow.

The library is built at first use, never at import, with the C++ compiler
that ``CXX`` names (default ``g++``) and ``CXXFLAGS`` below, into ``_build/``
beside the package (git-ignored). Its file name carries a hash of the
sources, the compiler, the flags and the host CPU (``-march=native`` code
must not move to another CPU), so an edited source is rebuilt and a finished
build is reused. Nothing degrades: a build that fails raises with the
compiler's output, and no caller falls back to another resize, encoder or
decoder.
"""

from __future__ import annotations

import base64
import ctypes
import dataclasses
import hashlib
import json
import os
import platform
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional, Sequence, Union

import numpy as np

from ..text.tokenizer import META, NUM_SENTINELS

SOURCE = Path(__file__).resolve().parent / "klab_host.cpp"
JPEG_SOURCE = SOURCE.parent / "klab_jpeg.cpp"
SOURCES = (SOURCE, JPEG_SOURCE)  # compiled into one library
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
# The JAX package's build flags: -march=native lets the compiler fuse the
# resize's multiply-adds, and both builds must do the same to give the same
# pixels.
CXXFLAGS = ("-O3", "-march=native", "-std=c++20", "-fPIC", "-shared",
            "-pthread", "-Werror=return-type")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def compiler() -> str:
    return os.environ.get("CXX") or "g++"


def _cpu_identity() -> bytes:
    """The host CPU's model and feature flags (what ``-march=native``
    compiles for)."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            lines = [ln for ln in f.read().splitlines()
                     if ln.startswith((b"model name", b"flags"))]
        return b"\n".join(lines[:2])
    except OSError:
        return platform.processor().encode()


def library_path(build_dir: Path = BUILD_DIR) -> Path:
    h = hashlib.sha256()
    for source in SOURCES:
        h.update(source.name.encode() + b"\0" + source.read_bytes())
    h.update("\0".join((compiler(),) + CXXFLAGS).encode())
    h.update(_cpu_identity())
    return Path(build_dir) / f"libklab_host-{h.hexdigest()[:16]}.so"


def build_library(build_dir: Path = BUILD_DIR) -> Path:
    """Compile ``SOURCES`` into ``build_dir`` unless their library is
    there already; the path of the library. Writes nothing outside
    ``build_dir``: the compiler's output goes to a temporary file there,
    renamed into place whole. Raises ``RuntimeError`` with the compiler's
    output when the build fails."""
    target = library_path(build_dir)
    if target.exists():
        return target
    target.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=target.parent)
    os.close(fd)
    cmd = [compiler(), *CXXFLAGS, "-o", tmp, *map(str, SOURCES)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300, cwd=target.parent)
    except (OSError, subprocess.SubprocessError) as e:
        os.unlink(tmp)
        raise RuntimeError(f"native host runtime: cannot run the C++ "
                           f"compiler ({' '.join(cmd)}): {e}") from e
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"native host runtime: the build failed (exit "
            f"{proc.returncode}): {' '.join(cmd)}\n{proc.stderr}")
    os.replace(tmp, target)  # atomic: other processes see whole files
    return target


def load_library() -> ctypes.CDLL:
    """The library, built first if needed. Raises where it cannot be
    built or loaded."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build_library()))
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.klab_resize_batch.argtypes = [
            ctypes.POINTER(P), ctypes.POINTER(I), I, P, I, I, I, I]
        lib.klab_resize_batch.restype = None
        lib.klab_tok_new.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(I), I, I]
        lib.klab_tok_new.restype = I
        lib.klab_tok_set_chain.argtypes = [I, I, I, I, I]
        lib.klab_tok_set_chain.restype = I
        lib.klab_tok_add_special.argtypes = [I, ctypes.c_char_p, I]
        lib.klab_tok_add_special.restype = I
        lib.klab_tok_set_charsmap.argtypes = [
            I, ctypes.c_char_p, ctypes.c_int64]
        lib.klab_tok_set_charsmap.restype = I
        lib.klab_tok_encode.argtypes = [I, ctypes.c_char_p, ctypes.c_int64,
                                        P, I]
        lib.klab_tok_encode.restype = I
        lib.klab_tok_encode_batch.argtypes = [
            I, ctypes.c_char_p, P, I, P, P, I, I, I, I]
        lib.klab_tok_encode_batch.restype = I
        lib.klab_jpeg_info.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, P, ctypes.c_char_p, I]
        lib.klab_jpeg_info.restype = I
        lib.klab_jpeg_decode.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, I, P, ctypes.c_int64,
            ctypes.c_char_p, I]
        lib.klab_jpeg_decode.restype = I
        _lib = lib
        return lib


# ---------------------------------------------------------------------------
# Image resize
# ---------------------------------------------------------------------------

BILINEAR = 0
BICUBIC = 1  # Pillow's resize() default


def resize_batch(images: Sequence[np.ndarray], size: int,
                 filter: int = BICUBIC, n_threads: int = 0) -> np.ndarray:
    """List of (H, W, 3) uint8 arrays -> (B, size, size, 3) uint8.
    ``n_threads`` 0: half the host's cores."""
    if size < 1:
        raise ValueError(f"size {size} < 1")
    for im in images:
        if im.dtype != np.uint8 or im.ndim != 3 or im.shape[2] != 3 or (
                min(im.shape[:2]) < 1):
            raise ValueError(f"expected (H, W, 3) uint8 images, got "
                             f"{im.shape} {im.dtype}")
    lib = load_library()
    batch = len(images)
    images = [np.ascontiguousarray(im) for im in images]
    ptrs = (ctypes.c_void_p * batch)(
        *[im.ctypes.data_as(ctypes.c_void_p) for im in images])
    dims = np.empty(2 * batch, np.int32)
    for i, im in enumerate(images):
        dims[2 * i], dims[2 * i + 1] = im.shape[0], im.shape[1]
    out = np.empty((batch, size, size, 3), np.uint8)
    lib.klab_resize_batch(
        ctypes.cast(ptrs, ctypes.POINTER(ctypes.c_void_p)),
        dims.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), batch,
        out.ctypes.data_as(ctypes.c_void_p), size, size, filter, n_threads)
    return out


# ---------------------------------------------------------------------------
# JPEG decoding
# ---------------------------------------------------------------------------

JPEG_SIGNATURE = b"\xff\xd8\xff"  # what Pillow's JPEG plugin accepts
DRAFT_SCALES = (8, 4, 2, 1)


def jpeg_size(data: bytes) -> tuple[int, int]:
    """(width, height) from a JPEG's SOF marker. Raises ``ValueError`` with
    the reason where the header is corrupt, truncated or unsupported, or the
    image is over Pillow's decompression-bomb limit."""
    data = bytes(data)
    lib = load_library()
    info = np.zeros(3, np.int32)
    err = ctypes.create_string_buffer(256)
    if lib.klab_jpeg_info(data, len(data), info.ctypes.data_as(
            ctypes.c_void_p), err, len(err)) != 0:
        raise ValueError(f"JPEG: {err.value.decode()}")
    return int(info[0]), int(info[1])


def draft_scale(width: int, height: int, size: int) -> int:
    """The scale 1/s that Pillow's ``JpegImageFile.draft(mode, (size,
    size))`` picks: the largest s of 8, 4, 2, 1 with s <= min(width //
    size, height // size), so the decode is never smaller than the
    target."""
    fit = min(width // size, height // size)
    return next((s for s in DRAFT_SCALES if fit >= s), 1)


def decode_jpeg(data: bytes, scale: int = 1) -> np.ndarray:
    """JPEG bytes -> (ceil(H / scale), ceil(W / scale), 3) uint8 RGB, the
    pixels Pillow gives for ``Image.open(...)`` with a draft at 1/scale,
    then ``convert("RGB")``, damaged entropy-coded data recovered as
    libjpeg recovers it. ``scale`` is 1, 2, 4 or 8. Raises ``ValueError``
    with the reason where Pillow raises: a malformed stream, one that ends
    where libjpeg under Pillow asks for more, what Pillow's header parser
    refuses, and what the decoder does not take (12-bit and hierarchical
    frames, a lossless frame at a draft scale or with a colour transform,
    fractional sampling ratios). The decode runs without the GIL."""
    if scale not in DRAFT_SCALES:
        raise ValueError(f"scale {scale}: only 1, 2, 4 or 8")
    data = bytes(data)
    width, height = jpeg_size(data)
    out = np.empty((-(-height // scale), -(-width // scale), 3), np.uint8)
    err = ctypes.create_string_buffer(256)
    if load_library().klab_jpeg_decode(
            data, len(data), scale, out.ctypes.data_as(ctypes.c_void_p),
            out.nbytes, err, len(err)) != 0:
        raise ValueError(f"JPEG: {err.value.decode()}")
    return out


# ---------------------------------------------------------------------------
# Unigram tokenizer files
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class UnigramSpec:
    """What the encoder and the decoder need of a unigram tokenizer file.
    ``pieces`` / ``scores``: the unigram vocabulary, id = index.
    ``specials``: (content, id) of the added tokens matched on the raw text
    before normalization (T5's sentinels). ``chain``: the switches of the
    C++ core's optional steps (``klab_tok_set_chain``)."""

    pieces: list[str]
    scores: list[float]
    unk_id: int
    charsmap: bytes
    specials: list[tuple[str, int]]
    chain: dict

    def token_to_id(self) -> dict[str, int]:
        """Every token's id, the added tokens over the vocabulary (as HF
        tokenizers' ``get_vocab`` merges them)."""
        out = {p: i for i, p in enumerate(self.pieces)}
        out.update(dict(self.specials))
        return out

    def id_to_token(self) -> dict[int, str]:
        out = dict(enumerate(self.pieces))
        out.update({i: t for t, i in self.specials})
        return out


# The spiece.model chain (HF's SpmConverter, which T5's converter inherits):
# Precompiled charsmap, Strip(right), Replace(/ {2,}/ -> U+2581), Metaspace.
SPM_CHAIN = dict(strip_left=False, strip_right=True, collapse_spaces=True,
                 whitespace_split=False)


def _spec_from_spm(path: str) -> UnigramSpec:
    """A ``spiece.model`` proto: its unigram pieces and charsmap, the 100
    ``<extra_id_k>`` sentinels appended reversed so that ``<extra_id_0>`` is
    the last id (as HF's T5 tokenizer adds them)."""
    from ..text.spm_proto import load_model_proto

    m = load_model_proto(path)
    if m.model_type != 1:  # 1 = UNIGRAM
        raise ValueError(f"{path}: only unigram SentencePiece models are "
                         "supported (T5's spiece.model is unigram)")
    if m.byte_fallback:
        raise ValueError(f"{path}: byte_fallback is not supported (T5's "
                         "spiece.model has none)")
    pieces = [p for p, _ in m.pieces]
    known = {p: i for i, p in enumerate(pieces)}
    specials, next_id = [], len(pieces)
    for k in reversed(range(NUM_SENTINELS)):
        tok = f"<extra_id_{k}>"
        if tok in known:
            specials.append((tok, known[tok]))
        else:
            specials.append((tok, next_id))
            next_id += 1
    return UnigramSpec(pieces=pieces, scores=[s for _, s in m.pieces],
                       unk_id=m.unk_id, charsmap=m.precompiled_charsmap,
                       specials=specials, chain=dict(SPM_CHAIN))


def _metaspace_ok(entry: dict) -> bool:
    """A Metaspace pre-tokenizer or decoder that prepends the metaspace to
    every section and splits at it (``prepend_scheme`` 'always', or the
    older ``add_prefix_space``)."""
    scheme = entry.get("prepend_scheme",
                       "always" if entry.get("add_prefix_space", True)
                       else "never")
    return (entry.get("replacement", META) == META and scheme == "always"
            and entry.get("split", True))


def _spec_from_json(path: str) -> UnigramSpec:
    """A HF ``tokenizer.json`` with a Unigram model. Its normalizer and
    pre-tokenizer set the chain; a step the C++ core does not have raises
    ``ValueError`` rather than encode otherwise than HF tokenizers would."""
    with open(path, encoding="utf-8") as f:
        spec = json.load(f)
    model = spec.get("model") or {}
    if model.get("type") != "Unigram":
        raise ValueError(f"{path}: only Unigram tokenizer.json models are "
                         f"supported, got {model.get('type')!r}")
    if model.get("byte_fallback"):
        raise ValueError(f"{path}: byte_fallback is not supported")
    vocab = model["vocab"]  # [[piece, score], ...]
    pieces = [p for p, _ in vocab]

    # Normalizer: [Precompiled] [Strip] [Replace(/ {2,}/ -> U+2581)], in
    # that order, each optional.
    norm = spec.get("normalizer") or {}
    chain_in = (norm.get("normalizers", []) if norm.get("type") == "Sequence"
                else [norm] if norm else [])
    chain = dict(strip_left=False, strip_right=False, collapse_spaces=False,
                 whitespace_split=False)
    charsmap, order = b"", []
    for entry in chain_in:
        kind = entry.get("type")
        if kind == "Precompiled":
            charsmap = base64.b64decode(entry["precompiled_charsmap"])
        elif kind == "Strip":
            chain["strip_left"] = bool(entry.get("strip_left"))
            chain["strip_right"] = bool(entry.get("strip_right"))
        elif (kind == "Replace" and entry.get("pattern") == {"Regex": " {2,}"}
              and entry.get("content") == META):
            chain["collapse_spaces"] = True
        else:
            raise ValueError(f"{path}: normalizer {entry} is not supported")
        order.append(("Precompiled", "Strip", "Replace").index(kind))
    if order != sorted(set(order)):
        raise ValueError(f"{path}: normalizers in an unsupported order: "
                         f"{[e.get('type') for e in chain_in]}")

    # Pre-tokenizer: Metaspace, or WhitespaceSplit then Metaspace (the
    # older T5 tokenizer.json files).
    pre = spec.get("pre_tokenizer") or {}
    steps = (pre.get("pretokenizers", []) if pre.get("type") == "Sequence"
             else [pre])
    if [s.get("type") for s in steps] == ["WhitespaceSplit", "Metaspace"]:
        chain["whitespace_split"] = True
        steps = steps[1:]
    if ([s.get("type") for s in steps] != ["Metaspace"]
            or not _metaspace_ok(steps[0])):
        raise ValueError(f"{path}: pre-tokenizer {pre} is not supported "
                         "(Metaspace, prepend_scheme 'always', split)")
    decoder = spec.get("decoder") or {}
    if decoder.get("type") != "Metaspace" or not _metaspace_ok(decoder):
        raise ValueError(f"{path}: decoder {decoder} is not supported "
                         "(Metaspace, prepend_scheme 'always')")

    # Added tokens are matched on the raw text, before normalization.
    specials = []
    for t in spec.get("added_tokens", []):
        if (t.get("normalized") or t.get("lstrip") or t.get("rstrip")
                or t.get("single_word")):
            raise ValueError(f"{path}: added token {t} is not supported "
                             "(only raw-text tokens without stripping)")
        specials.append((t["content"], int(t["id"])))
    return UnigramSpec(pieces=pieces, scores=[s for _, s in vocab],
                       unk_id=model.get("unk_id", 2), charsmap=charsmap,
                       specials=specials, chain=chain)


def load_unigram_spec(path: str) -> UnigramSpec:
    """``spiece.model`` (by its ``.model`` suffix) or ``tokenizer.json``."""
    if path.endswith(".model"):
        return _spec_from_spm(path)
    return _spec_from_json(path)


class NativeUnigramEncoder:
    """The C++ Viterbi encoder with the HF-T5 chain, over a
    ``tokenizer.json`` or ``spiece.model`` (a path) or a ``UnigramSpec``:
    charsmap normalization, the strip / collapse / whitespace-split steps
    the file names, metaspace, raw-text special tokens, per-pre-token
    Viterbi with fused unk. ``encode`` gives one text's ids;
    ``encode_batch`` a padded batch's."""

    def __init__(self, path: Union[str, UnigramSpec]):
        spec = path if isinstance(path, UnigramSpec) else load_unigram_spec(
            path)
        lib = load_library()
        pieces = [p.encode("utf-8") for p in spec.pieces]
        if any(b"\0" in p for p in pieces):
            raise ValueError("a vocabulary piece holds a NUL byte")
        blob = b"\0".join(pieces) + b"\0"
        n = len(pieces)
        scores = (ctypes.c_double * n)(*spec.scores)
        ids = (ctypes.c_int * n)(*range(n))
        self._lib = lib
        with _lock:  # the core's model table is not thread-safe
            self._handle = lib.klab_tok_new(blob, scores, ids, n, spec.unk_id)
        c = spec.chain
        lib.klab_tok_set_chain(self._handle, c["strip_left"],
                               c["strip_right"], c["collapse_spaces"],
                               c["whitespace_split"])
        for content, tok_id in spec.specials:
            lib.klab_tok_add_special(self._handle, content.encode("utf-8"),
                                     tok_id)
        if spec.charsmap:
            rc = lib.klab_tok_set_charsmap(self._handle, spec.charsmap,
                                           len(spec.charsmap))
            if rc != 0:
                raise ValueError("malformed precompiled_charsmap")

    def encode(self, text: str) -> list[int]:
        """One text's ids, no eos."""
        data = text.encode("utf-8")
        cap = 2 * len(data) + 8
        while True:
            out = np.empty(cap, np.int32)
            n = self._lib.klab_tok_encode(
                self._handle, data, len(data),
                out.ctypes.data_as(ctypes.c_void_p), cap)
            if n < 0:
                raise ValueError(f"native encode rejected its input (rc={n})")
            if n <= cap:
                return out[:n].tolist()
            cap = n

    def encode_batch(self, texts: Sequence[str], max_len: int,
                     pad_id: int = 0, eos_id: int = 1,
                     n_threads: int = 0) -> tuple[np.ndarray, np.ndarray]:
        """(ids, mask), each (len(texts), max_len) int32: every text
        truncated to ``max_len - 1`` ids, ``eos_id`` appended, ``pad_id``
        after it; the ids of ``encode``. ``n_threads`` 0: one thread per
        KiB of text, at most half the host's cores."""
        if not texts:
            return (np.zeros((0, max_len), np.int32),
                    np.zeros((0, max_len), np.int32))
        encoded = [t.encode("utf-8") for t in texts]
        offsets = np.zeros(len(encoded) + 1, np.int64)
        np.cumsum([len(t) for t in encoded], out=offsets[1:])
        B = len(texts)
        ids = np.empty((B, max_len), np.int32)
        mask = np.empty((B, max_len), np.int32)
        rc = self._lib.klab_tok_encode_batch(
            self._handle, b"".join(encoded),
            offsets.ctypes.data_as(ctypes.c_void_p), B,
            ids.ctypes.data_as(ctypes.c_void_p),
            mask.ctypes.data_as(ctypes.c_void_p), max_len, pad_id, eos_id,
            n_threads)
        if rc != 0:
            # The buffers were never written: raise rather than hand back
            # uninitialized "tokens".
            raise ValueError(
                f"native encode_batch rejected its inputs (rc={rc}): "
                f"handle={self._handle}, max_len={max_len}, batch={B}")
        return ids, mask
