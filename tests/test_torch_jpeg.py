"""The port's JPEG decoder (``native.decode_jpeg``, C++ in
``native/klab_jpeg.cpp``) against Pillow, bit for bit: JPEGs that Pillow
writes from seeded numpy content (noise and smooth) at every size, quality,
chroma subsampling, colour mode and coding option of ``CASES``, each decoded
at every draft scale Pillow can pick for it; and the port's
``load_image_bytes_resized`` against the JAX package's (Pillow's decode and
the JAX package's resize) at a target that picks that scale; files that
Pillow decodes but cannot write, written by the fixtures' own encoder
(``torch_jpeg/make_fixtures.encode_jpeg``) from seeded content: every
sampling ratio libjpeg upsamples (4:4:0, 4:1:1, 1x4, 4x2, chroma above
luma, ...), Huffman and arithmetic coding, sequential and progressive,
restart markers, DAC conditioning, and lossless frames (each predictor,
gray and RGB; refused at a draft scale and with a colour transform, where
Pillow raises or overruns its buffer); byte streams
edited into what Pillow does not write but decodes (the colour space that
libjpeg infers from JFIF, the Adobe transform or the component ids, YCCK,
no Huffman tables, padding, data after EOI, progressive scans cut short
(block smoothing), quantization steps raised after the encode); then the
committed fixtures
of ``tests/torch_jpeg/`` against their manifest, and decodes in four
threads at once."""

import hashlib
import io
import itertools
import json
import pathlib
import threading

import numpy as np
import pytest
from PIL import Image

from klab_multimodalmodel_tpu.data.datasets import (
    load_image_bytes_resized as jax_bytes_loader)
from klab_multimodalmodel_tpu_torch import native
from klab_multimodalmodel_tpu_torch.data.datasets import (
    load_image_bytes_resized, load_image_resized)
from torch_jpeg.make_fixtures import encode_jpeg

FIXTURES = pathlib.Path(__file__).resolve().parent / "torch_jpeg"
SIZES = [(1, 1), (7, 13), (17, 33), (48, 64), (513, 771)]  # (height, width)
# RGB at every quality and subsampling (Pillow's 0 = 4:4:4, 1 = 4:2:2,
# 2 = 4:2:0); then each colour mode and coding option at 4:2:0, quality 75.
# Progressive 4:4:4 at quality 50: Pillow's progressive encoder holds the
# whole file in a buffer of width x height bytes, which a noisy 4:4:4 file
# outgrows at 75.
VARIANTS = {
    "gray": ("L", {}),
    "cmyk": ("CMYK", {}),
    "progressive": ("RGB", {"progressive": True}),
    "progressive_444": ("RGB", {"progressive": True, "subsampling": 0,
                                "quality": 50}),
    "optimize": ("RGB", {"optimize": True}),
    "restart_blocks": ("RGB", {"restart_marker_blocks": 3}),
    "restart_rows": ("RGB", {"restart_marker_rows": 1}),
    "progressive_restart": ("RGB", {"progressive": True,
                                    "restart_marker_blocks": 2}),
}
CASES = (
    [("rgb", size, q, sub, content)
     for size, q, sub, content in itertools.product(
         SIZES, (50, 75, 95), (0, 1, 2), ("noise", "smooth"))]
    + [(variant, size, VARIANTS[variant][1].get("quality", 75), 2, content)
       for variant, size, content in itertools.product(
           VARIANTS, SIZES, ("noise", "smooth"))])


def pixels(rng: np.random.Generator, h: int, w: int, channels: int,
           content: str) -> np.ndarray:
    if content == "noise":
        return rng.integers(0, 256, (h, w, channels), dtype=np.uint8)
    y, x = np.mgrid[0:h, 0:w]
    f = rng.uniform(0.02, 0.3, (channels, 2))
    phase = rng.uniform(0, 2 * np.pi, (channels, 2))
    out = [127 + 110 * np.sin(x * f[c, 0] + phase[c, 0])
           * np.cos(y * f[c, 1] + phase[c, 1]) for c in range(channels)]
    return np.clip(np.stack(out, -1), 0, 255).astype(np.uint8)


def encode(case) -> bytes:
    variant, (h, w), quality, sub, content = case
    mode, options = VARIANTS.get(variant, ("RGB", {}))
    seed = CASES.index(case)
    channels = {"RGB": 3, "L": 1, "CMYK": 4}[mode]
    a = pixels(np.random.default_rng(seed), h, w, channels, content)
    im = Image.fromarray(a[..., 0] if mode == "L" else a, mode)
    kw = {"quality": quality, **options}
    if mode == "RGB":
        kw.setdefault("subsampling", sub)
    buf = io.BytesIO()
    im.save(buf, "JPEG", **kw)
    return buf.getvalue()


def pillow_decode(data: bytes, target: int) -> tuple[np.ndarray, int]:
    """Pillow's RGB pixels with the draft for (target, target), and the
    scale it picked."""
    with Image.open(io.BytesIO(data)) as im:
        im.draft("RGB", (target, target))
        return np.asarray(im.convert("RGB")), im.decoderconfig[0]


@pytest.mark.parametrize("case", CASES, ids=lambda c: (
    f"{c[0]}-{c[1][0]}x{c[1][1]}-q{c[2]}-s{c[3]}-{c[4]}"))
def test_decode_matches_pillow(case):
    data = encode(case)
    h, w = case[1]
    assert native.jpeg_size(data) == (w, h)
    for scale in native.DRAFT_SCALES:
        if min(h, w) < scale:
            continue
        target = min(h, w) // scale  # Pillow's draft picks this scale
        want, picked = pillow_decode(data, target)
        assert picked == scale == native.draft_scale(w, h, target)
        got = native.decode_jpeg(data, scale)
        assert got.shape == want.shape == (-(-h // scale), -(-w // scale), 3)
        np.testing.assert_array_equal(got, want, err_msg=f"1/{scale}")
        np.testing.assert_array_equal(
            load_image_bytes_resized(data, target),
            jax_bytes_loader(data, target), err_msg=f"loader at {target}")


# name: (sampling factors per component, encode_jpeg's options)
ENC_SAMPLINGS = {
    "440": [(1, 2), (1, 1), (1, 1)], "411": [(4, 1), (1, 1), (1, 1)],
    "1x4": [(1, 4), (1, 1), (1, 1)], "4x2": [(4, 2), (1, 1), (1, 1)],
    "2x2_1x2": [(2, 2), (1, 2), (1, 2)], "chroma_2x2": [(1, 1), (2, 2), (2, 2)],
    "310": [(3, 1), (1, 1), (1, 1)], "420": [(2, 2), (1, 1), (1, 1)]}
ENC_CODINGS = {
    "huffman": {}, "progressive": {"progressive": True},
    "restarts": {"restart": 3}, "arith": {"coding": "arith"},
    "arith_progressive": {"coding": "arith", "progressive": True},
    "arith_restarts": {"coding": "arith", "restart": 2,
                       "dac": {"L": [2, 1], "U": [5, 3], "K": [3, 9]}}}
ENCODED = [(s, c, size) for s, c, size in itertools.product(
    ENC_SAMPLINGS, ENC_CODINGS, ((23, 41), (64, 48)))]


@pytest.mark.parametrize("case", ENCODED, ids=lambda c: (
    f"{c[0]}-{c[1]}-{c[2][0]}x{c[2][1]}"))
def test_encoded_codings_match_pillow(case):
    """What Pillow decodes but cannot write, bit for bit at every scale."""
    sampling, coding, (h, w) = case
    a = pixels(np.random.default_rng(ENCODED.index(case)), h, w, 3,
               "smooth" if h < 50 else "noise")
    data = encode_jpeg(a, ENC_SAMPLINGS[sampling], **ENC_CODINGS[coding])
    for scale in native.DRAFT_SCALES:
        if min(h, w) < scale:
            continue
        want, picked = pillow_decode(data, min(h, w) // scale)
        assert picked == scale
        np.testing.assert_array_equal(native.decode_jpeg(data, scale), want,
                                      err_msg=f"1/{scale}")


LOSSLESS = [(p, kind) for p in range(1, 8) for kind in ("gray", "rgb")] + [
    (4, "gray_restarts"), (7, "rgb_restarts"), (1, "ycc")]


@pytest.mark.parametrize("case", LOSSLESS, ids=lambda c: f"{c[1]}-p{c[0]}")
def test_lossless_matches_pillow(case):
    """Lossless frames at scale 1 bit for bit; at a draft scale (where
    Pillow 12 raises or writes past its buffer) and with a colour transform
    (which libjpeg-turbo refuses) refused."""
    predictor, kind = case
    h, w = 29, 37
    a = pixels(np.random.default_rng(predictor), h, w, 3,
               "noise" if predictor % 2 else "smooth")
    restart = w * 2 if kind.endswith("restarts") else 0
    if kind.startswith("gray"):
        data = encode_jpeg(a[..., 0], [(1, 1)], predictor=predictor,
                           restart=restart)
    else:
        data = encode_jpeg(a, [(1, 1)] * 3, predictor=predictor,
                           restart=restart, rgb=kind != "ycc")
    if kind == "ycc":
        with pytest.raises(OSError), Image.open(io.BytesIO(data)) as im:
            im.convert("RGB")
        with pytest.raises(ValueError, match="with a colour transform"):
            native.decode_jpeg(data)
        return
    with Image.open(io.BytesIO(data)) as im:
        want = np.asarray(im.convert("RGB"))
    np.testing.assert_array_equal(native.decode_jpeg(data), want)
    if kind.startswith("gray"):
        np.testing.assert_array_equal(want[..., 0], a[..., 0])
    for scale in (2, 4, 8):
        with pytest.raises(ValueError, match="at a draft scale"):
            native.decode_jpeg(data, scale)


def segments(data: bytes) -> list[tuple[int, int, int]]:
    """(offset, marker, length) of each marker segment before the first
    SOS."""
    out, p = [], 2
    while data[p + 1] != 0xDA:
        n = int.from_bytes(data[p + 2:p + 4], "big")
        out.append((p, data[p + 1], n))
        p += 2 + n
    return out


def without(data: bytes, marker: int) -> bytes:
    """The file with its header's segments of one marker taken out."""
    keep, last = [data[:2]], 2
    for p, code, n in segments(data):
        if code == marker:
            keep.append(data[last:p])
            last = p + 2 + n
    return b"".join(keep) + data[last:]


def with_adobe(data: bytes, transform: int) -> bytes:
    """An Adobe APP14 segment with the given colour transform after SOI
    (the one that is there already patched, if any)."""
    i = data.find(b"Adobe")
    if i > 0:
        return data[:i + 11] + bytes([transform]) + data[i + 12:]
    return (data[:2] + b"\xff\xee\x00\x0eAdobe\x00\x64\x00\x00\x00\x00"
            + bytes([transform]) + data[2:])


def with_ids(data: bytes, ids: bytes) -> bytes:
    """Component ids 1, 2, 3 renamed in the SOF and every SOS."""
    b = bytearray(data)
    p, code, _ = next(s for s in segments(data) if s[1] in (0xC0, 0xC2))
    for i in range(3):
        b[p + 10 + 3 * i] = ids[i]
    q = 0
    while (q := b.find(b"\xff\xda", q) + 2) > 1:
        for i in range(b[q + 2]):
            b[q + 3 + 2 * i] = ids[b[q + 3 + 2 * i] - 1]
    return bytes(b)


def first_scans(data: bytes, n: int) -> bytes:
    """A progressive file cut after its first n scans, EOI appended: the
    later refinements never come, and libjpeg block-smooths the image."""
    p, seen = 2, 0
    while True:
        code = data[p + 1]
        p += 2 + int.from_bytes(data[p + 2:p + 4], "big")
        if code == 0xDA:  # to the end of the scan's entropy-coded data
            while not (data[p] == 0xFF and data[p + 1] not in (0, 0xFF)
                       and not 0xD0 <= data[p + 1] <= 0xD7):
                p += 1
            seen += 1
            if seen == n:
                return data[:p] + b"\xff\xd9"


def with_padding(data: bytes) -> bytes:
    """Fill FF bytes before every header marker and junk bytes between two
    segments, which libjpeg (and Pillow's parser) skip."""
    out, last = [data[:2]], 2
    for i, (p, code, n) in enumerate(segments(data)):
        out.append(data[last:p] + (b"\x00junk" if i == 1 else b"")
                   + b"\xff\xff\xff")
        last = p
    return b"".join(out) + data[last:]


def with_quant(data: bytes, steps: dict) -> bytes:
    """The first quantization table's steps at the given zigzag indices
    replaced after the file was written: coefficients then dequantize far
    beyond what an encoder gives (8-bit tables)."""
    b = bytearray(data)
    p = next(p for p, code, _ in segments(data) if code == 0xDB)
    for k, v in steps.items():
        b[p + 5 + k] = v
    return bytes(b)


def _pillow_file(mode: str, **options) -> bytes:
    a = pixels(np.random.default_rng(11), 37, 53,
               {"RGB": 3, "CMYK": 4}[mode], "smooth")
    buf = io.BytesIO()
    Image.fromarray(a, mode).save(buf, "JPEG", quality=80, **options)
    return buf.getvalue()


# Byte streams that Pillow does not write but decodes: the colour space
# that libjpeg infers (JFIF, the Adobe transform, component ids), Motion
# JPEG's missing Huffman tables, padding, and data after EOI.
STREAMS = {
    "ycck": lambda: with_adobe(_pillow_file("CMYK"), 2),
    "ycck_progressive": lambda: with_adobe(
        _pillow_file("CMYK", progressive=True), 2),
    "cmyk_no_adobe": lambda: without(_pillow_file("CMYK"), 0xEE),
    "adobe_other_transform": lambda: with_adobe(_pillow_file("CMYK"), 7),
    "rgb_adobe_0": lambda: with_adobe(without(_pillow_file("RGB"), 0xE0), 0),
    "ycc_adobe_1": lambda: with_adobe(without(_pillow_file("RGB"), 0xE0), 1),
    "jfif_beside_adobe_0": lambda: with_adobe(_pillow_file("RGB"), 0),
    "ids_RGB": lambda: with_ids(without(_pillow_file("RGB"), 0xE0), b"RGB"),
    "ids_other": lambda: with_ids(without(_pillow_file("RGB"), 0xE0),
                                  b"\x05\x06\x07"),
    "no_jfif": lambda: without(_pillow_file("RGB", subsampling=1), 0xE0),
    "no_dht": lambda: without(_pillow_file("RGB"), 0xC4),
    "padding": lambda: with_padding(_pillow_file("RGB", progressive=True)),
    "after_eoi": lambda: _pillow_file("RGB") + b"\x00trailing\xff\xd8",
    # A single-scan image is whole once its scan is: a segment cut after it
    # ends the file early, which libjpeg meets only while finishing.
    "cut_after_scan": lambda: (_pillow_file("RGB")[:-2]
                               + b"\xff\xfe\x00\x10cut"),
    # Progressive scans that stop short: block smoothing, of the first AC
    # coefficients (9 scans of 10) and of the DC too (the DC scan alone).
    "smoothed": lambda: first_scans(_pillow_file(
        "RGB", progressive=True), 9),
    "smoothed_444_restarts": lambda: first_scans(_pillow_file(
        "RGB", progressive=True, subsampling=0, restart_marker_blocks=3), 5),
    "smoothed_dc_only": lambda: first_scans(_pillow_file(
        "RGB", progressive=True), 1),
    "smoothed_cmyk_dc_only": lambda: first_scans(_pillow_file(
        "CMYK", progressive=True), 1),
    # Out of the range an encoder gives: libjpeg-turbo's SIMD IDCTs
    # saturate where its C code wraps.
    "quant_out_of_range": lambda: with_quant(
        _pillow_file("RGB", subsampling=0), {0: 251, 1: 200, 2: 180}),
    "quant_out_of_range_progressive": lambda: with_quant(
        _pillow_file("RGB", progressive=True), {0: 251, 3: 255}),
}


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_edited_streams_match_pillow(name):
    data = STREAMS[name]()
    for scale in native.DRAFT_SCALES:
        want, picked = pillow_decode(data, 37 // scale)
        assert picked == scale
        np.testing.assert_array_equal(native.decode_jpeg(data, scale), want,
                                      err_msg=f"1/{scale}")


def test_draft_scale_matches_pillow():
    data = encode(CASES[0])
    for w, h, size in itertools.product((1, 255, 256, 511, 512, 1030, 4032),
                                        (1, 300, 2060, 3024), (1, 32, 256)):
        with Image.open(io.BytesIO(data)) as im:
            im._size = (w, h)
            im.draft("RGB", (size, size))
            assert im.decoderconfig[0] == native.draft_scale(w, h, size), (
                w, h, size)


def _sha(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


MANIFEST = json.loads((FIXTURES / "manifest.json").read_text())


def test_fixture_set_is_whole():
    files = sorted(p.name for p in FIXTURES.glob("*.jpg"))
    assert files == sorted(MANIFEST)
    assert 12 <= len(files) <= 24
    assert sum((FIXTURES / f).stat().st_size for f in files) < 1.5e6
    kinds = {e["kind"] for e in MANIFEST.values()}
    assert {"coco", "draft_s2", "draft_s4", "draft_s8", "gray", "cmyk",
            "progressive", "restart", "subsampling_444",
            "subsampling_422", "subsampling_440", "subsampling_411",
            "progressive_440", "arithmetic", "arithmetic_progressive",
            "lossless"} <= kinds
    assert {e["draft_scale"] for e in MANIFEST.values()} == {1, 2, 4, 8}


@pytest.mark.parametrize("name", sorted(MANIFEST))
def test_fixture_manifest(name):
    """The manifest's digests are what Pillow and the JAX package give now,
    and what the port's decoder and loaders give."""
    entry = MANIFEST[name]
    data = (FIXTURES / name).read_bytes()
    assert len(data) == entry["bytes"]
    want, scale = pillow_decode(data, 256)
    assert scale == entry["draft_scale"]
    assert list(want.shape) == entry["decode_shape"]
    assert _sha(want) == entry["decode"]
    assert _sha(jax_bytes_loader(data, 256)) == entry["resized_256"]
    w, h = entry["size"]
    got = native.decode_jpeg(data, native.draft_scale(w, h, 256))
    assert _sha(got) == entry["decode"]
    assert _sha(load_image_bytes_resized(data, 256)) == entry["resized_256"]
    assert _sha(load_image_resized(str(FIXTURES / name), 256)) == entry[
        "resized_256"]


OWN = sorted(n for n, e in MANIFEST.items() if "decode_scales" in e)


@pytest.mark.parametrize("name", OWN)
def test_fixture_every_draft_scale(name):
    """The encoder's fixtures at every draft scale: the manifest's digests
    are Pillow's now and the port's; where Pillow does not decode (a
    lossless frame at a draft scale), the port refuses."""
    data = (FIXTURES / name).read_bytes()
    w, h = MANIFEST[name]["size"]
    for s, want in MANIFEST[name]["decode_scales"].items():
        scale = int(s)
        if want is None:
            with pytest.raises(ValueError, match="at a draft scale"):
                native.decode_jpeg(data, scale)
            continue
        pixels_, picked = pillow_decode(data, min(w, h) // scale)
        assert picked == scale and _sha(pixels_) == want
        assert _sha(native.decode_jpeg(data, scale)) == want


def test_threads_decode_at_once():
    """The decode releases the GIL (a ``ctypes`` call): four threads decode
    the fixtures at once, each with the pixels of the serial decode."""
    names = sorted(n for n in MANIFEST if MANIFEST[n]["bytes"] < 100_000)
    blobs = [(FIXTURES / n).read_bytes() for n in names]
    want = [native.decode_jpeg(b) for b in blobs]
    got = [[None] * len(blobs) for _ in range(4)]

    def work(t: int) -> None:
        for i, b in enumerate(blobs):
            got[t][i] = native.decode_jpeg(b)

    threads = [threading.Thread(target=work, args=(t,)) for t in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    for row in got:
        for a, b in zip(row, want):
            np.testing.assert_array_equal(a, b)
