"""What the port's JPEG decoder refuses, where it decides as Pillow decides,
and that no input crashes it: frames it does not decode (12-bit samples,
hierarchical, arithmetic-coded lossless, fractional sampling ratios,
lossless with a colour transform or at a draft scale, an image over
Pillow's decompression-bomb limit, arithmetic-coded data across Pillow's
65536-byte reads), made by patching bytes of a file Pillow wrote, each a
``ValueError`` that names the reason; byte streams on which the port must
do what Pillow does (decode to the same pixels, or raise): patched SOF
codes and sampling factors, and the markers before the first SOS that
Pillow's own header parser refuses (TEM, a JFIF, Adobe or ICC segment too
short, a Photoshop resource cut short) or skips; every fixture with its EOI
marker replaced by zero or random bytes, where libjpeg under Pillow decodes
what it reads before the end and raises where it asks for bytes past it; a
file cut at each of its markers; empty input; bytes of fixtures flipped
and cut at random (``hypothesis``: a ``ValueError`` or a well-formed array,
never a crash, and Pillow's pixels where Pillow decodes the file too); and
``POST /caption`` with a corrupt JPEG, a 400 "bad image" from a server that
goes on serving and captions a file that ends without EOI."""

import base64
import io
import json
import pathlib

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image

import _torch_port as tp
from klab_multimodalmodel_tpu.data.datasets import (
    load_image_bytes_resized as jax_bytes_loader)
from klab_multimodalmodel_tpu_torch import native
from klab_multimodalmodel_tpu_torch.data.datasets import (
    load_image_bytes_resized)
from test_torch_jpeg import segments
from torch_jpeg.make_fixtures import encode_jpeg

FIXTURES = pathlib.Path(__file__).resolve().parent / "torch_jpeg"


def pillow_jpeg(**options) -> bytes:
    rng = np.random.default_rng(7)
    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 256, (40, 56, 3), dtype=np.uint8)).save(
        buf, "JPEG", quality=80, **options)
    return buf.getvalue()


def markers(data: bytes) -> list[tuple[int, int]]:
    """(offset, marker code) of every marker of a JPEG, SOI to EOI, the
    restart markers inside scans included."""
    out, p = [(0, 0xD8)], 2
    while p < len(data):
        code = data[p + 1]
        out.append((p, code))
        if code == 0xD9:
            return out
        p += 2 + int.from_bytes(data[p + 2:p + 4], "big")
        if code == 0xDA:  # the entropy-coded data, up to the next marker
            while not (data[p] == 0xFF and data[p + 1] not in (0, 0xFF)):
                p += 1
            while 0xD0 <= data[p + 1] <= 0xD7:
                out.append((p, data[p + 1]))
                p += 2
                while not (data[p] == 0xFF and data[p + 1] not in (0, 0xFF)):
                    p += 1
    raise AssertionError("no EOI marker")


def patch_sof(data: bytes, **fields) -> bytes:
    """The file with its SOF marker's fields replaced: ``code`` (the marker's
    second byte), ``precision``, ``height``, ``width``, ``sampling`` (one
    byte per component)."""
    b = bytearray(data)
    p = next(p for p, code in markers(data) if code in (0xC0, 0xC1, 0xC2))
    if "code" in fields:
        b[p + 1] = fields["code"]
    if "precision" in fields:
        b[p + 4] = fields["precision"]
    if "height" in fields:
        b[p + 5:p + 7] = fields["height"].to_bytes(2, "big")
    if "width" in fields:
        b[p + 7:p + 9] = fields["width"].to_bytes(2, "big")
    for i, hv in enumerate(fields.get("sampling", ())):
        b[p + 11 + 3 * i] = hv
    return bytes(b)


BASE = pillow_jpeg()


def big_arithmetic_jpeg() -> bytes:
    """An arithmetic-coded file whose scan runs past Pillow's first 65536
    bytes: libjpeg's arithmetic decoder cannot suspend for Pillow's next
    read, and Pillow raises."""
    rng = np.random.default_rng(3)
    data = encode_jpeg(rng.integers(0, 256, (176, 256, 3), dtype=np.uint8),
                       [(1, 1)] * 3, coding="arith", quality=95)
    assert len(data) > 65536
    return data


REFUSED = {
    "precision12": (patch_sof(BASE, precision=12), r"12-bit samples"),
    "SOF3": (patch_sof(BASE, code=0xC3), r"lossless \(SOF3\)"),
    "SOF5": (patch_sof(BASE, code=0xC5), r"hierarchical \(SOF5\)"),
    "SOF11": (patch_sof(BASE, code=0xCB),
              r"arithmetic-coded lossless \(SOF11\)"),
    "fractional": (patch_sof(BASE, sampling=(0x31, 0x21, 0x21)),
                   r"sampling factors 3x1,2x1,2x1, not an integer ratio"),
    "arithmetic_past_64k": (big_arithmetic_jpeg(),
                            r"across Pillow's 65536-byte reads"),
    "65500x65500": (patch_sof(BASE, width=65500, height=65500),
                    r"decompression-bomb limit"),
    "empty": (b"", r"not a JPEG: no SOI marker"),
}


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_refusals_name_the_reason(name):
    data, reason = REFUSED[name]
    with pytest.raises(ValueError, match=reason):
        native.decode_jpeg(data)
    if data:  # Pillow refuses them too
        with pytest.raises(Exception):
            pillow_scaled(data, 1)
    if name == "65500x65500":
        # Refused from the SOF, before any scan is read or buffer made.
        with pytest.raises(ValueError, match=reason):
            native.jpeg_size(data[:next(
                p for p, code in markers(BASE) if code == 0xDA)])
    if data:
        with pytest.raises(ValueError, match=reason):
            load_image_bytes_resized(data, 16)
    else:
        with pytest.raises(ValueError, match="empty image data"):
            load_image_bytes_resized(data, 16)


def pillow_scaled(data: bytes, scale: int) -> np.ndarray:
    """Pillow's RGB pixels with the draft at 1/scale."""
    with Image.open(io.BytesIO(data)) as im:
        if scale > 1:
            im.draft("RGB", (max(1, min(im.size) // scale),) * 2)
            assert im.decoderconfig[0] == scale
        return np.asarray(im.convert("RGB"))


def assert_does_what_pillow_does(data: bytes, scales=native.DRAFT_SCALES,
                                 target: int = 16) -> bool:
    """At each scale, the port's pixels are Pillow's or both raise; its
    loader's at ``target`` are the JAX package's, or both raise. Whether
    Pillow decodes at scale 1."""
    decoded = {}
    for scale in scales:
        try:
            want = pillow_scaled(data, scale)
        except Exception:  # noqa: BLE001 — any refusal of Pillow's
            want = None
        if want is None:
            with pytest.raises(ValueError):
                native.decode_jpeg(data, scale)
        else:
            np.testing.assert_array_equal(native.decode_jpeg(data, scale),
                                          want, err_msg=f"1/{scale}")
        decoded[scale] = want is not None
    try:
        want = jax_bytes_loader(data, target)
    except Exception:  # noqa: BLE001
        with pytest.raises(ValueError):
            load_image_bytes_resized(data, target)
    else:
        np.testing.assert_array_equal(load_image_bytes_resized(data, target),
                                      want)
    return decoded.get(1, False)


def before(data: bytes, marker: int, insert: bytes) -> bytes:
    """``insert`` placed before the first segment of ``marker`` (0xDA: the
    first SOS)."""
    p = next((p for p, code, _ in segments(data) if code == marker), None)
    if p is None:
        p = next(p for p, code in markers(data) if code == marker)
    return data[:p] + insert + data[p:]


def app(code: int, body: bytes) -> bytes:
    return bytes([0xFF, code]) + (len(body) + 2).to_bytes(2, "big") + body


def fuzz_file_101_7() -> bytes:
    """The fuzz's seed 101 file 7 (gray, progressive) with its SOS marker's
    FF and a byte after it changed: an FF 01 (TEM) before the first SOS,
    which libjpeg ignores and Pillow's header parser refuses."""
    import sys

    sys.path.insert(0, str(FIXTURES.parent.parent / "tools"))
    import jpeg_fuzz

    data = bytearray(jpeg_fuzz.seed_files(np.random.default_rng(101))[7])
    assert len(data) == 417 and data[128:130] == b"\xff\xda"
    data[128], data[153] = 0x14, 0x01
    return bytes(data)


def sixteen_bit_dqt(data: bytes) -> bytes:
    """The first DQT's table marked 16-bit: its 64 bytes are then short of
    the 128 that the precision asks for."""
    p = next(p for p, code, _ in segments(data) if code == 0xDB)
    return data[:p + 4] + bytes([data[p + 4] | 0x10]) + data[p + 5:]


SOS = 0xDA
# name: (bytes, whether Pillow decodes them at scale 1)
AS_PILLOW = {
    # Huffman-coded data read as arithmetic-coded, and the scan's
    # sequential parameters in a progressive frame.
    "SOF9": lambda: (patch_sof(BASE, code=0xC9), True),
    "SOF10": lambda: (patch_sof(BASE, code=0xCA), False),
    # 4:2:0 data read as 4:1:1 and 4:4:0.
    "411": lambda: (patch_sof(BASE, sampling=(0x41, 0x11, 0x11)), True),
    "440": lambda: (patch_sof(BASE, sampling=(0x12, 0x11, 0x11)), True),
    # Pillow's header parser (JpegImageFile._open) before the first SOS.
    "TEM_after_SOI": lambda: (BASE[:2] + b"\xff\x01" + BASE[2:], False),
    "TEM_before_SOS": lambda: (before(BASE, SOS, b"\xff\x01"), False),
    "unknown_FF02": lambda: (before(BASE, SOS, b"\xff\x02"), False),
    "unknown_FFBF": lambda: (before(BASE, 0xC0, b"\xff\xbf"), False),
    "fuzz_101_7": lambda: (fuzz_file_101_7(), False),
    "short_JFIF": lambda: (before(BASE, 0xDB, app(0xE0, b"JFIF\x00\x01")),
                           False),
    "short_Adobe": lambda: (before(BASE, 0xDB, app(0xEE, b"Adobe\x00")),
                            False),
    "Photoshop_cut": lambda: (before(BASE, 0xDB, app(
        0xED, b"Photoshop 3.0\x008BIM\x03\xed")), False),
    "Photoshop_whole": lambda: (before(BASE, 0xDB, app(
        0xED, b"Photoshop 3.0\x008BIM\x04\x04\x00\x00\x00\x00\x00"
        b"\x02ab")), True),
    "ICC_short_before_SOF": lambda: (before(BASE, 0xC0, app(
        0xE2, b"ICC_PROFILE\x00\x01")), False),
    "ICC_short_after_SOF": lambda: (before(BASE, SOS, app(
        0xE2, b"ICC_PROFILE\x00\x01")), True),
    "DQT_16bit_short": lambda: (sixteen_bit_dqt(BASE), False),
    "segment_cut_before_SOS": lambda: (BASE[:next(
        p for p, code, _ in segments(BASE) if code == 0xC4) + 10], False),
    "junk_and_fill": lambda: (before(BASE, 0xC0, b"\x00\x12\xff\x00\xff\xff"),
                              True),
    "RST_before_SOS": lambda: (before(BASE, SOS, b"\xff\xd3"), True),
    "APP_length_0": lambda: (before(BASE, 0xDB, b"\xff\xe5\x00\x00"), True),
}


@pytest.mark.parametrize("name", sorted(AS_PILLOW))
def test_the_port_does_what_pillow_does(name):
    data, decodes = AS_PILLOW[name]()
    assert assert_does_what_pillow_does(data) == decodes


MANIFEST = json.loads((FIXTURES / "manifest.json").read_text())
# Bytes in place of a fixture's EOI marker: zeros, which libjpeg reads as
# entropy-coded data, and seeded random bytes without FF.
TAILS = [bytes(k) for k in (0, 1, 2, 4, 8, 16, 32, 64)] + [
    np.random.default_rng(k).integers(0, 255, n, dtype=np.uint8).tobytes()
    for k, n in ((1, 5), (2, 23))]


@pytest.mark.parametrize("name", sorted(MANIFEST))
def test_end_of_file_in_place_of_eoi(name):
    """A single-scan file decodes where libjpeg never asks for bytes past
    the end (its MCUs decoded before the end are Pillow's, bit for bit); a
    multi-scan file never does, as libjpeg reads to EOI before its first
    line. At every draft scale, and through both loaders."""
    data = (FIXTURES / name).read_bytes()
    assert data.endswith(b"\xff\xd9")
    w, h = MANIFEST[name]["size"]
    scales = [s for s in native.DRAFT_SCALES if min(w, h) >= s
              and MANIFEST[name].get("decode_scales", {}).get(str(s), 1)]
    for tail in TAILS:
        assert_does_what_pillow_does(data[:-2] + tail, scales, 256)


def test_end_of_file_counts_of_pr20_fixtures():
    """The PR 20 fixtures with EOI replaced by k zero bytes: as many decode
    through the port's loader as through the JAX package's (0, 7 and 13 of
    15 at k = 0, 4 and 16)."""
    names = sorted(n for n, e in MANIFEST.items() if "decode_scales" not in e)
    assert len(names) == 15
    for k, count in ((0, 0), (4, 7), (16, 13)):
        got = []
        for name in names:
            data = (FIXTURES / name).read_bytes()[:-2] + bytes(k)
            try:
                load_image_bytes_resized(data, 256)
                got.append(name)
            except ValueError:
                pass
        assert len(got) == count, (k, got)


@pytest.mark.parametrize("options", [{}, {"progressive": True},
                                     {"restart_marker_blocks": 2}],
                         ids=["baseline", "progressive", "restarts"])
def test_truncation_at_every_marker(options):
    data = pillow_jpeg(**options)
    cuts = markers(data)
    assert len(cuts) > 8
    for p, code in cuts[1:]:
        with pytest.raises(ValueError, match="truncated"):
            native.decode_jpeg(data[:p])
        if p > 2:  # FF D8 alone is not a JPEG signature (FF D8 FF)
            with pytest.raises(ValueError, match="truncated"):
                load_image_bytes_resized(data[:p], 16)
    np.testing.assert_array_equal(native.decode_jpeg(data), np.asarray(
        Image.open(io.BytesIO(data)).convert("RGB")))
    if options.get("progressive"):
        # Later scans are still to come: a segment cut after a scan
        # truncates the image.
        sos = [p for p, code in cuts if code == 0xDA]
        with pytest.raises(ValueError, match="truncated"):
            native.decode_jpeg(data[:sos[-1]] + b"\xff\xfe\x00\x10cut")


FUZZED = {name: (FIXTURES / name).read_bytes() for name in (
    "coco_375x500.jpg", "progressive_640x480.jpg", "restart_640x427.jpg",
    "s440_640x480.jpg", "sof9_arith_640x480.jpg",
    "sof10_arith_progressive_640x427.jpg")}


@settings(max_examples=150, deadline=None, derandomize=True, database=None)
@given(st.data())
def test_flipped_and_cut_bytes_never_crash(draw):
    name = draw.draw(st.sampled_from(sorted(FUZZED)))
    blob = bytearray(FUZZED[name])
    for i, x in draw.draw(st.lists(st.tuples(
            st.integers(0, len(blob) - 1), st.integers(1, 255)), max_size=6)):
        blob[i] ^= x
    cut = draw.draw(st.one_of(st.none(), st.integers(0, len(blob))))
    if cut is not None:
        del blob[cut:]
    scale = draw.draw(st.sampled_from(native.DRAFT_SCALES))
    data = bytes(blob)
    try:
        out = native.decode_jpeg(data, scale)
    except ValueError as e:
        assert str(e).startswith("JPEG: ")
        return
    w, h = native.jpeg_size(data)
    assert out.dtype == np.uint8 and out.shape == (
        -(-h // scale), -(-w // scale), 3)
    # Where Pillow decodes the damaged file too, its pixels.
    try:
        with Image.open(io.BytesIO(data)) as im:
            im.draft("RGB", (max(1, min(w, h) // scale),) * 2)
            picked = im.decoderconfig[0] if im.decoderconfig else 1
            want = np.asarray(im.convert("RGB"))
    except Exception:  # noqa: BLE001 — Pillow refuses the file
        return
    if picked == scale:
        np.testing.assert_array_equal(out, want)


def test_http_corrupt_jpeg_is_a_bad_image():
    """``/caption`` with a cut JPEG and with one whose scan names a
    component the frame lacks (Pillow raises on both): 400 "bad image"
    with the decoder's reason; the same server then captions the whole
    file, and the file whose EOI is zero bytes."""
    from klab_multimodalmodel_tpu_torch.serve.http import CaptionHTTPServer
    from klab_multimodalmodel_tpu_torch.serve.service import CaptionService
    from klab_multimodalmodel_tpu_torch.text import ByteTokenizer

    cfg, state = tp.port_cascade_state()
    service = CaptionService(cfg, state, ByteTokenizer(), max_batch=2,
                             window_ms=5.0, device="cpu")
    server = CaptionHTTPServer(service, host="127.0.0.1", port=0)
    base = f"http://127.0.0.1:{server.port}"
    good = (FIXTURES / "coco_375x500.jpg").read_bytes()
    corrupt = bytearray(good)
    sos = next(p for p, code in markers(good) if code == 0xDA)
    corrupt[sos + 5] = 9  # the first component selector: no such id
    try:
        server.start(warmup=False)
        for body, reason in ((good[:len(good) // 2], "truncated"),
                             (bytes(corrupt), "names component id 9")):
            code, err = tp.http_post(base, "/caption", {
                "image_b64": base64.b64encode(body).decode()})
            assert code == 400, err
            assert err["error"].startswith("bad image: JPEG: ") and (
                reason in err["error"]), err
        # The whole file, and the file with 16 zero bytes in place of its
        # EOI (Pillow decodes it too).
        for body in (good, good[:-2] + bytes(16)):
            code, body = tp.http_post(base, "/caption", {
                "image_b64": base64.b64encode(body).decode()})
            assert code == 200 and isinstance(body["caption"], str)
        assert tp.http_get(base, "/stats")[1]["errors"] == 0
    finally:
        server.httpd.shutdown()
        server.httpd.server_close()
        service.close()
