"""What the port's JPEG decoder refuses, and that no input crashes it: frames
it does not decode (arithmetic coding, 12-bit samples, lossless, 4:1:1, an
image over Pillow's decompression-bomb limit), made by patching bytes of a
file Pillow wrote, each a ``ValueError`` that names the reason; a file cut
at each of its markers; empty input; bytes of three fixtures flipped and cut
at random (``hypothesis``: a ``ValueError`` or a well-formed array, never a
crash, and Pillow's pixels where Pillow decodes the file too); and
``POST /caption`` with a corrupt JPEG, a 400 "bad image" from a
server that goes on serving."""

import base64
import io
import pathlib

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image

import _torch_port as tp
from klab_multimodalmodel_tpu_torch import native
from klab_multimodalmodel_tpu_torch.data.datasets import (
    load_image_bytes_resized)

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
REFUSED = {
    "SOF9": (patch_sof(BASE, code=0xC9), r"arithmetic coding \(SOF9\)"),
    "SOF10": (patch_sof(BASE, code=0xCA), r"arithmetic coding \(SOF10\)"),
    "precision12": (patch_sof(BASE, precision=12), r"12-bit samples"),
    "SOF3": (patch_sof(BASE, code=0xC3), r"lossless \(SOF3\)"),
    "SOF5": (patch_sof(BASE, code=0xC5), r"hierarchical \(SOF5\)"),
    "411": (patch_sof(BASE, sampling=(0x41, 0x11, 0x11)),
            r"sampling factors 4x1,1x1,1x1"),
    "440": (patch_sof(BASE, sampling=(0x12, 0x11, 0x11)),
            r"sampling factors 1x2,1x1,1x1"),
    "65500x65500": (patch_sof(BASE, width=65500, height=65500),
                    r"decompression-bomb limit"),
    "empty": (b"", r"not a JPEG: no SOI marker"),
}


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_refusals_name_the_reason(name):
    data, reason = REFUSED[name]
    with pytest.raises(ValueError, match=reason):
        native.decode_jpeg(data)
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
    "coco_375x500.jpg", "progressive_640x480.jpg", "restart_640x427.jpg")}


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
    file."""
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
        code, body = tp.http_post(base, "/caption", {
            "image_b64": base64.b64encode(good).decode()})
        assert code == 200 and isinstance(body["caption"], str)
        assert tp.http_get(base, "/stats")[1]["errors"] == 0
    finally:
        server.httpd.shutdown()
        server.httpd.server_close()
        service.close()
