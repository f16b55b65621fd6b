"""Writes the JPEG fixtures of this directory and their ``manifest.json``.

    JAX_PLATFORMS=cpu python tests/torch_jpeg/make_fixtures.py

Each fixture is a smooth seeded scene (gratings, blobs and a gradient per
channel, so the files stay small) at a size and with options that the
port's JPEG decoder must cover: COCO sizes, one image for each of Pillow's
draft scales at 256 px, grayscale, CMYK, progressive, restart markers,
4:4:4 and 4:2:2, which Pillow writes; and what Pillow decodes but cannot
write, which this file's own encoder (``encode_jpeg``: numpy DCT, libjpeg's
quality scaling, optimal Huffman tables, the arithmetic coder of T.81 Annex
D as libjpeg's jcarith.c codes it, lossless prediction) writes: 4:4:0 and
4:1:1, progressive 4:4:0, arithmetic coding sequential (with a DAC segment)
and progressive, and a lossless frame. The manifest gives, for each file,
its kind, the draft scale at 256 px, and the SHA-256 of Pillow's RGB decode
at that scale (``decode``) and of the JAX package's
``load_image_bytes_resized(data, 256)`` (``resized_256``); for the encoder's
files also Pillow's decode at every draft scale (``decode_scales``; null
where Pillow does not decode: a lossless frame at a draft scale, where
Pillow 12 raises or writes past its buffer). ``tests/test_torch_jpeg.py``
holds the manifest against what Pillow, the JAX package and the port's
native decoder give now; ``chip_smoke.py`` holds the port's decode on the
card's machine against it. ``tools/jpeg_fuzz.py`` mutates the encoder's
files too.
"""

import hashlib
import io
import json
import pathlib
import sys

import numpy as np

HERE = pathlib.Path(__file__).resolve().parent
SIZE = 256
SEED = 20

# name: (kind, (width, height), Pillow mode, save options)
FIXTURES = {
    "coco_640x480.jpg": ("coco", (640, 480), "RGB", {}),
    "coco_480x640.jpg": ("coco", (480, 640), "RGB", {}),
    "coco_640x427.jpg": ("coco", (640, 427), "RGB", {"quality": 90}),
    "coco_375x500.jpg": ("coco", (375, 500), "RGB", {"quality": 60}),
    "coco_612x612.jpg": ("coco", (612, 612), "RGB", {"optimize": True}),
    "draft2_600x520.jpg": ("draft_s2", (600, 520), "RGB", {}),
    "draft4_1100x1030.jpg": ("draft_s4", (1100, 1030), "RGB", {}),
    "draft8_2100x2060.jpg": ("draft_s8", (2100, 2060), "RGB", {}),
    "photo_4032x3024.jpg": ("draft_s8", (4032, 3024), "RGB", {}),
    "gray_640x480.jpg": ("gray", (640, 480), "L", {}),
    "cmyk_500x375.jpg": ("cmyk", (500, 375), "CMYK", {}),
    "progressive_640x480.jpg": ("progressive", (640, 480), "RGB",
                                {"progressive": True}),
    "restart_640x427.jpg": ("restart", (640, 427), "RGB",
                            {"restart_marker_blocks": 5}),
    "s444_480x640.jpg": ("subsampling_444", (480, 640), "RGB",
                         {"subsampling": 0}),
    "s422_640x480.jpg": ("subsampling_422", (640, 480), "RGB",
                         {"subsampling": 1, "progressive": True}),
}


# The encoder's files. name: (kind, (width, height), mode, encode_jpeg's
# options); "L" is gray, "RGB" is stored as JFIF YCbCr unless "rgb".
S420 = [(2, 2), (1, 1), (1, 1)]
OWN_FIXTURES = {
    "s440_640x480.jpg": ("subsampling_440", (640, 480), "RGB",
                         {"sampling": [(1, 2), (1, 1), (1, 1)]}),
    "s411_640x480.jpg": ("subsampling_411", (640, 480), "RGB",
                         {"sampling": [(4, 1), (1, 1), (1, 1)]}),
    "s440_progressive_480x640.jpg": (
        "progressive_440", (480, 640), "RGB",
        {"sampling": [(1, 2), (1, 1), (1, 1)], "progressive": True}),
    "sof9_arith_640x480.jpg": (
        "arithmetic", (640, 480), "RGB",
        {"sampling": S420, "coding": "arith", "restart": 40,
         "dac": {"L": [1, 0], "U": [4, 2], "K": [6, 3]}}),
    "sof10_arith_progressive_640x427.jpg": (
        "arithmetic_progressive", (640, 427), "RGB",
        {"sampling": S420, "coding": "arith", "progressive": True}),
    "lossless_rgb_320x240.jpg": (
        "lossless", (320, 240), "RGB",
        {"sampling": [(1, 1)] * 3, "predictor": 6, "rgb": True}),
}

def scene(rng: np.random.Generator, width: int, height: int,
          channels: int) -> np.ndarray:
    """(height, width, channels) uint8: per channel two gratings, two
    Gaussian blobs and a linear gradient, with seeded parameters."""
    y, x = np.mgrid[0:height, 0:width].astype(np.float64)
    out = []
    for _ in range(channels):
        v = 128.0 + 60.0 * (x / width - 0.5) * rng.uniform(-1, 1)
        for _ in range(2):
            fx, fy = rng.uniform(0.002, 0.05, 2)
            v += 35.0 * np.sin(fx * x + fy * y + rng.uniform(0, 2 * np.pi))
        for _ in range(2):
            cx, cy = rng.uniform(0, width), rng.uniform(0, height)
            r = rng.uniform(0.05, 0.3) * max(width, height)
            v += rng.uniform(-60, 60) * np.exp(
                -((x - cx) ** 2 + (y - cy) ** 2) / (2 * r * r))
        out.append(v)
    return np.clip(np.stack(out, -1), 0, 255).astype(np.uint8)


def encode(name: str, seed: int) -> bytes:
    from PIL import Image

    kind, (width, height), mode, options = {**FIXTURES, **OWN_FIXTURES}[name]
    channels = {"RGB": 3, "L": 1, "CMYK": 4}[mode]
    pixels = scene(np.random.default_rng(seed), width, height, channels)
    if name in OWN_FIXTURES:
        kw = dict(options)
        return encode_jpeg(pixels[..., 0] if mode == "L" else pixels,
                           kw.pop("sampling"), **kw)
    im = Image.fromarray(pixels[..., 0] if mode == "L" else pixels, mode)
    buf = io.BytesIO()
    im.save(buf, "JPEG", **{"quality": 75, **options})
    return buf.getvalue()


def pillow_decode(data: bytes, size: int = SIZE) -> tuple[np.ndarray, int]:
    """Pillow's RGB pixels at the draft for (size, size), and the scale."""
    from PIL import Image

    with Image.open(io.BytesIO(data)) as im:
        im.draft("RGB", (size, size))
        scale = im.decoderconfig[0] if im.decoderconfig else 1
        return np.asarray(im.convert("RGB")), scale


def digest(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def entry(name: str, data: bytes) -> dict:
    """The manifest's entry of one file, from Pillow and the JAX package."""
    from klab_multimodalmodel_tpu import native as jnative
    from klab_multimodalmodel_tpu.data.datasets import (
        load_image_bytes_resized)

    assert jnative.available(), "the JAX package's native resize is needed"
    kind, (width, height), mode, options = {**FIXTURES, **OWN_FIXTURES}[name]
    decoded, scale = pillow_decode(data)
    resized = load_image_bytes_resized(data, SIZE)
    out = {"kind": kind, "size": [width, height], "mode": mode,
           "options": options, "bytes": len(data), "draft_scale": scale,
           "decode_shape": list(decoded.shape), "decode": digest(decoded),
           "resized_256": digest(resized)}
    if name in OWN_FIXTURES:
        out["decode_scales"] = {
            str(s): None if "predictor" in options and s > 1 else digest(
                pillow_decode(data, min(width, height) // s)[0])
            for s in (1, 2, 4, 8)}
    return out


# --------------------------------------------------------------------------
# The encoder
# --------------------------------------------------------------------------

ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])
LUMA_Q = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
CHROMA_Q = np.array([
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99] + [99] * 32)
# T.81 Table D.2: (Qe, next index after an MPS, after an LPS, switch MPS).
QE = [
    (0x5a1d, 1, 1, 1), (0x2586, 2, 14, 0), (0x1114, 3, 16, 0),
    (0x080b, 4, 18, 0), (0x03d8, 5, 20, 0), (0x01da, 6, 23, 0),
    (0x00e5, 7, 25, 0), (0x006f, 8, 28, 0), (0x0036, 9, 30, 0),
    (0x001a, 10, 33, 0), (0x000d, 11, 35, 0), (0x0006, 12, 9, 0),
    (0x0003, 13, 10, 0), (0x0001, 13, 12, 0), (0x5a7f, 15, 15, 1),
    (0x3f25, 16, 36, 0), (0x2cf2, 17, 38, 0), (0x207c, 18, 39, 0),
    (0x17b9, 19, 40, 0), (0x1182, 20, 42, 0), (0x0cef, 21, 43, 0),
    (0x09a1, 22, 45, 0), (0x072f, 23, 46, 0), (0x055c, 24, 48, 0),
    (0x0406, 25, 49, 0), (0x0303, 26, 51, 0), (0x0240, 27, 52, 0),
    (0x01b1, 28, 54, 0), (0x0144, 29, 56, 0), (0x00f5, 30, 57, 0),
    (0x00b7, 31, 59, 0), (0x008a, 32, 60, 0), (0x0068, 33, 62, 0),
    (0x004e, 34, 63, 0), (0x003b, 35, 32, 0), (0x002c, 9, 33, 0),
    (0x5ae1, 37, 37, 1), (0x484c, 38, 64, 0), (0x3a0d, 39, 65, 0),
    (0x2ef1, 40, 67, 0), (0x261f, 41, 68, 0), (0x1f33, 42, 69, 0),
    (0x19a8, 43, 70, 0), (0x1518, 44, 72, 0), (0x1177, 45, 73, 0),
    (0x0e74, 46, 74, 0), (0x0bfb, 47, 75, 0), (0x09f8, 48, 77, 0),
    (0x0861, 49, 78, 0), (0x0706, 50, 79, 0), (0x05cd, 51, 48, 0),
    (0x04de, 52, 50, 0), (0x040f, 53, 50, 0), (0x0363, 54, 51, 0),
    (0x02d4, 55, 52, 0), (0x025c, 56, 53, 0), (0x01f8, 57, 54, 0),
    (0x01a4, 58, 55, 0), (0x0160, 59, 56, 0), (0x0125, 60, 57, 0),
    (0x00f6, 61, 58, 0), (0x00cb, 62, 59, 0), (0x00ab, 63, 61, 0),
    (0x008f, 32, 61, 0), (0x5b12, 65, 65, 1), (0x4d04, 66, 80, 0),
    (0x412c, 67, 81, 0), (0x37d8, 68, 82, 0), (0x2fe8, 69, 83, 0),
    (0x293c, 70, 84, 0), (0x2379, 71, 86, 0), (0x1edf, 72, 87, 0),
    (0x1aa9, 73, 87, 0), (0x174e, 74, 72, 0), (0x1424, 75, 72, 0),
    (0x119c, 76, 74, 0), (0x0f6b, 77, 74, 0), (0x0d51, 78, 75, 0),
    (0x0bb6, 79, 77, 0), (0x0a40, 48, 77, 0), (0x5832, 81, 80, 1),
    (0x4d1c, 82, 88, 0), (0x438e, 83, 89, 0), (0x3bdd, 84, 90, 0),
    (0x34ee, 85, 91, 0), (0x2eae, 86, 92, 0), (0x299a, 87, 93, 0),
    (0x2516, 71, 86, 0), (0x5570, 89, 88, 1), (0x4ca9, 90, 95, 0),
    (0x44d9, 91, 96, 0), (0x3e22, 92, 97, 0), (0x3824, 93, 99, 0),
    (0x32b4, 94, 99, 0), (0x2e17, 86, 93, 0), (0x56a8, 96, 95, 1),
    (0x4f46, 97, 101, 0), (0x47e5, 98, 102, 0), (0x41cf, 99, 103, 0),
    (0x3c3d, 100, 104, 0), (0x375e, 93, 99, 0), (0x5231, 102, 105, 0),
    (0x4c0f, 103, 106, 0), (0x4639, 104, 107, 0), (0x415e, 99, 103, 0),
    (0x5627, 106, 105, 1), (0x50e7, 107, 108, 0), (0x4b85, 103, 109, 0),
    (0x5597, 109, 110, 0), (0x504f, 107, 111, 0), (0x5a10, 111, 110, 1),
    (0x5522, 109, 112, 0), (0x59eb, 111, 112, 1), (0x5a1d, 113, 113, 0)]


def quant_table(base: np.ndarray, quality: int) -> np.ndarray:
    """libjpeg's quality scaling of a base table (natural order)."""
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return np.clip((base * scale + 50) // 100, 1, 255).astype(np.int64)


def _dct_matrix() -> np.ndarray:
    m = np.zeros((8, 8))
    for u in range(8):
        c = np.sqrt(0.5) if u == 0 else 1.0
        for x in range(8):
            m[u, x] = 0.5 * c * np.cos((2 * x + 1) * u * np.pi / 16)
    return m


DCT = _dct_matrix()


def planes(pixels: np.ndarray, sampling, ycc: bool):
    """Each component's plane, downsampled by averaging, padded to whole
    MCUs by replicating its last row and column; and the MCU grid."""
    h_img, w_img = pixels.shape[:2]
    x = pixels.astype(np.float64)
    if ycc:
        r, g, b = x[..., 0], x[..., 1], x[..., 2]
        x = np.stack([0.299 * r + 0.587 * g + 0.114 * b,
                      -0.168736 * r - 0.331264 * g + 0.5 * b + 128,
                      0.5 * r - 0.418688 * g - 0.081312 * b + 128], -1)
    max_h = max(h for h, _ in sampling)
    max_v = max(v for _, v in sampling)
    mcus_x = -(-w_img // (8 * max_h))
    mcus_y = -(-h_img // (8 * max_v))
    out = []
    for c, (h, v) in enumerate(sampling):
        fh, fv = max_h // h, max_v // v
        ph, pw = -(-h_img // fv) * fv, -(-w_img // fh) * fh
        p = np.pad(x[..., c], ((0, ph - h_img), (0, pw - w_img)), "edge")
        p = p.reshape(ph // fv, fv, pw // fh, fh).mean((1, 3))
        rows, cols = mcus_y * v * 8, mcus_x * h * 8
        p = np.pad(p, ((0, rows - p.shape[0]), (0, cols - p.shape[1])),
                   "edge")
        out.append(p)
    return out, mcus_x, mcus_y


def coefficients(plane: np.ndarray, q: np.ndarray) -> np.ndarray:
    """(block rows, block cols, 64) quantized DCT coefficients in natural
    order."""
    by, bx = plane.shape[0] // 8, plane.shape[1] // 8
    b = (plane - 128.0).reshape(by, 8, bx, 8).transpose(0, 2, 1, 3)
    f = np.einsum("ux,ijxy,vy->ijuv", DCT, b, DCT).reshape(by, bx, 64)
    return np.round(f / q).astype(np.int64)


def lossless_samples(plane: np.ndarray) -> np.ndarray:
    return np.clip(np.round(plane), 0, 255).astype(np.int64)


def size_of(v: int) -> int:
    return int(abs(v)).bit_length()


def bits_of(v: int, s: int) -> int:
    return v if v >= 0 else v + (1 << s) - 1


class BitWriter:
    def __init__(self):
        self.out = bytearray()
        self.acc = 0
        self.n = 0

    def put(self, value: int, count: int) -> None:
        if count == 0:
            return
        self.acc = (self.acc << count) | (value & ((1 << count) - 1))
        self.n += count
        while self.n >= 8:
            self.n -= 8
            byte = (self.acc >> self.n) & 0xFF
            self.out.append(byte)
            if byte == 0xFF:
                self.out.append(0)
        self.acc &= (1 << self.n) - 1

    def flush(self) -> bytes:
        if self.n:
            self.put((1 << (8 - self.n)) - 1, 8 - self.n)
        return bytes(self.out)


def optimal_table(freq: dict) -> tuple[list, list]:
    """libjpeg's jpeg_gen_optimal_table: (bits[1..16], values) of a
    Huffman code for symbol frequencies (no code of all ones)."""
    f = [0] * 257
    for s, n in freq.items():
        f[s] = n
    f[256] = 1
    codesize = [0] * 257
    others = [-1] * 257
    while True:
        c1, v = -1, 1 << 62
        for i in range(257):
            if f[i] and f[i] <= v:
                v, c1 = f[i], i
        c2, v = -1, 1 << 62
        for i in range(257):
            if f[i] and f[i] <= v and i != c1:
                v, c2 = f[i], i
        if c2 < 0:
            break
        f[c1] += f[c2]
        f[c2] = 0
        codesize[c1] += 1
        while others[c1] >= 0:
            c1 = others[c1]
            codesize[c1] += 1
        others[c1] = c2
        codesize[c2] += 1
        while others[c2] >= 0:
            c2 = others[c2]
            codesize[c2] += 1
    bits = [0] * 33
    for i in range(257):
        if codesize[i]:
            bits[codesize[i]] += 1
    for i in range(32, 16, -1):
        while bits[i] > 0:
            j = i - 2
            while bits[j] == 0:
                j -= 1
            bits[i] -= 2
            bits[i - 1] += 1
            bits[j + 1] += 2
            bits[j] -= 1
    i = 16
    while bits[i] == 0:
        i -= 1
    bits[i] -= 1
    values = [j for size in range(1, 33) for j in range(256)
              if codesize[j] == size]
    return bits[1:17], values


def codes_of(bits, values) -> dict:
    out, code, k = {}, 0, 0
    for length in range(1, 17):
        for _ in range(bits[length - 1]):
            out[values[k]] = (code, length)
            code += 1
            k += 1
        code <<= 1
    return out


def segment(marker: int, body: bytes) -> bytes:
    return bytes([0xFF, marker]) + (len(body) + 2).to_bytes(2, "big") + body


def dht(tables) -> bytes:
    """tables: [(class 0 DC / 1 AC, slot, bits, values)]."""
    body = b""
    for cls, slot, bits, values in tables:
        body += bytes([cls << 4 | slot]) + bytes(bits) + bytes(values)
    return segment(0xC4, body)


# -- Huffman symbol streams ------------------------------------------------
# A scan's coded content is a list of events: ("h", table key, symbol),
# ("b", value, count) for raw bits; tables are built from the counts.

def seq_block_events(ev, blk, last_dc, dc_key, ac_key):
    diff = int(blk[0]) - last_dc
    s = size_of(diff)
    ev.append(("h", dc_key, s))
    ev.append(("b", bits_of(diff, s), s))
    zz = blk[ZIGZAG]
    run = 0
    last_nz = max([k for k in range(1, 64) if zz[k]], default=0)
    for k in range(1, last_nz + 1):
        v = int(zz[k])
        if v == 0:
            run += 1
            continue
        while run > 15:
            ev.append(("h", ac_key, 0xF0))
            run -= 16
        s = size_of(v)
        ev.append(("h", ac_key, (run << 4) | s))
        ev.append(("b", bits_of(v, s), s))
        run = 0
    if last_nz < 63:
        ev.append(("h", ac_key, 0x00))
    return int(blk[0])


def emit_huffman(events, keys) -> tuple[bytes, dict]:
    """Codes the events with optimal tables; {key: (bits, values)}."""
    freq = {k: {} for k in keys}
    for e in events:
        if e[0] == "h":
            freq[e[1]][e[2]] = freq[e[1]].get(e[2], 0) + 1
    tables = {k: optimal_table(f or {0: 1}) for k, f in freq.items()}
    codes = {k: codes_of(*t) for k, t in tables.items()}
    w = BitWriter()
    for e in events:
        if e[0] == "h":
            code, n = codes[e[1]][e[2]]
            w.put(code, n)
        elif e[0] == "b":
            w.put(e[1], e[2])
        else:  # ("r", n): a restart marker after flushing
            data = w.flush()
            w = BitWriter()
            w.out = bytearray(data) + bytes([0xFF, 0xD0 + e[1]])
    return w.flush(), tables


# -- arithmetic coder (T.81 Annex D, libjpeg's jcarith.c) -------------------

class ArithEncoder:
    def __init__(self):
        self.out = bytearray()
        self.c = 0
        self.a = 0x10000
        self.ct = 11
        self.sc = 0
        self.zc = 0
        self.buffer = -1

    def _emit(self, b):
        self.out.append(b)

    def _zeros(self):
        while self.zc:
            self._emit(0)
            self.zc -= 1

    def encode(self, st: list, i: int, val: int) -> None:
        sv = st[i]
        qe, nmps, nlps, switch = QE[sv & 0x7F]
        self.a -= qe
        if val != (sv >> 7):
            if self.a >= qe:
                self.c += self.a
                self.a = qe
            st[i] = (sv & 0x80) ^ (nlps | (switch << 7))
        else:
            if self.a >= 0x8000:
                return
            if self.a < qe:
                self.c += self.a
                self.a = qe
            st[i] = (sv & 0x80) ^ nmps
        while True:
            self.a <<= 1
            self.c <<= 1
            self.ct -= 1
            if self.ct == 0:
                temp = self.c >> 19
                if temp > 0xFF:
                    if self.buffer >= 0:
                        self._zeros()
                        self._emit(self.buffer + 1)
                        if self.buffer + 1 == 0xFF:
                            self._emit(0)
                    self.zc += self.sc
                    self.sc = 0
                    self.buffer = temp & 0xFF
                elif temp == 0xFF:
                    self.sc += 1
                else:
                    if self.buffer == 0:
                        self.zc += 1
                    elif self.buffer >= 0:
                        self._zeros()
                        self._emit(self.buffer)
                    if self.sc:
                        self._zeros()
                        while self.sc:
                            self._emit(0xFF)
                            self._emit(0)
                            self.sc -= 1
                    self.buffer = temp & 0xFF
                self.c &= 0x7FFFF
                self.ct += 8
            if self.a >= 0x8000:
                break

    def finish(self) -> bytes:
        temp = (self.a - 1 + self.c) & 0xFFFF0000
        self.c = temp + 0x8000 if temp < self.c else temp
        self.c <<= self.ct
        if self.c & 0xF8000000:
            if self.buffer >= 0:
                self._zeros()
                self._emit(self.buffer + 1)
                if self.buffer + 1 == 0xFF:
                    self._emit(0)
            self.zc += self.sc
            self.sc = 0
        else:
            if self.buffer == 0:
                self.zc += 1
            elif self.buffer >= 0:
                self._zeros()
                self._emit(self.buffer)
            if self.sc:
                self._zeros()
                while self.sc:
                    self._emit(0xFF)
                    self._emit(0)
                    self.sc -= 1
        if self.c & 0x7FFF800:
            self._zeros()
            b = (self.c >> 19) & 0xFF
            self._emit(b)
            if b == 0xFF:
                self._emit(0)
            if self.c & 0x7F800:
                b = (self.c >> 11) & 0xFF
                self._emit(b)
                if b == 0xFF:
                    self._emit(0)
        return bytes(self.out)


class ArithScan:
    """One scan's statistics and coder (jcarith.c's encode_mcu*)."""

    def __init__(self, ncomp, dac):
        self.dc = [[0] * 64 for _ in range(4)]
        self.ac = [[0] * 256 for _ in range(4)]
        self.fixed = [113]
        self.enc = ArithEncoder()
        self.last_dc = [0] * ncomp
        self.ctx = [0] * ncomp
        self.dac = dac  # {"L": [...], "U": [...], "K": [...]} per table

    def dc_diff(self, ci, tbl, v):
        st = self.dc[tbl]
        e = self.enc
        s0 = self.ctx[ci]
        if v == 0:
            e.encode(st, s0, 0)
            self.ctx[ci] = 0
            return
        e.encode(st, s0, 1)
        if v > 0:
            e.encode(st, s0 + 1, 0)
            i = s0 + 2
            self.ctx[ci] = 4
        else:
            v = -v
            e.encode(st, s0 + 1, 1)
            i = s0 + 3
            self.ctx[ci] = 8
        m = 0
        v -= 1
        if v:
            e.encode(st, i, 1)
            m = 1
            v2 = v
            i = 20
            while v2 >> 1:
                v2 >>= 1
                e.encode(st, i, 1)
                m <<= 1
                i += 1
        e.encode(st, i, 0)
        lo, hi = self.dac["L"][tbl], self.dac["U"][tbl]
        if m < (1 << lo) >> 1:
            self.ctx[ci] = 0
        elif m > (1 << hi) >> 1:
            self.ctx[ci] += 8
        i += 14
        while m >> 1:
            m >>= 1
            e.encode(st, i, 1 if m & v else 0)

    def ac_value(self, tbl, i, k, v):
        """The magnitude of a nonzero AC value at statistics bin i (S0 +
        3(k-1)) after its sign."""
        st = self.ac[tbl]
        e = self.enc
        i += 2
        m = 0
        v -= 1
        if v:
            e.encode(st, i, 1)
            m = 1
            v2 = v >> 1
            if v2:
                e.encode(st, i, 1)
                m <<= 1
                i = 189 if k <= self.dac["K"][tbl] else 217
                while v2 >> 1:
                    v2 >>= 1
                    e.encode(st, i, 1)
                    m <<= 1
                    i += 1
        e.encode(st, i, 0)
        i += 14
        while m >> 1:
            m >>= 1
            e.encode(st, i, 1 if m & v else 0)

    def ac_band(self, tbl, zz, ss, se):
        """Sequential or AC-first coding of zz[ss..se] (already shifted)."""
        st = self.ac[tbl]
        e = self.enc
        ke = max([k for k in range(ss, se + 1) if zz[k]], default=ss - 1)
        k = ss
        while k <= ke:
            i = 3 * (k - 1)
            e.encode(st, i, 0)
            while zz[k] == 0:
                e.encode(st, i + 1, 0)
                i += 3
                k += 1
            e.encode(st, i + 1, 1)
            v = int(zz[k])
            if v > 0:
                e.encode(self.fixed, 0, 0)
            else:
                v = -v
                e.encode(self.fixed, 0, 1)
            self.ac_value(tbl, i, k, v)
            k += 1
        if k <= se:
            e.encode(st, 3 * (k - 1), 1)

    def ac_refine(self, tbl, zz, ss, se, al):
        """jcarith.c encode_mcu_AC_refine over zz (natural coefficients in
        zigzag order, unshifted)."""
        st = self.ac[tbl]
        e = self.enc
        absv = [abs(int(x)) >> al for x in zz]
        ke = max([k for k in range(ss, se + 1) if absv[k]], default=ss - 1)
        kex = max([k for k in range(ss, se + 1) if absv[k] >> 1],
                  default=ss - 1)
        k = ss
        while k <= ke:
            i = 3 * (k - 1)
            if k > kex:
                e.encode(st, i, 0)
            while True:
                v = absv[k]
                if v:
                    if v >> 1:
                        e.encode(st, i + 2, v & 1)
                    else:
                        e.encode(st, i + 1, 1)
                        e.encode(self.fixed, 0, 1 if zz[k] < 0 else 0)
                    break
                e.encode(st, i + 1, 0)
                i += 3
                k += 1
            k += 1
        if k <= se:
            e.encode(st, 3 * (k - 1), 1)


def _pt(x: int, al: int) -> int:
    """The AC point transform: |x| >> al with x's sign."""
    return (abs(x) >> al) * (1 if x >= 0 else -1)


def encode_jpeg(pixels: np.ndarray, sampling, *, coding: str = "huffman",
                progressive: bool = False, quality: int = 75,
                restart: int = 0, dac: dict | None = None,
                predictor: int = 0, rgb: bool = False) -> bytes:
    """A JPEG of pixels ((H, W) gray or (H, W, 3) RGB, stored as JFIF
    YCbCr) with per-component (h, v) sampling factors, written with
    libjpeg's conventions: Huffman (optimal tables) or arithmetic coding
    (``dac``: {"L", "U", "K"} conditioning per table slot, written as a
    DAC segment), sequential or progressive (DC successive approximation;
    AC spectral selection, and for arithmetic coding AC successive
    approximation too), restart markers every ``restart`` MCUs, or
    lossless (SOF3, Huffman, ``predictor`` 1-7). ``rgb`` stores the RGB
    samples as they are, with an Adobe segment of transform 0 in place of
    JFIF."""
    gray = pixels.ndim == 2
    px = pixels[..., None] if gray else pixels
    h_img, w_img = px.shape[:2]
    ncomp = px.shape[2]
    lossless = predictor > 0
    comps, mcus_x, mcus_y = planes(px, sampling, not gray and not rgb)
    max_h = max(h for h, _ in sampling)
    max_v = max(v for _, v in sampling)
    slot = [0] + [1] * (ncomp - 1)
    tables = [quant_table(LUMA_Q, quality), quant_table(CHROMA_Q, quality)]
    if lossless:
        data = [lossless_samples(p) for p in comps]
    else:
        data = [coefficients(p, tables[slot[c]]) for c, p in enumerate(comps)]
    dims = [(-(-(-(-h_img * v // max_v)) // 8), -(-(-(-w_img * h // max_h)) // 8))
            for h, v in sampling]  # (height, width) in blocks
    arith = coding == "arith"
    write_dac = dac is not None
    dac = dac or {"L": [0] * 16, "U": [1] * 16, "K": [5] * 16}

    out = bytearray(b"\xff\xd8")
    if rgb:
        out += segment(0xEE, b"Adobe\x00\x64\x00\x00\x00\x00\x00")
    else:
        out += segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    if not lossless:
        body = b""
        for t, q in enumerate(tables[:1 if gray else 2]):
            body += bytes([t]) + bytes(int(q[i]) for i in ZIGZAG)
        out += segment(0xDB, body)
    sof = (0xC3 if lossless else (0xC8 if arith else 0xC0)
           + (2 if progressive else 1 if arith else 0))
    body = bytes([8]) + h_img.to_bytes(2, "big") + w_img.to_bytes(2, "big")
    body += bytes([ncomp])
    for c, (h, v) in enumerate(sampling):
        body += bytes([c + 1, h << 4 | v, 0 if lossless else slot[c]])
    out += segment(sof, body)
    if arith and write_dac:
        body = b""
        for t in range(2):
            body += bytes([t, dac["U"][t] << 4 | dac["L"][t]])
            body += bytes([16 + t, dac["K"][t]])
        out += segment(0xCC, body)
    if restart:
        out += segment(0xDD, restart.to_bytes(2, "big"))

    def units(cs):
        """(component, block row, block col, MCU index) in scan order."""
        if len(cs) > 1 or lossless:
            i = 0
            for my in range(mcus_y if not lossless else h_img):
                for mx in range(mcus_x if not lossless else w_img):
                    for c in cs:
                        h, v = sampling[c]
                        for y in range(v):
                            for x in range(h):
                                yield c, my * v + y, mx * h + x, i
                    i += 1
        else:
            (c,) = cs
            hb, wb = dims[c]
            for i, (by, bx) in enumerate(
                    (by, bx) for by in range(hb) for bx in range(wb)):
                yield c, by, bx, i

    def sos(cs, ss, se, ah, al):
        body = bytes([len(cs)])
        for c in cs:
            body += bytes([c + 1, slot[c] << 4 | slot[c]])
        return segment(0xDA, body + bytes([ss, se, ah << 4 | al]))

    def huffman_scan(cs, ss, se, ah, al):
        ev = []
        last = [0] * ncomp
        eobrun = [0]
        rst = [0]

        def flush_eob(c):
            if eobrun[0]:
                n = eobrun[0].bit_length() - 1
                ev.append(("h", ("ac", slot[c]), n << 4))
                ev.append(("b", eobrun[0], n))
                eobrun[0] = 0

        prev_i = 0
        for c, by, bx, i in units(cs):
            if restart and i != prev_i and i % restart == 0:
                flush_eob(cs[0])
                ev.append(("r", rst[0]))
                rst[0] = (rst[0] + 1) & 7
                last = [0] * ncomp
            prev_i = i
            if lossless:
                ev_lossless(ev, c, by, bx, i)
                continue
            blk = data[c][by, bx]
            if not progressive:
                last[c] = seq_block_events(ev, blk, last[c], ("dc", slot[c]),
                                           ("ac", slot[c]))
            elif ss == 0 and ah == 0:
                v = int(blk[0]) >> al
                d = v - last[c]
                last[c] = v
                s = size_of(d)
                ev.append(("h", ("dc", slot[c]), s))
                ev.append(("b", bits_of(d, s), s))
            elif ss == 0:
                ev.append(("b", (int(blk[0]) >> al) & 1, 1))
            else:
                zz = [_pt(int(x), al) for x in blk[ZIGZAG]]
                r = 0
                for k in range(ss, se + 1):
                    if zz[k] == 0:
                        r += 1
                        continue
                    flush_eob(c)
                    while r > 15:
                        ev.append(("h", ("ac", slot[c]), 0xF0))
                        r -= 16
                    s = size_of(zz[k])
                    ev.append(("h", ("ac", slot[c]), r << 4 | s))
                    ev.append(("b", bits_of(zz[k], s), s))
                    r = 0
                if r:
                    eobrun[0] += 1
                    if eobrun[0] == 0x7FFF:
                        flush_eob(c)
        if progressive and ss:
            flush_eob(cs[0])
        keys = sorted({e[1] for e in ev if e[0] == "h"})
        coded, tabs = emit_huffman(ev, keys)
        seg = dht([(0 if k[0] == "dc" else 1, k[1], *tabs[k]) for k in keys])
        return seg + sos(cs, ss, se, ah, al) + coded

    pred_rows = {}

    def ev_lossless(ev, c, y, x, i):
        s = data[c]
        if restart and i % restart == 0:
            pred_rows[c] = y  # the first row of a restart interval
        first = pred_rows.get(c, 0) == y
        if y == 0 or first:
            p = 128 if x == 0 else s[y, x - 1]
        elif x == 0:
            p = s[y - 1, x]
        else:
            ra, rb, rc = int(s[y, x - 1]), int(s[y - 1, x]), int(s[y - 1, x - 1])
            p = [0, ra, rb, rc, ra + rb - rc, ra + ((rb - rc) >> 1),
                 rb + ((ra - rc) >> 1), (ra + rb) >> 1][predictor]
        d = (int(s[y, x]) - int(p)) & 0xFFFF
        if d >= 0x8000:
            d -= 0x10000
        n = size_of(d) if d != -0x8000 else 16
        ev.append(("h", ("dc", slot[c]), n))
        if n < 16:
            ev.append(("b", bits_of(d, n), n))

    def arith_scan(cs, ss, se, ah, al):
        sc = ArithScan(ncomp, dac)
        chunks = []
        rst = 0
        prev_i = 0
        for c, by, bx, i in units(cs):
            if restart and i != prev_i and i % restart == 0:
                chunks.append(sc.enc.finish() + bytes([0xFF, 0xD0 + rst]))
                rst = (rst + 1) & 7
                fresh = ArithScan(ncomp, dac)
                if progressive and not (ss == 0 and ah == 0):
                    fresh.dc = sc.dc
                if progressive and not ss:
                    fresh.ac = sc.ac
                sc = fresh
            prev_i = i
            blk = data[c][by, bx]
            zz = [int(x) for x in blk[ZIGZAG]]
            if not progressive:
                sc.dc_diff(c, slot[c], zz[0] - sc.last_dc[c])
                sc.last_dc[c] = zz[0]
                sc.ac_band(slot[c], zz, 1, 63)
            elif ss == 0 and ah == 0:
                v = zz[0] >> al
                sc.dc_diff(c, slot[c], v - sc.last_dc[c])
                sc.last_dc[c] = v
            elif ss == 0:
                sc.enc.encode(sc.fixed, 0, (zz[0] >> al) & 1)
            elif ah == 0:
                sc.ac_band(slot[c], [_pt(x, al) for x in zz], ss, se)
            else:
                sc.ac_refine(slot[c], zz, ss, se, al)
        chunks.append(sc.enc.finish())
        return sos(cs, ss, se, ah, al) + b"".join(chunks)

    scan = arith_scan if arith else huffman_scan
    every = list(range(ncomp))
    if lossless:
        out += scan(every, predictor, 0, 0, 0)
    elif not progressive:
        out += scan(every, 0, 63, 0, 0)
    else:
        out += scan(every, 0, 0, 0, 1)
        al = 1 if arith else 0
        for c in every:
            bands = [(1, 5), (6, 63)] if c == 0 else [(1, 63)]
            for ss, se in bands:
                out += scan([c], ss, se, 0, al)
        out += scan(every, 0, 0, 1, 0)
        if arith:
            for c in every:
                out += scan([c], 1, 63, 1, 0)
    return bytes(out + b"\xff\xd9")


def main() -> int:
    sys.path.insert(0, str(HERE.parent.parent))
    manifest = {}
    for i, name in enumerate({**FIXTURES, **OWN_FIXTURES}):
        data = encode(name, SEED * 1000 + i)
        (HERE / name).write_bytes(data)
        manifest[name] = entry(name, data)
        print(f"{name}: {len(data)} bytes, draft 1/"
              f"{manifest[name]['draft_scale']}")
    with open(HERE / "manifest.json", "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")
    total = sum(e["bytes"] for e in manifest.values())
    print(f"{len(manifest)} files, {total} bytes")
    return 0


if __name__ == "__main__":
    sys.exit(main())
