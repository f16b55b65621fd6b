#!/usr/bin/env python3
"""Differential fuzz of the port's JPEG decoder (``native.decode_jpeg``)
against Pillow: seeded JPEGs that Pillow writes (baseline, progressive,
restart markers, gray, CMYK, 4:4:4 and 4:2:2) and that the fixtures' own
encoder writes (``tests/torch_jpeg/make_fixtures.py``: 4:4:0, 4:1:1,
progressive 4:4:0, arithmetic coding sequential with restarts and a DAC
segment and progressive, lossless) have one or two bytes changed, each file
is decoded by both at a draft scale, and the outcomes are counted: both
decode (and then the pixels must be equal), only one of them raises, both
raise. The decoder's reasons for the files it refuses and Pillow decodes
are listed. At a draft scale Pillow 12 raises on a lossless frame or writes
past its buffer (the process may abort), so such a file is not handed to
Pillow there and counts as refused; the port refuses it.

    python3 tools/jpeg_fuzz.py [--seed S] [--files N] [--where header|any]
        [--scales 1,2,4,8] [--library PATH]

``--where header`` changes bytes of the marker segments (tables, frame and
scan headers), ``any`` bytes anywhere (mostly entropy-coded data).
``--library`` loads another build of the port's host runtime, such as one
built with ``-fsanitize=address,undefined`` (run it with the sanitizers'
runtimes in ``LD_PRELOAD``). Exits 1 when the pixels of a file that both
decode differ. Needs Pillow and numpy; no JAX, no card.
"""

import argparse
import collections
import io
import os
import sys
import warnings

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (Pillow mode, save options) of the seed files.
SEEDS = [("RGB", {}), ("RGB", {"progressive": True}),
         ("RGB", {"progressive": True, "restart_marker_blocks": 2}),
         ("RGB", {"progressive": True, "subsampling": 0}), ("L", {}),
         ("CMYK", {"progressive": True}), ("RGB", {"subsampling": 1}),
         ("L", {"progressive": True}), ("RGB", {"restart_marker_rows": 1})]


# (mode, encode_jpeg's options) of the seed files of the fixtures' encoder.
S420 = [(2, 2), (1, 1), (1, 1)]
OWN_SEEDS = [
    ("RGB", {"sampling": [(1, 2), (1, 1), (1, 1)]}),
    ("RGB", {"sampling": [(4, 1), (1, 1), (1, 1)]}),
    ("RGB", {"sampling": [(1, 2), (1, 1), (1, 1)], "progressive": True}),
    ("RGB", {"sampling": S420, "coding": "arith", "restart": 2,
             "dac": {"L": [1, 0], "U": [4, 2], "K": [6, 3]}}),
    ("RGB", {"sampling": S420, "coding": "arith", "progressive": True}),
    ("L", {"sampling": [(1, 1)], "coding": "arith", "progressive": True}),
    ("L", {"sampling": [(1, 1)], "predictor": 4}),
    ("L", {"sampling": [(1, 1)], "predictor": 7, "restart": 80}),
    ("RGB", {"sampling": [(1, 1)] * 3, "predictor": 1, "rgb": True})]


def seed_files(rng: np.random.Generator) -> list[bytes]:
    from PIL import Image

    sys.path.insert(0, os.path.join(REPO, "tests", "torch_jpeg"))
    from make_fixtures import encode_jpeg

    out = []
    y, x = np.mgrid[0:24, 0:40]
    for mode, options in SEEDS + OWN_SEEDS:
        channels = {"RGB": 3, "L": 1, "CMYK": 4}[mode]
        f = rng.uniform(0.05, 0.3, (channels, 2))
        a = np.stack([127 + 110 * np.sin(x * f[c, 0]) * np.cos(y * f[c, 1])
                      for c in range(channels)], -1).astype(np.uint8)
        pixels = a[..., 0] if mode == "L" else a
        if (mode, options) in OWN_SEEDS:
            kw = dict(options)
            out.append(encode_jpeg(pixels, kw.pop("sampling"), quality=85,
                                   **kw))
            continue
        buf = io.BytesIO()
        Image.fromarray(pixels, mode).save(buf, "JPEG", quality=85, **options)
        out.append(buf.getvalue())
    return out


def lossless(data: bytes) -> bool:
    """Whether the file's first frame marker is SOF3."""
    for p in range(2, len(data) - 1):
        if data[p] == 0xFF and 0xC0 <= data[p + 1] <= 0xCF and (
                data[p + 1] not in (0xC4, 0xC8, 0xCC)):
            return data[p + 1] == 0xC3
    return False


def header_bytes(data: bytes) -> list[int]:
    """Offsets of the bytes of every marker segment, scans' headers
    included, up to EOI."""
    out, p = [], 2
    while p + 4 <= len(data) and data[p] == 0xFF and data[p + 1] != 0xD9:
        code = data[p + 1]
        n = int.from_bytes(data[p + 2:p + 4], "big")
        out += range(p, min(p + 2 + n, len(data)))
        p += 2 + n
        if code == 0xDA:  # skip the entropy-coded data
            while p + 1 < len(data) and not (
                    data[p] == 0xFF and data[p + 1] not in (0, 0xFF)
                    and not 0xD0 <= data[p + 1] <= 0xD7):
                p += 1
    return out


def pillow_decode(data: bytes, scale: int):
    """Pillow's RGB pixels at the draft for 1/scale (or full size where the
    image is smaller than the scale), and that scale; None where it
    raises."""
    from PIL import Image

    if scale > 1 and lossless(data):
        return None, scale  # Pillow raises or overruns its buffer
    try:
        with Image.open(io.BytesIO(data)) as im:
            w, h = im.size
            if min(w, h) < scale:
                scale = 1
            if scale > 1:
                im.draft("RGB", (min(w, h) // scale,) * 2)
                scale = im.decoderconfig[0]
            return np.asarray(im.convert("RGB")), scale
    except Exception:  # noqa: BLE001 — any failure of Pillow is counted
        return None, scale


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--files", type=int, default=10_000)
    p.add_argument("--where", choices=("header", "any"), default="header")
    p.add_argument("--scales", default="1,2,4,8")
    p.add_argument("--library", default=None)
    args = p.parse_args()
    sys.path.insert(0, REPO)
    from klab_multimodalmodel_tpu_torch import native

    if args.library:
        native.build_library = lambda *a: args.library
    warnings.simplefilter("ignore")  # Pillow's decompression-bomb warnings
    rng = np.random.default_rng(args.seed)
    seeds = seed_files(rng)
    spots = [header_bytes(s) if args.where == "header" else range(len(s))
             for s in seeds]
    scales = [int(s) for s in args.scales.split(",")]
    counts = collections.Counter()
    refused = collections.Counter()
    for _ in range(args.files):
        k = int(rng.integers(len(seeds)))
        data = bytearray(seeds[k])
        for _ in range(int(rng.integers(1, 3))):
            i = spots[k][int(rng.integers(len(spots[k])))]
            data[i] = (int(rng.integers(256)) if rng.random() < 0.5
                       else data[i] ^ (1 << int(rng.integers(8))))
        data = bytes(data)
        want, scale = pillow_decode(data, int(rng.choice(scales)))
        try:
            got = native.decode_jpeg(data, scale)
        except ValueError as e:
            got = None
            if want is not None:
                refused[str(e)[:70]] += 1
        if got is None or want is None:
            counts[("pillow" if want is not None else "neither")
                   if got is None else "port only"] += 1
        elif got.shape == want.shape and np.array_equal(got, want):
            counts["equal"] += 1
        else:
            counts["differ"] += 1
    print(f"{args.files} files ({args.where} bytes, seed {args.seed}): both "
          f"decode {counts['equal'] + counts['differ']} (pixels differ in "
          f"{counts['differ']}); only Pillow decodes {counts['pillow']}; "
          f"only the port {counts['port only']}; neither {counts['neither']}")
    for reason, n in refused.most_common(12):
        print(f"  {n} refused by the port: {reason}")
    return 1 if counts["differ"] else 0


if __name__ == "__main__":
    sys.exit(main())
