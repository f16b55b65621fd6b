"""Writes the JPEG fixtures of this directory and their ``manifest.json``.

    JAX_PLATFORMS=cpu python tests/torch_jpeg/make_fixtures.py

Each fixture is a smooth seeded scene (gratings, blobs and a gradient per
channel, so the files stay small) saved by Pillow at a size and with options
that the port's JPEG decoder must cover: COCO sizes, one image for each of
Pillow's draft scales at 256 px, grayscale, CMYK, progressive, restart
markers, 4:4:4 and 4:2:2. The manifest gives, for each file, its kind, the
draft scale at 256 px, and the SHA-256 of Pillow's RGB decode at that scale
(``decode``) and of the JAX package's ``load_image_bytes_resized(data, 256)``
(``resized_256``). ``tests/test_torch_jpeg.py`` holds the manifest against
what Pillow, the JAX package and the port's native decoder give now;
``chip_smoke.py`` holds the port's decode on the card's machine against it.
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

    kind, (width, height), mode, options = FIXTURES[name]
    channels = {"RGB": 3, "L": 1, "CMYK": 4}[mode]
    pixels = scene(np.random.default_rng(seed), width, height, channels)
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
    kind, (width, height), mode, options = FIXTURES[name]
    decoded, scale = pillow_decode(data)
    resized = load_image_bytes_resized(data, SIZE)
    return {"kind": kind, "size": [width, height], "mode": mode,
            "options": options, "bytes": len(data), "draft_scale": scale,
            "decode_shape": list(decoded.shape), "decode": digest(decoded),
            "resized_256": digest(resized)}


def main() -> int:
    sys.path.insert(0, str(HERE.parent.parent))
    manifest = {}
    for i, name in enumerate(FIXTURES):
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
