"""Datasets: MSCOCO captions, RedCaps span corruption, synthetic.

The reference's datasets:
  * COCO: ``captions_{phase}2017.json``, the **first caption only** per
    image, and the fixed prompt ``'What does th image describe ?'`` (typo
    kept);
  * RedCaps: indexes ``annotations/*.json`` eagerly and span-corrupts each
    sample anew per epoch; ``phase`` does not split the data (train and val
    iterate the same examples, as in the reference);
  * images: decode -> RGB, then the port's C++ bicubic resize
    (``native.resize_batch``) to (size, size) on the host; normalization
    runs on the device (``image_ops.normalize_images``). The decode is
    chosen by content: JPEG bytes (``FF D8 FF``) always go to the port's C++
    decoder (``native.decode_jpeg``: baseline, extended and progressive,
    Huffman or arithmetic coding, 8-bit, gray / YCbCr / RGB / CMYK / YCCK,
    any sampling factors libjpeg upsamples (4:4:4, 4:2:2, 4:2:0, 4:4:0,
    4:1:1, ...), lossless at full size), which gives Pillow's pixels bit
    for bit at Pillow's draft scale, and refuses what Pillow refuses (its
    header parser's refusals, a file that ends where libjpeg asks for
    more), with no Pillow; any other format (PNG, ...) goes to Pillow, imported
    there, and raises ``ValueError`` naming the format where Pillow is not
    installed. A JPEG never reaches Pillow, and a failed native decode is
    not retried elsewhere.

Items are ``(image_uint8 (H,W,3), src_text, tgt_text)``; tokenization and
batching live in ``pipeline.py``. The synthetic dataset needs no file and
no Pillow.
"""

from __future__ import annotations

import json
import os

import numpy as np

from ..text.span_corruption import span_corrupt
from .coco import CocoIndex

COCO_PROMPT = "What does th image describe ?"  # sic: the reference's prompt


def load_image_resized(path: str, size: int = 256) -> np.ndarray:
    """Decode -> RGB -> bicubic resize -> (size, size, 3) uint8. A JPEG
    decodes straight to Pillow's draft scale near the target (never below
    it); the port's C++ runtime does the resize, as the JAX package's
    does."""
    with open(path, "rb") as f:
        return _decode_resized(f.read(), size)


def load_image_bytes_resized(data: bytes, size: int = 256) -> np.ndarray:
    """``load_image_resized`` over in-memory encoded bytes. Malformed,
    truncated or unsupported bytes raise ``ValueError`` (a JPEG) or
    Pillow's ``OSError`` (another format)."""
    return _decode_resized(bytes(data), size)


def _decode_resized(data: bytes, size: int) -> np.ndarray:
    from ..native import BICUBIC, resize_batch

    return resize_batch([decode_image(data, size)], size, filter=BICUBIC,
                        n_threads=1)[0]


# Signatures of the formats named in the error where Pillow is missing.
_SIGNATURES = ((b"\x89PNG\r\n\x1a\n", "PNG"), (b"GIF8", "GIF"),
               (b"BM", "BMP"), (b"II*\x00", "TIFF"), (b"MM\x00*", "TIFF"))


def _format_name(data: bytes) -> str:
    if data[:4] == b"RIFF" and data[8:12] == b"WEBP":
        return "WebP"
    return next((name for sig, name in _SIGNATURES
                 if data.startswith(sig)), "non-JPEG")


def decode_image(data: bytes, size: int) -> np.ndarray:
    """Encoded bytes -> (H, W, 3) uint8 RGB at the draft scale that Pillow's
    ``draft("RGB", (size, size))`` picks for a JPEG (full size for other
    formats): what ``Image.open(...).convert("RGB")`` gives. JPEG bytes take
    the native decoder; other formats need Pillow."""
    from ..native import JPEG_SIGNATURE, decode_jpeg, draft_scale, jpeg_size

    if not data:
        raise ValueError("empty image data")
    if data.startswith(JPEG_SIGNATURE):
        width, height = jpeg_size(data)
        return decode_jpeg(data, draft_scale(width, height, size))
    try:
        from PIL import Image
    except ImportError:
        raise ValueError(
            f"cannot decode a {_format_name(data)} image: Pillow is not "
            "installed, and without it the port decodes JPEG alone") from None
    import io

    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im.convert("RGB"), dtype=np.uint8)


class DatasetBase:
    """Indexable dataset of (image, src_text, tgt_text)."""

    image_size: int = 256
    # True when a sample's source text never changes across epochs (caption
    # prompts): the frozen-feature cache may then cache the text tower's
    # output too. Span corruption re-masks per epoch and sets it False.
    source_is_static: bool = True
    # Set by the train loop for epochs whose every image feature is cached:
    # the cached step never reads the pixels, so the decode is skipped.
    skip_image_load: bool = False

    def _image_or_stub(self, path: str) -> np.ndarray:
        if self.skip_image_load:
            return np.zeros((self.image_size, self.image_size, 3), np.uint8)
        return load_image_resized(path, self.image_size)

    def __len__(self) -> int:
        raise NotImplementedError

    def __getitem__(self, idx: int) -> tuple[np.ndarray, str, str]:
        raise NotImplementedError

    def set_epoch(self, epoch: int) -> None:
        """Per-epoch reseed hook."""


class CocoCaptionDataset(DatasetBase):
    def __init__(self, data_dir: str, phase: str = "train",
                 image_size: int = 256):
        anno_path = os.path.join(data_dir, "annotations",
                                 f"captions_{phase}2017.json")
        coco = CocoIndex(anno_path)
        img_dir = os.path.join(data_dir, f"{phase}2017")
        self.image_size = image_size
        self.images: list[str] = []
        self.captions: list[str] = []
        for image_id in coco.getImgIds():
            info = coco.loadImgs(image_id)[0]
            anns = coco.loadAnns(coco.getAnnIds(image_id))
            if not anns:
                continue
            self.images.append(os.path.join(img_dir, info["file_name"]))
            self.captions.append(anns[0]["caption"])  # first caption only

    def __len__(self) -> int:
        return len(self.images)

    def __getitem__(self, idx: int):
        img = self._image_or_stub(self.images[idx])
        return img, COCO_PROMPT, self.captions[idx]


class RedCapsDataset(DatasetBase):
    """Self-supervised span-corruption pretraining on RedCaps."""

    source_is_static = False  # re-masked per epoch

    def __init__(self, data_dir: str, phase: str = "train",
                 image_size: int = 256, seed: int = 0):
        anno_dir = os.path.join(data_dir, "annotations")
        img_dir = os.path.join(data_dir, "images")
        self.image_size = image_size
        self.seed = seed
        self.epoch = 0
        self.images: list[str] = []
        self.raw_captions: list[str] = []
        for name in sorted(os.listdir(anno_dir)):
            with open(os.path.join(anno_dir, name)) as f:
                annotations = json.load(f)
            for ann in annotations["annotations"]:
                self.images.append(os.path.join(
                    img_dir, ann["subreddit"], f"{ann['image_id']}.jpg"))
                self.raw_captions.append(ann["raw_caption"])

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        return len(self.images)

    def __getitem__(self, idx: int):
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + self.epoch) * 2_654_435_761 + idx)
        src, tgt = span_corrupt(self.raw_captions[idx], rng)
        img = self._image_or_stub(self.images[idx])
        return img, src, tgt


class SyntheticCaptionDataset(DatasetBase):
    """Deterministic in-memory dataset (no file, no decode): seeded uint8
    images and four captions in turn, under the COCO prompt, or
    span-corrupted anew per epoch with ``pretrain``."""

    _CAPTIONS = [
        "A man with a red helmet on a small moped on a dirt road.",
        "A dog jumps over a wooden fence in a park.",
        "Two cats sit on a sunny window sill.",
        "A plate of food with rice and vegetables on a table.",
    ]
    # 'skew': an extreme spread of lengths, so bucket_lengths puts rows in
    # different power-of-two buckets.
    _CAPTIONS_SKEW = [
        "A dog.",
        "A man with a red helmet on a small moped rides down a long and "
        "winding dirt road past tall green trees near a mountain village.",
        "Two cats.",
        "A large plate of steaming food with fried rice, grilled seasonal "
        "vegetables and a tall glass of fresh orange juice on a table.",
    ]

    def __init__(self, n: int = 64, image_size: int = 256, seed: int = 0,
                 pretrain: bool = False, skew: bool = False):
        self.n = n
        self.image_size = image_size
        self.seed = seed
        self.pretrain = pretrain
        self.skew = skew
        self.source_is_static = not pretrain
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, idx: int):
        rng = np.random.default_rng(self.seed + idx)
        img = rng.integers(0, 256, size=(self.image_size, self.image_size, 3),
                           dtype=np.uint8)
        captions = self._CAPTIONS_SKEW if self.skew else self._CAPTIONS
        caption = captions[idx % len(captions)]
        if self.pretrain:
            crng = np.random.default_rng(self.seed + self.epoch * 131 + idx)
            src, tgt = span_corrupt(caption, crng)
            return img, src, tgt
        return img, COCO_PROMPT, caption


def build_dataset(data_dir: str, phase: str, image_size: int = 256,
                  seed: int = 0) -> DatasetBase:
    """Dataset by substring of ``data_dir`` (the reference's rule), with a
    'synthetic' option ('synthetic-pretrain', 'synthetic-skew')."""
    low = data_dir.lower()
    if "mscoco" in low:
        return CocoCaptionDataset(data_dir, phase, image_size)
    if "redcaps" in low:
        return RedCapsDataset(data_dir, phase, image_size, seed)
    if "synthetic" in low:
        return SyntheticCaptionDataset(image_size=image_size, seed=seed,
                                       pretrain="pretrain" in low,
                                       skew="skew" in low)
    raise NotImplementedError(f"no dataset for data_dir={data_dir!r}")
