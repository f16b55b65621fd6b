"""COCO caption annotation index: plain JSON, no pycocotools.

The reference uses only the JSON-indexing half of ``pycocotools.coco.COCO``.
This is the same index as a small class: ``imgs`` / ``anns`` /
``imgToAnns`` keyed as pycocotools keys them, in file order (which decides
the reference's "first caption per image").
"""

from __future__ import annotations

import json
from collections import defaultdict
from typing import Any


class CocoIndex:
    def __init__(self, annotation_file: str | None = None):
        self.dataset: dict[str, Any] = {}
        self.anns: dict[int, dict] = {}
        self.imgs: dict[int, dict] = {}
        self.imgToAnns: defaultdict[int, list] = defaultdict(list)
        if annotation_file is not None:
            with open(annotation_file) as f:
                self.dataset = json.load(f)
            if not isinstance(self.dataset, dict):
                raise ValueError(
                    f"annotation file format {type(self.dataset)} not supported")
            self._create_index()

    def _create_index(self) -> None:
        for ann in self.dataset.get("annotations", []):
            self.imgToAnns[ann["image_id"]].append(ann)
            self.anns[ann["id"]] = ann
        for img in self.dataset.get("images", []):
            self.imgs[img["id"]] = img

    # pycocotools-compatible accessors used by the reference loader
    def getImgIds(self) -> list[int]:
        return list(self.imgs.keys())

    def loadImgs(self, ids) -> list[dict]:
        if isinstance(ids, int):
            ids = [ids]
        return [self.imgs[i] for i in ids]

    def getAnnIds(self, img_id: int) -> list[int]:
        return [a["id"] for a in self.imgToAnns[img_id]]

    def loadAnns(self, ids) -> list[dict]:
        if isinstance(ids, int):
            ids = [ids]
        return [self.anns[i] for i in ids]
