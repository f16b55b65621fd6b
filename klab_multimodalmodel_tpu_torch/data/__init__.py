"""Datasets, the host input pipeline and device-side image preprocessing."""

from .coco import CocoIndex  # noqa: F401
from .datasets import (COCO_PROMPT, CocoCaptionDataset, DatasetBase,  # noqa: F401
                       RedCapsDataset, SyntheticCaptionDataset, build_dataset)
from .pipeline import DataLoader, get_dataloader  # noqa: F401
