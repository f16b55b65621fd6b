"""On-device image preprocessing."""

from __future__ import annotations

import torch

# HF Swinv2 preprocessor defaults (IMAGENET_STANDARD mean/std).
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def normalize_images(images_uint8: torch.Tensor,
                     dtype: torch.dtype = torch.float32,
                     reference_double_rescale: bool = False) -> torch.Tensor:
    """(B, H, W, 3) uint8 -> normalized (B, H, W, 3) in ``dtype`` (computed
    in fp32, then cast), on the images' device. ``reference_double_rescale``
    reproduces the reference's numerics: the images, already scaled to
    [0, 1], are divided by 255 once more before the ImageNet normalization."""
    x = images_uint8.to(torch.float32) / 255.0
    if reference_double_rescale:
        x = x / 255.0
    # Asynchronous copies: a blocking one would wait for the device to drain
    # the steps enqueued before this one.
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32).to(
        x.device, non_blocking=True)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32).to(
        x.device, non_blocking=True)
    return ((x - mean) / std).to(dtype)
