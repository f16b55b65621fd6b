"""Power-of-two padding-bucket policy for prompt trimming."""

from __future__ import annotations

import numpy as np


def pow2_bucket_width(mask: np.ndarray, floor: int) -> int:
    """Smallest power-of-two (>= ``floor``) column count covering the
    longest real (mask==1) row, capped at the mask's padded width."""
    longest = int(np.asarray(mask).sum(axis=1).max())
    width = floor
    while width < longest:
        width *= 2
    return min(width, mask.shape[1])
