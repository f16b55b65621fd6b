"""T5-style masked-span corruption for self-supervised pretraining.

The reference's RedCaps transform, decision for decision:

  * punctuation ``. , ! ?`` gets a space inserted before it;
  * the text is whitespace-split into words;
  * ``int(len(words) * 0.15) + 1`` word *positions* are drawn uniformly
    without replacement;
  * each masked word is replaced by its own sentinel in positional order
    (word-level masking, no span merging);
  * the target interleaves sentinels and masked words starting from
    ``<extra_id_0>``: ``<extra_id_0> w_a <extra_id_1> w_b <extra_id_2>``.

The RNG is an explicit ``numpy.random.Generator``, so masking is
reproducible and reseedable per epoch.
"""

from __future__ import annotations

import numpy as np

MASK_RATIO = 0.15
_PUNCT = [".", ",", "!", "?"]


def span_corrupt(text: str, rng: np.random.Generator,
                 mask_ratio: float = MASK_RATIO) -> tuple[str, str]:
    """text -> (corrupted_source, sentinel_target)."""
    for p in _PUNCT:
        text = text.replace(p, " " + p)
    words = text.split()
    n_mask = int(len(words) * mask_ratio) + 1
    mask_idx = set(rng.permutation(len(words))[:n_mask].tolist())

    tgt = ["<extra_id_0>"]
    j = 0
    src = list(words)
    for i in range(len(src)):
        if i in mask_idx:
            tgt.append(src[i])
            tgt.append(f"<extra_id_{j + 1}>")
            src[i] = f"<extra_id_{j}>"
            j += 1
    return " ".join(src), " ".join(tgt)
