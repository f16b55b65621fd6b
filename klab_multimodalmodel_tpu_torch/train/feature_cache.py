"""Cross-epoch cache of the frozen towers' features.

With the towers frozen (the reference's default caption recipe), their
forwards are deterministic: a sample's features are a pure function of its
image (and, for a static prompt, of its source ids). Epoch 1 runs the normal
step, which computes them anyway; the loop copies them to the host and
writes them here. Later epochs feed the cached features straight into the
transformer and skip the towers. Batches with rows still missing (a resumed
run, a wrapped tail) take the full step and fill as they go.

Storage is an ``np.memmap`` under ``result_dir`` in the run's compute dtype,
so a bf16 cache holds exactly what the towers computed. numpy has no
bfloat16, so bf16 rows are stored as their ``uint16`` bits and viewed as
``torch.bfloat16`` on the way out. A ``.meta.json`` records the geometry and
dtype (a change recreates the cache) and ``.mask.npy`` which rows are
filled; the mask is written only after the data, at ``flush()``. A memmap
has no second writer: across processes each rank keeps its own files
(``train/loop.py`` names them ``.p{rank}``), of whole rows also on the
ranks of a seq group (the Swin tower runs whole there, and the text
tower's output is gathered whole).
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch


class FrozenFeatureCache:
    """Disk-backed (sample index -> feature block) store with a fill mask."""

    def __init__(self, path: str, num_samples: int,
                 feature_shape: tuple[int, ...],
                 dtype: str = "bfloat16"):
        self.path = path
        self.num_samples = num_samples
        self.feature_shape = tuple(int(s) for s in feature_shape)
        self.dtype = dtype
        self._np_dtype = np.uint16 if dtype == "bfloat16" else np.float32
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        meta_path = path + ".meta.json"
        meta = {"num_samples": num_samples,
                "feature_shape": list(self.feature_shape),
                "dtype": dtype}
        fresh = True
        if os.path.exists(path) and os.path.exists(meta_path):
            with open(meta_path) as f:
                fresh = json.load(f) != meta
        if fresh:
            with open(meta_path, "w") as f:
                json.dump(meta, f)
        mode = "w+" if fresh or not os.path.exists(path) else "r+"
        self._mask_path = path + ".mask.npy"
        if fresh and os.path.exists(self._mask_path):
            # The old mask must not outlive its data: a crash between this
            # recreate (which zeroes the memmap) and the first flush() would
            # otherwise serve zeros as filled rows.
            os.remove(self._mask_path)
        self._data = np.memmap(path, dtype=self._np_dtype, mode=mode,
                               shape=(num_samples,) + self.feature_shape)
        if not fresh and os.path.exists(self._mask_path):
            self._filled = np.load(self._mask_path)
        else:
            self._filled = np.zeros(num_samples, bool)
        self._dirty = False  # rows put since the last flush()

    # Negative indices mark phantom rows (the padding of a ragged
    # accumulation tail, train/loop.py): never stored (their features come
    # from zeroed masks and differ from the row they duplicate), never gate
    # has(), and read row 0 on get(); every consumer masks them out.

    def has(self, indices: np.ndarray) -> bool:
        idx = np.asarray(indices)
        return bool(self._filled[idx[idx >= 0]].all())

    def put(self, indices: np.ndarray, features) -> None:
        """Store rows given as a tensor or an array of floats (or, for a
        bf16 cache, an array of their uint16 bits)."""
        idx = np.asarray(indices)
        real = idx >= 0
        self._data[idx[real]] = self._bits(features)[real]
        self._filled[idx[real]] = True
        self._dirty = True

    def get(self, indices: np.ndarray) -> torch.Tensor:
        """The rows as a CPU tensor in the cache's dtype."""
        idx = np.asarray(indices)
        rows = np.asarray(self._data[np.where(idx >= 0, idx, 0)])
        t = torch.from_numpy(rows)
        return t.view(torch.bfloat16) if self.dtype == "bfloat16" else t

    def _bits(self, features) -> np.ndarray:
        """Rows in the storage dtype: bf16 as its uint16 bits."""
        if (isinstance(features, np.ndarray)
                and features.dtype == self._np_dtype):
            return features
        t = torch.as_tensor(features)
        if self.dtype == "bfloat16":
            return t.to(torch.bfloat16).view(torch.int16).numpy().view(
                np.uint16)
        return t.to(torch.float32).numpy()

    def flush(self) -> None:
        """Persist the data, then the fill mask (survives a restart). A
        no-op when nothing was put since the last flush: the files already
        hold it, and each flush waits for the disk."""
        if not self._dirty:
            return
        self._data.flush()
        np.save(self._mask_path, self._filled)
        self._dirty = False


def swin_feature_shape(config) -> tuple[int, int]:
    """(tokens, num_features) of the image tower's output for ``config``."""
    s = config.swin
    return (s.num_patches_out, s.num_features)
