"""Loss accounting and the loss-curve plot.

The reference's ``LossCounter``: per-phase running sums, the epoch mean as
total / loader length, and a ``loss.png`` curve. Losses arrive as 0-d
tensors on the device and stay there until an epoch closes or a checkpoint
records them: one transfer then, not a ``.item()`` per step.
"""

from __future__ import annotations

import os
import time
from typing import Dict, List

import numpy as np
import torch


def _floats(values: list) -> list[float]:
    """Host floats of a list of 0-d tensors and floats, in order, with one
    transfer for all the tensors."""
    at = [i for i, v in enumerate(values) if isinstance(v, torch.Tensor)]
    out = list(values)
    if at:
        host = torch.stack([values[i].detach().float() for i in at]).cpu()
        for i, v in zip(at, host.tolist()):
            out[i] = v
    return [float(v) for v in out]


class LossCounter:
    """``add_loss`` / ``count_and_get_loss`` / ``plot_loss``, as the
    reference's."""

    def __init__(self, train_loader_len: int, val_loader_len: int):
        self.loader_len = {"train": max(train_loader_len, 1),
                           "val": max(val_loader_len, 1)}
        self.losses: Dict[str, List[float]] = {"train": [], "val": []}
        self._pending: Dict[str, list] = {"train": [], "val": []}

    def add_loss(self, phase: str, loss) -> None:
        self._pending[phase].append(loss)

    # -- checkpointable state (mid-epoch resume) --------------------------
    def state_dict(self) -> dict:
        """The epoch history and this epoch's partials as host floats
        (JSON), so a resumed run's curve equals the uninterrupted one."""
        return {"losses": {k: list(v) for k, v in self.losses.items()},
                "pending": {k: _floats(v) for k, v in self._pending.items()}}

    def load_state_dict(self, state: dict) -> None:
        self.losses = {k: list(v) for k, v in state["losses"].items()}
        self._pending = {k: list(v) for k, v in state["pending"].items()}

    def count_and_get_loss(self) -> tuple[float, float]:
        for phase in ("train", "val"):
            vals = _floats(self._pending[phase])
            self.losses[phase].append(
                float(np.sum(vals)) / self.loader_len[phase])
            self._pending[phase] = []
        return self.losses["train"][-1], self.losses["val"][-1]

    def plot_loss(self, result_dir: str) -> str:
        """Write ``{result_dir}/loss.png``; raises ImportError without
        matplotlib (``metrics.jsonl`` holds the same curve)."""
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        plt.figure()
        plt.plot(self.losses["train"], label="Train")
        plt.plot(self.losses["val"], label="Val")
        plt.title("Loss Curve")
        plt.xlabel("Epoch")
        plt.ylabel("Loss")
        plt.legend()
        path = os.path.join(result_dir, "loss.png")
        plt.savefig(path)
        plt.close()
        return path


class Stopwatch:
    """Counts items against the host clock (images/s)."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self._t0 = time.perf_counter()
        self._count = 0

    def tick(self, n: int = 1) -> None:
        self._count += n

    def rate(self) -> float:
        dt = time.perf_counter() - self._t0
        return self._count / dt if dt > 0 else 0.0
