"""Optional TensorBoard scalars through ``torch.utils.tensorboard``.

The ``tensorboard`` package is imported only when the writer is enabled
(``Config.tensorboard``), so training without the flag never needs it.
"""

from __future__ import annotations

from typing import Optional


class ScalarWriter:
    """A no-op unless given a log directory."""

    def __init__(self, log_dir: Optional[str]):
        self._w = None
        if log_dir:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError as e:
                raise ImportError(
                    "tensorboard=True needs the tensorboard package; drop "
                    "the flag (train.log and metrics.jsonl need nothing "
                    "more)") from e
            self._w = SummaryWriter(log_dir=log_dir)

    @property
    def enabled(self) -> bool:
        return self._w is not None

    def scalar(self, tag: str, value: float, step: int) -> None:
        if self._w is not None:
            self._w.add_scalar(tag, float(value), int(step))

    def close(self) -> None:
        if self._w is not None:
            self._w.flush()
            self._w.close()
