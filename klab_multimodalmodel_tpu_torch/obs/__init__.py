"""Logging, loss accounting, TensorBoard scalars and profiling."""

from .logger import get_logger  # noqa: F401
from .metrics import LossCounter, Stopwatch  # noqa: F401
