"""Profiling hooks on ``torch.profiler``: named ranges, and a trace of the
first N optimizer steps exported to ``{result_dir}/profile``."""

from __future__ import annotations

import contextlib
import os

import torch


def _activities() -> list:
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


@contextlib.contextmanager
def trace(result_dir: str, enabled: bool = True):
    """Trace the block into ``{result_dir}/profile/trace.json``."""
    if not enabled:
        yield
        return
    path = os.path.join(result_dir, "profile")
    os.makedirs(path, exist_ok=True)
    with torch.profiler.profile(activities=_activities()) as prof:
        yield
    prof.export_chrome_trace(os.path.join(path, "trace.json"))


def annotate(name: str):
    """A named range on the profiler's timeline."""
    return torch.profiler.record_function(name)


class StepWindowTrace:
    """Traces the first ``n_steps`` optimizer steps into
    ``{result_dir}/profile/trace.json``: ``tick()`` once before each step;
    the trace starts before step 1 and stops at the tick after step N (or
    at ``close()``). With ``n_steps`` 0 every call is a no-op."""

    def __init__(self, result_dir: str, n_steps: int):
        self._path = os.path.join(result_dir, "profile")
        self._remaining = n_steps
        self._prof = None

    def tick(self) -> None:
        if self._remaining <= 0:
            self.close()
            return
        if self._prof is None:
            os.makedirs(self._path, exist_ok=True)
            self._prof = torch.profiler.profile(activities=_activities())
            self._prof.start()
        self._remaining -= 1

    def close(self) -> None:
        if self._prof is not None:
            self._prof.stop()
            self._prof.export_chrome_trace(
                os.path.join(self._path, "trace.json"))
            self._prof = None
