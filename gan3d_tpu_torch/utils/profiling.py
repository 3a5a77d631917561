"""Profiling hook of the trainer (counterpart of gan3d_tpu/utils/profiling.py).

Set ``cfg.profile_dir``: the Trainer traces steps [PROFILE_START,
PROFILE_START + PROFILE_STEPS) with ``torch.profiler`` (host activity, and
the card's kernels, copies and memsets when the trainer runs on the card)
and writes one Chrome trace, ``trace_steps_<first>-<last>.json``, into that
directory when the window closes. The window closes at the first step past
it or at ``close()`` (the trainer calls it after its last step), whichever
comes first. With an empty ``profile_dir`` nothing is traced or written.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
from torch.profiler import ProfilerActivity, profile

PROFILE_START = 5
PROFILE_STEPS = 5


class StepProfiler:
    """A trace window around a range of training steps."""

    def __init__(self, profile_dir: str, start: int = PROFILE_START,
                 num_steps: int = PROFILE_STEPS, cuda: bool = False):
        self.dir = profile_dir
        self.start = start
        self.stop = start + num_steps
        self.cuda = cuda
        self.path: Optional[str] = None  # the trace, once written
        self._prof: Optional[profile] = None
        self._last = start

    def step(self, i: int) -> None:
        """Call at the top of step ``i``."""
        if not self.dir:
            return
        if i == self.start and self._prof is None:
            activities = [ProfilerActivity.CPU]
            if self.cuda:
                activities.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=activities)
            self._prof.start()
        elif i >= self.stop and self._prof is not None:
            self._finish(i - 1)
        if self._prof is not None:
            self._last = i

    def close(self) -> None:
        """End an open window (after the trainer's last step)."""
        if self._prof is not None:
            self._finish(self._last)

    def _finish(self, last: int) -> None:
        if self.cuda:
            torch.cuda.synchronize()  # the window's kernels end inside it
        self._prof.stop()
        os.makedirs(self.dir, exist_ok=True)
        self.path = os.path.join(self.dir,
                                 f"trace_steps_{self.start}-{last}.json")
        self._prof.export_chrome_trace(self.path)
        self._prof = None
