"""Profiling hook (counterpart of ``bignn_tpu/utils/profiling.py``): a
``torch.profiler`` trace of a block, host and CUDA activities, written as a
Chrome trace (open in Perfetto or ``chrome://tracing``)."""

from __future__ import annotations

import contextlib
import os

import torch


@contextlib.contextmanager
def profile_trace(log_dir: str | None):
    """Trace the enclosed block into ``log_dir/trace.json`` (nothing when
    ``log_dir`` is None or empty)."""
    if not log_dir:
        yield
        return
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
