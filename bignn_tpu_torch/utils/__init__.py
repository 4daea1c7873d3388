"""Shared utilities (counterpart of ``bignn_tpu/utils``): metric logging
and profiling hooks."""

from bignn_tpu_torch.utils.logging import MetricLogger
from bignn_tpu_torch.utils.profiling import profile_trace

__all__ = ["MetricLogger", "profile_trace"]
