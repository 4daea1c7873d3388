"""Metric logging (counterpart of ``bignn_tpu/utils/logging.py``): one JSON
record per epoch or event appended to ``<run_dir>/metrics.jsonl``, mirrored
to stdout."""

from __future__ import annotations

import json
import os
import time


class MetricLogger:
    def __init__(self, run_dir: str | None = None, stdout: bool = True):
        self.stdout = stdout
        self._fh = None
        if run_dir:
            os.makedirs(run_dir, exist_ok=True)
            self._fh = open(os.path.join(run_dir, "metrics.jsonl"), "a")
        self._t0 = time.time()

    def log(self, record: dict) -> None:
        record = {"wall_s": round(time.time() - self._t0, 3), **record}
        if self._fh:
            self._fh.write(json.dumps(record) + "\n")
            self._fh.flush()
        if self.stdout:
            parts = [
                f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}"
                for k, v in record.items()
            ]
            print(" ".join(parts), flush=True)

    def __call__(self, record: dict) -> None:
        self.log(record)

    def close(self):
        if self._fh:
            self._fh.close()
