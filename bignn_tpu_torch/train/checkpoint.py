"""Checkpoint and resume (counterpart of ``bignn_tpu/train/checkpoint.py``).

The JAX package saves through orbax; the port writes one ``torch.save``
file per step, ``step_<n>.pt``, through a temporary file and an atomic
rename, and keeps the newest ``max_to_keep``. A state is any nest of dicts,
lists, tensors and numbers: ``Trainer.fit`` saves parameters, optimizer
state, best parameters and the epoch counter, which is all an exact resume
needs. A JAX (orbax) checkpoint is read by ``scripts/convert_jax_checkpoint.py``,
which needs JAX and writes this format without the optimizer state.
"""

from __future__ import annotations

import os
import re

import torch

_NAME = re.compile(r"^step_(\d+)\.pt$")


class CheckpointManager:
    """Save and restore full training states in ``directory``."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = int(max_to_keep)
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step}.pt")

    def steps(self) -> list[int]:
        """Saved steps, oldest first."""
        return sorted(int(m.group(1)) for name in os.listdir(self.directory)
                      if (m := _NAME.match(name)))

    def save_state(self, step: int, state: dict) -> None:
        """Write ``state`` as step ``step``; a reader never sees half a
        file. Drops the oldest steps beyond ``max_to_keep``."""
        tmp = self._path(step) + f".{os.getpid()}.tmp"
        torch.save(state, tmp)
        os.replace(tmp, self._path(step))
        for old in self.steps()[: -self.max_to_keep]:
            os.remove(self._path(old))

    def restore_state(self, step: int | None = None,
                      map_location: str | torch.device = "cpu"):
        """The latest (or given) state with its tensors on ``map_location``;
        None if nothing is saved. There is no template, as orbax needs:
        the file keeps the state's structure."""
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        return torch.load(self._path(step), map_location=map_location,
                          weights_only=True)

    def latest_step(self) -> int | None:
        steps = self.steps()
        return steps[-1] if steps else None

    def close(self) -> None:
        """Nothing is held open between calls; kept for the JAX interface."""
