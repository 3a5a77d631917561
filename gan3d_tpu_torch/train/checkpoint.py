"""Checkpoint / resume with torch.save.

Reference semantics (trainer.py:128-163): one rolling checkpoint in
``log_dir/models/checkpoint.pt`` holding the step, both models' state_dicts,
both optimizer states and the loss/FID histories, under the reference's key
names; resume is automatic whenever it exists. Writes go to a temporary
file that replaces the old checkpoint, so a crash mid-save leaves the
previous one intact.

In a data-parallel run (``replicas``; gan3d_tpu/train/checkpoint.py:82)
rank 0 writes and every rank waits at a barrier until it has; every rank
restores from the file, so a run resumes at any world size (the state is
a replica's, the same on every rank).
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import torch

from gan3d_tpu_torch.parallel.dist import ONE, Replicas

CHECKPOINT_FILE = "checkpoint.pt"


class CheckpointManager:
    def __init__(self, models_dir: str, replicas: Replicas = ONE):
        self.dir = os.path.abspath(models_dir)
        self.replicas = replicas
        if replicas.main:
            os.makedirs(self.dir, exist_ok=True)
        self.path = os.path.join(self.dir, CHECKPOINT_FILE)

    def save(self, payload: Dict[str, Any]) -> None:
        if self.replicas.main:
            tmp = self.path + ".tmp"
            torch.save(payload, tmp)
            os.replace(tmp, self.path)
        self.replicas.barrier()

    def restore(self, device: torch.device) -> Optional[Dict[str, Any]]:
        """The latest checkpoint's payload, or None if there is none."""
        if not os.path.isfile(self.path):
            return None
        return torch.load(self.path, map_location=device, weights_only=True)
