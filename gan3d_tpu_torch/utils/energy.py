"""Energy estimate of a training run (counterpart of
gan3d_tpu/utils/energy.py).

The reference wires carbontracker but comments it out (reference:
trainer.py:6, 93, 297, 304, 311). As in the JAX package, the estimate is
the run's active training time x a per-chip power figure x the number of
chips, converted to CO2e with a grid intensity, written as
``log_dir/energy.json`` (``cfg.track_energy``) with the JAX package's
``summary()`` keys. The power figure of a card is its power limit as
``nvidia-smi --query-gpu=power.limit`` reads it (an upper bound on its
draw); the CPU takes the JAX package's 65 W. ``n_chips`` is the run's
world size (one process a card). On the card every step is synchronized
before its end is read, so the active time is the card's, not the host's
dispatch time.
"""

from __future__ import annotations

import json
import os
import subprocess
import time
from dataclasses import dataclass, field

import torch

CPU_WATTS = 65.0
DEFAULT_G_CO2_PER_KWH = 420.0  # world-average grid intensity


def card_watts(index: int = 0) -> float:
    """Card ``index``'s power limit in W, read with nvidia-smi (raises when
    it cannot be read)."""
    out = subprocess.run(
        ["nvidia-smi", f"--id={index}", "--query-gpu=power.limit",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60, check=True)
    return float(out.stdout.strip().splitlines()[0])


def device_watts(device: torch.device) -> float:
    """The power figure of one chip of ``device``'s kind."""
    if device.type == "cuda":
        return card_watts(device.index if device.index is not None
                          else torch.cuda.current_device())
    return CPU_WATTS


@dataclass
class EnergyTracker:
    enabled: bool = False
    n_chips: int = 1
    watts_per_chip: float = CPU_WATTS
    g_co2_per_kwh: float = DEFAULT_G_CO2_PER_KWH
    device: torch.device = field(default_factory=lambda: torch.device("cpu"))
    _t0: float = 0.0
    _active_s: float = 0.0

    def epoch_start(self) -> None:
        if self.enabled:
            self._t0 = time.perf_counter()

    def epoch_end(self) -> None:
        if self.enabled and self._t0:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self._active_s += time.perf_counter() - self._t0
            self._t0 = 0.0

    @property
    def kwh(self) -> float:
        return self._active_s * self.watts_per_chip * self.n_chips / 3.6e6

    def summary(self) -> dict:
        return {
            "active_seconds": round(self._active_s, 3),
            "chips": self.n_chips,
            "watts_per_chip_estimate": self.watts_per_chip,
            "kwh_estimate": round(self.kwh, 6),
            "g_co2e_estimate": round(self.kwh * self.g_co2_per_kwh, 3),
        }

    def write(self, log_dir: str) -> None:
        if self.enabled:
            with open(os.path.join(log_dir, "energy.json"), "w") as f:
                json.dump(self.summary(), f, indent=2)
