"""One run's outcome, as the traffic runners fill it in."""

from __future__ import annotations

import gc
from dataclasses import dataclass, field

import torch


@dataclass
class RunResult:
    attempted: int = 0
    failed: int = 0
    setup_s: float = 0.0
    e2e: dict = field(default_factory=dict)
    numbers: dict = field(default_factory=dict)
    notes: dict = field(default_factory=dict)
    memory_peak_bytes: int = 0
    summary: object = None

    def read_memory(self, device):
        """The program's peak, read before the reference runs."""
        if device.type == "cuda":
            torch.cuda.synchronize()
            self.memory_peak_bytes = int(torch.cuda.max_memory_allocated())

    def free(self, device):
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
