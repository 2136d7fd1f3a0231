"""Runtime statistics of one recognition (reference EnvStats,
utils/utils.h:114-120), with peak device memory from `torch.cuda`, and named
wall-clock spans (`StageTimer`)."""

from __future__ import annotations

import contextlib
import dataclasses
import time

import torch


@dataclasses.dataclass
class EnvStats:
    scenes_rendered: int = 0
    scenes_valid: int = 0
    expands: int = 0
    time: float = 0.0           # total recognition seconds
    input_time: float = 0.0
    gpu_time: float = 0.0       # device dispatch seconds
    icp_time: float = 0.0
    cost: int = -1
    peak_device_mem_mb: float = 0.0

    def update_peak_memory(self, device: torch.device) -> None:
        """Raise peak_device_mem_mb to the allocator's peak on a CUDA
        device (no-op for the CPU)."""
        if device.type == "cuda":
            self.peak_device_mem_mb = max(
                self.peak_device_mem_mb,
                torch.cuda.max_memory_allocated(device) / 1e6)


class StageTimer:
    """Named wall-clock spans: `with timer.span("render"): ...`."""

    def __init__(self):
        self.spans: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.spans[name] = self.spans.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> str:
        return " | ".join(
            f"{k}: {v:.3f}s/{self.counts[k]}" for k, v in self.spans.items())
