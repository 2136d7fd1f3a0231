"""Runtime statistics of one recognition (reference EnvStats,
utils/utils.h:114-120), with peak device memory from `torch.cuda`."""

from __future__ import annotations

import dataclasses

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
