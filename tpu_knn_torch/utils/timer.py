"""Wall-clock timing + memory usage (reference: include/ztimer.h:25-47,
include/memory.h / src/memory.cc)."""

from __future__ import annotations

import os
import time

import torch


def _sync() -> None:
    # CUDA work is asynchronous: a clock read without a synchronize
    # measures the enqueue, not the work
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


class WallClockTimer:
    """Microsecond-resolution split/elapsed timer, same surface as the
    reference's WallClockTimer (ztimer.h:25-47). Synchronizes CUDA before
    every clock read."""

    def __init__(self):
        self.reset()

    def reset(self):
        _sync()
        self._start = time.perf_counter()
        self._elapsed_us = 0.0

    def split(self):
        _sync()
        now = time.perf_counter()
        self._elapsed_us = (now - self._start) * 1e6

    def elapsed(self) -> float:
        """Elapsed microseconds since last reset (after split())."""
        return self._elapsed_us


def mem_usage_mb() -> float:
    """Current process VmSize in MB (reference: src/memory.cc /proc reader)."""
    try:
        with open(f"/proc/{os.getpid()}/status") as f:
            for line in f:
                if line.startswith("VmSize:"):
                    return float(line.split()[1]) / 1024.0
    except OSError:
        pass
    return 0.0
