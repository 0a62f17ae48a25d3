"""Profiling helpers (port of raytracer_tpu/utils/profiling.py): a
torch.profiler trace capture, and a wall-clock phase timer that waits for
the device at the end of each phase.

On a multi-device render each rank keeps its own PhaseTimer
(`ProgressiveRenderer.timer`): the tile render, ReSTIR's halo exchange and
the image gather are its phases."""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional

import torch


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Capture a torch.profiler trace of the CPU and, with a card, CUDA
    activities, written to `log_dir` as a Chrome trace (TensorBoard's
    profiler plugin reads it)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                log_dir)):
        yield


def _first_tensor(value):
    if isinstance(value, torch.Tensor):
        return value
    if isinstance(value, dict):
        value = list(value.values())
    for item in value:
        found = _first_tensor(item)
        if found is not None:
            return found
    return None


def sync(value) -> float:
    """Wait for the device that holds `value` (a tensor, or the first tensor
    of a tuple, list or dict): torch.cuda.synchronize on a card, a readback
    on the CPU. Returns its first element."""
    leaf = _first_tensor(value)
    if leaf.is_cuda:
        torch.cuda.synchronize(leaf.device)
    return float(leaf.reshape(-1)[0])


class PhaseTimer:
    """Accumulates wall time per named phase; a phase given a result
    waits for the device before it ends."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str, result_holder: Optional[List] = None):
        t0 = time.perf_counter()
        yield
        if result_holder:
            sync(result_holder[0])
        dt = time.perf_counter() - t0
        self.totals[name] = self.totals.get(name, 0.0) + dt
        self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        rows = sorted(self.totals.items(), key=lambda kv: -kv[1])
        width = max((len(k) for k, _ in rows), default=1)
        return "\n".join(
            f"{k.ljust(width)}  {v * 1e3:8.1f} ms total  "
            f"({v / max(self.counts[k], 1) * 1e3:.1f} ms/call x{self.counts[k]})"
            for k, v in rows
        )
