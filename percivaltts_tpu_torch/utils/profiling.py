"""Tracing / profiling hooks (counterpart of
``percivaltts_tpu/utils/profiling.py``).

Reference parity: percivaltts has no profiling subsystem beyond wall-clock
prints and a system/GPU info dump. The port provides a ``torch.profiler``
trace around training steps, written as a Chrome trace (Perfetto /
``chrome://tracing`` readable), a per-step timer that feeds the JSONL
metrics log, and a device/system info dump.
"""

from __future__ import annotations

import contextlib
import os
import platform
import time
from typing import Dict, Iterator, Optional

import torch

from percivaltts_tpu_torch.utils.logging import print_log


def system_info(device="cuda") -> Dict[str, object]:
    """Device/system info dump (reference: the GPU-info print in utils)."""
    device = torch.device(device)
    on_card = device.type == "cuda"
    count = torch.cuda.device_count() if on_card else 1
    return {
        "platform": device.type,
        "devices": [torch.cuda.get_device_name(i) for i in range(count)] if on_card else ["cpu"],
        "device_count": count,
        "python": platform.python_version(),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "host": platform.node(),
        "cpus": os.cpu_count(),
    }


@contextlib.contextmanager
def trace(workdir: str, cuda: bool) -> Iterator[None]:
    """Capture a ``torch.profiler`` trace (host and, with ``cuda``, device
    activity) and write it as a Chrome trace into ``workdir/traces``. Wrap
    a few steady-state steps, not the whole run."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    trace_dir = os.path.join(workdir, "traces")
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, f"trace_{time.time_ns()}.json")
    with profile(activities=activities) as prof:
        yield
    t0 = time.perf_counter()
    prof.export_chrome_trace(path)
    print_log(f"profiler trace written to {path} in {time.perf_counter() - t0:.3f} s")


class StepTimer:
    """Per-step wall-clock timing with jitter stats for the metrics log."""

    def __init__(self):
        self._t0: Optional[float] = None
        self.count = 0
        self.total = 0.0
        self.max = 0.0

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self) -> float:
        dt = time.perf_counter() - (self._t0 or time.perf_counter())
        self.count += 1
        self.total += dt
        self.max = max(self.max, dt)
        return dt

    @property
    def mean(self) -> float:
        return self.total / max(self.count, 1)

    def summary(self) -> Dict[str, float]:
        return {"steps": self.count, "mean_s": self.mean, "max_s": self.max}
