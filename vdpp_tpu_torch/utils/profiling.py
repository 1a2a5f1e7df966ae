"""Timing fences and traces (port of ``vdpp_tpu/utils/profiling.py``).

* :func:`force_sync` and :func:`phase_timer` fence on the device: PyTorch
  returns before a card finishes, so a host clock ends at
  ``torch.cuda.synchronize``. On the CPU they need no fence.
* :func:`device_trace` is a ``torch.profiler`` trace (CPU activity, and CUDA
  activity on a card) that each rank writes as its own Chrome trace,
  ``trace_rank{r}.json``, when the context closes, on the error path too.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time

import torch

LOGGER = logging.getLogger(__name__)


def force_sync(device: torch.device) -> None:
    """Wait for the work queued on ``device`` (a card); no-op on the CPU."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def phase_timer(name: str, device: torch.device | None = None):
    """Time a phase on the host clock, fenced on ``device`` at its end;
    yields a dict that holds ``"seconds"`` afterwards."""
    t0 = time.perf_counter()
    result: dict = {}
    try:
        yield result
    finally:
        if device is not None:
            force_sync(device)
        result["seconds"] = time.perf_counter() - t0
        LOGGER.info("[phase %s] %.3f s", name, result["seconds"])


@contextlib.contextmanager
def device_trace(log_dir: str, rank: int = 0, device: torch.device | None = None):
    """Trace the enclosed work into ``log_dir/trace_rank{rank}.json`` (open
    it in Perfetto or ``chrome://tracing``); CUDA activity is traced when
    ``device`` is a card."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device is not None and device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"trace_rank{rank}.json")
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield path
    finally:
        if device is not None:
            force_sync(device)
        prof.stop()
        prof.export_chrome_trace(path)
        LOGGER.info("trace written to %s", path)
