"""Tracing, timing and debugging (counterpart of ``utils/profiling.py``).

* ``trace(logdir)``: a ``torch.profiler`` context over the CPU and, where
  there is one, the CUDA device; on exit it writes a Chrome trace
  (``trace.json``, viewable in Perfetto or ``chrome://tracing``) under
  ``logdir``;
* ``annotate(name)``: a named region in such a trace
  (``torch.profiler.record_function``);
* ``StepTimer``: wall-clock phase timers with p50/p95 summaries; a phase
  given outputs on the card waits for the device (``synchronize``) before
  it stops its clock;
* ``enable_nan_debugging``: ``torch.autograd.set_detect_anomaly``, which
  names the forward operation whose backward produced a NaN.
"""

from __future__ import annotations

import contextlib
import os
import statistics
import time
from collections import defaultdict
from typing import Any, Dict

import torch

from cosmology_gnn_simulation_tpu_torch.types import tree_leaves


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the body; write ``logdir/trace.json`` (a Chrome trace)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def annotate(name: str):
    """Named region that shows up in profiler traces."""
    return torch.profiler.record_function(name)


def block_until_ready(outputs: Any) -> None:
    """Wait for the device work that produces ``outputs`` (a tree of
    tensors): synchronize each CUDA device among its leaves."""
    devices = {t.device for t in tree_leaves(outputs) if isinstance(t, torch.Tensor)}
    for device in devices:
        if device.type == "cuda":
            torch.cuda.synchronize(device)


class StepTimer:
    """Accumulates wall-clock timings per phase.

    Usage::

        timer = StepTimer()
        with timer.phase("train_step", block_on=outputs):
            outputs = step(...)
        print(timer.summary())
    """

    def __init__(self):
        self._samples: Dict[str, list] = defaultdict(list)

    @contextlib.contextmanager
    def phase(self, name: str, block_on: Any = None):
        start = time.perf_counter()
        yield
        if block_on is not None:
            block_until_ready(block_on)
        self._samples[name].append(time.perf_counter() - start)

    def record(self, name: str, seconds: float) -> None:
        self._samples[name].append(seconds)

    def summary(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for name, xs in self._samples.items():
            xs_sorted = sorted(xs)
            out[name] = {
                "count": len(xs),
                "mean_s": statistics.fmean(xs),
                "p50_s": xs_sorted[len(xs) // 2],
                "p95_s": xs_sorted[min(len(xs) - 1, int(len(xs) * 0.95))],
                "total_s": sum(xs),
            }
        return out

    def reset(self) -> None:
        self._samples.clear()


def enable_nan_debugging(enable: bool = True) -> None:
    """Raise in the backward pass where a NaN is produced, naming the forward
    operation (``torch.autograd.set_detect_anomaly``; debug runs only: it
    slows every backward)."""
    torch.autograd.set_detect_anomaly(enable)
