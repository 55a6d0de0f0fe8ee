"""Tracing / profiling / device-memory observability.

Strict upgrade over the reference's instrumentation (SURVEY.md §5.1:
CUDACallback epoch time + peak memory at utils/callbacks.py:104-133, tqdm
step timers, CUDA_LAUNCH_BLOCKING crutch at gradio_app.py:3):

  - trace(): context manager around jax.profiler for TensorBoard-viewable
    XLA traces
  - StepTimer: true-wall-clock step timing (ends each step with a host
    fetch)
  - device_memory_stats(): per-device memory usage
  - annotate(): TraceAnnotation for named regions inside jitted code
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Optional

import jax
import numpy as np


@contextlib.contextmanager
def trace(logdir: str):
    """Capture an XLA profiler trace viewable in TensorBoard/Perfetto."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def annotate(name: str):
    """Named region appearing in profiler traces (usable under jit)."""
    return jax.profiler.TraceAnnotation(name)


def sync(x) -> None:
    """True device sync: host-fetch one element."""
    leaf = jax.tree_util.tree_leaves(x)[0]
    np.asarray(jax.device_get(leaf)).reshape(-1)[:1]


class StepTimer:
    """Rolling step timer with percentile summary."""

    def __init__(self, warmup: int = 1):
        self.warmup = warmup
        self.times = []
        self._t = None
        self._n = 0

    def tick(self, result=None):
        if result is not None:
            sync(result)
        now = time.perf_counter()
        if self._t is not None:
            self._n += 1
            if self._n > self.warmup:
                self.times.append(now - self._t)
        self._t = now

    def summary(self) -> Dict[str, float]:
        if not self.times:
            return {}
        a = np.asarray(self.times)
        return {"mean_s": float(a.mean()), "p50_s": float(np.median(a)),
                "p90_s": float(np.percentile(a, 90)), "n": len(a)}


def device_memory_stats() -> Dict[str, Dict[str, float]]:
    """Per-device memory (bytes in use / limit) where the backend reports it
    (replaces torch.cuda.max_memory_allocated at callbacks.py:117-131)."""
    out = {}
    for d in jax.local_devices():
        try:
            s = d.memory_stats()
        except Exception:
            s = None
        if s:
            out[str(d)] = {
                "bytes_in_use": s.get("bytes_in_use", 0),
                "peak_bytes_in_use": s.get("peak_bytes_in_use", 0),
                "bytes_limit": s.get("bytes_limit", 0),
            }
    return out


def count_params(params) -> int:
    """DynamiCrafter/utils/utils.py:8 equivalent."""
    return sum(int(np.prod(p.shape))
               for p in jax.tree_util.tree_leaves(params)
               if hasattr(p, "shape"))
