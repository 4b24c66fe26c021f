"""Profiling / observability.

Replacement for the reference's print-based CudaMon
(/root/reference/cpd/util.py:457-465) and the attention layer's
read-memory-in-forward pattern (attention.py:299-324, explicitly removed):
  * :class:`StepTimer` — wall-clock step timing with images/sec summaries
    (the tqdm postfix stats of ddim.py:172-188, minus the tqdm).
  * :func:`trace` — context manager around jax.profiler for TensorBoard
    traces.
  * :func:`device_memory_stats` — static HBM introspection per device.
  * :func:`live_array_bytes` — total bytes of live jax arrays.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional

import jax

__all__ = ["StepTimer", "trace", "device_memory_stats", "live_array_bytes"]


class StepTimer:
    """Accumulate step timings; report p50/mean and throughput."""

    def __init__(self, unit: str = "step"):
        self.unit = unit
        self.times: List[float] = []
        self._t0: Optional[float] = None

    def start(self):
        self._t0 = time.perf_counter()
        return self

    def stop(self, count: int = 1):
        if self._t0 is None:
            raise RuntimeError("StepTimer.stop without start")
        dt = (time.perf_counter() - self._t0) / count
        self.times.extend([dt] * count)
        self._t0 = None
        return dt

    @contextlib.contextmanager
    def __call__(self, count: int = 1):
        self.start()
        yield
        self.stop(count)

    def summary(self) -> Dict[str, float]:
        if not self.times:
            return {}
        ts = sorted(self.times)
        p50 = ts[len(ts) // 2]
        mean = sum(ts) / len(ts)
        return {
            f"p50_{self.unit}_ms": p50 * 1e3,
            f"mean_{self.unit}_ms": mean * 1e3,
            f"{self.unit}s_per_sec": 1.0 / mean,
            "count": float(len(ts)),
        }


@contextlib.contextmanager
def trace(logdir: str):
    """jax.profiler trace context (view with TensorBoard)."""
    jax.profiler.start_trace(logdir)
    try:
        yield logdir
    finally:
        jax.profiler.stop_trace()


def device_memory_stats() -> Dict[str, Dict[str, int]]:
    """Per-device memory stats when the backend exposes them."""
    out = {}
    for d in jax.devices():
        try:
            stats = d.memory_stats()
        except Exception:
            stats = None
        if stats:
            out[str(d)] = {
                "bytes_in_use": stats.get("bytes_in_use", -1),
                "bytes_limit": stats.get("bytes_limit", -1),
                "peak_bytes_in_use": stats.get("peak_bytes_in_use", -1),
            }
    return out


def live_array_bytes() -> int:
    """Total bytes of live jax arrays (the CudaMon equivalent)."""
    total = 0
    for arr in jax.live_arrays():
        total += arr.size * arr.dtype.itemsize
    return total
