"""Tracing and throughput accounting.

The reference has no observability beyond ``println!`` (SURVEY §5); the
framework gets these small tools:

* :class:`StageStats` — per-stage sample/byte throughput counters kept
  by the executors (samples pulled, device steps, wall time).
* :func:`trace` — context manager around ``jax.profiler`` emitting a
  TensorBoard-loadable trace directory.
* :func:`sync_fetch` — wait for a result by fetching a scalar reduced
  from it.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from dataclasses import dataclass


@dataclass
class StageStats:
    samples: int = 0
    steps: int = 0
    seconds: float = 0.0

    @property
    def msps(self) -> float:
        return self.samples / self.seconds / 1e6 if self.seconds > 0 else 0.0


class Profiler:
    """Process-wide registry of per-stage throughput counters."""

    def __init__(self):
        self.stages: dict[str, StageStats] = defaultdict(StageStats)
        self.enabled = False

    def account(self, stage: str, samples: int, seconds: float) -> None:
        if not self.enabled:
            return
        s = self.stages[stage]
        s.samples += samples
        s.steps += 1
        s.seconds += seconds

    @contextlib.contextmanager
    def stage(self, name: str, samples: int):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.account(name, samples, time.perf_counter() - t0)

    def report(self) -> str:
        lines = ["stage                     steps     samples      Msps"]
        for name, s in sorted(self.stages.items()):
            lines.append(f"{name:<24} {s.steps:>6} {s.samples:>11} {s.msps:>9.2f}")
        return "\n".join(lines)

    def reset(self) -> None:
        self.stages.clear()


PROFILER = Profiler()


@contextlib.contextmanager
def profiled():
    """Enable stage accounting for the duration of the block."""
    prev = PROFILER.enabled
    PROFILER.enabled = True
    try:
        yield PROFILER
    finally:
        PROFILER.enabled = prev


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a device trace (TensorBoard / xprof format)."""
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def sync_fetch(x) -> float:
    """Wait for ``x`` (and so for everything it depends on) and return a
    scalar derived from it."""
    import jax.numpy as jnp

    return float(jnp.sum(x)) if getattr(x, "ndim", 0) else float(x)
