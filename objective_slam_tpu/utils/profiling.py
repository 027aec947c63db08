"""Tracing / profiling helpers — the observability subsystem.

The reference's tracing is #ifdef DEBUG cudaEvent timers around PPF
generation and lookup ("Time to generate PPFs" scene.cu:72-98, "Time to
lookup model" model.cu:271-305). The equivalents here:

  * `phase(name)` — wall-clock timer context that block_until_ready()s its
    result, logging "Time to <name>: X ms" at debug level (same shape as
    the reference's messages);
  * `trace(dir)` — jax.profiler trace context for device-level profiles;
  * `Timings` — accumulating per-phase statistics for benchmark reports.
"""

from __future__ import annotations

import contextlib
import logging
import time
from collections import defaultdict

import jax

log = logging.getLogger("objective_slam_tpu")


class Timings:
    """Accumulates per-phase wall times (ms)."""

    def __init__(self):
        self.samples: dict[str, list[float]] = defaultdict(list)

    def add(self, name: str, ms: float) -> None:
        self.samples[name].append(ms)

    def summary(self) -> dict[str, dict[str, float]]:
        out = {}
        for name, xs in self.samples.items():
            xs_sorted = sorted(xs)
            out[name] = {
                "mean_ms": sum(xs) / len(xs),
                "min_ms": xs_sorted[0],
                "p50_ms": xs_sorted[len(xs) // 2],
                "max_ms": xs_sorted[-1],
                "count": len(xs),
            }
        return out


@contextlib.contextmanager
def phase(name: str, timings: Timings | None = None, result_holder=None):
    """Times a device phase. Usage:

        with profiling.phase("generate PPFs") as hold:
            hold.append(some_jitted_fn(x))   # last appended is synced

    Mirrors the reference's '#ifdef DEBUG' event timers (scene.cu:72-98)."""
    holder = result_holder if result_holder is not None else []
    t0 = time.perf_counter()
    yield holder
    if holder:
        jax.block_until_ready(holder[-1])
    ms = (time.perf_counter() - t0) * 1e3
    log.debug("Time to %s: %3.1f ms", name, ms)
    if timings is not None:
        timings.add(name, ms)


@contextlib.contextmanager
def trace(log_dir: str):
    """Device-level profiler trace (view with tensorboard/xprof)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
