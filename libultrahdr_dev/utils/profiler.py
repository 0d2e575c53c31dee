"""Tracing / profiling utilities.

The reference has only ad-hoc gettimeofday Profiler wrappers
(/root/reference/examples/ultrahdr_app.cpp:100-138,
 tests/jpegr_test.cpp:2156-2200). Here: a stage timer with the same
start/stop/elapsed surface, a scoped context manager, and hooks into
jax.profiler for device traces (tensorboard-compatible)."""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict


class Profiler:
    """Wall-clock stage timer (Profiler parity: start/stop/elapsed)."""

    def __init__(self):
        self._t0 = None
        self._elapsed = 0.0

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self):
        if self._t0 is not None:
            self._elapsed += time.perf_counter() - self._t0
            self._t0 = None

    def elapsed_ms(self) -> float:
        running = (time.perf_counter() - self._t0) if self._t0 else 0.0
        return (self._elapsed + running) * 1000.0

    def reset(self):
        self._t0 = None
        self._elapsed = 0.0


class StageTimes:
    """Accumulates named stage timings across iterations."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            n = self.counts[name]
            ms = self.totals[name] * 1000.0
            lines.append(f"{name}: {ms:.2f} ms total, "
                         f"{ms / max(n, 1):.2f} ms/iter x{n}")
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(logdir: str | None = None):
    """jax.profiler trace around a region (view with tensorboard or
    xprof). A failure to start or stop the trace propagates."""
    import jax

    logdir = logdir or os.environ.get("UHDR_TRACE_DIR") or os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))), ".uhdr_trace")
    jax.profiler.start_trace(logdir)
    try:
        yield logdir
    finally:
        jax.profiler.stop_trace()


def annotate(name: str):
    """TraceAnnotation context for device timelines."""
    import jax

    return jax.profiler.TraceAnnotation(name)
