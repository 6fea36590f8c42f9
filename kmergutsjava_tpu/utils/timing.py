"""Phase timing and profiling hooks.

The reference's entire observability surface is wall-clock phase lines and
10%-granularity lookup progress (ref KmerGutsJava.java:794,:803,:819,
:1019-1025). We keep those (same text format) and add an optional
jax.profiler trace around the device phases for device work analysis.
"""
from __future__ import annotations

import contextlib
import time
from typing import Callable, Optional


class PhaseTimer:
    def __init__(self) -> None:
        self._start = time.time()

    def restart(self) -> None:
        self._start = time.time()

    def elapsed_ms(self) -> int:
        return int((time.time() - self._start) * 1000)


class ProgressReporter:
    """Emits 'Processed: N%, time=T ms., found-so-far=K' lines per decile,
    mirroring the reference's lookup progress (ref :1019-1025)."""

    def __init__(self, total: int, emit: Callable[[str], None]):
        self.total = max(total, 1)
        self.emit = emit
        self.fraction = 0
        self.found = 0
        self.timer = PhaseTimer()

    def update(self, done: int, found_delta: int) -> None:
        self.found += found_delta
        new_fraction = int(10.0 * done / self.total)
        if new_fraction != self.fraction:
            self.fraction = new_fraction
            self.emit("Processed: %d%%, time=%d ms., found-so-far=%d"
                      % (self.fraction * 10, self.timer.elapsed_ms(), self.found))


@contextlib.contextmanager
def maybe_profile(trace_dir: Optional[str]):
    """jax.profiler trace context when a directory is given, else no-op."""
    if not trace_dir:
        yield
        return
    import jax

    with jax.profiler.trace(trace_dir):
        yield
