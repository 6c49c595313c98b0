"""Profiling hooks (SURVEY.md section 5: tracing subsystem).

Thin wrappers over jax.profiler: named scopes around the hot stages (blind
rotate / key switch / keygen) and a one-shot trace capture helper for
inspection in TensorBoard/XProf.
"""

from __future__ import annotations

import contextlib
import statistics
import time

import jax


def scope(name: str):
    """Named scope: annotates ops traced under jit so the stage shows up in
    HLO/XProf timelines (used around the PBS stages in models/bootstrap.py)."""
    return jax.named_scope(name)


@contextlib.contextmanager
def capture_trace(log_dir: str):
    """Capture a device trace around a block: writes to ``log_dir``."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def median_call_s(fn, *args, reps: int = 5):
    """Median wall time of ``reps`` calls of ``fn(*args)`` after one warm-up
    (compile) call; every call ends in ``block_until_ready``.  Returns
    (median seconds, last output)."""
    out = jax.block_until_ready(fn(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return statistics.median(times), out


class Timer:
    """Wall-clock stage timer with a device sync at each mark."""

    def __init__(self):
        self.marks: list[tuple[str, float]] = []
        self._t = time.perf_counter()

    def mark(self, name: str, *block_on):
        for x in block_on:
            jax.block_until_ready(x)
        now = time.perf_counter()
        self.marks.append((name, now - self._t))
        self._t = now

    def __str__(self):
        return ", ".join(f"{n}: {dt*1e3:.1f}ms" for n, dt in self.marks)
