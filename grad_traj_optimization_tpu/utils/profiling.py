"""Tracing / profiling helpers.

Replaces the reference's manual ``ros::Time`` stopwatches scattered
through the optimizer and search code (grad_traj_optimizer.cpp:283-285,
434-447; SURVEY.md section 5): structured timings on the host side plus
JAX profiler traces for device-side analysis.

The jitted solve already returns its own device-side metrics (cost
trace, accepted iterations, status); these helpers cover host-visible
wall time and XLA-level traces.
"""

from __future__ import annotations

import contextlib
import time


class Stopwatch:
    """Accumulating named timers (host wall time).

    >>> sw = Stopwatch()
    >>> with sw.section("edt"):
    ...     build_field()
    >>> sw.report()
    {'edt': {'total_s': ..., 'count': 1}}
    """

    def __init__(self):
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    @contextlib.contextmanager
    def section(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> dict:
        return {
            k: {"total_s": round(v, 6), "count": self.counts[k]}
            for k, v in self.totals.items()
        }


@contextlib.contextmanager
def device_trace(log_dir: str):
    """JAX profiler trace around a block (open with TensorBoard/XProf).

    Device-side replacement for the reference's per-iteration stopwatch:
    shows the actual kernel timeline instead of host-observed wall time.
    """
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def sync_time(fn, *args, n: int = 1):
    """Device timing: run ``fn`` once to compile and warm, then n timed
    times, each ending in ``jax.block_until_ready``; returns
    (result, best_s)."""
    import jax

    result = jax.block_until_ready(fn(*args))  # compile + warm
    best = float("inf")
    for _ in range(n):
        t0 = time.perf_counter()
        result = jax.block_until_ready(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return result, best
