"""Profiling/tracing helpers (SURVEY.md §5: the reference has none beyond wall-clock;
here: jax.profiler traces + per-step timing)."""

from __future__ import annotations

import contextlib
import os
import tempfile
import time

import jax

__all__ = ["trace", "time_steps"]


@contextlib.contextmanager
def trace(logdir: str | None = None):
    """jax.profiler trace context (default directory: ``osg_trace`` under the
    temporary directory); view with TensorBoard or xprof."""
    if logdir is None:
        logdir = os.path.join(tempfile.gettempdir(), "osg_trace")
    jax.profiler.start_trace(logdir)
    try:
        yield logdir
    finally:
        jax.profiler.stop_trace()


def time_steps(step_fn, model, state, dt, n=50, warmup=3):
    """Steady-state per-step wall time in ms (construction/compile excluded)."""
    s = state
    for _ in range(warmup):
        s = step_fn(model, s, dt)
    jax.block_until_ready(s)
    t0 = time.perf_counter()
    for _ in range(n):
        s = step_fn(model, s, dt)
    jax.block_until_ready(s)
    return (time.perf_counter() - t0) / n * 1e3, s
