"""Profiler tracing (SURVEY.md §5: the reference measured timings
externally; here ``jax.profiler`` traces are first-class)."""

from __future__ import annotations

import contextlib
from pathlib import Path

import jax

# git-ignored, inside the checkout
DEFAULT_DIR = str(Path(__file__).resolve().parents[2] / "chiprun_out" / "trace")


@contextlib.contextmanager
def trace(log_dir: str = DEFAULT_DIR):
    """Capture a TensorBoard-viewable device trace around a block of work.

    with trace():
        state, out = rx.step(state, raw)
        jax.block_until_ready(out)
    """
    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()


def annotate(name: str):
    """Named region inside a trace (host-side annotation)."""
    return jax.profiler.TraceAnnotation(name)
