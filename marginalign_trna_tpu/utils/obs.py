"""Observability: logging, stage timers, DP-throughput counters, profiling.

The reference's observability is the sonLib/jobTree logger plus wall-clock
prints in tests (SURVEY.md §5).  Here: a standard-library logger
(MARGINALIGN_LOG=debug|info|... to enable), stage timers that report DP
cells/s for kernel stages, and an optional JAX profiler trace directory
(MARGINALIGN_TRACE_DIR) for TensorBoard-compatible device traces.

Stage timers log at debug level.  At that level stage_sync also blocks on
the device arrays it is given, so a timer around a device call measures
the device's work rather than its dispatch (and the stages stop
overlapping); at any other level both cost a clock read.  Each record
carries `stage` and `seconds` attributes for a handler to collect
(benchmarks/stage_profile.py does).
"""
from __future__ import annotations

import contextlib
import logging
import os
import time
from typing import Iterator, Optional

logger = logging.getLogger("marginalign")

_level = os.environ.get("MARGINALIGN_LOG")
if _level:
    logging.basicConfig(
        level=getattr(logging, _level.upper(), logging.INFO),
        format="%(asctime)s %(name)s %(levelname)s %(message)s",
    )


@contextlib.contextmanager
def stage_timer(name: str, dp_cells: Optional[int] = None) -> Iterator[None]:
    """Log stage wall time and, for kernel stages, DP cells/s (debug)."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        extra = {"stage": name, "seconds": dt}
        if dp_cells:
            logger.debug("%s: %.3fs (%.3g DP cells/s)", name, dt,
                         dp_cells / dt, extra=extra)
        else:
            logger.debug("%s: %.3fs", name, dt, extra=extra)


def stage_sync(x):
    """x, after its device work has finished when debug logging is on;
    x at once otherwise."""
    if logger.isEnabledFor(logging.DEBUG):
        import jax

        jax.block_until_ready(x)
    return x


@contextlib.contextmanager
def maybe_profile(tag: str) -> Iterator[None]:
    """Wrap a block in a JAX profiler trace if MARGINALIGN_TRACE_DIR is set."""
    trace_dir = os.environ.get("MARGINALIGN_TRACE_DIR")
    if not trace_dir:
        yield
        return
    import jax

    with jax.profiler.trace(os.path.join(trace_dir, tag)):
        yield
