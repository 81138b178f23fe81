"""Structured per-stage timing and JAX profiler hooks.

The reference's only observability is a candidate-trace ``debug`` level and
one ``@timed`` around the whole LGL run (reference: src/learning.jl:587,
src/hiton.jl:128,293-310).  This build replaces that with a structured
stage timer (normalize / univariate / conditional / postprocess) printed in
verbose mode and recorded in the result parameters, plus an optional
``jax.profiler`` trace context for device-level analysis (SURVEY §5).
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Optional


class StageTimer:
    """Accumulates wall-clock seconds per named pipeline stage."""

    def __init__(self) -> None:
        self.stages: Dict[str, float] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.stages[name] = (
                self.stages.get(name, 0.0) + time.perf_counter() - t0
            )

    def summary(self) -> str:
        total = sum(self.stages.values())
        lines = ["Stage timings:"]
        for name, secs in self.stages.items():
            frac = 100.0 * secs / total if total > 0 else 0.0
            lines.append(f"\t{name:<12} {secs:8.3f}s  ({frac:4.1f}%)")
        lines.append(f"\t{'total':<12} {total:8.3f}s")
        return "\n".join(lines)


@contextlib.contextmanager
def profiler_trace(profile_dir: Optional[str]):
    """Capture a jax.profiler trace into ``profile_dir`` (no-op if falsy).

    The trace can be inspected with TensorBoard or Perfetto and contains
    per-kernel device timelines -- the replacement for the
    reference's absent profiling layer.
    """
    if not profile_dir:
        yield
        return
    import jax

    with jax.profiler.trace(profile_dir):
        yield
