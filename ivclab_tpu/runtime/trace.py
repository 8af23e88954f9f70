"""Structured stage tracing / profiling.

The reference's observability is emoji debug prints sprayed through the hot
path (``ivclab/entropy/zerorun.py:14-16``, ``ivclab/image/intracodec.py:42``
— SURVEY.md §5 'Tracing'). Here: named stage timers with device sync,
optional ``jax.profiler`` trace annotations (xprof-compatible), and a JSON
report.
"""

from __future__ import annotations

import contextlib
import json
import time
from collections import defaultdict


class StageTimer:
    """Accumulates wall time per named stage; device-synced on exit."""

    def __init__(self, enabled: bool = True, annotate: bool = True):
        self.enabled = enabled
        self.annotate = annotate
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str, sync=None):
        """Time a stage; ``sync`` may be an array to block on (device sync)."""
        if not self.enabled:
            yield
            return
        import jax

        ctx = jax.profiler.TraceAnnotation(name) if self.annotate else contextlib.nullcontext()
        t0 = time.perf_counter()
        with ctx:
            yield
        if sync is not None:
            jax.block_until_ready(sync)  # device faults surface here
        self.totals[name] += time.perf_counter() - t0
        self.counts[name] += 1

    def report(self) -> dict:
        return {
            name: {
                "total_s": round(self.totals[name], 4),
                "calls": self.counts[name],
                "mean_ms": round(1000 * self.totals[name] / max(self.counts[name], 1), 2),
            }
            for name in sorted(self.totals)
        }

    def dump(self) -> str:
        return json.dumps(self.report(), indent=2)


@contextlib.contextmanager
def device_trace(logdir: str):
    """Capture a jax.profiler trace (view with xprof/tensorboard)."""
    import jax.profiler

    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
