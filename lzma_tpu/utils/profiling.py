"""Device-path profiling: jax.profiler trace capture + phase timers.

The device-side analogue of the reference's (absent) profiler story: the scalar
path traces per symbol (utils/trace.py); the device path records per-phase
wall time and can capture full XLA traces for TensorBoard/Perfetto.
"""

from __future__ import annotations

import contextlib
import time


class PhaseTimer:
    """Accumulates wall-clock per named phase; device-sync by block_until_ready."""

    def __init__(self):
        self.totals: dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str, sync_arrays=()):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            for a in sync_arrays:
                try:
                    a.block_until_ready()
                except AttributeError:
                    pass
            self.totals[name] = self.totals.get(name, 0.0) + time.perf_counter() - t0

    def report(self) -> str:
        total = sum(self.totals.values()) or 1.0
        lines = [
            f"  {name:<24s} {t:8.3f}s  {100 * t / total:5.1f}%"
            for name, t in sorted(self.totals.items(), key=lambda kv: -kv[1])
        ]
        return "\n".join(lines)


@contextlib.contextmanager
def xla_trace(logdir: str):
    """Capture a jax.profiler trace (view in TensorBoard / Perfetto)."""
    import jax

    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
