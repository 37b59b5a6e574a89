"""Profiling: EMA-filtered step timing and interaction rates (SURVEY §5.1).

The reference instruments with WebGPU timestamp queries wrapped in a
state-machine ``TimingHelper`` (``util.js:297-423``) plus
``performance.now()`` host timing, all EMA-smoothed with filterStrength=10
(``nbody3d.js:434,441-443``).  Here the analogs are wall-clock timing
around blocked ``lax.scan`` chunks (device timing via
``jax.profiler.trace`` when a deep dive is needed), the derived metrics the
HUD showed (fps -> steps/s) plus the one that matters for an O(N^2) code:
pairwise interactions per second.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time


class Ema:
    """Exponential moving average with the reference's update rule
    ``x += (sample - x) / filterStrength`` (``nbody3d.js:441-443``)."""

    def __init__(self, filter_strength: float = 10.0):
        self.filter_strength = filter_strength
        self.value = 0.0
        self._initialized = False

    def update(self, sample: float) -> float:
        if not self._initialized:
            self.value = sample
            self._initialized = True
        else:
            self.value += (sample - self.value) / self.filter_strength
        return self.value


@dataclasses.dataclass
class StepStats:
    """Running stats over :meth:`update` calls (one call per scan chunk)."""

    ema: Ema = dataclasses.field(default_factory=Ema)
    total_steps: int = 0
    total_time: float = 0.0
    steps_per_s: float = 0.0
    ms_per_step: float = 0.0
    gints_per_s: float = 0.0

    def update(self, steps: int, elapsed_s: float, pair_interactions: int) -> None:
        self.total_steps += steps
        self.total_time += elapsed_s
        per_step = elapsed_s / max(steps, 1)
        self.ms_per_step = self.ema.update(per_step * 1e3)
        if per_step > 0:
            self.steps_per_s = 1.0 / per_step
            self.gints_per_s = pair_interactions / per_step / 1e9
        else:
            self.steps_per_s = float("inf")
            self.gints_per_s = float("inf")


class Timer:
    """Simple perf_counter timer usable as a context manager."""

    def __init__(self):
        self.elapsed = 0.0
        self._t0 = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self._t0
        return False


@contextlib.contextmanager
def device_trace(path: str | None):
    """Optional ``jax.profiler`` trace (Perfetto/XPlane dump) around a block
    — the deep-dive analog of the reference's timestamp queries."""
    if path is None:
        yield
        return
    import jax

    with jax.profiler.trace(path):
        yield
