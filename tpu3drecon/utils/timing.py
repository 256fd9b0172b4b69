"""Timing + profiling utilities: the compile/run split and traces.

Formalizes the reference's measurement discipline (reference:
src/benchmark/jaxopt_benchmark/benchmark_pose_optimization.py:165-182 —
perf_counter brackets with an explicit compile-vs-run split and
block_until_ready) as reusable helpers, and adds jax.profiler trace capture
(SURVEY.md §5 'tracing/profiling' upgrade).
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import jax


@dataclass
class CompileRunTimer:
    """Measures the first (compile+run) call separately from steady-state."""

    compile_time: Optional[float] = None
    run_times: List[float] = field(default_factory=list)

    def measure(self, fn: Callable, *args, repeats: int = 1, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        jax.block_until_ready(out)
        first = time.perf_counter() - t0
        for _ in range(repeats):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            jax.block_until_ready(out)
            self.run_times.append(time.perf_counter() - t0)
        run = min(self.run_times) if self.run_times else 0.0
        self.compile_time = max(first - run, 0.0)
        return out

    @property
    def best_run(self) -> float:
        return min(self.run_times) if self.run_times else float("nan")


@contextlib.contextmanager
def stopwatch(label: str, sink: Optional[Dict[str, float]] = None):
    """Simple perf_counter bracket; results printed or collected."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        elapsed = time.perf_counter() - t0
        if sink is not None:
            sink[label] = sink.get(label, 0.0) + elapsed
        else:
            print(f"[stopwatch] {label}: {elapsed:.4f}s")


@contextlib.contextmanager
def profiler_trace(log_dir: str, enabled: bool = True):
    """Capture a jax.profiler trace (view with TensorBoard / xprof)."""
    if not enabled:
        yield
        return
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
