"""Per-phase prover profiling (SURVEY §5 names this greenfield work: the
reference declares a `profile` feature with zero uses, Cargo.toml:76).

Usage:
    from sha2cq_tpu.utils.profiling import profiler
    with profiler.phase("h_eval"):
        ...
    print(profiler.report())

Enabled when SHA2CQ_PROFILE is set (any nonempty value) or after
profiler.enable(); zero overhead otherwise (a no-op context manager).
Optionally wraps the JAX device profiler: set SHA2CQ_JAX_TRACE=/dir to
capture an xprof trace around every profiled region.
"""
from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple


class Profiler:
    def __init__(self):
        self._enabled = bool(os.environ.get("SHA2CQ_PROFILE"))
        self._trace_dir = os.environ.get("SHA2CQ_JAX_TRACE") or None
        self._records: "OrderedDict[str, Tuple[float, int]]" = OrderedDict()
        # per-thread phase stacks: the prover prefetches the device h
        # pipeline on a background thread, whose nested phases must not
        # corrupt the main thread's path nesting
        self._local = threading.local()

    @property
    def _stack(self) -> List[str]:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    # -- control
    def enable(self) -> None:
        self._enabled = True

    def disable(self) -> None:
        self._enabled = False

    @property
    def enabled(self) -> bool:
        return self._enabled

    def reset(self) -> None:
        self._records.clear()
        self._counts.clear()

    # -- measurement
    @contextlib.contextmanager
    def phase(self, name: str):
        """Time a named region.  Nested regions are recorded under
        'outer/inner' paths."""
        if not self._enabled:
            yield
            return
        self._stack.append(name)
        path = "/".join(self._stack)
        trace_ctx = contextlib.nullcontext()
        if self._trace_dir and len(self._stack) == 1:
            import jax
            trace_ctx = jax.profiler.trace(
                os.path.join(self._trace_dir, path.replace("/", "_")))
        t0 = time.perf_counter()
        try:
            with trace_ctx:
                yield
        finally:
            dt = time.perf_counter() - t0
            tot, cnt = self._records.get(path, (0.0, 0))
            self._records[path] = (tot + dt, cnt + 1)
            self._stack.pop()

    def marker(self, scope: str):
        """Sequential section timing with single-line call sites:

            mark = profiler.marker("create_proof")
            ...work...
            mark("witness")        # records time since marker creation
            ...more work...
            mark("commitments")    # records time since previous mark

        Each call records the elapsed time since the previous call under
        'scope/name'.  No-op when disabled."""
        if not self._enabled:
            return lambda name: None
        state = {"t": time.perf_counter()}

        def mark(name: str) -> None:
            now = time.perf_counter()
            path = f"{scope}/{name}"
            tot, cnt = self._records.get(path, (0.0, 0))
            self._records[path] = (tot + (now - state["t"]), cnt + 1)
            tot, cnt = self._records.get(scope, (0.0, 0))
            self._records[scope] = (tot + (now - state["t"]), cnt)
            state["t"] = now

        return mark

    def count(self, name: str, inc: int = 1) -> None:
        """Count an event (no timing): host<->device uploads, dispatches,
        fetches.  Reported as 'name = N' lines."""
        if not self._enabled:
            return
        self._counts[name] = self._counts.get(name, 0) + inc

    @property
    def _counts(self) -> Dict[str, int]:
        c = getattr(self, "_count_store", None)
        if c is None:
            c = self._count_store = {}
        return c

    # -- reporting
    def timings(self) -> Dict[str, float]:
        return {k: v[0] for k, v in self._records.items()}

    def counts(self) -> Dict[str, int]:
        return dict(self._counts)

    def report(self, title: str = "prover phases") -> str:
        if not self._records:
            return f"[{title}] (no profiling records)"
        total = sum(v[0] for k, v in self._records.items() if "/" not in k)
        lines = [f"[{title}] total {total:.3f}s"]
        for path, (dt, cnt) in self._records.items():
            indent = "  " * path.count("/")
            name = path.rsplit("/", 1)[-1]
            pct = 100.0 * dt / total if total and "/" not in path else 0.0
            suffix = f" ({pct:4.1f}%)" if "/" not in path else ""
            times = f" x{cnt}" if cnt > 1 else ""
            lines.append(f"  {indent}{name:<28s} {dt:8.3f}s{times}{suffix}")
        for name, n in sorted(self._counts.items()):
            lines.append(f"  {name:<30s} = {n}")
        return "\n".join(lines)

    def reset_counts(self) -> None:
        self._counts.clear()


profiler = Profiler()
