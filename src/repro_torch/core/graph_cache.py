"""The §3.6 graph tiers, for an eager runtime.

``repro.core.graph_cache`` compiles one executable per (phase, domain
version, shape bucket) and times three tiers: **precompiled** (built at
start-up for the anticipated failure scenario; recovery pays a lookup),
**cached** (re-lowered, backend compile served from the on-disk cache)
and **cold**.  The port runs eagerly — there is no compiler, and
capturing CUDA graphs per tier is a later step — so a "graph" here is
the registered step callable.  Every lookup is still timed and recorded
as a :class:`CompileTiming` under the same tier names, so a recovery
report's ``compile_source == "precompiled"`` keeps its meaning: the
post-failure step was registered before the fault.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple


# The tiers of a lookup that built the step's graph during the step (today
# the first lookup of a key; once steps are captured as CUDA graphs, the
# capture too): such a step's wall time is no straggler sample.
FRESH_SOURCES = ("cached", "cold")


@dataclass
class CompileTiming:
    source: str            # 'precompiled' | 'cached' | 'cold'
    read_cache_s: float
    compile_s: float
    key: Tuple = ()


class GraphCache:
    def __init__(self, persist_dir: Optional[str] = None):
        """persist_dir: names the on-disk cache tier ('cached' instead of
        'cold' for a miss); nothing is written there yet."""
        self.persist_dir = persist_dir
        self._exec: Dict[Tuple, Any] = {}
        self.timings: list[CompileTiming] = []

    def fresh_since(self, n: int) -> bool:
        """Whether a lookup after the first ``n`` timings built a graph
        (a tier in :data:`FRESH_SOURCES`)."""
        return any(t.source in FRESH_SOURCES for t in self.timings[n:])

    def __contains__(self, key) -> bool:
        return key in self._exec

    def precompile(self, key: Tuple, fn: Callable) -> CompileTiming:
        """Register ``fn`` now so recovery finds it ready."""
        t0 = time.perf_counter()
        self._exec[key] = fn
        tm = CompileTiming("precompiled", 0.0, time.perf_counter() - t0, key)
        self.timings.append(tm)
        return tm

    def get_or_compile(self, key: Tuple, fn: Optional[Callable]
                       ) -> Tuple[Any, CompileTiming]:
        """Recovery-time lookup: a precompiled hit costs a dict lookup;
        otherwise ``fn`` is registered under the miss tier, timed."""
        if key in self._exec:
            tm = CompileTiming("precompiled", 0.0, 0.0, key)
            self.timings.append(tm)
            return self._exec[key], tm
        t0 = time.perf_counter()
        self._exec[key] = fn
        source = "cached" if self.persist_dir else "cold"
        tm = CompileTiming(source, 0.0, time.perf_counter() - t0, key)
        self.timings.append(tm)
        return fn, tm

    def invalidate(self, predicate: Callable[[Tuple], bool]) -> int:
        drop = [k for k in self._exec if predicate(k)]
        for k in drop:
            del self._exec[k]
        return len(drop)
