"""Lightweight nested wall-clock spans.

A minimal copy of ``repro.obsv.spans.SpanTracer``: entering and leaving a
span is two clock reads and a dict update, and per-name totals
accumulate, which is how ``core.detect.StageTimes`` attributes stage wall
time. The JSONL sink and the profiler hook come with a later slice.
"""
from __future__ import annotations

import contextlib
import time
from typing import Callable


class SpanTracer:
    def __init__(self, clock: Callable[[], float] = time.perf_counter):
        self.clock = clock
        # name -> [count, total_s]; insertion-ordered = first-entered order
        self.totals: dict[str, list] = {}

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = self.clock()
        try:
            yield self
        finally:
            tot = self.totals.setdefault(name, [0, 0.0])
            tot[0] += 1
            tot[1] += self.clock() - t0

    def total_s(self, name: str) -> float:
        return self.totals.get(name, (0, 0.0))[1]
