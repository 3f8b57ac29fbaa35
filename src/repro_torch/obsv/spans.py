"""Lightweight nested wall-clock spans with optional JSONL emission.

The port of ``repro.obsv.spans.SpanTracer``. A span is one stage of the
detection path (``ingest`` → ``fused_step`` → ``host_tail``, or the batch
driver's ``fingerprint_stats`` → ``hashgen`` → ``fused_step`` →
``host_tail``). Entering and leaving is two clock reads and a dict
update, so the tracer stays on; per-name totals accumulate whatever the
sink, which is how ``core.detect.StageTimes`` and the streaming
telemetry attribute wall time. The JSONL event log is opt-in (pass
``jsonl_path``), one record a line::

    {"ts": 1754660000.1, "name": "fused_step", "path": "ingest/fused_step",
     "depth": 1, "dur_s": 0.0021, "station": 0}

``profile()`` brackets a region with a ``torch.profiler`` trace (CPU and,
where there is one, CUDA activity), written as a Chrome trace into
``profile_dir``; without ``profile_dir`` it is a no-op context.
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from typing import IO, Callable


class SpanTracer:
    def __init__(self, jsonl_path: str | None = None,
                 clock: Callable[[], float] = time.perf_counter,
                 profile_dir: str | None = None):
        self.clock = clock
        self.jsonl_path = jsonl_path
        self.profile_dir = profile_dir
        self._fh: IO | None = None
        self._stack: list[str] = []
        self._profiles = 0
        # name -> [count, total_s]; insertion-ordered = first-entered order
        self.totals: dict[str, list] = {}

    @contextlib.contextmanager
    def span(self, name: str, **attrs):
        self._stack.append(name)
        t0 = self.clock()
        try:
            yield self
        finally:
            dt = self.clock() - t0
            path = "/".join(self._stack)
            self._stack.pop()
            tot = self.totals.setdefault(name, [0, 0.0])
            tot[0] += 1
            tot[1] += dt
            if self.jsonl_path is not None:
                rec = {"ts": time.time(), "name": name, "path": path,
                       "depth": len(self._stack), "dur_s": dt}
                rec.update(attrs)
                if self._fh is None:
                    self._fh = open(self.jsonl_path, "a")
                self._fh.write(json.dumps(rec) + "\n")

    def total_s(self, name: str) -> float:
        return self.totals.get(name, (0, 0.0))[1]

    def summary(self) -> dict:
        return {name: {"count": c, "total_s": t}
                for name, (c, t) in self.totals.items()}

    @contextlib.contextmanager
    def profile(self):
        """Bracket a region with a ``torch.profiler`` trace, written to
        ``profile_dir/trace_<n>.json`` (no-op without ``profile_dir``)."""
        if self.profile_dir is None:
            yield
            return
        import torch
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts) as prof:
            yield
        os.makedirs(self.profile_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(
            self.profile_dir, f"trace_{self._profiles}.json"))
        self._profiles += 1

    def flush(self):
        if self._fh is not None:
            self._fh.flush()

    def close(self):
        if self._fh is not None:
            self._fh.close()
            self._fh = None
