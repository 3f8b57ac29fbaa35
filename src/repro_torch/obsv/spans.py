"""Lightweight nested wall-clock spans with optional JSONL emission, on
the profiler's timeline.

The port of ``repro.obsv.spans.SpanTracer``. A span is one stage of the
detection path (``ingest`` → ``fused_step`` → ``host_tail``, or the batch
driver's ``fingerprint_stats`` → ``hashgen`` → ``fused_step`` →
``host_tail``) or of the serving tick (``serve.tick`` → ``serve.admit`` …
``serve.unpack``). Entering and leaving is two clock reads, a dict update
and one check whether a ``torch.profiler`` is recording, so the tracer
stays on; per-name totals accumulate whatever the sink, which is how
``core.detect.StageTimes`` and the streaming telemetry attribute wall
time. The JSONL event log is opt-in (pass ``jsonl_path``), one record a
line, written when the span ends::

    {"ts": 1754660000.1, "name": "fused_step", "path": "ingest/fused_step",
     "depth": 1, "dur_s": 0.0021, "id": 7, "parent": 6, "station": 0}

``ts`` is the span's start in Unix seconds: the clock reading its
``dur_s`` starts from, moved onto the clock of a ``torch.profiler``
Chrome trace (an event starts at ``baseTimeNanoseconds`` + its ``ts``
µs, in Unix time) by an offset taken when the tracer is built; with a
clock other than the default ``time.perf_counter``, ``ts`` is that
clock's reading. ``id`` numbers the tracer's spans from 1; ``parent`` is
the enclosing span's id (null at the top). ``record`` writes a span whose
ends lie in different calls, such as a request's lifetime, with
``parent`` null.

**The profiler bridge.** While a ``torch.profiler`` records, every span
also opens ``torch.profiler.record_function(name)``, so the spans appear
in its trace as ``user_annotation`` events (and, with CUDA activity, as
device-side annotation ranges) on the kernels' timeline. With no profiler
running no ``record_function`` is entered: that costs about 18 µs, the
check 0.2 µs. Library functions, which hold no tracer, use
``bridge(name)`` (or the decorator ``traced(name)``): the gated
annotation alone, with no totals and no record.
"""
from __future__ import annotations

import contextlib
import functools
import json
import time
from typing import IO, Callable

import torch

_NOOP = contextlib.nullcontext()
_recording = torch.autograd._profiler_enabled


def bridge(name: str):
    """``torch.profiler.record_function(name)`` while a profiler records,
    else a context that does nothing."""
    if _recording():
        return torch.profiler.record_function(name)
    return _NOOP


def traced(name: str):
    """Decorator: the function runs inside ``bridge(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def run(*args, **kw):
            with bridge(name):
                return fn(*args, **kw)
        return run
    return wrap


class SpanTracer:
    def __init__(self, jsonl_path: str | None = None,
                 clock: Callable[[], float] = time.perf_counter):
        self.clock = clock
        self.jsonl_path = jsonl_path
        # a reading of the default clock + epoch = Unix seconds, the clock
        # of the profiler's trace; another clock's ``ts`` is its own reading
        self.epoch = (time.time() - time.perf_counter()
                      if clock is time.perf_counter else 0.0)
        self._fh: IO | None = None
        self._stack: list[str] = []
        self._ids: list[int] = []
        self._last_id = 0
        # name -> [count, total_s]; insertion-ordered = first-entered order
        self.totals: dict[str, list] = {}

    @contextlib.contextmanager
    def span(self, name: str, **attrs):
        """Time the block as span ``name``. Yields ``attrs``: what the
        block adds to it is written with the record."""
        with bridge(name):
            ids = self._ids
            parent = ids[-1] if ids else None
            self._last_id = sid = self._last_id + 1
            ids.append(sid)
            self._stack.append(name)
            t0 = self.clock()
            try:
                yield attrs
            finally:
                dt = self.clock() - t0
                path = "/".join(self._stack)
                self._stack.pop()
                ids.pop()
                tot = self.totals.setdefault(name, [0, 0.0])
                tot[0] += 1
                tot[1] += dt
                if self.jsonl_path is not None:
                    self._write(t0, name, path, len(self._stack), dt, sid,
                                parent, attrs)

    def record(self, name: str, start: float, dur: float, **attrs) -> None:
        """A span of ``dur`` seconds from ``start`` (a reading of
        ``clock``) that began in another call: counted in the totals and
        written with depth 0 and no parent."""
        self._last_id += 1
        tot = self.totals.setdefault(name, [0, 0.0])
        tot[0] += 1
        tot[1] += dur
        if self.jsonl_path is not None:
            self._write(start, name, name, 0, dur, self._last_id, None, attrs)

    def _write(self, t0, name, path, depth, dt, sid, parent, attrs) -> None:
        rec = {"ts": self.epoch + t0, "name": name, "path": path,
               "depth": depth, "dur_s": dt, "id": sid, "parent": parent}
        rec.update(attrs)
        if self._fh is None:
            self._fh = open(self.jsonl_path, "a")
        self._fh.write(json.dumps(rec) + "\n")

    def total_s(self, name: str) -> float:
        return self.totals.get(name, (0, 0.0))[1]

    def summary(self) -> dict:
        return {name: {"count": c, "total_s": t}
                for name, (c, t) in self.totals.items()}

    def flush(self):
        if self._fh is not None:
            self._fh.flush()

    def close(self):
        if self._fh is not None:
            self._fh.close()
            self._fh = None
