"""Readers of the program's own spans in a traced stretch.

While a ``torch.profiler`` records, each span of ``repro_torch.obsv.spans``
is a ``user_annotation`` event of its name in the trace, on the clock of
the device's kernels and copies (``trace.Summary.host`` and
``Summary.busy``). The serving engine's dispatched tick is the span
``serve.tick``, with the children ``serve.admit``, ``serve.assemble``,
``serve.step``, ``serve.fetch`` and ``serve.unpack``. A program without
these spans leaves no such event, and every reader returns None.
"""
from __future__ import annotations

import bisect

TICK = "serve.tick"


def _spans(prof, name: str) -> list[tuple[float, float]]:
    """(start, end) µs of the trace's annotations named ``name``, sorted."""
    return sorted((e["ts"], e["ts"] + e["dur"]) for e in prof.host
                  if e.get("cat") == "user_annotation" and e["name"] == name)


def _overlap(iv: list[tuple[float, float]], a: float, b: float) -> float:
    """Length of [a, b] covered by the sorted, disjoint intervals ``iv``."""
    i = max(0, bisect.bisect_right(iv, (a, float("inf"))) - 1)
    got = 0.0
    while i < len(iv) and iv[i][0] < b:
        got += max(0.0, min(b, iv[i][1]) - max(a, iv[i][0]))
        i += 1
    return got


def per_tick_ms(*children: str):
    """Mean milliseconds a ``serve.tick`` spends in its ``children``
    spans: their durations inside ticks, summed, over the ticks."""
    def read(ctx: dict):
        prof = ctx.get("trace")
        ticks = _spans(prof, TICK) if prof is not None else []
        if not ticks:
            return None
        starts = [a for a, _ in ticks]
        inside = 0.0
        for name in children:
            for a, b in _spans(prof, name):
                i = bisect.bisect_right(starts, a) - 1
                if i >= 0 and b <= ticks[i][1]:
                    inside += b - a
        return inside / len(ticks) * 1e-3
    return read


def idle_in_tick(ctx: dict):
    """Share (%) of the traced stretch in which the device ran nothing
    (no kernel, copy or set) while the host was inside a ``serve.tick``;
    the device's whole idle share less this is its idle time between
    ticks."""
    prof = ctx.get("trace")
    ticks = _spans(prof, TICK) if prof is not None else []
    if not ticks or prof.window_s <= 0:
        return None
    idle = sum((b - a) - _overlap(prof.busy, a, b) for a, b in ticks)
    return 100.0 * idle * 1e-6 / prof.window_s
