"""Reduction of a ``torch.profiler`` trace of a steady stretch.

The stretch is traced with CPU and CUDA activity and exported as a
Chrome trace into ``$TMPDIR`` once the window has closed (deleted once
read). From it: the length of the stretch, the seconds in which some
device operation ran (kernels, copies, sets; overlaps counted once), each
device operation's total time by name, each kernel's device time and
launches (names mapped by ``cost.kernel_of``), and the longest idle gaps
of the device, each named by what the host was doing at its middle (the
innermost CPU-side event that covers it).
"""
from __future__ import annotations

import contextlib
import json
import os
import tempfile

from harness import cost

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime")


class Summary:
    def __init__(self, events: list[dict]):
        spans = [e for e in events if e.get("ph") == "X" and "dur" in e]
        dev = [e for e in spans if e.get("cat") in DEVICE_CATS]
        self.host = [e for e in spans if e.get("cat") in HOST_CATS]
        self.start = min(e["ts"] for e in spans) if spans else 0.0
        self.end = max(e["ts"] + e["dur"] for e in spans) if spans else 0.0
        self.by_name: dict[str, float] = {}
        self.kernel_us: dict[str, float] = {}
        self.launches: dict[str, int] = {}
        for e in dev:
            self.by_name[e["name"]] = self.by_name.get(e["name"], 0) + e["dur"]
            k = cost.kernel_of(e["name"]) if e["cat"] == "kernel" else None
            if k is not None:
                self.kernel_us[k] = self.kernel_us.get(k, 0.0) + e["dur"]
                self.launches[k] = self.launches.get(k, 0) + 1
        self.busy: list[tuple[float, float]] = []
        for a, b in sorted((e["ts"], e["ts"] + e["dur"]) for e in dev):
            if self.busy and a <= self.busy[-1][1]:
                self.busy[-1] = (self.busy[-1][0], max(self.busy[-1][1], b))
            else:
                self.busy.append((a, b))

    @property
    def window_s(self) -> float:
        return (self.end - self.start) * 1e-6

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy) * 1e-6

    def kernel_ms(self, kernel: str) -> float:
        return self.kernel_us.get(kernel, 0.0) * 1e-3

    def device_ops(self, k: int = 10) -> list[list]:
        top = sorted(self.by_name.items(), key=lambda kv: -kv[1])[:k]
        return [[name, us * 1e-6] for name, us in top]

    def _host_at(self, t: float) -> str:
        best = None
        for e in self.host:
            if e["ts"] <= t <= e["ts"] + e["dur"] and (
                    best is None or e["ts"] >= best["ts"]):
                best = e
        return best["name"] if best else "host (no traced op)"

    def idle_gaps(self, k: int = 10) -> list[list]:
        edges = [self.start] + [x for ab in self.busy for x in ab] + [self.end]
        gaps = [(edges[i + 1] - edges[i], edges[i])
                for i in range(0, len(edges) - 1, 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(reverse=True)
        return [[self._host_at(t0 + g / 2), g * 1e-6] for g, t0 in gaps[:k]]


class Stretch:
    """One traced stretch: ``start()`` and ``stop()`` bracket it inside the
    window; ``summary()``, after the window has closed, exports the trace
    and reduces it, so the export's seconds fall in no measured stretch."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile
        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])

    def start(self) -> None:
        self._prof.start()

    def stop(self) -> None:
        import torch
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._prof.stop()

    def summary(self) -> Summary:
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as fh:
                return Summary(json.load(fh).get("traceEvents", []))
        finally:
            os.remove(path)


@contextlib.contextmanager
def profiled(out: list):
    """Trace the block; appends its ``Stretch`` to ``out``."""
    stretch = Stretch()
    stretch.start()
    try:
        yield stretch
    finally:
        stretch.stop()
        out.append(stretch)
