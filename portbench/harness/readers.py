"""What the per-layer readers under ``metrics/`` share. Each reader file
binds one of these to its metric's key, kernel or trace; a reader that
finds nothing to read returns None, and the metric is left out."""
from __future__ import annotations


def span_mean(key: str):
    """The mean of the window's readings of span ``key`` (ms)."""
    def read(ctx: dict):
        vals = ctx.get("spans", {}).get(key) or []
        return sum(vals) / len(vals) if vals else None
    return read


def counter(key: str):
    """A number the mode counted, as it is."""
    def read(ctx: dict):
        return ctx.get(key)
    return read


def roofline(kernel: str):
    """Share (%) of its roofline that ``kernel`` reaches in the traced
    stretch: the least time of its launches there (``bound_ms``, from the
    frozen cost model at the cell's shapes and data) over their device
    time in the trace."""
    def read(ctx: dict):
        bound = ctx.get("bound_ms", {}).get(kernel)
        prof = ctx.get("trace")
        spent = prof.kernel_ms(kernel) if prof is not None else 0.0
        return 100.0 * bound / spent if bound and spent else None
    return read


def idle(ctx: dict):
    """Share (%) of the traced stretch in which no operation ran on the
    device (kernels, copies and sets, overlaps counted once)."""
    prof = ctx.get("trace")
    if prof is None or prof.window_s <= 0:
        return None
    return 100.0 * (1.0 - prof.busy_s / prof.window_s)
