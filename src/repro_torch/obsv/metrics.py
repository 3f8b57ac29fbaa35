"""Host metrics registry: counters, gauges, log-bucketed histograms.

Pure Python, copied from ``repro.obsv.metrics`` (the port imports nothing
of the reference package).

Every metric is O(1) memory — histograms are a fixed array of
power-of-two buckets, not a sample list — so a detector can run for
months without its telemetry growing.

Metrics carry a label mapping (``station="3"``); the registry indexes by
``(name, sorted labels)`` so the same metric name fans out per station
while aggregate views (``total``) sum across labels. ``snapshot()``
returns a plain JSON-able dict and ``restore()`` rebuilds from it, so the
registry can ride inside a detector checkpoint.

``render_prometheus`` emits the text exposition format
(https://prometheus.io/docs/instrumenting/exposition_formats/) consumed
by the serving tier's metrics file.
"""
from __future__ import annotations

import math


class Counter:
    """Monotonic counter. ``set_total`` exists only to mirror counts that
    are authoritatively kept elsewhere (e.g. ring quality dicts) into the
    exposition — it never goes backwards."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def inc(self, n: int | float = 1):
        self.value += n

    def set_total(self, v: int | float):
        self.value = max(self.value, v)


class Gauge:
    """Point-in-time value (host_state_rows, real-time factor, ...)."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float):
        self.value = float(v)


class Histogram:
    """Log-bucketed wall-time histogram with fixed memory.

    Buckets are powers of two spanning ``[lo, lo * 2**(n_buckets-1))``
    seconds (defaults cover ~8 µs .. ~2 min); values outside clamp to the
    edge buckets. Tracks count/sum/min/max exactly, percentiles to
    bucket resolution (each estimate returns the upper edge of the
    bucket holding that rank — a ≤ 2x overestimate, fine for p50/p95
    monitoring).
    """

    __slots__ = ("lo", "counts", "total", "count", "vmin", "vmax")

    N_BUCKETS = 25

    def __init__(self, lo: float = 2.0 ** -17):
        self.lo = float(lo)
        self.counts = [0] * self.N_BUCKETS
        self.total = 0.0
        self.count = 0
        self.vmin = math.inf
        self.vmax = -math.inf

    def _bucket(self, v: float) -> int:
        if v <= self.lo:
            return 0
        i = int(math.ceil(math.log2(v / self.lo)))
        return min(i, self.N_BUCKETS - 1)

    def record(self, v: float):
        v = float(v)
        self.counts[self._bucket(v)] += 1
        self.total += v
        self.count += 1
        self.vmin = min(self.vmin, v)
        self.vmax = max(self.vmax, v)

    def edges(self) -> list[float]:
        """Upper edge of each bucket (the Prometheus ``le`` labels)."""
        return [self.lo * 2.0 ** i for i in range(self.N_BUCKETS)]

    def percentile(self, q: float) -> float:
        if self.count == 0:
            return 0.0
        rank = q * self.count
        acc = 0
        for i, c in enumerate(self.counts):
            acc += c
            if acc >= rank:
                return min(self.lo * 2.0 ** i, self.vmax)
        return self.vmax

    def summary(self) -> dict:
        return {"count": self.count, "sum": self.total,
                "min": 0.0 if self.count == 0 else self.vmin,
                "max": 0.0 if self.count == 0 else self.vmax,
                "p50": self.percentile(0.50), "p95": self.percentile(0.95)}


def _label_key(labels: dict) -> tuple:
    return tuple(sorted(labels.items()))


def _label_str(key: tuple) -> str:
    if not key:
        return ""
    return "{" + ",".join(f'{k}="{v}"' for k, v in key) + "}"


class MetricsRegistry:
    """Name + labels → metric instance; one registry per detector."""

    def __init__(self):
        # name -> kind ("counter"|"gauge"|"histogram"), insertion-ordered
        self._kinds: dict[str, str] = {}
        # (name, label_key) -> metric
        self._metrics: dict[tuple, object] = {}

    def _get(self, kind: str, cls, name: str, labels: dict):
        have = self._kinds.setdefault(name, kind)
        assert have == kind, f"{name} already registered as {have}"
        key = (name, _label_key(labels))
        m = self._metrics.get(key)
        if m is None:
            m = self._metrics[key] = cls()
        return m

    def counter(self, name: str, **labels) -> Counter:
        return self._get("counter", Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get("gauge", Gauge, name, labels)

    def histogram(self, name: str, **labels) -> Histogram:
        return self._get("histogram", Histogram, name, labels)

    def total(self, name: str) -> float:
        """Sum of a counter/gauge across all label sets (0 if absent)."""
        return sum(m.value for (n, _), m in self._metrics.items()
                   if n == name)

    def histogram_merged(self, name: str) -> Histogram:
        """All label sets of a histogram folded into one (for summaries)."""
        out = Histogram()
        for (n, _), m in self._metrics.items():
            if n == name:
                out.lo = m.lo
                out.counts = [a + b for a, b in zip(out.counts, m.counts)]
                out.total += m.total
                out.count += m.count
                out.vmin = min(out.vmin, m.vmin)
                out.vmax = max(out.vmax, m.vmax)
        return out

    # -- persistence --------------------------------------------------------

    def snapshot(self) -> dict:
        counters, gauges, histograms = [], [], []
        for (name, key), m in self._metrics.items():
            labels = dict(key)
            kind = self._kinds[name]
            if kind == "counter":
                counters.append({"name": name, "labels": labels,
                                 "value": m.value})
            elif kind == "gauge":
                gauges.append({"name": name, "labels": labels,
                               "value": m.value})
            else:
                histograms.append({
                    "name": name, "labels": labels, "lo": m.lo,
                    "counts": list(m.counts), "sum": m.total,
                    "count": m.count,
                    "min": None if m.count == 0 else m.vmin,
                    "max": None if m.count == 0 else m.vmax})
        return {"schema": "metrics/v1", "counters": counters,
                "gauges": gauges, "histograms": histograms}

    def restore(self, snap: dict):
        self._kinds.clear()
        self._metrics.clear()
        for c in snap.get("counters", []):
            self.counter(c["name"], **c["labels"]).value = c["value"]
        for g in snap.get("gauges", []):
            self.gauge(g["name"], **g["labels"]).value = g["value"]
        for h in snap.get("histograms", []):
            m = self.histogram(h["name"], **h["labels"])
            m.lo = h["lo"]
            m.counts = list(h["counts"])
            m.total = h["sum"]
            m.count = h["count"]
            m.vmin = math.inf if h["min"] is None else h["min"]
            m.vmax = -math.inf if h["max"] is None else h["max"]

    def render(self, namespace: str = "repro") -> str:
        return render_prometheus(self, namespace=namespace)


def render_prometheus(reg: MetricsRegistry, namespace: str = "repro") -> str:
    """Prometheus text exposition (version 0.0.4) of a registry."""
    lines: list[str] = []
    for name, kind in reg._kinds.items():
        full = f"{namespace}_{name}"
        lines.append(f"# TYPE {full} {kind}")
        for (n, key), m in reg._metrics.items():
            if n != name:
                continue
            ls = _label_str(key)
            if kind in ("counter", "gauge"):
                lines.append(f"{full}{ls} {_fmt(m.value)}")
            else:
                acc = 0
                for edge, c in zip(m.edges(), m.counts):
                    acc += c
                    el = _label_str(key + (("le", _fmt(edge)),))
                    lines.append(f"{full}_bucket{el} {acc}")
                el = _label_str(key + (("le", "+Inf"),))
                lines.append(f"{full}_bucket{el} {m.count}")
                lines.append(f"{full}_sum{ls} {_fmt(m.total)}")
                lines.append(f"{full}_count{ls} {m.count}")
    return "\n".join(lines) + "\n"


def _fmt(v) -> str:
    if isinstance(v, int):
        return str(v)
    return repr(float(v))


def merge_counts(dicts) -> dict:
    """Key-wise integer sum of count dicts, first-seen key order.

    The single aggregation path behind every quality/drop summary
    (``StationStream.quality_summary``, the pooled
    ``StreamingDetector.quality_summary``, ``metrics_snapshot`` drop
    breakdowns) — one implementation, identical keys everywhere.
    """
    out: dict = {}
    for d in dicts:
        for k, v in d.items():
            out[k] = out.get(k, 0) + int(v)
    return out
