"""Streaming telemetry hub: the detector's counters, wall-time histograms,
step watchdog and spans.

PyTorch-port counterpart of ``repro.stream.telemetry``, as far as the
detector and ``engine.ingest_chunks`` call it. One
:class:`StreamTelemetry` per detector (shared by its stations) ties the
``obsv`` primitives to the detection path:

* **step counters** — every step returns the ``index.QC_FIELDS`` counter
  vector beside its pairs; ``record_step`` mirrors it into per-station
  registry counters (``step_<field>_total``), which ``drop_breakdown``
  and ``drop_rates`` read back.
* **wall-time histograms** — chunk ingest, device step (``fused_step``,
  ended by the step's one device→host copy, so it covers device time) and
  host tail, labelled per station (``station="pool"`` for a pooled step).
* **StepWatchdog** (``train.watchdog``) around each device step; flagged
  steps count in ``straggler_steps_total``.
* **spans** — an ``obsv.SpanTracer`` whose per-name totals attribute the
  stream's wall time (``ingest``, and inside it ``dup_hash`` — the
  sample-exact duplicate guard — ``fused_step`` and ``host_tail``).
* **health** — ``heartbeat(det)``: real-time factor, throughput, drop
  rates and quality counters.

Not ported yet (ROADMAP queue 1 item 2): the serving hooks
(``record_serve_*``, ``serve_view``), the Prometheus exposition
(``prometheus``, ``write_prometheus``), ``metrics_snapshot`` and the
registry's ride inside detector snapshots. The heartbeat therefore has
no ``serve`` entry.
"""
from __future__ import annotations

import json
import time

import numpy as np

from repro_torch.obsv.metrics import MetricsRegistry, merge_counts
from repro_torch.obsv.spans import SpanTracer
from repro_torch.stream.index import QC_FIELDS
from repro_torch.train.watchdog import StepWatchdog, WatchdogConfig


class StreamTelemetry:
    def __init__(self, n_stations: int = 1, *,
                 registry: MetricsRegistry | None = None,
                 tracer: SpanTracer | None = None,
                 watchdog: StepWatchdog | None = None,
                 clock=time.perf_counter):
        self.n_stations = n_stations
        self.registry = registry or MetricsRegistry()
        self.tracer = tracer or SpanTracer()
        if watchdog is None:
            watchdog = StepWatchdog(WatchdogConfig(hang_timeout_s=60.0),
                                    on_straggler=self._on_straggler)
        else:                       # chain the caller's policy with ours
            prev = watchdog.on_straggler
            watchdog.on_straggler = \
                lambda info: (prev(info), self._on_straggler(info))[0]
        self.watchdog = watchdog
        self.clock = clock
        self.t_start: float | None = None   # first chunk arrival

    def _on_straggler(self, info: dict) -> None:
        self.registry.counter("straggler_steps_total").inc()

    # -- recording hooks (called from the engine) ----------------------------

    def start(self) -> None:
        if self.t_start is None:
            self.t_start = self.clock()

    def uptime_s(self) -> float:
        if self.t_start is None:
            return 0.0
        return self.clock() - self.t_start

    def record_chunk(self, station: int, wall_s: float, samples: int) -> None:
        s = str(station)
        self.registry.counter("chunks_total", station=s).inc()
        self.registry.counter("samples_total", station=s).inc(samples)
        self.registry.histogram("chunk_ingest_wall_seconds",
                                station=s).record(wall_s)

    def record_step(self, station: int, qc: np.ndarray) -> None:
        """Mirror one step's counter vector into the registry."""
        s = str(station)
        for name, v in zip(QC_FIELDS, np.asarray(qc).reshape(-1)):
            self.registry.counter(f"step_{name}_total", station=s).inc(int(v))

    def record_fused_wall(self, label: str, wall_s: float) -> None:
        self.registry.histogram("fused_step_wall_seconds",
                                station=label).record(wall_s)

    def record_host_tail(self, station, wall_s: float) -> None:
        self.registry.histogram("host_tail_wall_seconds",
                                station=str(station)).record(wall_s)

    # -- derived views -------------------------------------------------------

    def drop_breakdown(self) -> dict:
        """Step counters summed over stations (QC layout)."""
        return {name: int(self.registry.total(f"step_{name}_total"))
                for name in QC_FIELDS}

    def drop_rates(self) -> dict:
        """Per-guard drop rates relative to the raw pair/collision flow."""
        d = self.drop_breakdown()
        emitted = d["pairs_emitted"]
        denom = max(emitted + d["limited_pairs"], 1)
        raw = max(d["raw_collisions"], 1)
        return {
            "limited_pairs": round(d["limited_pairs"] / denom, 6),
            "quarantined_collisions":
                round(d["quarantined_collisions"] / raw, 6),
            "masked_fingerprints": round(
                d["masked_fingerprints"]
                / max(d["masked_fingerprints"] + emitted, 1), 6),
        }

    def stream_seconds(self, det) -> float:
        """Stream seconds the detector has taken in (stations ingest in
        lockstep, so the least-fed station's sample count)."""
        fs = det.cfg.fingerprint.fs
        if not det.stations:
            return 0.0
        return min(st.stats.samples for st in det.stations) / fs

    def real_time_factor(self, det) -> float:
        """Stream seconds per wall second since the first chunk (> 1 keeps
        up with real time)."""
        return self.stream_seconds(det) / max(self.uptime_s(), 1e-9)

    def heartbeat(self, det) -> dict:
        """The periodic liveness record (``ingest_chunks`` prints it)."""
        chunks = int(self.registry.total("chunks_total"))
        wall = self.uptime_s()
        return {
            "uptime_s": round(wall, 3),
            "stream_s": round(self.stream_seconds(det), 3),
            "rtf": round(self.real_time_factor(det), 3),
            "chunks": chunks,
            "pairs": int(self.registry.total("step_pairs_emitted_total")),
            "fp_per_s": [
                round(st.stats.fingerprints / max(wall, 1e-9), 1)
                for st in det.stations],
            "drop_rates": self.drop_rates(),
            "quality": det.quality_summary(),
            "stragglers": int(self.registry.total("straggler_steps_total")),
        }

    def heartbeat_line(self, det) -> str:
        return "HEARTBEAT " + json.dumps(self.heartbeat(det))


def quality_view(ring_quality: dict, qc: dict) -> dict:
    """One station's quality summary: ingest reconciliation counters +
    step guard counters, merged on the one aggregation path
    (``merge_counts``). The key set is the reference's."""
    return merge_counts([ring_quality, qc])
