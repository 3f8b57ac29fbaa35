"""Streaming telemetry hub: the detector's counters, wall-time histograms,
step watchdog, spans and health surface.

PyTorch-port counterpart of ``repro.stream.telemetry``. One
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
  rates, quality counters and the serving tier's view; ``prometheus(det)``
  the text exposition, which ``write_prometheus`` rewrites atomically
  (``ingest_chunks(metrics_file=…)``, ``serve_detect --metrics-file``).
* **serving tier** — ``launch.serve_detect.ServeDetectEngine`` publishes
  through the same registry (``record_serve_*``): admission outcomes
  (``serve_requests_total{outcome=accepted|served|shed}``), per-tick
  queue-depth and slot gauges, and the queue-wait / service / latency
  histograms; ``serve_view()`` is their summary. The engine's ticks are
  spans of the hub's tracer.
* **location tier** — ``record_locate`` counts each migration-stack pass
  (groups in, located detections out, moveout rejections, the stack's
  wall); ``locate_view`` is their summary, all 0 without a location tier.

``metrics_snapshot(det)`` is the one structured view of a detector
(schema ``stream-metrics/v1``, the reference's keys). The registry, the
uptime and the watchdog's EMA ride inside detector snapshots
(``snapshot`` / ``restore``), so a restored service resumes its counters.
"""
from __future__ import annotations

import json
import os
import time

import numpy as np

from repro_torch.obsv.metrics import MetricsRegistry, merge_counts
from repro_torch.obsv.spans import SpanTracer
from repro_torch.stream.index import QC_FIELDS
from repro_torch.train.watchdog import StepWatchdog, WatchdogConfig

METRICS_SCHEMA = "stream-metrics/v1"


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
        self.raw_walls: dict[str, list] | None = None
        # uptime carried over restores (wall time is not checkpointable)
        self._uptime_base = 0.0

    def _on_straggler(self, info: dict) -> None:
        self.registry.counter("straggler_steps_total").inc()

    # -- recording hooks (called from the engine) ----------------------------

    def start(self) -> None:
        if self.t_start is None:
            self.t_start = self.clock()

    def uptime_s(self) -> float:
        if self.t_start is None:
            return self._uptime_base
        return self._uptime_base + (self.clock() - self.t_start)

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

    def capture_raw_walls(self) -> dict[str, list]:
        """Opt in to exact wall samples: the histograms are log-bucketed,
        so their percentiles are bucket upper edges; a benchmark that
        publishes percentiles computes them from these lists instead.
        Returns the ``{"fused_step": [...], "host_tail": [...]}`` lists
        that the two hooks below fill from now on."""
        if self.raw_walls is None:
            self.raw_walls = {"fused_step": [], "host_tail": []}
        return self.raw_walls

    def record_fused_wall(self, label: str, wall_s: float) -> None:
        if self.raw_walls is not None:
            self.raw_walls["fused_step"].append(wall_s)
        self.registry.histogram("fused_step_wall_seconds",
                                station=label).record(wall_s)

    def record_host_tail(self, station, wall_s: float) -> None:
        if self.raw_walls is not None:
            self.raw_walls["host_tail"].append(wall_s)
        self.registry.histogram("host_tail_wall_seconds",
                                station=str(station)).record(wall_s)

    # -- location tier ------------------------------------------------------

    def record_locate(self, groups: int, located: int, rejected: int,
                      wall: float) -> None:
        """One migration-stack pass over associated groups: how many went
        in, how many located detections came out, how many fell to the
        moveout-consistency gate, and the stack's wall time."""
        self.registry.counter("locate_passes_total").inc()
        self.registry.counter("locate_groups_total").inc(int(groups))
        self.registry.counter("located_detections_total").inc(int(located))
        self.registry.counter("moveout_rejected_total").inc(int(rejected))
        self.registry.histogram("locate_stack_wall_seconds").record(wall)

    def locate_view(self) -> dict:
        """Location-tier summary: stack passes, group flow, moveout
        rejections. All zero without a location tier."""
        reg = self.registry
        h = reg.histogram_merged("locate_stack_wall_seconds")
        return {
            "passes": int(reg.total("locate_passes_total")),
            "groups": int(reg.total("locate_groups_total")),
            "located": int(reg.total("located_detections_total")),
            "moveout_rejected": int(reg.total("moveout_rejected_total")),
            "stack_wall": {"count": h.count,
                           "p50_ms": round(h.percentile(0.50) * 1e3, 3),
                           "p95_ms": round(h.percentile(0.95) * 1e3, 3)},
        }

    # -- serving-tier hooks (called from ServeDetectEngine) ------------------

    def record_serve_admission(self, accepted: bool) -> None:
        """One admission decision: queued, or shed at the queue bound."""
        outcome = "accepted" if accepted else "shed"
        self.registry.counter("serve_requests_total", outcome=outcome).inc()
        if not accepted:
            self.registry.counter("serve_shed_total").inc()

    def record_serve_tick(self, active_slots: int, queue_depth: int) -> None:
        """One service tick: occupancy and backlog gauges, and a dispatch
        when any slot is active (idle ticks do not dispatch)."""
        self.registry.counter("serve_ticks_total").inc()
        if active_slots:
            self.registry.counter("serve_dispatches_total").inc()
            self.registry.counter("serve_slot_ticks_total").inc(active_slots)
        self.registry.gauge("serve_active_slots").set(active_slots)
        self.registry.gauge("serve_queue_depth").set(queue_depth)

    def record_serve_done(self, queue_wait_s: float, service_s: float,
                          latency_s: float) -> None:
        """One served request: where its latency went (queue wait against
        in-slot service)."""
        self.registry.counter("serve_requests_total", outcome="served").inc()
        self.registry.histogram("serve_queue_wait_seconds").record(
            queue_wait_s)
        self.registry.histogram("serve_service_seconds").record(service_s)
        self.registry.histogram("serve_latency_seconds").record(latency_s)

    def record_serve_refresh(self) -> None:
        self.registry.counter("serve_state_refreshes_total").inc()

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

    def serve_view(self) -> dict:
        """Serving-tier summary from the registry: admission outcomes,
        tick and dispatch counts, the live gauges and the (bucketed)
        latency split. All zero when no serving engine shares this hub."""
        reg = self.registry

        def hist_ms(name):
            h = reg.histogram_merged(name)
            return {"count": h.count,
                    "p50_ms": round(h.percentile(0.50) * 1e3, 3),
                    "p95_ms": round(h.percentile(0.95) * 1e3, 3)}

        def tot(name, **labels):
            if labels:
                return int(reg.counter(name, **labels).value)
            return int(reg.total(name))

        return {
            "accepted": tot("serve_requests_total", outcome="accepted"),
            "served": tot("serve_requests_total", outcome="served"),
            "shed": tot("serve_requests_total", outcome="shed"),
            "ticks": tot("serve_ticks_total"),
            "dispatches": tot("serve_dispatches_total"),
            "slot_ticks": tot("serve_slot_ticks_total"),
            "refreshes": tot("serve_state_refreshes_total"),
            "queue_depth": int(reg.gauge("serve_queue_depth").value),
            "active_slots": int(reg.gauge("serve_active_slots").value),
            "latency": hist_ms("serve_latency_seconds"),
            "queue_wait": hist_ms("serve_queue_wait_seconds"),
            "service": hist_ms("serve_service_seconds"),
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
            "serve": self.serve_view(),
            "stragglers": int(self.registry.total("straggler_steps_total")),
        }

    def heartbeat_line(self, det) -> str:
        return "HEARTBEAT " + json.dumps(self.heartbeat(det))

    def prometheus(self, det=None) -> str:
        """Text exposition of the registry, with the point-in-time gauges
        (host_state_rows, real_time_factor, uptime_seconds) and the host
        quality counters synced in first, so one scrape stands alone."""
        if det is not None:
            for i, st in enumerate(det.stations):
                self.registry.gauge("host_state_rows",
                                    station=str(i)).set(st.host_state_rows())
                for k, v in st.quality_summary().items():
                    self.registry.counter(f"quality_{k}_total",
                                          station=str(i)).set_total(int(v))
            self.registry.gauge("real_time_factor").set(
                self.real_time_factor(det))
            self.registry.gauge("uptime_seconds").set(self.uptime_s())
        return self.registry.render()

    def write_prometheus(self, path: str, det=None) -> None:
        """Rewrite ``path`` with the exposition atomically (write a
        sibling, then rename it over), so a scrape never reads a torn
        file."""
        tmp = str(path) + ".tmp"
        with open(tmp, "w") as fh:
            fh.write(self.prometheus(det))
        os.replace(tmp, path)

    # -- persistence ---------------------------------------------------------

    def snapshot(self) -> dict:
        return {
            "schema": "stream-telemetry/v1",
            "registry": self.registry.snapshot(),
            "uptime_s": self.uptime_s(),
            "watchdog": {"ema": self.watchdog.ema, "n": self.watchdog.n},
        }

    def restore(self, snap: dict) -> None:
        self.registry.restore(snap["registry"])
        self._uptime_base = float(snap.get("uptime_s", 0.0))
        self.t_start = None
        wd = snap.get("watchdog", {})
        self.watchdog.ema = wd.get("ema")
        self.watchdog.n = int(wd.get("n", 0))


def quality_view(ring_quality: dict, qc: dict) -> dict:
    """One station's quality summary: ingest reconciliation counters +
    step guard counters, merged on the one aggregation path
    (``merge_counts``). The key set is the reference's."""
    return merge_counts([ring_quality, qc])


def metrics_snapshot(det) -> dict:
    """The one structured metrics view of a detector (schema
    ``stream-metrics/v1``, the reference's keys): aggregate and
    per-station throughput, the step drop breakdown and rates, quality
    counters, wall-time histograms, the serving and location views, span
    totals and the watchdog's state."""
    tel = det.telemetry
    reg = tel.registry
    stream = merge_counts([st.stats.summary() for st in det.stations])
    # wall figures do not sum across lockstep stations: report the slowest
    # station's, with the merged histograms below
    for k in ("wall_s", "chunk_ms_p50", "chunk_ms_p95", "chunks_per_s",
              "samples_per_s"):
        stream[k] = max(st.stats.summary()[k] for st in det.stations)
    return {
        "schema": METRICS_SCHEMA,
        "stations": len(det.stations),
        "uptime_s": round(tel.uptime_s(), 3),
        "stream_s": round(tel.stream_seconds(det), 3),
        "rtf": round(tel.real_time_factor(det), 3),
        "stream": stream,
        "per_station": [
            {"station": i, **st.stats.summary(),
             "host_state_rows": st.host_state_rows(),
             "quality": st.quality_summary()}
            for i, st in enumerate(det.stations)],
        "drops": tel.drop_breakdown(),
        "drop_rates": tel.drop_rates(),
        "quality": det.quality_summary(),
        "histograms": {
            name: reg.histogram_merged(name).summary()
            for name in ("chunk_ingest_wall_seconds",
                         "fused_step_wall_seconds",
                         "host_tail_wall_seconds",
                         "serve_latency_seconds",
                         "serve_queue_wait_seconds",
                         "locate_stack_wall_seconds")},
        "serve": tel.serve_view(),
        "locate": tel.locate_view(),
        "spans": tel.tracer.summary(),
        "watchdog": {"steps": tel.watchdog.n,
                     "stragglers": len(tel.watchdog.events)},
    }
