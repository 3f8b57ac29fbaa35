"""Concurrent, backpressured query serving over a streaming LSH index pool.

PyTorch counterpart of ``repro.launch.serve_detect``. Requests are query
windows of raw waveform ("when did something like this happen?")
answered against the per-station index pool that continuous ingestion
builds (``StreamingDetector.pool_serving_state``). Three layers:

* **admission queue** (``ServeDetectEngine.submit``): a bounded FIFO in
  front of the slots. A request past ``max_queue`` is shed: it completes
  at once with ``outcome="rejected"``. Each request records its queue
  wait (submit → slot) and service time (slot → done).
* **batched ticks** (``ServeDetectEngine.tick``): each tick admits queued
  requests into free slots and runs **one** ``_serve_step`` over every
  slot and every station: one ``stft_mag`` and one ``haar2d`` launch for
  the (n_slots, block_samples) batch, the per-station binarization
  broadcast over the slots, one ``minmax_hash`` launch for the signatures
  of all stations and slots, and the index lookups of all of them in one
  gather (``index.query`` with a slot axis; serving never changes the pool). Idle
  ticks (no active slot) assemble nothing and launch nothing.
* **interleaved ingestion** (``ServeSession``): ingest chunks keep growing
  the corpus while query ticks run between them, against a read-only copy
  of the pool refreshed every ``refresh_every_chunks`` chunks (gated on
  ``StreamingDetector.serving_version``, so an unchanged detector costs
  nothing).

Telemetry goes through the detector's ``StreamTelemetry`` registry
(``serve_requests_total{outcome=…}``, queue-depth and slot gauges,
latency / queue-wait / service histograms, ``serve_state_refreshes_total``),
so the heartbeat, the Prometheus file and ``metrics_snapshot()["serve"]``
carry the serving tier.

Flags as the reference's (``--stations``, ``--snapshot-every``,
``--snapshot-dir``, ``--restore``, ``--window-fp``, ``--filter-window-fp``,
``--occ-limit``, ``--slots``, ``--max-queue``, ``--interleave``,
``--refresh-every``, ``--metrics-every``, ``--metrics-file``,
``--trace-jsonl``, ``--dirty``, ``--locate``), plus ``--device`` (default
``cuda``; ``cpu`` runs the kernels' plain versions). ``--locate`` ingests
a ``physical_geometry`` network through ``located_smoke_config()`` in the
bounded regime, prints one ``ALERT {...}`` JSON row an alert (origin in
km, relative magnitude ``dmag``) and adds a ``located`` block to the
RESULT. ``--restore`` into a wider ``--stations`` grows the restored pool
with ``StreamingDetector.add_station``, re-split over the station mesh of
the visible cards (one card: no mesh).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve_detect --requests 12
  PYTHONPATH=src python -m repro_torch.launch.serve_detect --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve_detect \
      --snapshot-every 4 --snapshot-dir snap          # then stop it …
  PYTHONPATH=src python -m repro_torch.launch.serve_detect \
      --restore --snapshot-dir snap                   # … and resume
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch import utils
from repro_torch.configs.fast_seismic import smoke_config, stream_smoke_config
from repro_torch.core import fingerprint as fp_mod
from repro_torch.core import lsh as lsh_mod
from repro_torch.core.detect import DetectConfig
from repro_torch.core.fingerprint import FingerprintConfig
from repro_torch.core.lsh import INVALID, LSHConfig
from repro_torch.core.synth import SynthConfig, make_dataset
from repro_torch.stream import index as index_mod
from repro_torch.stream.engine import StreamingDetector, ingest_chunks
from repro_torch.stream.index import IndexState
from repro_torch.stream.ingest import StreamConfig
from repro_torch.stream.telemetry import StreamTelemetry

# completed requests' latency samples kept for exact percentiles; the
# registry's histograms keep the whole lifetime (bucketed), so the engine's
# own memory stays bounded on an unbounded request stream
LATENCY_WINDOW = 65536


@dataclass
class ServeConfig:
    """Serving-tier knobs (``configs.fast_seismic.serve_smoke_config`` /
    ``serve_config``)."""
    n_slots: int = 4            # concurrent slots a batched step
    max_queue: int = 64         # admission bound; beyond it requests shed
    top_k: int = 32             # matches returned per (station, block)
    refresh_every_chunks: int = 4   # interleaved serving-state cadence


@dataclass
class QueryRequest:
    rid: int
    window: np.ndarray            # raw waveform samples
    matches: list = field(default_factory=list)  # (station, fp_id, sim)
    ticks: int = 0
    done: bool = False
    outcome: str = "pending"      # pending | active | served | rejected
    t_submit: float = 0.0
    t_admit: float = 0.0          # dequeued into a slot
    t_done: float = 0.0
    t_traced: float = 0.0         # submit on the tracer's clock

    @property
    def queue_wait_s(self) -> float:
        """Submit → slot admission (0.0 while still queued or shed)."""
        if self.t_admit <= 0.0:
            return 0.0
        return self.t_admit - self.t_submit

    @property
    def service_s(self) -> float:
        """Slot admission → completion (0.0 while in flight)."""
        if self.t_done <= 0.0 or self.t_admit <= 0.0:
            return 0.0
        return self.t_done - self.t_admit

    @property
    def latency_s(self) -> float:
        """Submit → completion; 0.0 for an unfinished request."""
        if self.t_done <= 0.0:
            return 0.0
        return self.t_done - self.t_submit


def _serve_step(state: IndexState, blocks: torch.Tensor, med: torch.Tensor,
                mad: torch.Tensor, mappings: torch.Tensor,
                slot_valid: torch.Tensor, fcfg: FingerprintConfig,
                lcfg: LSHConfig, top_k: int = 32, max_pairs: int = 0
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """(n_slots, block_samples) slot blocks × (S,)-pooled index state →
    per-(station, slot) (ids, sims) match tables, each (S, n_slots, k),
    k = min(top_k, candidates a row).

    The raw coefficients are computed once for all slots and shared by the
    stations; binarization takes each station's (med, mad) broadcast over
    the slots; signatures come from one ``minmax_hash`` call over every
    (station, slot) row, with invalid fingerprints given filler
    signatures. Query fingerprints get the reference's ids above any
    corpus id (``INVALID - 1 - n + arange(n)``), so each pairs with all of
    its stored partners. ``max_pairs`` > 0 compacts each slot's candidates
    before ranking, as the reference does. The ranking is
    ``jax.lax.top_k``'s: by similarity, ties to the earlier candidate.
    """
    coeffs = fp_mod.coeffs_from_waveform(blocks, fcfg)     # (Q, N, C)
    _, packed = fp_mod.binarize_coeffs(coeffs, fcfg,
                                       (med[:, None], mad[:, None]))
    s, n = packed.shape[0], packed.shape[-2]
    sigs = lsh_mod.signatures(packed, mappings, lcfg,
                              valid=slot_valid.expand(s, -1, -1))
    qids = (INVALID - 1 - n) + torch.arange(n, dtype=torch.int32,
                                            device=blocks.device)
    pairs = index_mod.query(state, sigs, qids, lcfg, max_pairs=max_pairs)
    sims = torch.where(pairs.valid, pairs.sim, 0)
    m = sims.shape[-1]
    # a key unique per row: similarity first, then the earlier position
    pos = torch.arange(m, dtype=torch.int64, device=sims.device)
    key = sims.to(torch.int64) * m + (m - 1 - pos)
    top = torch.topk(key, min(top_k, m), dim=-1).indices
    return pairs.idx1.gather(-1, top), sims.gather(-1, top)


class ServeDetectEngine:
    """Admission queue + static slots + one batched step a tick.

    ``state`` / ``med`` / ``mad`` carry a leading station axis
    (``StreamingDetector.pool_serving_state``) and are moved to
    ``device`` (``cuda`` unless named). The state may start ``None``
    (interleaved serving before the detector's statistics freeze):
    requests queue, and ticks are idle until the first ``refresh`` /
    ``refresh_from`` installs a pool.
    """

    def __init__(self, cfg: DetectConfig, scfg: StreamConfig,
                 state: IndexState | None = None, med_mad=None,
                 n_slots: int = 4, top_k: int = 32, max_queue: int = 64,
                 telemetry: StreamTelemetry | None = None,
                 clock=time.perf_counter, device=None):
        self.cfg = cfg
        self.scfg = scfg
        self.device = utils.resolve_device(device)
        self.telemetry = telemetry or StreamTelemetry(0)
        self.clock = clock
        self.state: IndexState | None = None
        self.med = self.mad = None
        self.n_stations = 0
        self.serving_version = -1   # detector version the pool mirrors
        self.mappings = lsh_mod.hash_mappings(cfg.fingerprint.fp_dim,
                                              cfg.lsh, self.device)
        self.n_slots = n_slots
        self.top_k = top_k
        # compacted slot queries (0 = dense): never below top_k, or the
        # (S, slots, top_k) match tables would shrink
        self.max_pairs = (0 if scfg.max_pairs_per_block == 0
                          else max(scfg.max_pairs_per_block, top_k))
        self.max_queue = max_queue
        self.block_samples = cfg.fingerprint.block_samples(
            scfg.block_fingerprints)
        # cached filler rows: idle slots never allocate per tick
        self._zero_block = np.zeros(self.block_samples, np.float32)
        self._zero_mask = np.zeros(scfg.block_fingerprints, bool)
        self.slot_req: list[QueryRequest | None] = [None] * n_slots
        self.slot_blocks: list[list] = [[] for _ in range(n_slots)]
        self.queue: collections.deque[QueryRequest] = collections.deque()
        self.ticks = 0
        self.dispatches = 0
        self.lat = {k: collections.deque(maxlen=LATENCY_WINDOW)
                    for k in ("queue_wait_s", "service_s", "latency_s")}
        if state is not None:
            self._install(state, med_mad)

    @classmethod
    def from_detector(cls, det: StreamingDetector, **kw
                      ) -> "ServeDetectEngine":
        """Engine over a detector's current pool on the detector's
        device, sharing its telemetry registry."""
        eng = cls(det.cfg, det.scfg, telemetry=det.telemetry,
                  device=det.device, **kw)
        eng.refresh_from(det)
        return eng

    # -- serving state -------------------------------------------------------

    def _install(self, state: IndexState, med_mad) -> None:
        def put(x):
            return torch.as_tensor(x).to(self.device)

        med = put(med_mad[0])
        if med.ndim != 2 or state.n_stations != med.shape[0]:
            raise ValueError(
                f"serving state must be pooled (leading station axis): "
                f"index of {state.n_stations} stations, med "
                f"{tuple(med.shape)}")
        if self.n_stations and med.shape[0] != self.n_stations:
            raise ValueError(
                f"refresh changed the pool width: serving {self.n_stations}"
                f" stations, refresh has {med.shape[0]}")
        self.state = IndexState(**{f.name: put(getattr(state, f.name))
                                   for f in dataclasses.fields(IndexState)})
        self.med = med
        self.mad = put(med_mad[1])
        self.n_stations = med.shape[0]

    def refresh(self, state: IndexState, med_mad, version: int = -1) -> None:
        """Install a new read-only pool (queries from the next tick on see
        the grown corpus)."""
        self._install(state, med_mad)
        self.serving_version = version
        self.telemetry.record_serve_refresh()

    def refresh_from(self, det: StreamingDetector) -> bool:
        """Version-gated refresh from an ingesting detector: a no-op until
        its statistics freeze, and when nothing arrived since the pool
        this engine already serves."""
        if not all(st.stats_frozen for st in det.stations):
            return False
        if det.serving_version == self.serving_version:
            return False
        state, med, mad = det.pool_serving_state()
        self.refresh(state, (med, mad), version=det.serving_version)
        return True

    # -- admission -----------------------------------------------------------

    def submit(self, req: QueryRequest) -> bool:
        """Enqueue, or shed past ``max_queue``: a shed request completes
        at once with ``outcome="rejected"``."""
        now = self.clock()
        req.t_submit = now
        req.t_traced = self.telemetry.tracer.clock()
        if len(self.queue) >= self.max_queue:
            req.done = True
            req.outcome = "rejected"
            req.t_done = now
            self.telemetry.record_serve_admission(False)
            return False
        self.queue.append(req)
        self.telemetry.record_serve_admission(True)
        return True

    def active(self) -> bool:
        """Whether any slot holds a request."""
        return any(r is not None for r in self.slot_req)

    def pending(self) -> int:
        """Requests not yet completed (queued + in slots)."""
        return len(self.queue) + sum(r is not None for r in self.slot_req)

    def _admit(self) -> None:
        for slot in range(self.n_slots):
            if self.slot_req[slot] is None and self.queue:
                req = self.queue.popleft()
                req.t_admit = self.clock()
                req.outcome = "active"
                self.slot_req[slot] = req
                self.slot_blocks[slot] = self._split_blocks(req.window)

    def _split_blocks(self, window: np.ndarray
                      ) -> list[tuple[np.ndarray, np.ndarray]]:
        """Fixed-size (block, fingerprint-valid mask) pairs covering the
        window: tails are zero-padded, and the mask marks fingerprints
        whose analysis window lies inside real samples, so padding never
        queries."""
        fcfg = self.cfg.fingerprint
        n_fp = self.scfg.block_fingerprints
        bs, adv = self.block_samples, n_fp * fcfg.lag_samples
        blocks, start = [], 0
        while start == 0 or start + fcfg.window_samples <= window.size:
            blk = np.zeros(bs, np.float32)
            seg = window[start: start + bs]
            blk[: seg.size] = seg
            avail = window.size - start
            n_valid = max(0, min(
                n_fp, (avail - fcfg.window_samples) // fcfg.lag_samples + 1))
            blocks.append((blk, np.arange(n_fp) < n_valid))
            start += adv
        return blocks

    # -- the batched tick ----------------------------------------------------

    def tick(self) -> int:
        """One service tick: admit queued requests into free slots, run at
        most one batched ``_serve_step`` over every active slot (one
        device→host copy of its match tables), and complete requests whose
        last block was answered. Returns the slots served; an idle tick
        returns 0 without assembling a batch, launching anything or
        opening a span.

        A dispatched tick is the tracer's ``serve.tick`` span (``tick``:
        the dispatch number, ``slots``: the active slots), with the
        children ``serve.admit``, ``serve.assemble`` (the slot batch and
        masks stacked and put on the device), ``serve.step`` (the step
        enqueued), ``serve.fetch`` (the one device→host copy, which waits
        for the device) and ``serve.unpack`` (match lists, completions)."""
        if self.state is None or not (self.queue or self.active()):
            self.ticks += 1
            self.telemetry.record_serve_tick(0, len(self.queue))
            return 0
        tr = self.telemetry.tracer
        with tr.span("serve.tick", tick=self.dispatches) as attrs:
            with tr.span("serve.admit"):
                self._admit()
            active = [s for s in range(self.n_slots)
                      if self.slot_req[s] is not None]
            attrs["slots"] = len(active)
            self.ticks += 1
            self.telemetry.record_serve_tick(len(active), len(self.queue))
            with tr.span("serve.assemble"):
                batch = np.stack([
                    self.slot_blocks[s][0][0] if self.slot_req[s] is not None
                    else self._zero_block for s in range(self.n_slots)])
                slot_valid = np.stack([
                    self.slot_blocks[s][0][1] if self.slot_req[s] is not None
                    else self._zero_mask for s in range(self.n_slots)])
                batch = torch.as_tensor(batch, device=self.device)
                slot_valid = torch.as_tensor(slot_valid, device=self.device)
            with tr.span("serve.step"):
                ids, sims = _serve_step(
                    self.state, batch, self.med, self.mad, self.mappings,
                    slot_valid, self.cfg.fingerprint, self.cfg.lsh,
                    self.top_k, self.max_pairs)
            self.dispatches += 1
            with tr.span("serve.fetch"):
                # (S, slots, k) each
                ids_h, sims_h = torch.stack([ids, sims]).cpu().numpy()
            with tr.span("serve.unpack"):
                for slot in active:
                    req = self.slot_req[slot]
                    for station in range(self.n_stations):
                        keep = sims_h[station, slot] > 0
                        req.matches.extend(
                            (station, int(i), int(s))
                            for i, s in zip(ids_h[station, slot][keep],
                                            sims_h[station, slot][keep]))
                    req.ticks += 1
                    self.slot_blocks[slot].pop(0)
                    if not self.slot_blocks[slot]:
                        self._complete(slot)
        return len(active)

    def _complete(self, slot: int) -> None:
        req = self.slot_req[slot]
        req.done = True
        req.outcome = "served"
        req.t_done = self.clock()
        self.slot_req[slot] = None
        self.lat["queue_wait_s"].append(req.queue_wait_s)
        self.lat["service_s"].append(req.service_s)
        self.lat["latency_s"].append(req.latency_s)
        self.telemetry.record_serve_done(req.queue_wait_s, req.service_s,
                                         req.latency_s)
        # on the tracer's clock, whatever the engine's; a request is served
        # in every dispatch from its admission on
        tr = self.telemetry.tracer
        last = self.dispatches - 1
        tr.record("serve.request", req.t_traced, tr.clock() - req.t_traced,
                  rid=req.rid, queue_wait_s=req.queue_wait_s,
                  first_tick=last - req.ticks + 1, last_tick=last)

    def drain(self) -> None:
        """Tick until every admitted request completes."""
        if self.state is None and self.pending():
            raise RuntimeError(
                "cannot drain before a serving state is installed")
        while self.pending():
            self.tick()

    # -- summaries -----------------------------------------------------------

    def run(self, requests: list[QueryRequest]) -> dict:
        """Submit everything at once (a burst), drain, summarize."""
        t0 = self.clock()
        for r in requests:
            self.submit(r)
        self.drain()
        return self.summary(requests, self.clock() - t0)

    def summary(self, requests: list[QueryRequest], wall_s: float) -> dict:
        served = [r for r in requests if r.outcome == "served"]

        def pct(vals, q):
            if not vals:        # empty request list / everything shed
                return 0.0
            return round(float(np.percentile(vals, q)) * 1e3, 2)

        lats = [r.latency_s for r in served]
        waits = [r.queue_wait_s for r in served]
        svc = [r.service_s for r in served]
        return {
            "requests": len(requests),
            "served": len(served),
            "shed": sum(1 for r in requests if r.outcome == "rejected"),
            "stations": self.n_stations,
            "ticks": self.ticks,
            "dispatches": self.dispatches,
            "wall_s": round(wall_s, 3),
            "requests_per_s": round(len(served) / max(wall_s, 1e-9), 1),
            "latency_ms_p50": pct(lats, 50),
            "latency_ms_p95": pct(lats, 95),
            "latency_ms_p99": pct(lats, 99),
            "queue_wait_ms_p50": pct(waits, 50),
            "queue_wait_ms_p99": pct(waits, 99),
            "service_ms_p50": pct(svc, 50),
            "service_ms_p99": pct(svc, 99),
            "hit_requests": sum(1 for r in served if r.matches),
        }


class ServeSession:
    """Cooperative ingest + serve loop on one thread: chunks keep growing
    the corpus while query ticks run between them against a refreshed
    read-only pool.

    ``after_push()`` is the per-chunk duty cycle — refresh the engine's
    serving state at the configured cadence (version-gated; a no-op until
    the detector's statistics freeze) and pump up to ``ticks_per_chunk``
    ticks. ``finish()`` flushes the detector, takes the final refresh and
    drains the queue.
    """

    def __init__(self, det: StreamingDetector, engine: ServeDetectEngine,
                 refresh_every_chunks: int = 4, ticks_per_chunk: int = 2):
        self.det = det
        self.engine = engine
        self.refresh_every_chunks = max(1, refresh_every_chunks)
        self.ticks_per_chunk = ticks_per_chunk
        self.chunks = 0
        self.refreshes = 0

    def submit(self, req: QueryRequest) -> bool:
        return self.engine.submit(req)

    def ingest(self, chunk: np.ndarray, offset: int | None = None) -> None:
        self.det.push(chunk, offset)
        self.after_push()

    def after_push(self) -> None:
        self.chunks += 1
        if self.chunks % self.refresh_every_chunks == 0:
            self.refreshes += int(self.engine.refresh_from(self.det))
        self.pump(self.ticks_per_chunk)

    def pump(self, max_ticks: int) -> int:
        """Run up to ``max_ticks`` ticks; stops early when nothing is
        pending or no serving state exists yet."""
        n = 0
        while (n < max_ticks and self.engine.state is not None
               and self.engine.pending()):
            self.engine.tick()
            n += 1
        return n

    def finish(self) -> None:
        self.det.flush()
        self.refreshes += int(self.engine.refresh_from(self.det))
        self.engine.drain()


def _located_summary(det: StreamingDetector, source_xy: np.ndarray,
                     fcfg: FingerprintConfig) -> dict:
    """Print one ``ALERT {...}`` JSON row an alert (the sentinels of the
    location and magnitude columns decoded to None) and return the RESULT's
    ``located`` block: alerts, located alerts, upgrades, moveout
    rejections, locate passes and the median origin error against the
    synthetic sources."""
    from repro_torch.core.locate import LOC_NONE, MAG_NONE
    lag_s = fcfg.lag_samples / fcfg.fs
    alert_rows = []
    for rows in det.alerts:
        for dt, onset, n_st, score, upg, x_mkm, y_mkm, mag_m in rows:
            alert_rows.append({
                "t_s": round(float(onset) * lag_s, 1),
                "dt_s": round(float(dt) * lag_s, 1),
                "stations": int(n_st), "score": int(score),
                "upgrade": bool(upg),
                "x_km": None if x_mkm == LOC_NONE else x_mkm / 1e3,
                "y_km": None if y_mkm == LOC_NONE else y_mkm / 1e3,
                "dmag": None if mag_m == MAG_NONE else mag_m / 1e3,
            })
    for row in alert_rows:
        print("ALERT " + json.dumps(row))
    loc = [r for r in alert_rows if r["x_km"] is not None]
    errs = [float(np.min(np.linalg.norm(
                source_xy - np.array([r["x_km"], r["y_km"]]), axis=1)))
            for r in loc]
    lv = det.telemetry.locate_view()
    return {
        "alerts": len(alert_rows),
        "located": len(loc),
        "upgrades": int(sum(r["upgrade"] for r in alert_rows)),
        "moveout_rejected": lv["moveout_rejected"],
        "locate_passes": lv["passes"],
        "median_origin_err_km": (round(float(np.median(errs)), 2)
                                 if errs else None),
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-queue", type=int, default=64,
                    help="admission-queue bound (beyond it requests shed)")
    ap.add_argument("--interleave", action="store_true",
                    help="serve queries while ingesting (requests arrive "
                         "spread over the stream) instead of after it")
    ap.add_argument("--refresh-every", type=int, default=4,
                    help="chunks between serving-state refreshes "
                         "(interleaved mode)")
    ap.add_argument("--stations", type=int, default=2,
                    help="stations ingested + served (index pool S axis)")
    ap.add_argument("--duration-s", type=float, default=600.0)
    ap.add_argument("--window-s", type=float, default=20.0)
    ap.add_argument("--snapshot-every", type=int, default=0,
                    help="checkpoint the ingesting detector every N chunks")
    ap.add_argument("--snapshot-dir", default="fast_serve_snapshots")
    ap.add_argument("--restore", action="store_true",
                    help="resume ingestion from the latest snapshot")
    ap.add_argument("--window-fp", type=int, default=0,
                    help="sliding detection window (fingerprints; 0 = off)")
    ap.add_argument("--filter-window-fp", type=int, default=0,
                    help="rolling occurrence-filter window (0 = finalize)")
    ap.add_argument("--occ-limit", type=int, default=0,
                    help="in-step §6.5 partner-collision cap (0 = off)")
    ap.add_argument("--metrics-every", type=int, default=0,
                    help="heartbeat + exposition cadence in chunks (0=off)")
    ap.add_argument("--metrics-file", default=None,
                    help="Prometheus text exposition path (atomic rewrite)")
    ap.add_argument("--trace-jsonl", default=None,
                    help="append structured span records (JSONL) here")
    ap.add_argument("--dirty", action="store_true",
                    help="ingest the fault-injected scenario stream "
                         "through the quality-hardened config")
    ap.add_argument("--locate", action="store_true",
                    help="station geometry + location/magnitude tier: "
                         "alerts carry a migration-stacked origin and a "
                         "relative magnitude (defaults --window-fp 128 "
                         "--filter-window-fp 64 so alerts emit live)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the "
                         "kernels' plain versions)")
    args = ap.parse_args(argv)

    device = utils.resolve_device(args.device)
    if args.locate:
        from repro_torch.configs.fast_seismic import located_smoke_config
        cfg = located_smoke_config()
        # live alerts need the bounded regime: a sliding index window
        # plus the rolling occurrence filter
        if not args.window_fp:
            args.window_fp = 128
        if not args.filter_window_fp:
            args.filter_window_fp = 64
    else:
        cfg = smoke_config()
    if args.dirty:
        from repro_torch.configs.fast_seismic import stream_dirty_smoke_config
        scfg = stream_dirty_smoke_config()
    else:
        scfg = stream_smoke_config()
    if args.window_fp or args.filter_window_fp or args.occ_limit:
        icfg = scfg.index
        if args.occ_limit:
            # the ring spans everything a pair can reach back over: the
            # sliding window when set, else the whole ingested corpus
            n_fp = int(args.duration_s * cfg.fingerprint.fs
                       / cfg.fingerprint.lag_samples) + 1
            icfg = dataclasses.replace(
                icfg, occ_slots=args.window_fp or n_fp)
        scfg = dataclasses.replace(
            scfg, window_fingerprints=args.window_fp,
            filter_window_fingerprints=args.filter_window_fp,
            occ_limit=args.occ_limit, index=icfg)
    base = SynthConfig(duration_s=args.duration_s,
                       n_stations=args.stations,
                       n_sources=2, events_per_source=5,
                       event_snr=3.0, seed=3,
                       physical_geometry=args.locate)
    if args.dirty:
        # the scenario benchmark's pathology mix: telemetry gaps, a
        # duplicated block, one long repeating glitch train
        from repro_torch.core.synth import (ScenarioConfig,
                                            make_scenario_dataset)
        scen = make_scenario_dataset(ScenarioConfig(
            base=base, n_gaps=2, gap_dur_s=(2.0, 5.0),
            n_dup_blocks=1, dup_block_dur_s=20.0, dup_spacing_s=60.0,
            glitch_stations=(0,), glitch_trains=1,
            glitch_train_dur_s=args.duration_s / 4.0, seed=1))
        ds, ingest_wf = scen.clean, scen.waveforms
    else:
        ds = make_dataset(base)
        ingest_wf = ds.waveforms

    # build the corpus index pool by streaming the stations in, resuming
    # from the latest snapshot when asked (only post-snapshot samples
    # re-ingest)
    station_xy = ds.station_xy if args.locate else None
    skip = 0
    if args.restore:
        det, step = StreamingDetector.restore(args.snapshot_dir, cfg, scfg,
                                              station_xy=station_xy,
                                              device=device)
        if args.stations > len(det.stations) and det.pooled \
                and all(st.stats_frozen for st in det.stations):
            # growing the restored pool: stations join at the frontier,
            # and the pool is re-padded and re-split over the current mesh
            grown = args.stations - len(det.stations)
            for _ in range(grown):
                det.add_station()
            print(f"# restored pool grown {len(det.stations) - grown}"
                  f" -> {len(det.stations)} stations (elastic re-shard)")
        elif len(det.stations) != args.stations:
            raise SystemExit(
                f"--restore: the snapshot holds a {len(det.stations)}-"
                f"station index pool but --stations {args.stations} was "
                f"requested; shrinking would discard station identities "
                f"irrecoverably — rerun with --stations "
                f"{len(det.stations)} (or take a fresh snapshot at the "
                f"new width)")
        skip = det.stations[0].ring.samples_in
        print(f"# restored step {step}: {skip} samples already ingested")
    else:
        det = StreamingDetector(cfg, scfg, n_stations=args.stations,
                                station_xy=station_xy, device=device)
    if args.trace_jsonl:
        from repro_torch.obsv.spans import SpanTracer
        det.telemetry.tracer = SpanTracer(jsonl_path=args.trace_jsonl)

    # query windows centred on known event arrivals (+ random controls)
    wf = ds.waveforms[0]
    rng = np.random.default_rng(0)
    win = int(args.window_s * cfg.fingerprint.fs)
    reqs = []
    for i in range(args.requests):
        if i < len(ds.event_times):
            t0 = int(ds.arrival_time(i, 0) * cfg.fingerprint.fs)
        else:
            t0 = int(rng.integers(0, wf.size - win))
        lo = max(0, min(t0, wf.size - win))
        reqs.append(QueryRequest(rid=i, window=wf[lo: lo + win]))

    eng = ServeDetectEngine(cfg, scfg, n_slots=args.slots,
                            max_queue=args.max_queue,
                            telemetry=det.telemetry, device=device)
    n_chunks = 16
    t_serve = time.perf_counter()
    if args.interleave:
        # requests arrive spread over ingestion and are answered against
        # the refreshed pool while the corpus grows
        session = ServeSession(det, eng,
                               refresh_every_chunks=args.refresh_every)
        arrival_chunk = [min(n_chunks - 1, i * n_chunks // max(
            len(reqs), 1)) for i in range(len(reqs))]
        next_req = [0]

        def on_chunk(ci: int) -> None:
            while (next_req[0] < len(reqs)
                   and arrival_chunk[next_req[0]] <= ci):
                session.submit(reqs[next_req[0]])
                next_req[0] += 1
            session.after_push()

        ingest_chunks(det, ingest_wf, n_chunks=n_chunks, skip=skip,
                      snapshot_every=args.snapshot_every,
                      snapshot_dir=args.snapshot_dir,
                      metrics_every=args.metrics_every,
                      metrics_file=args.metrics_file,
                      on_chunk=on_chunk)
        for r in reqs[next_req[0]:]:
            session.submit(r)
        session.finish()
    else:
        ingest_chunks(det, ingest_wf, n_chunks=n_chunks, skip=skip,
                      snapshot_every=args.snapshot_every,
                      snapshot_dir=args.snapshot_dir,
                      metrics_every=args.metrics_every,
                      metrics_file=args.metrics_file)
        det.flush()
    if not all(st.stats_frozen for st in det.stations):
        raise SystemExit("ingest too short to freeze MAD statistics")
    # data-quality reconciliation + guard counters: how dirty the
    # ingested telemetry was
    quality = det.quality_summary()
    print("# ingest quality " + json.dumps(quality))
    located_summary = (_located_summary(det, ds.source_xy, cfg.fingerprint)
                       if args.locate else None)
    if args.metrics_every:
        # a last heartbeat after the flush
        print(det.telemetry.heartbeat_line(det))
    if args.metrics_file:
        # a bare --metrics-file still gets its final write
        det.telemetry.write_prometheus(args.metrics_file, det)
    det.telemetry.tracer.flush()

    if args.interleave:
        stats = eng.summary(reqs, time.perf_counter() - t_serve)
        stats["refreshes"] = int(eng.telemetry.registry.total(
            "serve_state_refreshes_total"))
    else:
        eng.refresh_from(det)
        stats = eng.run(reqs)
    if not all(r.done for r in reqs):
        raise RuntimeError("a request was left unfinished")
    stats["ingest_quality"] = quality
    if located_summary is not None:
        stats["located"] = located_summary
    if args.metrics_every:
        stats["metrics"] = det.metrics_snapshot()
    det.telemetry.tracer.flush()        # the serving ticks' spans too
    print("RESULT " + json.dumps(stats))
    return stats


if __name__ == "__main__":
    main()
