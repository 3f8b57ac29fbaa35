"""Streaming detector: ring → fingerprints → index → pairs → events.

PyTorch counterpart of ``repro.stream.engine``. ``StationStream`` owns one
station's ingestion state: a ``WaveformRing`` (chunk framing + halo), a
``StreamingMAD`` (running §5.2 statistics) and the device-resident
detection state. Each ready block runs one step of the detection core —
fingerprint, sign, expire, insert, query, verify — and the emitted pairs
either accumulate on the host (parity mode) or flow through a
``RollingPairFilter`` (bounded mode). ``StreamingDetector`` composes
stations and finishes with the same alignment stack as the batch driver
(occurrence filter → channel merge → ``cluster_station`` → network
association), so a streamed trace gives the batch driver's detections.

The steady-state step is ``fused.step_advance`` (one station) or
``fused.pool_step_advance`` (all stations of a pooled detector): only the
block's new samples, (S, block_fingerprints · lag_samples), cross from the
host; the overlapping head is the halo kept on the device. A block that
is gap-masked, the first after the statistics freeze, or the masked
flush tail goes through ``step_block`` / ``pool_step_block`` instead and
reprimes the halo (a zero-padded tail leaves it dirty, so the next block
re-seeds too). Every step ends in one device→host copy of the stacked
(idx1, idx2, sim, valid) and the QC vector: one synchronisation a block.
On the card the step runs the four CUDA kernels of the detection core
(``stft_mag``, ``haar2d``, ``minmax_sig_buckets`` and, with
``verify_jaccard``, ``jaccard_popcount``); on the CPU their plain
versions. ``fused=False`` keeps the reference's unfused chain
(``block_coeffs`` + ``stream_step``) as the parity reference.

Two memory regimes, selected by ``StreamConfig``:

* **parity mode** (defaults): every emitted triplet is kept until
  ``finalize`` runs the occurrence filter + clustering over the full
  accumulation — the batch driver's semantics, O(stream) host state.
* **bounded mode** (``window_fingerprints`` + ``filter_window_fingerprints``
  > 0): the step expires index entries older than the sliding window, and
  triplets are retired window by window through the rolling occurrence
  filter into compact event rows — O(window) host state. With ≥ 2
  stations, ``poll_detections`` associates closed-window events across
  stations after every push that closed a window, so network detections
  surface as ``alerts`` before finalize.

Host-side clustering (the rolling filter, ``poll_detections``,
``finalize``) runs through the port's ``core.align`` on the detector's
device. Entries run on ``cuda`` unless ``device`` names another
(``utils.resolve_device``).

``StreamingDetector.snapshot`` / ``restore`` checkpoint the whole
detector through ``train.checkpoint`` in the reference's on-disk layout
(each station's index leaves, ring, reservoir, duplicate-guard history,
pending blocks, rolling filter or triplets and counters, plus the alert
keys and the telemetry registry), so either package restores the other's
snapshot and continues the stream bit for bit. ``pool_serving_state``
hands the serving tier (``launch.serve_detect``) a copy of the pooled
index and statistics; ``serving_version`` counts the pushes and flushes
that may have changed it.

With a ``LocateConfig`` in ``cfg.locate``, ``station_xy`` and ≥ 2
stations the detector runs the location / magnitude tier
(``core.locate``): each push max-merges the chunk's |samples| into
per-station lag-bin amplitude timelines, every fresh alert row is
migration-located and sized (its location and magnitude columns; rows
failing the moveout gate are dropped), and ``finalize`` attaches the
located columns to the detections. The timelines ride in snapshots as
the reference's ``detector/amp<i>`` (n, 2) float64 arrays.

With ``StreamConfig.sharded`` (the default) the pool is split over a
``stations`` mesh (``dist.station_mesh``: every visible card, or the
``devices`` the caller names) into contiguous row blocks, one sub-pool a
device, padded with throwaway station rows to a multiple of the mesh
width; each block steps through ``fused.pool_step_*_sharded``, every
shard launched before any synchronisation. One card, or fewer than two
stations, gives no mesh and the one-device pool.

``add_station`` / ``remove_station`` change a live pool's width: the
stations' index slices are pulled out of the pool, the mesh is probed
again for the new width, and the pool is re-padded, re-split and rebuilt
(cold halo). Snapshots hold per-station slices, so a pool saved under one
mesh restores under another, or under none.
"""
from __future__ import annotations

import collections
import dataclasses
import hashlib
import time
from typing import TYPE_CHECKING

import numpy as np
import torch

from repro_torch import convert, dist, utils
from repro_torch.core import align as align_mod
from repro_torch.core import fingerprint as fp_mod
from repro_torch.core import locate as locate_mod
from repro_torch.core import lsh as lsh_mod
from repro_torch.core.align import AlignConfig, Events
from repro_torch.core.fingerprint import FingerprintConfig
from repro_torch.core.locate import LOC_NONE, MAG_NONE  # noqa: F401
from repro_torch.core.lsh import INVALID, LSHConfig, Pairs
from repro_torch.obsv.metrics import merge_counts
from repro_torch.stream import fused as fused_mod
from repro_torch.stream import index as index_mod
from repro_torch.stream import telemetry as tele_mod
from repro_torch.stream.index import IndexState
from repro_torch.stream.ingest import StreamConfig, StreamingMAD, WaveformRing
from repro_torch.stream.telemetry import StreamTelemetry
from repro_torch.train import checkpoint as ckpt_mod

if TYPE_CHECKING:
    from repro_torch.core.detect import DetectConfig


def block_coeffs(block: torch.Tensor, fcfg: FingerprintConfig) -> torch.Tensor:
    """(block_samples,) → (block_fp, n_coeff) Haar coefficients."""
    return fp_mod.coeffs_from_waveform(block, fcfg)


def pool_block_coeffs(blocks: torch.Tensor,
                      fcfg: FingerprintConfig) -> torch.Tensor:
    """(S, block_samples) → (S, block_fp, n_coeff) coefficients (one pass
    for the whole station pool's warm-up)."""
    return fp_mod.coeffs_from_waveform(blocks, fcfg)


def stream_step(state: IndexState, coeffs: torch.Tensor, med: torch.Tensor,
                mad: torch.Tensor, mappings: torch.Tensor, base_id: int,
                valid: torch.Tensor | None, fcfg: FingerprintConfig,
                lcfg: LSHConfig, window: int = 0, saturation: int = 0,
                dup_tables: int = 0, occ_limit: int = 0, counters: int = 0,
                max_pairs: int = 0, verify: int = 0, min_jac: float = 0.0
                ) -> tuple[IndexState, Pairs, torch.Tensor]:
    """The unfused half of the reference's two-call chain, one station:
    binarize → sign → expire → guards → insert → query (→ verify).

    ``state`` is a one-station index (S = 1), coeffs (N, n_coeff) from
    ``block_coeffs``, med/mad (n_coeff,), valid (N,) or None. The tail is
    ``index.guarded_step``, shared with the fused entries, so the two
    chains give the same pairs. Returns (state, pairs (M,), qc (8,)).
    """
    _, packed = fp_mod.binarize_coeffs(coeffs[None], fcfg,
                                       (med[None], mad[None]))
    v = None if valid is None else valid[None]
    sigs, buckets = lsh_mod.signatures_and_buckets(
        packed, mappings, lcfg, state.shape[1], valid=v)
    ids = int(base_id) + torch.arange(packed.shape[1], dtype=torch.int32,
                                      device=packed.device)
    state, pairs, qc = index_mod.guarded_step(
        state, sigs, buckets, ids, v, lcfg, window, saturation=saturation,
        dup_tables=dup_tables, occ_limit=occ_limit, counters=counters,
        packed=packed if verify > 0 else None, max_pairs=max_pairs,
        verify=verify, min_jac=min_jac)
    return (state, *fused_mod.drop_station_axis(pairs, qc))


def _step_knobs(scfg: StreamConfig) -> dict:
    """The step's quality / emission knobs from a ``StreamConfig``."""
    return dict(window=scfg.window_fingerprints,
                saturation=scfg.saturation_limit,
                dup_tables=scfg.dup_sig_tables, occ_limit=scfg.occ_limit,
                counters=1 if scfg.telemetry else 0,
                max_pairs=scfg.max_pairs_per_block,
                verify=scfg.verify_code,
                min_jac=scfg.verify_min_jaccard)


def _to_host(pairs: Pairs, qc: torch.Tensor
             ) -> tuple[tuple[np.ndarray, ...], np.ndarray]:
    """A step's (idx1, idx2, sim, valid) and qc as numpy, in one
    device→host copy (``fused.outputs_to_host``); a sharded step's
    outputs are on the host already and are taken as they are."""
    pairs, qc = fused_mod.outputs_to_host(
        [(Pairs(pairs.idx1, pairs.idx2, pairs.sim, pairs.valid), qc)])
    return (pairs.idx1.numpy(), pairs.idx2.numpy(), pairs.sim.numpy(),
            pairs.valid.numpy()), qc.numpy()


def pairs_from_triplets(tri: np.ndarray, pad_to: int = 1024,
                        device=None) -> Pairs:
    """(m, 3) host triplets (idx1, idx2, sim) → masked fixed-size ``Pairs``
    padded to a multiple of ``pad_to``, on ``cuda`` unless ``device``
    names another."""
    device = utils.resolve_device(device)
    tri = np.asarray(tri).reshape(-1, 3)
    m = tri.shape[0]
    size = max(pad_to, -(-max(m, 1) // pad_to) * pad_to)
    idx1 = np.full(size, INVALID, np.int32)
    idx2 = np.full(size, INVALID, np.int32)
    sim = np.zeros(size, np.int32)
    val = np.zeros(size, bool)
    idx1[:m] = tri[:, 0]
    idx2[:m] = tri[:, 1]
    sim[:m] = tri[:, 2]
    val[:m] = True
    return Pairs(*(torch.as_tensor(a, device=device)
                   for a in (idx1, idx2, sim, val)))


# alert row layout: (dt, onset, n_stations, score, upgrade, x_mkm, y_mkm,
# mag_milli) — locations in milli-km and magnitudes in milli-magnitudes,
# LOC_NONE / MAG_NONE without a location tier; upgrade=1 on a re-emission
# whose station multiplicity grew
ALERT_COLS = 8


def events_to_rows(events: Events) -> np.ndarray:
    """Valid entries of an ``Events`` → compact (k, 5) int64 host rows
    (dt, onset, extent, size, score), in one device→host copy."""
    cols = torch.stack([events.dt, events.onset, events.extent, events.size,
                        events.score, events.valid.to(events.dt.dtype)])
    cols = cols.cpu().numpy()
    v = cols[5] > 0
    return cols[:5, v].T.astype(np.int64)


def events_from_rows(rows: np.ndarray, pad_to: int = 256,
                     device=None) -> Events:
    """(k, 5) rows → masked ``Events`` padded to a multiple of ``pad_to``,
    on ``cuda`` unless ``device`` names another."""
    device = utils.resolve_device(device)
    rows = np.asarray(rows, np.int64).reshape(-1, 5)
    k = rows.shape[0]
    size = max(pad_to, -(-max(k, 1) // pad_to) * pad_to)
    full = np.zeros((size, 5), np.int64)
    full[:k] = rows
    val = np.arange(size) < k
    fill = np.where(val, 0, INVALID)

    def col(x):
        return torch.as_tensor(x.astype(np.int32), device=device)

    return Events(dt=col(full[:, 0] + fill), onset=col(full[:, 1] + fill),
                  extent=col(full[:, 2]), size=col(full[:, 3]),
                  score=col(full[:, 4]),
                  valid=torch.as_tensor(val, device=device))


def merge_boundary_rows(rows: np.ndarray, acfg: AlignConfig) -> np.ndarray:
    """Re-merge event rows split at rolling-filter window boundaries.

    Bounded-mode clustering closes per filter window, so a diagonal
    cluster straddling a boundary surfaces as two rows: (nearly) the same
    dt, abutting idx ranges. This pass re-joins rows whose dt differ by at
    most ``dt_merge_tol`` and whose [onset, onset + extent] spans are
    within ``gap`` of each other — the criteria ``cluster_station`` uses
    for its in-window merge, applied across windows. Host-side numpy,
    O(k log k) in the (small) number of event rows.
    """
    rows = np.asarray(rows, np.int64).reshape(-1, 5)
    k = rows.shape[0]
    if k <= 1:
        return rows
    order = np.lexsort((rows[:, 0], rows[:, 1]))  # by (onset, dt)
    rows = rows[order]
    dt, onset, ext = rows[:, 0], rows[:, 1], rows[:, 2]
    end = onset + ext
    # union-find over pairwise near-edges between the original rows, so
    # the result is independent of encounter order and a chain of ≥ 3
    # straddling rows collapses into one component
    parent = np.arange(k)

    def find(i: int) -> int:
        while parent[i] != i:
            parent[i] = parent[parent[i]]   # path halving
            i = parent[i]
        return i

    for i in range(k):
        for j in range(i + 1, k):
            apart = int(onset[j]) - int(end[i])
            if apart > acfg.gap:
                break            # onsets monotone: no later j can be near
            if abs(int(dt[i]) - int(dt[j])) <= acfg.dt_merge_tol:
                ri, rj = find(i), find(j)
                if ri != rj:
                    parent[max(ri, rj)] = min(ri, rj)
    roots = np.fromiter((find(i) for i in range(k)), np.int64, k)
    out: list[np.ndarray] = []
    for r in np.unique(roots):               # root order == onset order
        m = roots == r
        # representative dt: the highest-score member's original dt
        # (ties → earliest in the onset sort)
        rep = np.nonzero(m)[0][np.argmax(rows[m, 4])]
        out.append(np.array([dt[rep], onset[m].min(),
                             end[m].max() - onset[m].min(),
                             rows[m, 3].sum(), rows[m, 4].sum()], np.int64))
    return np.stack(out, axis=0)


def host_occurrence_filter(pairs: Pairs, n_fp: int, lcfg: LSHConfig, *,
                           base: int = 0, limit: int | None = None
                           ) -> tuple[Pairs, torch.Tensor]:
    """The §6.5 occurrence filter over an accumulated pair set. ``base``
    rebases ids into [0, n_fp) first and restores them on the way out;
    ``limit`` overrides the ``frac * n_fp`` cap. Returns (filtered pairs,
    excluded-fingerprint mask over the rebased span)."""
    v = pairs.valid
    local = pairs if base == 0 else Pairs(
        idx1=torch.where(v, pairs.idx1 - base, INVALID),
        idx2=torch.where(v, pairs.idx2 - base, INVALID),
        sim=pairs.sim, valid=v)
    filt, excluded = lsh_mod.occurrence_filter(
        local, n_fp, lcfg.occurrence_frac, limit=limit)
    if base == 0:
        return filt, excluded
    keep = filt.valid
    return Pairs(idx1=torch.where(keep, pairs.idx1, INVALID),
                 idx2=torch.where(keep, pairs.idx2, INVALID),
                 sim=torch.where(keep, pairs.sim, 0),
                 valid=keep), excluded


class RollingPairFilter:
    """Rolling per-window §6.5 occurrence filter + clustering.

    Every emitted pair is assigned to the window of its *later* member.
    Once the processed-id frontier passes a window's end, no further pair
    can land in it, so the window closes: the occurrence filter runs over
    its pairs with ids rebased into the static [w_start - lookback,
    w_start + window) span (the sliding index window bounds how far back
    partners reach), survivors are channel-merged and diagonal-clustered
    exactly like finalize, and only the compact event rows are kept.
    Rows handed out (``rows_tail`` / ``all_rows``) pass
    ``merge_boundary_rows`` first, so clusters split at a window close
    re-merge before association. The clustering runs on ``device``.
    """

    def __init__(self, cfg: DetectConfig, window: int, lookback: int,
                 pad_to: int = 1024, device=None):
        if window <= 0 or lookback <= 0:
            raise ValueError(f"need positive filter window and lookback, "
                             f"got {window}, {lookback}")
        self.cfg = cfg
        self.window = int(window)
        self.lookback = int(lookback)
        self.pad_to = pad_to
        self.device = utils.resolve_device(device)
        self.w_start = 0
        self.buf: list[np.ndarray] = []     # open-window (m, 3) triplets
        self.buf_rows = 0
        self.peak_rows = 0
        self.event_rows: list[np.ndarray] = []  # closed (k, 5) rows, active
        self.archive_rows: list[np.ndarray] = []  # retired from association
        self.windows_closed = 0
        self.pairs_seen = 0
        self.pairs_kept = 0

    def add(self, tri: np.ndarray) -> None:
        tri = np.asarray(tri).reshape(-1, 3)
        if tri.shape[0]:
            self.buf.append(tri)
            self.buf_rows += tri.shape[0]
            self.peak_rows = max(self.peak_rows, self.buf_rows)
            self.pairs_seen += tri.shape[0]

    def advance(self, frontier: int) -> int:
        """Close every window whose end the processed frontier has passed."""
        closed = 0
        while frontier >= self.w_start + self.window:
            self._close(self.w_start + self.window)
            closed += 1
        return closed

    def close_all(self, frontier: int) -> None:
        """Flush the open tail window (finalize boundary)."""
        self.advance(frontier)
        if self.buf_rows:
            self._close(self.w_start + self.window)

    def rows_tail(self, min_onset: int) -> np.ndarray:
        """Active event rows reaching ``min_onset`` or later (association
        feed), boundary-merged. The floor applies to the end of each
        merged span (onset + extent): a fresh row merged into an older
        cluster inherits the older onset and must still be fed."""
        if not self.event_rows:
            return np.zeros((0, 5), np.int64)
        rows = merge_boundary_rows(np.concatenate(self.event_rows, axis=0),
                                   self.cfg.align)
        return rows[rows[:, 1] + rows[:, 2] >= min_onset]

    def retire_below(self, min_onset: int) -> None:
        """Move rows the association floor has passed into the archive, so
        the per-push association scan stays O(active window); they remain
        part of ``all_rows`` for finalize."""
        if not self.event_rows:
            return
        rows = np.concatenate(self.event_rows, axis=0)
        old = rows[:, 1] < min_onset
        if not old.any():
            return
        self.archive_rows.append(rows[old])
        keep = rows[~old]
        self.event_rows = [keep] if keep.shape[0] else []

    def all_rows(self) -> np.ndarray:
        rows = self.archive_rows + self.event_rows
        if not rows:
            return np.zeros((0, 5), np.int64)
        return merge_boundary_rows(np.concatenate(rows, axis=0),
                                   self.cfg.align)

    def _close(self, w_end: int) -> None:
        tri = (np.concatenate(self.buf, axis=0) if self.buf
               else np.zeros((0, 3), np.int64))
        in_w = tri[:, 1] < w_end
        cur, rest = tri[in_w], tri[~in_w]
        self.buf = [rest] if rest.shape[0] else []
        self.buf_rows = int(rest.shape[0])
        if cur.shape[0]:
            rows = self._filter_cluster(cur)
            if rows.shape[0]:
                self.event_rows.append(rows)
        self.w_start = w_end
        self.windows_closed += 1

    def _filter_cluster(self, tri: np.ndarray) -> np.ndarray:
        """One window's triplets → occurrence-filtered clustered rows."""
        lcfg, acfg = self.cfg.lsh, self.cfg.align
        pairs = pairs_from_triplets(tri, self.pad_to, self.device)
        if lcfg.occurrence_frac > 0:
            pairs, _ = host_occurrence_filter(
                pairs, self.lookback + self.window, lcfg,
                base=self.w_start - self.lookback,
                limit=max(1, int(lcfg.occurrence_frac * self.window)))
        self.pairs_kept += int(pairs.count())
        merged = align_mod.merge_channels(
            [(pairs.dt, pairs.idx1, pairs.sim, pairs.valid)],
            acfg.channel_threshold)
        return events_to_rows(align_mod.cluster_station(merged, acfg))

    def snapshot(self) -> tuple[dict, dict]:
        buf = (np.concatenate(self.buf, axis=0).astype(np.int64)
               if self.buf else np.zeros((0, 3), np.int64))
        rows = self.archive_rows + self.event_rows
        raw = (np.concatenate(rows, axis=0) if rows
               else np.zeros((0, 5), np.int64))
        return ({"buf": buf, "events": raw},
                {"w_start": self.w_start, "windows_closed":
                 self.windows_closed, "pairs_seen": self.pairs_seen,
                 "pairs_kept": self.pairs_kept, "peak_rows": self.peak_rows})

    def restore(self, arrays: dict, scalars: dict) -> None:
        buf = np.asarray(arrays["buf"], np.int64).reshape(-1, 3)
        self.buf = [buf] if buf.shape[0] else []
        self.buf_rows = int(buf.shape[0])
        rows = np.asarray(arrays["events"], np.int64).reshape(-1, 5)
        self.archive_rows = []
        self.event_rows = [rows] if rows.shape[0] else []
        self.w_start = int(scalars["w_start"])
        self.windows_closed = int(scalars["windows_closed"])
        self.pairs_seen = int(scalars["pairs_seen"])
        self.pairs_kept = int(scalars["pairs_kept"])
        self.peak_rows = int(scalars["peak_rows"])


# per-chunk wall samples retained for the percentile view; older samples
# fold into wall_total_s, so host memory is O(1) on unbounded streams
WALL_WINDOW = 1024


@dataclasses.dataclass
class StreamStats:
    chunks: int = 0
    blocks: int = 0
    samples: int = 0
    fingerprints: int = 0
    pairs: int = 0
    wall_total_s: float = 0.0
    chunk_wall_s: collections.deque = dataclasses.field(
        default_factory=lambda: collections.deque(maxlen=WALL_WINDOW))

    def record_wall(self, dt: float) -> None:
        self.wall_total_s += dt
        self.chunk_wall_s.append(dt)

    def summary(self) -> dict:
        wall = np.asarray(self.chunk_wall_s or [0.0])
        total = float(self.wall_total_s)
        return {
            "chunks": self.chunks,
            "blocks": self.blocks,
            "samples": self.samples,
            "fingerprints": self.fingerprints,
            "pairs": self.pairs,
            "wall_s": round(total, 4),
            # percentiles over the rolling window (recent behavior)
            "chunk_ms_p50": round(float(np.percentile(wall, 50)) * 1e3, 3),
            "chunk_ms_p95": round(float(np.percentile(wall, 95)) * 1e3, 3),
            "chunks_per_s": round(self.chunks / max(total, 1e-9), 2),
            "samples_per_s": round(self.samples / max(total, 1e-9), 1),
        }


class StationStream:
    """Incremental detection state for a single station.

    ``external=True`` (set by a pooled ``StreamingDetector``) keeps only
    host-side state here — ring framing, reservoir, rolling filter,
    stats — while the owner steps the device state through the pooled
    step and feeds this station's slice back via ``_consume``.
    """

    def __init__(self, cfg: DetectConfig, scfg: StreamConfig,
                 med_mad: tuple | None = None, external: bool = False,
                 telemetry: StreamTelemetry | None = None, device=None):
        self.cfg = cfg
        self.scfg = scfg
        self.device = utils.resolve_device(device)
        # detector-shared telemetry hub; a standalone station gets its own
        self.telemetry = telemetry or StreamTelemetry(1)
        fcfg, lcfg = cfg.fingerprint, cfg.lsh
        self.external = external
        self.fused = scfg.fused
        self.ring = WaveformRing(fcfg, scfg.block_fingerprints,
                                 reorder_horizon=scfg.reorder_horizon_samples,
                                 max_gap=scfg.max_gap_samples)
        self.mad = StreamingMAD(scfg.reservoir_rows, fcfg.n_coeff,
                                seed=scfg.seed)
        # pk_words resolved against this detector's fingerprint dim so
        # the verify ring rows match what the binarizer packs
        self.icfg = scfg.effective_index(fcfg.fp_dim)
        self._state: IndexState | None = index_mod.init_index(
            lcfg, self.icfg, 1, self.device)
        self.mappings = lsh_mod.hash_mappings(fcfg.fp_dim, lcfg, self.device)
        self.fstate: fused_mod.FusedState | None = None
        self._halo_ok = False
        self._med_mad: tuple[torch.Tensor, torch.Tensor] | None = None
        self._owner = None          # pooled detector backref (+ index)
        self._pool_idx = 0
        if med_mad is not None:
            self._set_frozen(med_mad[0], med_mad[1])
        # (base_id, block, coeffs-or-None, gap_mask-or-None)
        self.pending: list[tuple[int, np.ndarray, torch.Tensor | None,
                                 np.ndarray | None]] = []
        # step guard counters (ring.quality covers the ingest side).
        # suppressed_fingerprints counts every fingerprint masked out of
        # the step for any reason — gap overlap or duplicate flag — so it
        # is a superset of duplicate_fingerprints
        self.qc = {"duplicate_fingerprints": 0, "saturated_lookups": 0,
                   "suppressed_fingerprints": 0, "limited_pairs": 0}
        # sample-exact repeated-segment detector state (window hashes of
        # the last dup_window_fingerprints fingerprints)
        self.dup_window = scfg.dup_window_fingerprints
        self._dup_hist: collections.deque[tuple[int, int]] = \
            collections.deque()
        self._dup_map: dict[int, int] = {}   # hash -> newest fp id
        self.triplets: list[np.ndarray] = []            # (m, 3) idx1,idx2,sim
        self.rolling = scfg.filter_window_fingerprints > 0
        self.filter = (RollingPairFilter(cfg, scfg.filter_window_fingerprints,
                                         scfg.window_fingerprints,
                                         device=self.device)
                       if self.rolling else None)
        self.processed_fp = 0       # ids fully through the device step
        self._tri_rows = 0
        self.peak_tri_rows = 0
        self.stats = StreamStats()

    # -- device-state views --------------------------------------------------

    @property
    def state(self) -> IndexState:
        """This station's one-station index state, wherever it lives."""
        if self.fstate is not None:
            return self.fstate.index
        if self._owner is not None and self._owner.pstate is not None:
            return self._owner._pool_slice(self._pool_idx)
        if self._state is None:
            raise RuntimeError("station has no device state")
        return self._state

    @property
    def med_mad(self) -> tuple[torch.Tensor, torch.Tensor] | None:
        return self._med_mad

    @property
    def stats_frozen(self) -> bool:
        return self._med_mad is not None

    def _set_frozen(self, med, mad) -> None:
        # own copies on the detector's device: the caller's arrays (numpy,
        # possibly read-only, or tensors) are never aliased
        self._med_mad = tuple(
            (x if isinstance(x, torch.Tensor)
             else torch.from_numpy(np.array(x, np.float32)))
            .to(device=self.device, dtype=torch.float32).clone()
            for x in (med, mad))
        if self.fused and not self.external:
            self.fstate = fused_mod.init_state(
                self._state, self.cfg.fingerprint.halo_samples,
                *self._med_mad)
            self._state = None      # the fused state owns the buffers now
            self._halo_ok = False

    def host_state_rows(self) -> int:
        """Candidate triplet rows currently buffered host-side — the
        quantity the rolling filter bounds."""
        return self.filter.buf_rows if self.rolling else self._tri_rows

    def quality_summary(self) -> dict:
        """Ingest reconciliation + step guard counters (the reference's
        key set; the pooled detector sums these through ``merge_counts``)."""
        return tele_mod.quality_view(self.ring.quality, self.qc)

    # -- ingestion -----------------------------------------------------------

    def push(self, chunk: np.ndarray, offset: int | None = None) -> int:
        """Ingest one chunk (optionally placed at an absolute sample
        ``offset`` — late/overlapping/gapped arrivals are reconciled by
        the ring); returns pairs emitted by its ready blocks."""
        if self.external:
            raise RuntimeError(
                "pooled stations are pushed through their StreamingDetector")
        self.telemetry.start()
        t0 = time.perf_counter()
        emitted = 0
        with self.telemetry.tracer.span("ingest", station=self._pool_idx):
            for base_id, block, mask in self.ring.push(chunk, offset):
                emitted += self._ingest_block(base_id, block, mask)
        n_samples = int(np.asarray(chunk).size)
        self.stats.chunks += 1
        self.stats.samples += n_samples
        wall = time.perf_counter() - t0
        self.stats.record_wall(wall)
        self.telemetry.record_chunk(self._pool_idx, wall, n_samples)
        return emitted

    def _flag_duplicates(self, base_id: int, block: np.ndarray,
                         mask: np.ndarray | None,
                         end_id: int | None = None) -> np.ndarray | None:
        """Sample-exact repeated-segment detector (host side).

        Hashes every (still-valid) fingerprint's raw sample window and
        flags exact repeats of any window seen within the last
        ``dup_window_fingerprints`` ids — telemetry-duplicated blocks and
        flat-lined channels give bit-exact windows, repeating earthquakes
        never do (independent noise floors). Flagged fingerprints merge
        into the block's validity mask: suppressed in the step, never
        inserted. ``end_id`` is one past the last fingerprint this block
        consumes from the id space (a flush tail consumes fewer than a
        whole block). Its wall time is the ``dup_hash`` span.
        """
        if self.dup_window <= 0:
            return mask
        with self.telemetry.tracer.span("dup_hash", station=self._pool_idx):
            fcfg = self.cfg.fingerprint
            w, lag = fcfg.window_samples, fcfg.lag_samples
            n = self.scfg.block_fingerprints
            valid = (np.ones(n, bool) if mask is None
                     else np.asarray(mask, bool).copy())
            flagged = 0
            block = np.ascontiguousarray(block, np.float32)
            # fingerprint windows overlap by w - lag: each lag-aligned stride
            # is digested once and a fingerprint's hash combines its k
            # full-stride digests plus the sub-stride tail — still exactly
            # window equality (up to hash collision), at ~1x the input bytes
            k, tail = w // lag, w % lag
            strides: list[bytes | None] = [None] * (n + k)

            def stride(s: int) -> bytes:
                if strides[s] is None:
                    strides[s] = hashlib.blake2b(
                        block[s * lag: (s + 1) * lag].tobytes(),
                        digest_size=8).digest()
                return strides[s]

            for i in range(n):
                if not valid[i]:
                    continue
                fid = base_id + i
                parts = b"".join(stride(i + j) for j in range(k))
                if tail:
                    t0 = (i + k) * lag
                    parts += block[t0: t0 + tail].tobytes()
                h = int.from_bytes(
                    hashlib.blake2b(parts, digest_size=8).digest(), "little")
                if h in self._dup_map:
                    valid[i] = False
                    flagged += 1
                else:
                    self._dup_map[h] = fid
                    self._dup_hist.append((fid, h))
            floor = (base_id + n if end_id is None else end_id) \
                - self.dup_window
            while self._dup_hist and self._dup_hist[0][0] < floor:
                old_id, old_h = self._dup_hist.popleft()
                if self._dup_map.get(old_h) == old_id:
                    del self._dup_map[old_h]
            if flagged:
                self.qc["duplicate_fingerprints"] += flagged
                return valid
            return mask

    def _on_device(self, x: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(x), device=self.device)

    def _ingest_block(self, base_id: int, block: np.ndarray,
                      mask: np.ndarray | None = None) -> int:
        mask = self._flag_duplicates(base_id, block, mask)
        if not self.stats_frozen:
            coeffs = block_coeffs(self._on_device(block),
                                  self.cfg.fingerprint)
            rows = coeffs.cpu().numpy()
            # gap-masked fingerprints hold sentinel samples — keep their
            # rows out of the §5.2 statistics reservoir
            self.mad.update(rows if mask is None else rows[mask])
            # the fused drain recomputes coefficients inside its step;
            # the unfused drain replays the exact buffered coefficients
            self.pending.append((base_id, np.asarray(block, np.float32),
                                 None if self.fused else coeffs, mask))
            warm = self.scfg.stats_warmup_blocks
            if warm > 0 and len(self.pending) >= warm:
                self._freeze_stats()
                return self._drain_pending()
            return 0
        return self._process(base_id, block=block, valid=mask, primed=True)

    def _freeze_stats(self) -> None:
        med, mad = self.mad.stats()
        self._set_frozen(med, mad)

    def _drain_pending(self) -> int:
        emitted = 0
        for base_id, block, coeffs, mask in self.pending:
            emitted += self._process(base_id, block=block, coeffs=coeffs,
                                     valid=mask, primed=True)
        self.pending = []
        return emitted

    def _absorb_qc(self, qc: np.ndarray, n_masked: int) -> None:
        qc = np.asarray(qc).reshape(-1)
        self.qc["duplicate_fingerprints"] += int(qc[0])
        self.qc["saturated_lookups"] += int(qc[1])
        self.qc["limited_pairs"] += int(qc[2])
        # n_masked covers host-side suppression (gap overlap + sample-
        # exact dup flags); qc[0] adds the in-step dup_sig_tables
        # suppressions so the superset invariant holds either way
        self.qc["suppressed_fingerprints"] += int(n_masked) + int(qc[0])
        # the telemetry tail of the vector mirrors into registry counters
        self.telemetry.record_step(self._pool_idx, qc)

    def _process(self, base_id: int, *, block: np.ndarray | None = None,
                 coeffs: torch.Tensor | None = None,
                 valid: np.ndarray | None = None,
                 primed: bool = False, n_adv: int | None = None) -> int:
        """One block through the device step (fused or unfused chain).

        ``valid`` masks fingerprints suppressed in the step (gap overlap
        or a zero-padded flush tail). ``primed`` says the block is fully
        framed — its tail primes the device halo even when some
        fingerprints are masked (gap blocks), unlike a padded tail.
        ``n_adv`` is the id-space advance (defaults to a whole block; a
        flush tail advances only by its consumed fingerprints).
        """
        fcfg, lcfg = self.cfg.fingerprint, self.cfg.lsh
        knobs = _step_knobs(self.scfg)
        n = self.scfg.block_fingerprints
        vmask = (np.ones(n, bool) if valid is None
                 else np.asarray(valid, bool))
        if n_adv is None:
            n_adv = n
        wd = self.telemetry.watchdog
        wd.step_start()
        with self.telemetry.tracer.span("fused_step",
                                        station=self._pool_idx):
            if self.fused:
                if valid is None and self._halo_ok:
                    adv = np.asarray(block, np.float32)[-self.ring.advance:]
                    self.fstate, pairs, qc = fused_mod.step_advance(
                        self.fstate, self._on_device(adv), self.mappings,
                        base_id, fcfg, lcfg, **knobs)
                else:
                    self.fstate, pairs, qc = fused_mod.step_block(
                        self.fstate, self._on_device(block), self.mappings,
                        base_id, self._on_device(vmask), fcfg, lcfg,
                        **knobs)
                    # a zero-padded tail leaves the device halo dirty and
                    # the next block must re-seed through step_block; a
                    # fully framed (gap-masked) block primes it clean
                    self._halo_ok = valid is None or primed
            else:
                if coeffs is None:
                    coeffs = block_coeffs(self._on_device(block), fcfg)
                med, mad = self._med_mad
                self._state, pairs, qc = stream_step(
                    self._state, coeffs, med, mad, self.mappings, base_id,
                    self._on_device(vmask), fcfg, lcfg, **knobs)
            # one device→host copy of the whole step output: it waits for
            # the step, so the watchdog step and the fused-wall histogram
            # cover device time
            pairs_np, qc = _to_host(pairs, qc)
        self.telemetry.record_fused_wall(str(self._pool_idx), wd.step_end())
        self._absorb_qc(qc, n_adv - int(vmask[:n_adv].sum()))
        t_host = time.perf_counter()
        with self.telemetry.tracer.span("host_tail",
                                        station=self._pool_idx):
            m = self._consume(base_id, n_adv, int(vmask.sum()), pairs_np)
        self.telemetry.record_host_tail(self._pool_idx,
                                        time.perf_counter() - t_host)
        return m

    def _consume(self, base_id: int, n_adv: int, n_valid: int,
                 pairs_np: tuple[np.ndarray, ...]) -> int:
        """Host-side tail of a step: triplet accounting + rolling filter.

        Shared by the solo path and the pooled detector (which hands each
        station its slice of the pooled step output). ``n_adv`` advances
        the processed-id frontier (the block's whole id span, gaps
        included); ``n_valid`` counts the real fingerprints.
        """
        i1, i2, sim, pv = pairs_np
        m = int(pv.sum())
        self.processed_fp = base_id + n_adv
        if m:
            tri = np.stack([i1[pv], i2[pv], sim[pv]], axis=1).astype(np.int64)
            if self.rolling:
                self.filter.add(tri)
            else:
                self.triplets.append(tri)
                self._tri_rows += m
        if self.rolling:
            self.filter.advance(self.processed_fp)
            self.peak_tri_rows = max(self.peak_tri_rows,
                                     self.filter.peak_rows)
        else:
            self.peak_tri_rows = max(self.peak_tri_rows, self._tri_rows)
        self.stats.blocks += 1
        self.stats.fingerprints += n_valid
        self.stats.pairs += m
        return m

    def flush(self) -> int:
        """Process the buffered tail: freeze stats if still warming up,
        drain pending blocks, and run the partial last block (masked).

        With ``stats_warmup_blocks == 0`` this is where the freeze always
        happens: the reservoir has absorbed the whole stream, so the
        buffered warm-up fingerprints are binarized with the matured
        statistics.
        """
        if self.external:
            return 0                # the owning detector flushes the pool
        emitted = 0
        ready = 0
        for base_id, block, mask in self.ring.flush_ready():
            ready += self._ingest_block(base_id, block, mask)
        part = self.ring.flush_partial()
        part_coeffs = None
        if part is not None:
            base_id, block, mask = part
            mask = self._flag_duplicates(base_id, block, mask,
                                         end_id=self.ring.next_fp)
            part = (base_id, block, mask)
            if not self.stats_frozen or not self.fused:
                part_coeffs = block_coeffs(self._on_device(block),
                                           self.cfg.fingerprint)
            if not self.stats_frozen:
                self.mad.update(part_coeffs.cpu().numpy()[mask])
        if not self.stats_frozen:
            if self.mad.filled < 2:
                return ready  # not enough signal ever arrived
            self._freeze_stats()
            emitted += self._drain_pending()
        emitted += ready
        if part is not None:
            base_id, block, mask = part
            emitted += self._process(base_id, block=block,
                                     coeffs=part_coeffs, valid=mask,
                                     n_adv=self.ring.next_fp - base_id)
        return emitted

    def accumulated_pairs(self, pad_to: int = 1024) -> Pairs:
        """All emitted triplets as a masked fixed-size ``Pairs``."""
        tri = (np.concatenate(self.triplets, axis=0) if self.triplets
               else np.zeros((0, 3), np.int64))
        return pairs_from_triplets(tri, pad_to, self.device)

    def finalize(self) -> tuple[Events, Pairs, dict]:
        """Occurrence filter + channel merge + diagonal clustering.

        Parity mode runs the reduction over the full accumulated pair set.
        Bounded mode closes the open rolling window and returns the
        per-window events (boundary-merged); raw pairs were retired window
        by window, so the returned ``Pairs`` is empty.
        """
        self.flush()
        lcfg, acfg = self.cfg.lsh, self.cfg.align
        n_fp = self.ring.next_fp
        if self.rolling:
            self.filter.close_all(self.processed_fp)
            events = events_from_rows(self.filter.all_rows(),
                                      device=self.device)
            fstats = {
                "fingerprints": n_fp,
                "pairs": self.filter.pairs_kept,
                "windows": self.filter.windows_closed,
                "events": int(events.count()),
                "peak_buffered_triplets": self.peak_tri_rows,
                "quality": self.quality_summary(),
            }
            return events, pairs_from_triplets(np.zeros((0, 3)),
                                               device=self.device), fstats
        pairs = self.accumulated_pairs()
        fstats = {"fingerprints": n_fp, "quality": self.quality_summary()}
        if lcfg.occurrence_frac > 0 and n_fp > 0:
            pairs, excluded = host_occurrence_filter(pairs, n_fp, lcfg)
            fstats["excluded_fingerprints"] = int(excluded.sum())
        merged = align_mod.merge_channels(
            [(pairs.dt, pairs.idx1, pairs.sim, pairs.valid)],
            acfg.channel_threshold)
        events = align_mod.cluster_station(merged, acfg)
        fstats["pairs"] = int(pairs.count())
        fstats["events"] = int(events.count())
        fstats["peak_buffered_triplets"] = self.peak_tri_rows
        return events, pairs, fstats

    # -- snapshot / restore -------------------------------------------------

    def snapshot_state(self) -> tuple[dict, dict]:
        """(flat host arrays, json-able extra) capturing this station
        exactly, in the reference's layout: the index leaves without the
        station axis (uint32 where the reference's are), every array an
        owned copy (a background write never sees a later step)."""
        index = convert.index_state_to_numpy(self.state)
        arrays = {f"index/{k}": np.array(v[0]) for k, v in index.items()}
        ring_a, ring_s = self.ring.snapshot()
        arrays["ring/buf"] = ring_a["buf"]
        arrays["ring/vbuf"] = ring_a["vbuf"]
        mad_a, mad_s = self.mad.snapshot()
        arrays["mad/rows"] = mad_a["rows"]
        arrays["stats/chunk_wall_s"] = np.asarray(self.stats.chunk_wall_s,
                                                  np.float64)
        extra = {
            "ring": ring_s, "mad": mad_s,
            "frozen": self.stats_frozen,
            "processed_fp": self.processed_fp,
            "peak_tri_rows": self.peak_tri_rows,
            "qc": dict(self.qc),
            "stats": {"chunks": self.stats.chunks,
                      "blocks": self.stats.blocks,
                      "samples": self.stats.samples,
                      "fingerprints": self.stats.fingerprints,
                      "pairs": self.stats.pairs,
                      "wall_total_s": self.stats.wall_total_s},
        }
        if self.stats_frozen:
            arrays["med"] = np.array(self._med_mad[0].cpu().numpy())
            arrays["mad_stat"] = np.array(self._med_mad[1].cpu().numpy())
        if self.dup_window > 0:
            arrays["dup/ids"] = np.asarray(
                [i for i, _ in self._dup_hist], np.int64)
            arrays["dup/hash"] = np.asarray(
                [h for _, h in self._dup_hist], np.uint64)
        if self.pending:
            n = self.scfg.block_fingerprints
            arrays["pending/base"] = np.asarray(
                [b for b, _, _, _ in self.pending], np.int64)
            arrays["pending/blocks"] = np.stack(
                [b for _, b, _, _ in self.pending]).astype(np.float32)
            # gap masks; an all-True row restores to None (clean block)
            arrays["pending/valid"] = np.stack(
                [np.ones(n, bool) if m is None else np.asarray(m, bool)
                 for _, _, _, m in self.pending])
            if not self.fused:      # unfused drains replay exact coeffs
                arrays["pending/coeffs"] = np.stack(
                    [c.cpu().numpy() for _, _, c, _ in self.pending]) \
                    .astype(np.float32)
        if self.rolling:
            f_a, f_s = self.filter.snapshot()
            arrays["filter/buf"] = f_a["buf"]
            arrays["filter/events"] = f_a["events"]
            extra["filter"] = f_s
        else:
            arrays["triplets"] = (
                np.concatenate(self.triplets, axis=0).astype(np.int64)
                if self.triplets else np.zeros((0, 3), np.int64))
        return arrays, extra

    def restore_state(self, arrays: dict, extra: dict) -> None:
        """Load ``snapshot_state``'s arrays and extra (this package's or
        the reference's). Snapshots that lack the guard leaves get the
        reference's defaults: the traffic counter from the cursor, the
        decay epoch from the processed frontier, empty occurrence and
        packed rings."""
        init = convert.index_state_to_numpy(
            index_mod.init_index(self.cfg.lsh, self.icfg, 1, "cpu"))
        window = self.scfg.window_fingerprints
        leaves = {
            "sig": arrays["index/sig"], "ids": arrays["index/ids"],
            "cursor": arrays["index/cursor"],
            "inserted": arrays["index/inserted"],
            "traffic": arrays.get("index/traffic", arrays["index/cursor"]),
            "occ": arrays.get("index/occ", init["occ"][0]),
            "epoch": arrays.get("index/epoch", np.int32(
                max(0, int(extra["processed_fp"]) - window)
                // max(window, 1))),
            "pk": arrays.get("index/pk", init["pk"][0])}
        for k in ("sig", "occ", "pk"):
            if np.shape(leaves[k]) != init[k].shape[1:]:
                raise ValueError(
                    f"snapshot index/{k} has shape {np.shape(leaves[k])}, "
                    f"this StreamConfig's is {init[k].shape[1:]}")
        self._state = convert.index_state(leaves, self.device)
        self.fstate = None
        self._halo_ok = False
        ring_a = {"buf": arrays["ring/buf"]}
        if "ring/vbuf" in arrays:
            ring_a["vbuf"] = arrays["ring/vbuf"]
        self.ring.restore(ring_a, extra["ring"])
        self.mad.restore({"rows": arrays["mad/rows"]}, extra["mad"])
        self.qc.update(extra.get("qc", {}))
        self._dup_hist.clear()
        self._dup_map = {}
        if "dup/ids" in arrays:
            ids = np.asarray(arrays["dup/ids"], np.int64)
            hashes = np.asarray(arrays["dup/hash"], np.uint64)
            for i in range(ids.shape[0]):
                fid, h = int(ids[i]), int(hashes[i])
                self._dup_hist.append((fid, h))
                self._dup_map[h] = fid
        self._med_mad = None
        if extra["frozen"]:
            self._set_frozen(arrays["med"], arrays["mad_stat"])
        self.pending = []
        if "pending/base" in arrays:
            bases = np.asarray(arrays["pending/base"], np.int64)
            blocks = np.asarray(arrays["pending/blocks"], np.float32)
            coeffs = (np.asarray(arrays["pending/coeffs"], np.float32)
                      if "pending/coeffs" in arrays else None)
            masks = (np.asarray(arrays["pending/valid"], bool)
                     if "pending/valid" in arrays else None)

            def _mask(i):
                if masks is None or masks[i].all():
                    return None
                return masks[i]

            self.pending = [
                (int(bases[i]), blocks[i],
                 None if coeffs is None else self._on_device(coeffs[i]),
                 _mask(i))
                for i in range(bases.shape[0])]
        if self.rolling:
            self.filter.restore(
                {"buf": arrays["filter/buf"],
                 "events": arrays["filter/events"]}, extra["filter"])
            self.triplets = []
            self._tri_rows = 0
        else:
            tri = np.asarray(arrays["triplets"], np.int64).reshape(-1, 3)
            self.triplets = [tri] if tri.shape[0] else []
            self._tri_rows = int(tri.shape[0])
        self.processed_fp = int(extra["processed_fp"])
        self.peak_tri_rows = int(extra["peak_tri_rows"])
        s = extra["stats"]
        wall = np.asarray(arrays["stats/chunk_wall_s"], np.float64)
        self.stats = StreamStats(
            chunks=int(s["chunks"]), blocks=int(s["blocks"]),
            samples=int(s["samples"]),
            fingerprints=int(s["fingerprints"]), pairs=int(s["pairs"]),
            # snapshots without the running total keep the exact total
            # through the stored sum
            wall_total_s=float(s.get("wall_total_s", wall.sum())),
            chunk_wall_s=collections.deque(wall.tolist(),
                                           maxlen=WALL_WINDOW))


def _station_stats(med_mad, n_stations: int) -> list:
    """Each station's frozen statistics: one (med, mad) pair shared by
    every station, or (S, n_coeff) arrays giving each station its own."""
    if med_mad is None:
        return [None] * n_stations
    med, mad = med_mad
    if getattr(med, "ndim", 1) == 1:
        return [(med, mad)] * n_stations
    if med.shape[0] != n_stations or mad.shape[0] != n_stations:
        raise ValueError(f"per-station statistics must have {n_stations} "
                         f"rows, got {tuple(med.shape)}, {tuple(mad.shape)}")
    return [(med[i], mad[i]) for i in range(n_stations)]


class StreamingDetector:
    """Multi-station streaming FAST: push chunks, read detections.

    ``push`` accepts (n_stations, chunk_len) or a 1-D chunk for a single
    station; chunk lengths may vary call to call. ``finalize`` runs the
    per-station alignment and (when n_stations ≥ 2) the network
    association, as ``core.detect.detect_events`` does. In bounded mode
    each push also polls the incremental association: newly final
    multi-station detections land in ``alerts`` as their windows close.

    With ``StreamConfig.pooled`` (the default) and ≥ 2 stations, the
    stations' device states are stacked into one pool and every ready
    block steps all stations through one pooled step; the per-station
    ``StationStream`` objects keep only host-side state. ``device``
    (default ``cuda``) holds the stations' state before the pool exists,
    the warm-up statistics, the serving copies and the host tail's
    tensors, and, without a mesh, the pool and every step.

    With ``sharded`` (the default) the pool is split over the ``stations``
    mesh that ``dist.station_mesh(n_stations, devices=devices)`` returns
    (``self.mesh``): ``devices`` defaults to every visible card when
    ``device`` is a card, and to no mesh on the CPU. The pool carries
    ``self.pool_pad`` pad rows, so that its width divides the mesh; a mesh
    may name one device several times (``[torch.device("cpu")] * 3``).

    ``med_mad`` freezes the §5.2 statistics up front: one (n_coeff,) pair
    for every station, as in the reference, or (n_stations, n_coeff)
    arrays, one row a station (the statistics ``core.detect`` computes per
    station, so a stream can be held to the batch driver). Without it
    each station's reservoir freezes them after ``stats_warmup_blocks``.
    """

    def __init__(self, cfg: DetectConfig, scfg: StreamConfig | None = None,
                 n_stations: int = 1, med_mad: tuple | None = None,
                 station_xy: np.ndarray | None = None, device=None,
                 devices=None):
        self.cfg = cfg
        self.scfg = scfg or StreamConfig()
        self.device = utils.resolve_device(device)
        # the devices a station mesh may span: every visible card for a
        # detector on the card, none on the CPU unless named
        self._devices = (devices if devices is not None
                         or self.device.type == "cuda" else ())
        self.station_xy = (np.asarray(station_xy, np.float32)
                           if station_xy is not None else None)
        if self.station_xy is not None \
                and self.station_xy.shape != (n_stations, 2):
            raise ValueError(f"station_xy must be ({n_stations}, 2) km, "
                             f"got {self.station_xy.shape}")
        # location/magnitude tier: active when a LocateConfig and station
        # geometry are both in hand (and there is a network to associate)
        self.locating = (cfg.locate is not None
                         and self.station_xy is not None
                         and n_stations >= 2)
        self.pooled = (self.scfg.fused and self.scfg.pooled
                       and n_stations >= 2)
        # the sharded station pool: a mesh where more than one device can
        # take a shard, else None (the one-device pool); the pool is padded
        # with throwaway station rows to a multiple of the mesh width
        self.mesh = self._probe_mesh(n_stations)
        self.pool_pad = dist.padded_pool_width(n_stations,
                                               self.mesh) - n_stations
        self.telemetry = StreamTelemetry(n_stations)
        self.stations = [StationStream(cfg, self.scfg, med_mad=mm,
                                       external=self.pooled,
                                       telemetry=self.telemetry,
                                       device=self.device)
                         for mm in _station_stats(med_mad, n_stations)]
        self.pstate: fused_mod.FusedState | None = None
        self._halo_ok = False
        self.mappings = self.stations[0].mappings
        for i, st in enumerate(self.stations):
            st._owner, st._pool_idx = self, i
        if self.pooled and med_mad is not None:
            self._build_pool()
        self.rolling = self.scfg.filter_window_fingerprints > 0
        self.alerts: list[np.ndarray] = []   # (k, ALERT_COLS) rows
        # alerted keys + the best station multiplicity each has alerted
        # at: (dt, onset, best_n_stations). A group whose multiplicity
        # later grows past its recorded best re-emits as an upgrade.
        self._emitted = np.zeros((0, 3), np.int64)
        self._assoc_lo = 0
        # bounded amplitude timeline (magnitude source): per station,
        # lag-bin → peak |sample| seen for that bin, max-merged across
        # (possibly late / duplicated) arrivals and pruned with the
        # association floor
        self._amp: list[dict[int, float]] = [{} for _ in range(n_stations)]
        self._polled_windows = 0  # window closes seen by the last poll
        # monotonic corpus version: bumps whenever ingestion may have
        # changed the index pool, so a serving engine can gate its
        # pool_serving_state() refreshes on "did anything arrive?"
        self.serving_version = 0

    def push(self, chunk: np.ndarray, offset: int | None = None) -> int:
        """Ingest one network chunk; ``offset`` places it at an absolute
        sample offset on every station's timeline (late / duplicated /
        gapped telemetry is reconciled per station by the rings; chunks
        are network-aligned, so one offset serves all stations — a
        single-station outage is NaN samples inside the chunk)."""
        chunk = np.asarray(chunk, np.float32)
        if chunk.ndim == 1:
            chunk = chunk[None, :]
        if chunk.shape[0] != len(self.stations):
            raise ValueError(f"chunk has {chunk.shape[0]} station rows, the "
                             f"detector {len(self.stations)}")
        if self.locating:
            pos = (self.stations[0].ring.frontier if offset is None
                   else int(offset))
            for i in range(chunk.shape[0]):
                self._note_amps(i, pos, chunk[i])
        if self.pooled:
            emitted = self._pool_push(chunk, offset)
        else:
            emitted = sum(st.push(chunk[i], offset)
                          for i, st in enumerate(self.stations))
        if self.rolling and len(self.stations) >= 2:
            new = self.poll_detections()
            if new.shape[0]:
                self.alerts.append(new)
        self.serving_version += 1
        return emitted

    # -- pooled stepping ----------------------------------------------------

    def _probe_mesh(self, n_stations: int) -> dist.StationMesh | None:
        if not (self.pooled and self.scfg.sharded):
            return None
        return dist.station_mesh(n_stations, devices=self._devices)

    def _build_pool(self) -> None:
        """Stack the stations' device state into one pool state. With a
        mesh, the pool is padded to a multiple of the mesh width (pad rows:
        a fresh index and station 0's statistics) and built as one
        sub-pool a mesh device, each on its device from its own rows; the
        hash mappings are copied to each distinct device once, here."""
        states = [st._state for st in self.stations]
        meds = [st._med_mad[0] for st in self.stations]
        mads = [st._med_mad[1] for st in self.stations]
        halo = self.cfg.fingerprint.halo_samples
        if self.mesh is None:
            self.pstate = fused_mod.init_pool_state(states, halo, meds, mads)
            self._pool_mappings = self.mappings
        else:
            states += [None] * self.pool_pad
            meds += [meds[0]] * self.pool_pad
            mads += [mads[0]] * self.pool_pad
            r = len(states) // self.mesh.size
            self.pstate = []
            for k, dev in enumerate(self.mesh.devices):
                rows = slice(k * r, (k + 1) * r)
                shard = [index_mod.init_index(self.cfg.lsh,
                                              self.stations[0].icfg, 1, dev)
                         if s is None
                         else dist.map_tensors(lambda x, d=dev: x.to(d), s)
                         for s in states[rows]]
                self.pstate.append(fused_mod.init_pool_state(
                    shard, halo, meds[rows], mads[rows]))
            self._pool_mappings = dist.replicate(self.mappings, self.mesh)
        for st in self.stations:
            st._state = None        # the pool owns the buffers now
        self._halo_ok = False

    def _pool_slice(self, station: int) -> IndexState:
        """One station's one-station view of the live pool."""
        if self.mesh is None:
            return index_mod.slice_state(self.pstate.index, station)
        k, j = divmod(station, self.pstate[0].halo.shape[0])
        return index_mod.slice_state(self.pstate[k].index, j)

    def _pad_rows(self, x: np.ndarray, fill=0) -> np.ndarray:
        """A host (S, ...) input with the pool's pad rows appended (zero
        samples, all-False masks): their output is never read, they only
        keep the rows a multiple of the mesh width."""
        if not self.pool_pad:
            return x
        pad = np.full((self.pool_pad,) + x.shape[1:], fill, x.dtype)
        return np.concatenate([x, pad])

    def _put(self, x: np.ndarray):
        """A host (S, ...) pool input on the pool's device, or with a mesh
        as the shards' row blocks, each straight onto its device."""
        if self.mesh is None:
            return self._on_device(x)
        return dist.put_rows(x, self.mesh)

    def _lockstep(self, per_st: list[list]) -> None:
        """The rings of a pool emit the same block ids (every station is
        pushed the same chunk lengths at the same offsets); a pool that
        re-indexed per station would diverge on gap data, so refuse."""
        ids = [[item[0] for item in items] for items in per_st]
        if any(i != ids[0] for i in ids):
            raise RuntimeError(f"pooled rings left lockstep: block ids {ids}")

    def _pool_push(self, chunk: np.ndarray, offset: int | None = None
                   ) -> int:
        self.telemetry.start()
        t0 = time.perf_counter()
        per_st = [st.ring.push(chunk[i], offset)
                  for i, st in enumerate(self.stations)]
        self._lockstep(per_st)
        emitted = 0
        with self.telemetry.tracer.span("ingest", station="pool"):
            for k in range(len(per_st[0])):
                base_id = per_st[0][k][0]
                blocks = np.stack([per_st[i][k][1]
                                   for i in range(len(self.stations))])
                masks = [per_st[i][k][2]
                         for i in range(len(self.stations))]
                emitted += self._pool_ingest_block(base_id, blocks, masks)
        wall = time.perf_counter() - t0
        for i, st in enumerate(self.stations):
            st.stats.chunks += 1
            st.stats.samples += int(chunk[i].size)
            st.stats.record_wall(wall)  # stations share the step
            self.telemetry.record_chunk(i, wall, int(chunk[i].size))
        return emitted

    def _on_device(self, x: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(x), device=self.device)

    def _pool_ingest_block(self, base_id: int, blocks: np.ndarray,
                           masks: list | None = None) -> int:
        if masks is None:
            masks = [None] * len(self.stations)
        masks = [st._flag_duplicates(base_id, blocks[i], masks[i])
                 for i, st in enumerate(self.stations)]
        if self.pstate is None:
            coeffs = pool_block_coeffs(self._on_device(blocks),
                                       self.cfg.fingerprint).cpu().numpy()
            for i, st in enumerate(self.stations):
                st.mad.update(coeffs[i] if masks[i] is None
                              else coeffs[i][masks[i]])
                st.pending.append((base_id, blocks[i], None, masks[i]))
            warm = self.scfg.stats_warmup_blocks
            if warm > 0 and len(self.stations[0].pending) >= warm:
                self._freeze_pool()
                return self._drain_pool()
            return 0
        return self._pool_process(base_id, blocks, masks=masks)

    def _freeze_pool(self) -> None:
        for st in self.stations:
            if not st.stats_frozen:
                st._freeze_stats()  # external: records stats only
        self._build_pool()

    def _drain_pool(self) -> int:
        emitted = 0
        pend = [st.pending for st in self.stations]
        for k in range(len(pend[0])):
            base_id = pend[0][k][0]
            blocks = np.stack([pend[i][k][1]
                               for i in range(len(self.stations))])
            masks = [pend[i][k][3] for i in range(len(self.stations))]
            emitted += self._pool_process(base_id, blocks, masks=masks)
        for st in self.stations:
            st.pending = []
        return emitted

    def _pool_process(self, base_id: int, blocks: np.ndarray,
                      masks: list | None = None, primed: bool = True,
                      n_adv: int | None = None) -> int:
        """One lockstep block through the pooled step.

        ``masks``: per-station gap masks (None entries = clean); a flush
        tail passes the shared tail mask per station with
        ``primed=False`` and the consumed id advance ``n_adv``. Only the
        advance route's (S, advance) new samples cross to the device on a
        clean primed block; the outputs come back in one copy (one a
        shard under a mesh, which also gets the pad rows' inputs).
        """
        fcfg, lcfg = self.cfg.fingerprint, self.cfg.lsh
        knobs = _step_knobs(self.scfg)
        n = self.scfg.block_fingerprints
        s = len(self.stations)
        clean = masks is None or all(m is None for m in masks)
        if n_adv is None:
            n_adv = n
        wd = self.telemetry.watchdog
        wd.step_start()
        with self.telemetry.tracer.span("fused_step", station="pool"):
            if clean and self._halo_ok and n_adv == n:
                adv = self._pad_rows(
                    blocks[:, -self.stations[0].ring.advance:])
                self.pstate, pairs, qc = fused_mod.pool_step_advance_sharded(
                    self.pstate, self._put(adv), self._pool_mappings,
                    base_id, fcfg, lcfg, **knobs, mesh=self.mesh)
                vm = np.ones((s, n), bool)
            else:
                vm = np.stack([
                    np.ones(n, bool) if (masks is None or masks[i] is None)
                    else np.asarray(masks[i], bool) for i in range(s)])
                self.pstate, pairs, qc = fused_mod.pool_step_block_sharded(
                    self.pstate, self._put(self._pad_rows(blocks)),
                    self._pool_mappings, base_id,
                    self._put(self._pad_rows(vm, fill=False)), fcfg, lcfg,
                    **knobs, mesh=self.mesh)
                self._halo_ok = clean or primed
            # one transfer + one sync for the whole pooled step output (a
            # sharded step has brought its outputs home already: one copy a
            # shard, one sync a device)
            (i1, i2, sim, pv), qc = _to_host(pairs, qc)
        # one watchdog step per pooled step (all stations share it)
        self.telemetry.record_fused_wall("pool", wd.step_end())
        t_host = time.perf_counter()
        emitted = 0
        with self.telemetry.tracer.span("host_tail", station="pool"):
            for i, st in enumerate(self.stations):
                st._absorb_qc(qc[i], n_adv - int(vm[i, :n_adv].sum()))
                emitted += st._consume(base_id, n_adv, int(vm[i].sum()),
                                       (i1[i], i2[i], sim[i], pv[i]))
        self.telemetry.record_host_tail("pool",
                                        time.perf_counter() - t_host)
        return emitted

    def _pool_flush(self) -> int:
        """Pool counterpart of ``StationStream.flush`` (lockstep rings ⇒
        every station tails at the same base id / consumed count)."""
        emitted = 0
        ready = 0
        per_st = [st.ring.flush_ready() for st in self.stations]
        self._lockstep(per_st)
        for k in range(len(per_st[0])):
            base_id = per_st[0][k][0]
            blocks = np.stack([per_st[i][k][1]
                               for i in range(len(self.stations))])
            masks = [per_st[i][k][2] for i in range(len(self.stations))]
            ready += self._pool_ingest_block(base_id, blocks, masks)
        parts = [st.ring.flush_partial() for st in self.stations]
        part = parts[0]
        if part is not None:
            parts = [(p[0], p[1],
                      st._flag_duplicates(p[0], p[1], p[2],
                                          end_id=st.ring.next_fp))
                     for st, p in zip(self.stations, parts)]
            part = parts[0]
        blocks = (np.stack([p[1] for p in parts])
                  if part is not None else None)
        if self.pstate is None:
            if part is not None:
                coeffs = pool_block_coeffs(
                    self._on_device(blocks),
                    self.cfg.fingerprint).cpu().numpy()
                for i, st in enumerate(self.stations):
                    st.mad.update(coeffs[i][parts[i][2]])
            if any(st.mad.filled < 2 for st in self.stations):
                return ready
            self._freeze_pool()
            emitted += self._drain_pool()
        emitted += ready
        if part is not None:
            base_id = part[0]
            masks = [p[2] for p in parts]
            n_adv = self.stations[0].ring.next_fp - base_id
            emitted += self._pool_process(base_id, blocks, masks=masks,
                                          primed=False, n_adv=n_adv)
        return emitted

    def flush(self) -> int:
        """Process buffered tails on every station (pool-aware)."""
        self.serving_version += 1
        if self.pooled:
            return self._pool_flush()
        return sum(st.flush() for st in self.stations)

    # -- elastic pool membership --------------------------------------------

    def _materialize_stations(self) -> None:
        """Give each real station its index slice of the pool back as its
        own state — the first half of a re-pack; pad rows are dropped
        (the next ``_build_pool`` makes fresh ones). Without a mesh the
        slices are views; from a sharded pool they are copies on
        ``device``. The rebuilt pool copies either."""
        if self.pstate is None:
            return
        for st in self.stations:
            view = self._pool_slice(st._pool_idx)
            st._state = (view if self.mesh is None else dist.map_tensors(
                lambda x: x.to(self.device, copy=True), view))
        self.pstate = None

    def _repack_pool(self) -> None:
        """Probe the mesh again for the current width, re-pad, re-split and
        rebuild the pool; the next block re-seeds the halo through
        ``pool_step_block_sharded``."""
        self.mesh = self._probe_mesh(len(self.stations))
        self.pool_pad = dist.padded_pool_width(
            len(self.stations), self.mesh) - len(self.stations)
        self.telemetry.n_stations = len(self.stations)
        self._build_pool()

    def add_station(self, med_mad=None) -> int:
        """Grow the live pool by one station; returns its index. The pool
        is re-padded and re-split for the new width (``_repack_pool``).

        The joining station enters at the network frontier: its ring
        mirrors a peer's framing position with the whole pre-join span
        marked missing, so the rings keep emitting the same block ids and
        the join span is masked out of the step rather than invented.
        ``med_mad`` defaults to station 0's frozen statistics. Serving
        engines built over the old width keep serving their copy; rebuild
        them to see the new station.
        """
        if not self.pooled:
            raise ValueError(
                "add_station needs a pooled detector (StreamConfig.fused"
                " + pooled with ≥2 stations at construction)")
        if self.locating:
            raise ValueError(
                "add_station cannot extend the locate tier: station_xy "
                "geometry is fixed at construction — rebuild the "
                "detector with the new geometry instead")
        if self.pstate is None \
                or not all(st.stats_frozen for st in self.stations):
            raise ValueError(
                "add_station requires a live pool (statistics frozen and "
                "the stacked state built); push warmup chunks first")
        if med_mad is None:
            med_mad = self.stations[0].med_mad
        self._materialize_stations()
        st = StationStream(self.cfg, self.scfg, med_mad=med_mad,
                           external=True, telemetry=self.telemetry,
                           device=self.device)
        st._owner, st._pool_idx = self, len(self.stations)
        peer = self.stations[0]
        st.ring.start = peer.ring.start
        st.ring.next_fp = peer.ring.next_fp
        st.ring.buf = np.zeros(peer.ring.buf.size, np.float32)
        st.ring.vbuf = np.zeros(peer.ring.buf.size, bool)
        st.ring.quality["missing_samples"] += int(peer.ring.buf.size)
        st.processed_fp = peer.processed_fp
        if st.rolling and st.processed_fp:
            st.filter.advance(st.processed_fp)  # join cost paid up front
        self.stations.append(st)
        self._amp.append({})
        self._repack_pool()
        self.serving_version += 1
        return st._pool_idx

    def remove_station(self, station: int) -> None:
        """Drop one station from the live pool (its index state and host
        buffers are discarded; later stations shift down, which renumbers
        pair / event station indices from here on) and rebuild the pool
        at the new width, re-padded and re-split."""
        if not self.pooled or self.pstate is None:
            raise ValueError("remove_station requires a live pooled "
                             "detector (statistics frozen)")
        if self.locating:
            raise ValueError(
                "remove_station cannot shrink the locate tier: "
                "station_xy geometry is fixed at construction")
        if not 0 <= station < len(self.stations):
            raise IndexError(station)
        if len(self.stations) < 2:
            raise ValueError("cannot remove the last station")
        self._materialize_stations()
        dropped = self.stations.pop(station)
        dropped._owner = None
        dropped._state = None
        self._amp.pop(station)
        for i, st in enumerate(self.stations):
            st._pool_idx = i
        self._repack_pool()
        self.serving_version += 1

    # -- association / location / finalize ----------------------------------

    def _note_amps(self, st_i: int, pos: int, chunk: np.ndarray) -> None:
        """Max-merge a chunk's |samples| into station ``st_i``'s lag-bin
        amplitude timeline (idempotent under duplicate delivery; NaN
        telemetry contributes nothing)."""
        lag = self.cfg.fingerprint.lag_samples
        b0 = pos // lag
        lead = pos - b0 * lag
        x = np.full(lead + chunk.size, np.nan, np.float32)
        x[lead:] = chunk
        nb = -(-x.size // lag)
        x = np.concatenate([x, np.full(nb * lag - x.size, np.nan,
                                       np.float32)])
        a = np.abs(x).reshape(nb, lag)
        vals = np.where(np.isfinite(a), a, -1.0).max(axis=1)
        d = self._amp[st_i]
        for b, vv in enumerate(vals):
            if vv >= 0:
                key = b0 + b
                prev = d.get(key)
                if prev is None or vv > prev:
                    d[key] = float(vv)

    def _amp_fn(self, st_i: int, fp_index: int) -> float | None:
        """Peak |amplitude| over fingerprint ``fp_index``'s analysis
        window, from the bounded timeline (None when no bin survives)."""
        fcfg = self.cfg.fingerprint
        w_bins = max(1, -(-fcfg.window_samples // fcfg.lag_samples))
        d = self._amp[st_i]
        vals = [d[b] for b in range(fp_index, fp_index + w_bins) if b in d]
        return max(vals) if vals else None

    def _station_weights(self) -> np.ndarray:
        """Live per-station stack weights from the ingest/guard QC
        counters (``core.locate.station_weights``)."""
        return locate_mod.station_weights(
            [st.quality_summary() for st in self.stations],
            [st.stats.samples for st in self.stations],
            [st.ring.next_fp for st in self.stations], self.cfg.locate)

    def _locate_rows(self, rows: np.ndarray, onset_mat: np.ndarray,
                     score_mat: np.ndarray) -> tuple[np.ndarray, int]:
        """Location/magnitude columns for fresh alert rows; returns the
        (moveout-filtered, with ``reject_inconsistent``) rows and the
        rejected count."""
        lcfg = self.cfg.locate
        fcfg = self.cfg.fingerprint
        t0 = time.perf_counter()
        weights = self._station_weights()
        det = {"valid": np.ones(rows.shape[0], bool),
               "station_onset": onset_mat}
        loc = locate_mod.locate_detections(
            det, self.station_xy, weights, fcfg.lag_samples / fcfg.fs,
            lcfg, device=self.device)
        mags = locate_mod.magnitudes_from_onsets(
            onset_mat, rows[:, 0], det["valid"], self._amp_fn, weights,
            score_mat)
        ok = np.isfinite(loc["x_km"])
        rows[:, 5] = np.where(ok, np.round(
            np.nan_to_num(loc["x_km"]) * 1e3), LOC_NONE).astype(np.int64)
        rows[:, 6] = np.where(ok, np.round(
            np.nan_to_num(loc["y_km"]) * 1e3), LOC_NONE).astype(np.int64)
        mok = np.isfinite(mags)
        rows[:, 7] = np.where(mok, np.round(
            np.nan_to_num(mags) * 1e3), MAG_NONE).astype(np.int64)
        rejected = 0
        if lcfg.reject_inconsistent:
            keep = np.asarray(loc["consistent"])
            rejected = int(rows.shape[0] - keep.sum())
            rows = rows[keep]
        self.telemetry.record_locate(
            groups=int(det["valid"].sum()),
            located=int(rows.shape[0]), rejected=rejected,
            wall=time.perf_counter() - t0)
        return rows, rejected

    def poll_detections(self) -> np.ndarray:
        """Incremental network association over closed-window events.

        Returns (k, ``ALERT_COLS``) int64 rows (dt, onset, n_stations,
        score, upgrade, x_mkm, y_mkm, mag_milli) for groups not alerted
        before, plus *upgrade* re-emissions — a previously alerted group
        whose station multiplicity has since grown re-emits with
        ``upgrade=1``. With the location tier on, each emitted row is
        migration-located and sized, and moveout-inconsistent rows are
        dropped (they may return later as upgrades); otherwise the
        location and magnitude columns hold ``LOC_NONE`` / ``MAG_NONE``.
        ``finalize`` remains the authoritative association over the full
        event history.
        """
        acfg = self.cfg.align
        if not self.rolling or len(self.stations) < 2:
            return np.zeros((0, ALERT_COLS), np.int64)
        # the active rows only change when a window closes — don't repeat
        # the association on pushes that closed nothing
        closed = sum(st.filter.windows_closed for st in self.stations)
        if closed == self._polled_windows:
            return np.zeros((0, ALERT_COLS), np.int64)
        self._polled_windows = closed
        per_station = [st.filter.rows_tail(self._assoc_lo)
                       for st in self.stations]
        if sum(r.shape[0] for r in per_station) == 0:
            return np.zeros((0, ALERT_COLS), np.int64)
        events = [events_from_rows(r, device=self.device)
                  for r in per_station]
        det = align_mod.associate_network(events, acfg, len(self.stations),
                                          with_onsets=self.locating)
        parts = [det["dt"][:, None], det["onset"][:, None],
                 det["n_stations"][:, None], det["score"][:, None],
                 det["valid"].to(det["dt"].dtype)[:, None]]
        if self.locating:
            parts += [det["station_onset"], det["station_score"]]
        cols = torch.cat(parts, dim=1).cpu().numpy()   # one copy a poll
        v = cols[:, 4] > 0
        rows = np.zeros((int(v.sum()), ALERT_COLS), np.int64)
        rows[:, :4] = cols[v, :4]
        rows[:, 5:7] = LOC_NONE
        rows[:, 7] = MAG_NONE
        n_st = len(self.stations)
        onset_mat = cols[v, 5:5 + n_st] if self.locating else None
        score_mat = cols[v, 5 + n_st:] if self.locating else None
        if self._emitted.shape[0] and rows.shape[0]:
            near = ((np.abs(rows[:, 0, None] - self._emitted[None, :, 0])
                     <= acfg.dt_tol)
                    & (np.abs(rows[:, 1, None] - self._emitted[None, :, 1])
                       <= acfg.onset_tol))
            matched = near.any(axis=1)
            # best multiplicity this key has alerted at; a matched group
            # that now exceeds it re-emits as an upgrade
            best = np.where(matched,
                            (near * self._emitted[None, :, 2]).max(axis=1),
                            0)
            upgrade = matched & (rows[:, 2] > best)
            for r in np.nonzero(upgrade)[0]:
                js = np.nonzero(near[r])[0]
                self._emitted[js, 2] = np.maximum(self._emitted[js, 2],
                                                  rows[r, 2])
            rows[:, 4] = upgrade.astype(np.int64)
            keep = ~matched | upgrade
            rows = rows[keep]
            if self.locating:
                onset_mat, score_mat = onset_mat[keep], score_mat[keep]
        fresh = rows[rows[:, 4] == 0]
        if fresh.shape[0]:
            self._emitted = np.concatenate([self._emitted, fresh[:, :3]])
        if self.locating and rows.shape[0]:
            rows, _ = self._locate_rows(rows, onset_mat, score_mat)
        # onsets below every station's closed frontier minus the sliding
        # window can gain no further members — stop rescanning them, and
        # archive rows + dedup keys + amplitude bins the floor has passed
        # so the per-push scan stays O(active window) instead of O(stream)
        frontier = min(st.filter.w_start for st in self.stations)
        self._assoc_lo = max(self._assoc_lo, frontier
                             - self.scfg.window_fingerprints
                             - 2 * acfg.onset_tol)
        for st in self.stations:
            st.filter.retire_below(self._assoc_lo)
        if self._emitted.shape[0]:
            live = self._emitted[:, 1] >= self._assoc_lo - acfg.onset_tol
            self._emitted = self._emitted[live]
        amp_floor = self._assoc_lo - acfg.onset_tol
        if amp_floor > 0:
            for d in self._amp:
                for b in [b for b in d if b < amp_floor]:
                    del d[b]
        return rows

    def finalize(self) -> tuple[dict | None, list[Events], dict]:
        if self.pooled:
            self._pool_flush()
        station_events, stats = [], {}
        for i, st in enumerate(self.stations):
            events, _, fstats = st.finalize()
            station_events.append(events)
            for k, v in fstats.items():
                stats[f"station{i}_{k}"] = v
        detections = None
        if len(self.stations) >= 2:
            detections = align_mod.associate_network(
                station_events, self.cfg.align, len(self.stations),
                with_onsets=self.locating)
            if self.locating:
                t0 = time.perf_counter()
                fcfg = self.cfg.fingerprint
                was = int(detections["valid"].sum())
                detections = locate_mod.attach_location(
                    detections, self.station_xy, self._station_weights(),
                    fcfg.lag_samples / fcfg.fs, self.cfg.locate,
                    self._amp_fn, stats, device=self.device)
                self.telemetry.record_locate(
                    groups=was,
                    located=int(np.asarray(detections["valid"]).sum()),
                    rejected=stats.get("moveout_rejected", 0),
                    wall=time.perf_counter() - t0)
            stats["detections"] = int(detections["valid"].sum())
        if self.rolling:
            stats["alerts"] = int(sum(a.shape[0] for a in self.alerts))
        stats["ingest"] = [st.stats.summary() for st in self.stations]
        stats["quality"] = self.quality_summary()
        return detections, station_events, stats

    def quality_summary(self) -> dict:
        """Network-wide data-quality counters — the per-station summaries
        folded through the one aggregation path (same keys as
        ``StationStream.quality_summary``)."""
        return merge_counts(st.quality_summary() for st in self.stations)

    def metrics_snapshot(self) -> dict:
        """The one structured telemetry view of this detector (schema
        ``stream-metrics/v1``): ``telemetry.metrics_snapshot``."""
        return tele_mod.metrics_snapshot(self)

    # -- serving -------------------------------------------------------------

    def pool_serving_state(self) -> tuple[IndexState, torch.Tensor,
                                          torch.Tensor]:
        """(stacked index, med (S, C), mad (S, C)) for the serving tier,
        pooled or not, sharded or not. Returns **copies** on ``device``:
        the pooled step updates the pool's tensors in place on the next
        push, so a serving engine keeps a stable read-only view of the
        index at call time. A sharded pool's rows are gathered onto
        ``device`` and its pad rows dropped, so serving sees exactly the
        S stations."""
        if not all(st.stats_frozen for st in self.stations):
            raise RuntimeError("pool_serving_state needs every station's "
                               "statistics frozen")
        if self.pstate is not None and self.mesh is not None:
            s = len(self.stations)
            index = index_mod.stack_states([
                dist.map_tensors(lambda x: x.to(self.device), p.index)
                for p in self.pstate])
            return (dist.map_tensors(lambda x: x[:s], index),
                    *(torch.cat([getattr(p, k).to(self.device)
                                 for p in self.pstate])[:s]
                      for k in ("med", "mad")))
        if self.pstate is not None:
            index = self.pstate.index
            return (IndexState(**{f.name: getattr(index, f.name).clone()
                                  for f in dataclasses.fields(IndexState)}),
                    self.pstate.med.clone(), self.pstate.mad.clone())
        return (index_mod.stack_states([st.state for st in self.stations]),
                torch.stack([st.med_mad[0] for st in self.stations]),
                torch.stack([st.med_mad[1] for st in self.stations]))

    # -- snapshot / restore -------------------------------------------------

    def snapshot(self, ckpt_dir: str, step: int | None = None, *,
                 background: bool = False, keep: int = 3):
        """Checkpoint the whole detector through ``train.checkpoint``.

        One ``step_<N>`` directory holds every station's
        ``snapshot_state`` (``s<i>/…``), the alert rows and their dedup
        keys, each station's amplitude timeline (``detector/amp<i>``,
        (bin, peak) rows in bin order, float64), the association floor,
        the telemetry and the ``StreamConfig`` fields that shape the
        station state — the reference's layout, so either
        package restores it. Pooled detectors write per-station slices
        (a sharded pool's real rows, without its pad rows), so no device
        topology reaches the disk. ``step`` defaults to the chunks pushed.
        """
        arrays: dict[str, np.ndarray] = {}
        st_extra = []
        for i, st in enumerate(self.stations):
            a, e = st.snapshot_state()
            arrays.update({f"s{i}/{k}": v for k, v in a.items()})
            st_extra.append(e)
        arrays["detector/emitted"] = self._emitted.copy()
        arrays["detector/alerts"] = (
            np.concatenate(self.alerts, axis=0).astype(np.int64)
            if self.alerts else np.zeros((0, ALERT_COLS), np.int64))
        for i, d in enumerate(self._amp):
            arrays[f"detector/amp{i}"] = (
                np.array([[b, a] for b, a in sorted(d.items())], np.float64)
                if d else np.zeros((0, 2), np.float64))
        extra = {"n_stations": len(self.stations), "stations": st_extra,
                 "assoc_lo": self._assoc_lo,
                 "telemetry": self.telemetry.snapshot(),
                 "scfg": {
                     "block_fingerprints": self.scfg.block_fingerprints,
                     "window_fingerprints": self.scfg.window_fingerprints,
                     "filter_window_fingerprints":
                         self.scfg.filter_window_fingerprints,
                     "reorder_horizon_samples":
                         self.scfg.reorder_horizon_samples,
                     "saturation_limit": self.scfg.saturation_limit,
                     "dup_window_fingerprints":
                         self.scfg.dup_window_fingerprints,
                     "dup_sig_tables": self.scfg.dup_sig_tables,
                     "occ_limit": self.scfg.occ_limit,
                     "max_pairs_per_block": self.scfg.max_pairs_per_block,
                     "verify_jaccard": int(self.scfg.verify_jaccard),
                 }}
        if step is None:
            step = self.stations[0].stats.chunks
        return ckpt_mod.save_checkpoint(ckpt_dir, step, arrays, extra=extra,
                                        background=background, keep=keep)

    @classmethod
    def restore(cls, ckpt_dir: str, cfg: DetectConfig,
                scfg: StreamConfig | None = None, *,
                step: int | None = None,
                station_xy: np.ndarray | None = None, device=None,
                devices=None) -> tuple["StreamingDetector", int]:
        """Rebuild a detector on ``device`` from its latest (or given)
        snapshot, this package's or the reference's; returns (detector,
        step). A ``scfg`` whose block size, windows or guard knobs differ
        from the snapshot's is refused with the reference's message (the
        station layouts are not interchangeable). A pooled detector's
        pool is rebuilt from the restored stations once all are frozen,
        with a cold halo, as the reference rebuilds it, over the mesh that
        this process's ``devices`` give (whatever mesh, if any, the
        snapshotting detector ran under). ``station_xy`` is
        not snapshotted (it is deployment geometry, not stream state):
        pass it again to keep the location tier running; the amplitude
        timelines are restored either way.
        """
        arrays, extra, step = ckpt_mod.restore_flat(ckpt_dir, step=step)
        det = cls(cfg, scfg, n_stations=int(extra["n_stations"]),
                  station_xy=station_xy, device=device, devices=devices)
        saved = extra.get("scfg", {})
        for key, have in (
                ("block_fingerprints", det.scfg.block_fingerprints),
                ("window_fingerprints", det.scfg.window_fingerprints),
                ("filter_window_fingerprints",
                 det.scfg.filter_window_fingerprints),
                ("reorder_horizon_samples",
                 det.scfg.reorder_horizon_samples),
                ("saturation_limit", det.scfg.saturation_limit),
                ("dup_window_fingerprints",
                 det.scfg.dup_window_fingerprints),
                ("dup_sig_tables", det.scfg.dup_sig_tables),
                ("occ_limit", det.scfg.occ_limit),
                # verify toggles the packed ring, part of the station
                # layout (max_pairs only shapes the step's output)
                ("verify_jaccard", det.scfg.verify_jaccard)):
            if key in saved and int(saved[key]) != int(have):
                raise ValueError(
                    f"snapshot was taken with {key}={saved[key]} but the "
                    f"restoring StreamConfig has {have}; pass a matching "
                    f"config (e.g. the same --window-fp/--filter-window-fp "
                    f"flags the snapshotting service ran with)")
        for i, st in enumerate(det.stations):
            prefix = f"s{i}/"
            sub = {k[len(prefix):]: v for k, v in arrays.items()
                   if k.startswith(prefix)}
            st.restore_state(sub, extra["stations"][i])
        if det.pooled and all(st.stats_frozen for st in det.stations):
            det._build_pool()
        emitted = np.asarray(arrays["detector/emitted"], np.int64)
        if emitted.ndim == 2 and emitted.shape[1] == 2:
            # keys without the best-multiplicity column: seed it at the
            # floor, so any growth past min_stations re-emits as an
            # upgrade (the reference's rule for such snapshots)
            emitted = np.concatenate(
                [emitted, np.full((emitted.shape[0], 1),
                                  cfg.align.min_stations, np.int64)],
                axis=1)
        det._emitted = emitted.reshape(-1, 3)
        alerts = np.asarray(arrays["detector/alerts"], np.int64)
        if alerts.ndim == 2 and alerts.shape[1] == 4:
            # 4-column rows: pad the upgrade / location / magnitude
            # columns with their sentinels
            pad = np.zeros((alerts.shape[0], ALERT_COLS - 4), np.int64)
            pad[:, 1:3] = LOC_NONE
            pad[:, 3] = MAG_NONE
            alerts = np.concatenate([alerts, pad], axis=1)
        alerts = alerts.reshape(-1, ALERT_COLS)
        det.alerts = [alerts] if alerts.shape[0] else []
        for i in range(len(det.stations)):
            amp = arrays.get(f"detector/amp{i}")
            if amp is not None and amp.size:
                det._amp[i] = {int(b): float(a)
                               for b, a in np.asarray(amp).reshape(-1, 2)}
        det._assoc_lo = int(extra["assoc_lo"])
        if "telemetry" in extra:    # older snapshots: a fresh registry
            det.telemetry.restore(extra["telemetry"])
        if det.rolling:
            det._polled_windows = sum(st.filter.windows_closed
                                      for st in det.stations)
        return det, step


def ingest_chunks(det: StreamingDetector, waveforms: np.ndarray,
                  n_chunks: int = 16, *, skip: int = 0,
                  warmup_chunks: int = 0, snapshot_every: int = 0,
                  snapshot_dir: str | None = None,
                  metrics_every: int = 0,
                  metrics_file: str | None = None,
                  heartbeat=print, on_chunk=None) -> dict:
    """Push a trace through a detector in equal chunks — the one ingest
    loop behind serving (``launch.serve_detect``) and ``chip_smoke.py``.

    ``waveforms``: (T,) or (n_stations, T). ``skip`` resumes mid-stream
    (samples already ingested are not re-pushed; a partially covered chunk
    is trimmed). ``warmup_chunks`` excludes the first chunks (statistics
    freeze, first kernel builds) from the timed span. ``metrics_every`` > 0
    sends a heartbeat line (real-time factor, throughput, drop rates,
    quality counters, serving view) to ``heartbeat`` every N pushed chunks and, with
    ``metrics_file``, rewrites the Prometheus exposition there atomically
    at the same cadence. ``snapshot_every`` > 0 checkpoints the detector
    into ``snapshot_dir`` after every N-th chunk of the trace (step = the
    chunk's 1-based index). ``on_chunk(ci)`` runs after each pushed chunk
    (the serving tier's interleave hook). Returns {"chunks",
    "timed_chunks", "wall_s", "warmup_wall_s", "samples"}.
    """
    waveforms = np.atleast_2d(np.asarray(waveforms, np.float32))
    chunks = np.array_split(waveforms, n_chunks, axis=1)
    seen = 0
    pushed = timed = 0
    samples = 0
    t_start = time.perf_counter()
    t_timed = None
    for ci, chunk in enumerate(chunks):
        seen += chunk.shape[1]
        if seen <= skip:
            continue
        if seen - chunk.shape[1] < skip:
            chunk = chunk[:, chunk.shape[1] - (seen - skip):]
        if pushed == warmup_chunks and t_timed is None:
            t_timed = time.perf_counter()
        det.push(chunk)
        pushed += 1
        if pushed > warmup_chunks:
            timed += 1
            samples += int(chunk.size)
        if snapshot_every and (ci + 1) % snapshot_every == 0:
            det.snapshot(snapshot_dir, step=ci + 1)
        if metrics_every and pushed % metrics_every == 0:
            heartbeat(det.telemetry.heartbeat_line(det))
            if metrics_file:
                det.telemetry.write_prometheus(metrics_file, det)
        if on_chunk is not None:
            on_chunk(ci)
    t_end = time.perf_counter()
    if t_timed is None:
        t_timed = t_end
    return {"chunks": pushed, "timed_chunks": timed,
            "wall_s": t_end - t_timed,
            "warmup_wall_s": t_timed - t_start, "samples": samples}
