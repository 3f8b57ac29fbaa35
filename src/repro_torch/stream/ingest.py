"""Continuous ingestion: arbitrary chunks → fixed fingerprint blocks.

PyTorch-port counterpart of ``repro.stream.ingest``. ``StreamConfig``
holds the streaming-side knobs, with the reference's fields, defaults and
validation, so one set of keyword arguments builds both packages'
configs. The port decides which code runs by the device of its tensors,
so ``verify_pallas`` is accepted for parity and changes nothing:
``verify_code`` 1 and 2 both verify through ``kernels.ops``.

``WaveformRing`` (chunk framing, halo, gap / late / duplicate
reconciliation) and ``StreamingMAD`` (the §5.2 reservoir) are host-side
numpy, copied from the reference semantics for semantics: the reservoir
keeps ``np.random.default_rng(seed)``, so it draws the reference's rows
and its statistics are the reference's.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.fingerprint import FingerprintConfig
from repro_torch.stream.index import StreamIndexConfig


@dataclasses.dataclass(frozen=True)
class StreamConfig:
    """Streaming-side knobs (capacity, cadence, data-quality guards and
    the emission epilogue); detection semantics stay in LSHConfig and
    AlignConfig. See ``repro.stream.ingest.StreamConfig`` for each knob.

    The batch replay uses: ``block_fingerprints`` (fingerprints per pooled
    step), ``index`` (resident index shape), ``window_fingerprints``
    (sliding window; 0 keeps all), ``saturation_limit``, ``dup_sig_tables``
    and ``occ_limit`` (the in-step guards; 0 = off),
    ``max_pairs_per_block`` (emission compaction; 0 = dense),
    ``verify_jaccard`` + ``verify_min_jaccard`` (exact-Jaccard verify from
    the packed ring) and ``telemetry`` (the QC counters). The streaming
    driver (``stream.engine.StreamingDetector``) reads every field;
    ``sharded`` splits a pooled detector's station axis over a
    ``stations`` mesh when more than one device can take a shard
    (``dist.station_mesh``).
    """

    block_fingerprints: int = 64   # fingerprints per pooled step
    index: StreamIndexConfig = StreamIndexConfig()  # resident index shape
    stats_warmup_blocks: int = 2   # blocks buffered before MAD stats freeze
                                   # (0 = freeze only at flush)
    reservoir_rows: int = 2048     # coefficient rows kept for median/MAD
    seed: int = 0
    window_fingerprints: int = 0   # sliding detection window (0 = keep all)
    filter_window_fingerprints: int = 0  # rolling occurrence filter window
    fused: bool = True             # single-dispatch fused hot path
    pooled: bool = True            # vmapped station pool when multi-station
    sharded: bool = True           # mesh-shard the pool when >1 device
    reorder_horizon_samples: int = 0  # late-chunk splice window (0 = none)
    max_gap_samples: int = 0       # largest offset jump gap-filled (0 = ∞)
    saturation_limit: int = 0      # quarantine buckets past this traffic
    dup_window_fingerprints: int = 0  # sample-exact repeat horizon
    dup_sig_tables: int = 0        # signature matches that flag a repeat
    occ_limit: int = 0             # in-dispatch §6.5 partner-count limiter
    max_pairs_per_block: int = 0   # emission compaction bound (0 = dense)
    verify_jaccard: bool = False   # exact-Jaccard verify epilogue
    verify_pallas: bool = False    # accepted; no effect in the port
    verify_min_jaccard: float = 0.0  # in-dispatch true-similarity floor
    telemetry: bool = True         # QC counters beside each step's pairs
                                   # (pairs emitted, masked rows, raw and
                                   # quarantined collisions); detections
                                   # are identical on or off

    def __post_init__(self):
        if self.stats_warmup_blocks < 0:
            raise ValueError(
                f"stats_warmup_blocks must be >= 0 (0 = freeze at flush), "
                f"got {self.stats_warmup_blocks}")
        if min(self.reorder_horizon_samples, self.max_gap_samples,
               self.saturation_limit, self.dup_window_fingerprints,
               self.dup_sig_tables, self.occ_limit) < 0:
            raise ValueError(
                "data-quality knobs (reorder_horizon_samples, "
                "max_gap_samples, saturation_limit, "
                "dup_window_fingerprints, dup_sig_tables, occ_limit) "
                "must be >= 0 (0 = off)")
        if self.occ_limit > 0 and self.index.occ_slots <= 0:
            raise ValueError(
                "occ_limit needs a partner-count ring: set "
                "StreamIndexConfig.occ_slots to at least the sliding "
                "window (window_fingerprints), or the expected stream "
                "length when unwindowed")
        if self.occ_limit > 0 and 0 < self.index.occ_slots \
                < self.window_fingerprints:
            # a ring narrower than the window makes two live in-window
            # fingerprints share a slot: the newcomer's slot reset zeroes
            # a still-active partner count (under-suppression) and merged
            # counts can push clean fingerprints past the limit (silent
            # clean-pair drops) — reject rather than degrade silently
            raise ValueError(
                f"occ_slots={self.index.occ_slots} is narrower than the "
                f"sliding window ({self.window_fingerprints}): every id a "
                f"pair can reach back to needs its own partner-count slot")
        if self.pooled and not self.fused:
            raise ValueError(
                "pooled station stepping runs through the fused chunk step;"
                " set fused=True (or pooled=False for the sequential path)")
        # ValueError (not assert): these are reachable from CLI flags and
        # must hold under `python -O` too — a filter window without an
        # expire window would let partners reach arbitrarily far back and
        # silently break the rolling filter's rebased id space.
        if self.filter_window_fingerprints > 0 \
                and self.window_fingerprints <= 0:
            raise ValueError(
                "rolling occurrence filter needs a sliding window "
                "(window_fingerprints > 0): the expire window is what "
                "bounds how far back partners reach")
        if 0 < self.window_fingerprints < self.block_fingerprints:
            raise ValueError(
                f"window_fingerprints={self.window_fingerprints} smaller "
                f"than one block ({self.block_fingerprints}) would expire "
                f"the block being inserted")
        if self.max_pairs_per_block < 0:
            raise ValueError(
                f"max_pairs_per_block must be >= 0 (0 = dense emission), "
                f"got {self.max_pairs_per_block}")
        if self.verify_jaccard and self.max_pairs_per_block <= 0:
            raise ValueError(
                "verify_jaccard scores the *compacted* emission; set "
                "max_pairs_per_block > 0 (the dense t*N*cap stream is "
                "never verified)")
        if self.verify_jaccard and self.index.pk_slots <= 0:
            raise ValueError(
                "verify_jaccard needs a packed-fingerprint ring: set "
                "StreamIndexConfig.pk_slots to at least the sliding "
                "window (window_fingerprints), or the expected stream "
                "length when unwindowed")
        if self.verify_jaccard and 0 < self.index.pk_slots \
                < self.window_fingerprints:
            # a ring narrower than the window makes two live in-window
            # fingerprints share a packed row: the newcomer overwrites a
            # still-pairable partner's bits and the verify scores garbage
            raise ValueError(
                f"pk_slots={self.index.pk_slots} is narrower than the "
                f"sliding window ({self.window_fingerprints}): every id a "
                f"pair can reach back to needs its own packed row")
        if self.verify_pallas and not self.verify_jaccard:
            raise ValueError(
                "verify_pallas selects the kernel for the verify "
                "epilogue; it needs verify_jaccard=True")
        if not 0.0 <= self.verify_min_jaccard <= 1.0:
            raise ValueError(
                f"verify_min_jaccard must be in [0, 1], got "
                f"{self.verify_min_jaccard}")
        if self.verify_min_jaccard > 0.0 and not self.verify_jaccard:
            raise ValueError(
                "verify_min_jaccard thresholds the verified similarity; "
                "it needs verify_jaccard=True")

    @property
    def verify_code(self) -> int:
        """Verify selector passed to the step: 0 = off, else on (the
        reference's 1 = jnp oracle / 2 = Pallas kernel; the port verifies
        through ``kernels.ops`` either way)."""
        if not self.verify_jaccard:
            return 0
        return 2 if self.verify_pallas else 1

    def effective_index(self, fp_dim: int) -> StreamIndexConfig:
        """Index config with the verify ring's row width resolved.

        ``pk_words == 0`` means "derive from the fingerprint config":
        packed fingerprints are ``fp_dim // 32`` uint32 words
        (``utils.pack_bits``; fp_dim is a multiple of 32 by
        construction). Every engine that materializes an ``IndexState``
        from a ``StreamConfig`` goes through here so snapshots, the
        batch driver and the live service agree on the ring shape.
        """
        icfg = self.index
        if self.verify_jaccard and icfg.pk_words == 0:
            icfg = dataclasses.replace(icfg, pk_words=fp_dim // 32)
        return icfg


class WaveformRing:
    """Host-side sample ring for one station, gap/reorder aware.

    push() accepts chunks of any length and returns zero or more
    fixed-size blocks; a ``halo_samples`` tail is retained so adjacent
    blocks overlap exactly like the offline sliding windows.

    Real telemetry is not contiguous, so every sample carries a validity
    bit alongside its value:

    * NaN samples in a chunk are "never arrived": stored as 0.0, marked
      invalid.
    * ``push(chunk, offset)`` places the chunk at an absolute sample
      offset. A jump past the contiguous frontier opens a *gap* — the
      missing span is sentinel-filled (0.0) and marked invalid, keeping
      the fingerprint id grid aligned to absolute time.
    * An offset behind the frontier is a late / out-of-order / duplicated
      chunk. Samples still inside the un-emitted buffer are reconciled
      deterministically: invalid positions are healed (spliced), already-
      valid positions are dropped first-writer-wins (re-sent duplicates
      are no-ops). Samples behind the buffer are dropped and counted.
      ``reorder_horizon`` holds block emission back that many samples so
      the buffer keeps a splice window open.

    Emitted blocks are ``(base_fingerprint_id, block, valid_mask)`` where
    ``valid_mask`` is None for fully-valid blocks (the clean hot path) or
    a per-fingerprint bool mask: a fingerprint is valid iff its whole
    analysis window holds valid samples. ``quality`` counts every
    reconciliation decision for monitoring.
    """

    def __init__(self, fcfg: FingerprintConfig, block_fingerprints: int,
                 reorder_horizon: int = 0, max_gap: int = 0):
        assert block_fingerprints >= 1
        assert reorder_horizon >= 0 and max_gap >= 0
        self.fcfg = fcfg
        self.block_fp = block_fingerprints
        self.block_samples = fcfg.block_samples(block_fingerprints)
        self.advance = block_fingerprints * fcfg.lag_samples
        self.horizon = int(reorder_horizon)
        self.max_gap = int(max_gap)
        self.buf = np.zeros(0, np.float32)
        self.vbuf = np.zeros(0, bool)   # per-sample validity
        self.start = 0            # absolute offset of buf[0]
        self.next_fp = 0          # global index of the next fingerprint
        self.samples_in = 0
        self.quality = {
            "gaps": 0, "gap_samples": 0, "missing_samples": 0,
            "late_spliced_samples": 0, "late_dropped_samples": 0,
            "duplicate_samples": 0, "rejected_chunks": 0,
            "rejected_samples": 0,
        }

    @property
    def frontier(self) -> int:
        """Absolute offset one past the last buffered sample."""
        return self.start + self.buf.size

    def push(self, chunk: np.ndarray, offset: int | None = None
             ) -> list[tuple[int, np.ndarray, np.ndarray | None]]:
        """Place samples at ``offset`` (default: the contiguous frontier);
        emit ready (base_fingerprint_id, block, valid_mask) tuples."""
        chunk = np.asarray(chunk, np.float32).reshape(-1)
        self.samples_in += chunk.size
        off = self.frontier if offset is None else int(offset)
        if self.max_gap > 0 and off - self.frontier > self.max_gap:
            # corrupted / unit-mismatched timestamp, not telemetry loss:
            # gap-filling the bogus span could demand unbounded memory
            self.quality["rejected_chunks"] += 1
            self.quality["rejected_samples"] += chunk.size
            return []
        finite = np.isfinite(chunk)
        if not finite.all():
            chunk = np.where(finite, chunk, np.float32(0.0))
        if off > self.frontier:          # gap: sentinel-fill to the offset
            fill = off - self.frontier
            self.quality["gaps"] += 1
            self.quality["gap_samples"] += fill
            self.buf = np.concatenate([self.buf,
                                       np.zeros(fill, np.float32)])
            self.vbuf = np.concatenate([self.vbuf, np.zeros(fill, bool)])
            off = self.frontier
        # the last emitted block's content is immutable: its tail is also
        # the device-resident halo of the fused path, so healing those
        # samples host-side would silently diverge from the halo already
        # committed on device. Late data below the committed frontier is
        # dropped (the committed region's validity mask stays authoritative).
        committed = self.start + (self.fcfg.halo_samples
                                  if self.next_fp > 0 else 0)
        if off < committed:              # beyond the reorder horizon
            cut = min(committed - off, chunk.size)
            self.quality["late_dropped_samples"] += int(finite[:cut].sum())
            chunk, finite = chunk[cut:], finite[cut:]
            off = committed
        overlap = min(self.frontier - off, chunk.size)
        if overlap > 0:                  # splice into the buffered region
            lo = off - self.start
            held = self.vbuf[lo:lo + overlap]
            heal = finite[:overlap] & ~held
            dup = finite[:overlap] & held
            self.buf[lo:lo + overlap][heal] = chunk[:overlap][heal]
            held[heal] = True
            self.quality["late_spliced_samples"] += int(heal.sum())
            self.quality["duplicate_samples"] += int(dup.sum())
            chunk, finite = chunk[overlap:], finite[overlap:]
        if chunk.size:                   # in-order tail append
            # count missing telemetry only in newly-accepted territory:
            # NaNs in re-delivered / late-dropped spans were either never
            # accepted or already accounted (gap fill)
            self.quality["missing_samples"] += int((~finite).sum())
            self.buf = np.concatenate([self.buf, chunk])
            self.vbuf = np.concatenate([self.vbuf, finite])
        out = []
        while self.buf.size >= self.block_samples + self.horizon:
            out.append(self._emit_block())
        return out

    def _fp_mask(self, v: np.ndarray) -> np.ndarray | None:
        """Per-fingerprint validity of a framed sample-validity span
        (None = all valid): fp i is valid iff v[i*lag : i*lag + w].all()."""
        if v.all():
            return None
        w, lag = self.fcfg.window_samples, self.fcfg.lag_samples
        csum = np.concatenate([[0], np.cumsum(~v)])
        starts = np.arange(self.block_fp) * lag
        return (csum[starts + w] - csum[starts]) == 0

    def _emit_block(self) -> tuple[int, np.ndarray, np.ndarray | None]:
        item = (self.next_fp, self.buf[:self.block_samples].copy(),
                self._fp_mask(self.vbuf[:self.block_samples]))
        self.buf = self.buf[self.advance:]
        self.vbuf = self.vbuf[self.advance:]
        self.start += self.advance
        self.next_fp += self.block_fp
        return item

    def flush_ready(self) -> list[tuple[int, np.ndarray,
                                        np.ndarray | None]]:
        """Emit complete blocks held back only by the reorder horizon
        (flush boundary: late chunks for them can no longer splice)."""
        out = []
        while self.buf.size >= self.block_samples:
            out.append(self._emit_block())
        return out

    def flush_partial(self) -> tuple[int, np.ndarray, np.ndarray] | None:
        """Emit the tail as a zero-padded block with a validity mask.

        Returns (base_fingerprint_id, block, valid_mask) covering however
        many whole fingerprints the buffer still holds, or None if fewer
        than one. The mask combines the tail cut (fingerprints whose
        window would run past the buffered samples) with gap validity.
        Consumes those fingerprints (the halo stays), so ingestion may
        continue afterwards — flush is a checkpoint, not a terminator.
        Call ``flush_ready()`` first when a reorder horizon is set.
        """
        w, lag = self.fcfg.window_samples, self.fcfg.lag_samples
        if self.buf.size < w:
            return None
        assert self.buf.size < self.block_samples, \
            "drain flush_ready() before flush_partial()"
        n_valid = (self.buf.size - w) // lag + 1
        block = np.zeros(self.block_samples, np.float32)
        block[: self.buf.size] = self.buf
        mask = np.arange(self.block_fp) < n_valid
        vfull = np.zeros(self.block_samples, bool)
        vfull[: self.buf.size] = self.vbuf
        gap_mask = self._fp_mask(vfull)
        if gap_mask is not None:
            mask = mask & gap_mask
        out = (self.next_fp, block, mask)
        self.buf = self.buf[n_valid * lag:]
        self.vbuf = self.vbuf[n_valid * lag:]
        self.start += n_valid * lag
        self.next_fp += n_valid
        return out

    @property
    def pending_samples(self) -> int:
        return int(self.buf.size)

    def snapshot(self) -> tuple[dict, dict]:
        """(arrays, json-able scalars) capturing the ring exactly."""
        return ({"buf": self.buf.copy(), "vbuf": self.vbuf.copy()},
                {"next_fp": self.next_fp, "samples_in": self.samples_in,
                 "quality": dict(self.quality)})

    def restore(self, arrays: dict, scalars: dict) -> None:
        self.buf = np.asarray(arrays["buf"], np.float32).reshape(-1).copy()
        if "vbuf" in arrays:
            self.vbuf = np.asarray(arrays["vbuf"], bool).reshape(-1).copy()
        else:                      # pre-quality snapshot: all samples valid
            self.vbuf = np.ones(self.buf.size, bool)
        assert self.vbuf.size == self.buf.size
        self.next_fp = int(scalars["next_fp"])
        self.samples_in = int(scalars["samples_in"])
        # start is not independent state: every consumption path advances
        # it in lockstep with next_fp (both by whole fingerprints)
        self.start = self.next_fp * self.fcfg.lag_samples
        self.quality.update(scalars.get("quality", {}))


class StreamingMAD:
    """Uniform reservoir of coefficient rows → running median/MAD (§5.2).

    Deterministic given the seed and arrival order; ``stats()`` matches
    ``fingerprint.mad_stats`` computed over a uniform row sample.
    """

    def __init__(self, n_rows: int, n_coeff: int, seed: int = 0):
        self.n_rows = n_rows
        self.rows = np.zeros((n_rows, n_coeff), np.float32)
        self.rng = np.random.default_rng(seed)
        self.seen = 0
        self.filled = 0

    def update(self, coeffs: np.ndarray) -> None:
        coeffs = np.asarray(coeffs, np.float32)
        for row in coeffs:
            self.seen += 1
            if self.filled < self.n_rows:
                self.rows[self.filled] = row
                self.filled += 1
            else:
                j = int(self.rng.integers(0, self.seen))
                if j < self.n_rows:
                    self.rows[j] = row

    def snapshot(self) -> tuple[dict, dict]:
        """(arrays, json-able scalars incl. PCG state) — exact restore."""
        return ({"rows": self.rows.copy()},
                {"seen": self.seen, "filled": self.filled,
                 "rng_state": self.rng.bit_generator.state})

    def restore(self, arrays: dict, scalars: dict) -> None:
        rows = np.asarray(arrays["rows"], np.float32)
        assert rows.shape == self.rows.shape, (rows.shape, self.rows.shape)
        self.rows = rows.copy()
        self.seen = int(scalars["seen"])
        self.filled = int(scalars["filled"])
        self.rng.bit_generator.state = scalars["rng_state"]

    def stats(self) -> tuple[np.ndarray, np.ndarray]:
        assert self.filled >= 2, "need ≥2 coefficient rows for MAD stats"
        sample = self.rows[: self.filled]
        med = np.median(sample, axis=0)
        mad = np.median(np.abs(sample - med[None, :]), axis=0)
        return med.astype(np.float32), mad.astype(np.float32)
