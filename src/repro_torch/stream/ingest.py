"""Streaming-side configuration shared by the batch replay driver.

PyTorch-port counterpart of ``repro.stream.ingest.StreamConfig``: the same
fields, defaults and validation, so one set of keyword arguments builds
both packages' configs. The port decides which code runs by the device of
its tensors, so ``verify_pallas`` is accepted for parity and changes
nothing: ``verify_code`` 1 and 2 both verify through ``kernels.ops``.
The ring, reservoir and streaming driver of the reference module come
with the streaming slice.
"""
from __future__ import annotations

import dataclasses

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
    the packed ring) and ``telemetry`` (the QC counters). The remaining
    fields belong to the streaming driver and are validated here only.
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
