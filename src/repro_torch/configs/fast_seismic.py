"""fast_seismic — the paper's own workload (the reference's widths).

Paper-faithful knobs: 100 Hz input, 8192-dim fingerprints (32×128 spectral
images, 2-bit sign encoding), t=100 tables / k=8 funcs / m=2 matches (the
optimized §6.3 setting), 1% occurrence filter, 3–20 Hz band. The values
are those of ``repro.configs.fast_seismic``, the streaming configs'
(``stream_config`` and the five smoke variants), the location tier's
(``locate_config``, ``locate_smoke_config``, ``located_smoke_config``),
the real-time alerting
pair (``latency_config``, ``stream_latency_smoke_config``) and the serving
tier's (``serve_config``, ``serve_smoke_config``) included; their
comments are the reference's reasons for each value.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.align import AlignConfig
from repro_torch.core.detect import DetectConfig
from repro_torch.core.fingerprint import FingerprintConfig
from repro_torch.core.locate import LocateConfig
from repro_torch.core.lsh import LSHConfig
from repro_torch.stream.index import StreamIndexConfig
from repro_torch.stream.ingest import StreamConfig

ARCH_ID = "fast_seismic"


def config() -> DetectConfig:
    fp = FingerprintConfig(img_freq=32, img_time=128, img_hop=8, top_k=400,
                           mad_sample_rate=0.1)
    return DetectConfig(
        fingerprint=fp,
        lsh=LSHConfig(n_tables=100, n_funcs=8, n_matches=2, bucket_cap=4,
                      min_dt=fp.overlap_fingerprints, occurrence_frac=0.01),
        align=AlignConfig(),
    )


def smoke_config() -> DetectConfig:
    fp = FingerprintConfig(img_freq=16, img_time=32, img_hop=8, top_k=64,
                           mad_sample_rate=1.0)
    return DetectConfig(
        fingerprint=fp,
        lsh=LSHConfig(n_tables=20, n_funcs=4, n_matches=2, bucket_cap=4,
                      min_dt=fp.overlap_fingerprints, occurrence_frac=0.05),
        align=AlignConfig(min_cluster_size=1, min_cluster_sim=4),
    )


def locate_config() -> LocateConfig:
    """Paper-scale location tier: a 50 km aperture gridded 12×12 (≈4 km
    coarse cells) and refined twice to sub-300 m cells, a homogeneous
    6 km/s halfspace at 8 km focal depth. At the 2 s fingerprint lag the
    moveout across the aperture is a handful of lags, so the consistency
    gate is tight (2 lags of weighted residual)."""
    return LocateConfig(grid_n=12, extent_km=50.0, depth_km=8.0,
                        velocity_km_s=6.0, refine_levels=2,
                        moveout_tol_lags=2.0)


def locate_smoke_config() -> LocateConfig:
    """CPU-scale location tier matching the synth scenario geometry
    (50 km extent, 8 km depth, 6 km/s) on a coarser 8×8 grid; the synth
    onsets are exact to one lag, so a 2-lag residual gate separates
    physical groups from coincidences on smoke traces too."""
    return LocateConfig(grid_n=8, extent_km=50.0, depth_km=8.0,
                        velocity_km_s=6.0, refine_levels=2,
                        moveout_tol_lags=2.0, pad_groups=16)


def located_smoke_config() -> DetectConfig:
    """``smoke_config`` + location / weighting / magnitude on every
    network detection, the tolerance-chaining extent cap, and
    moveout-consistency rejection."""
    base = smoke_config()
    return dataclasses.replace(
        base,
        align=dataclasses.replace(base.align, max_group_extent=90),
        locate=locate_smoke_config())


def batch_replay_config(n_fingerprints: int) -> StreamConfig:
    """Paper-scale batch replay of one archive partition: 256-fingerprint
    blocks, 2^14 buckets per table at the LSH bucket cap, emission
    compacted to 4096 pairs per station-block, and every pair scored with
    exact Jaccard from a packed ring that covers the whole trace."""
    lcfg = config().lsh
    return StreamConfig(block_fingerprints=256,
                        index=StreamIndexConfig(n_buckets=16384,
                                                bucket_cap=lcfg.bucket_cap,
                                                pk_slots=n_fingerprints),
                        max_pairs_per_block=4096,
                        verify_jaccard=True)


def stream_config() -> StreamConfig:
    """Streaming-detection block for the paper-scale config.

    256 fingerprints per step (~9 min of 100 Hz data per block at
    the 2 s lag); 2^14 buckets × cap 8 per table holds ~1.3e5 resident
    fingerprints per station before ring eviction. The sliding detection
    window expires ids older than 3 days (129 600 fingerprints at the 2 s
    lag — matching the index capacity), and the rolling occurrence filter
    retires candidate pairs day-by-day (43 200 fingerprints), so both
    device and host state stay flat over an unbounded stream.
    """
    day = 43_200  # fingerprints per day at the 2 s lag (86400 s / 2 s)
    # Data-quality knobs sized for real telemetry: a 60 s reorder horizon
    # absorbs out-of-order packet delivery, offset jumps beyond one hour
    # are rejected as corrupt timestamps rather than gap-filled, and the
    # sample-exact duplicate guard looks one day back (telemetry repeats
    # arrive within hours).
    # The bucket-saturation quarantine: with a sliding window its traffic
    # counter halves every window inside the step's expire, so it tracks
    # recent pressure — average bucket traffic per 3-day window is
    # ~130k/16384 ≈ 8 inserts, and 200 sits ~25× above it while a
    # repeating glitch hammers one bucket thousands of times per day. The
    # in-step §6.5 occurrence limiter caps per-fingerprint partners at 1%
    # of the filter window (the paper's occurrence fraction applied to a
    # day), with the partner-count ring sized to the 3-day detection
    # window; the host rolling filter stays on as the exact §6.5
    # reference.
    # Emission epilogue: the dense pair stream at this scale is
    # t=100 × 256 × cap 8 ≈ 205k slots per station per block, nearly all
    # masked; max_pairs_per_block=4096 bounds the device→host copy at ~50×
    # fewer slots, far above the occurrence-limited per-block pair budget
    # (overflow is counted in the overflow_pairs QC field, so a saturated
    # bound is visible). verify_jaccard keeps a packed-fingerprint ring
    # spanning the 3-day window (129 600 rows × fp_dim/32 words ≈ 133 MB)
    # and scores every surviving candidate with exact Jaccard in the same
    # step; verify_min_jaccard=0.0 keeps the pair set identical to the
    # dense path and adds the true-similarity channel.
    return StreamConfig(block_fingerprints=256,
                        index=StreamIndexConfig(n_buckets=16384,
                                                bucket_cap=8,
                                                occ_slots=3 * day,
                                                pk_slots=3 * day),
                        stats_warmup_blocks=2, reservoir_rows=4096,
                        window_fingerprints=3 * day,
                        filter_window_fingerprints=day,
                        reorder_horizon_samples=6000,
                        max_gap_samples=360_000,
                        dup_window_fingerprints=day,
                        saturation_limit=200,
                        occ_limit=day // 100,
                        max_pairs_per_block=4096,
                        verify_jaccard=True)


def stream_smoke_config() -> StreamConfig:
    """CPU-scale streaming block matching ``smoke_config``.

    Windows stay disabled: this is the parity configuration whose
    accumulated pair set is held against the offline search.
    """
    return StreamConfig(block_fingerprints=64,
                        index=StreamIndexConfig(n_buckets=2048,
                                                bucket_cap=8),
                        stats_warmup_blocks=2, reservoir_rows=1024)


def stream_compact_smoke_config() -> StreamConfig:
    """``stream_smoke_config`` + the emission epilogue.

    Same index shape and warmup as the parity smoke config, with the
    dense t=20 × 64 × cap 8 = 10 240-slot emission compacted to 512 and
    every surviving candidate scored with exact Jaccard from a 4096-row
    packed ring (covers the longest smoke trace; the smoke configs run
    unwindowed, so the ring must span the whole stream). 512 sits well
    above any smoke trace's real per-block pair count, so the pair set
    is bit-identical to ``stream_smoke_config`` — the golden parity test
    pins exactly that. ``verify_min_jaccard`` stays 0.0 here for the
    same reason; thresholding tests set it explicitly.
    """
    return StreamConfig(block_fingerprints=64,
                        index=StreamIndexConfig(n_buckets=2048,
                                                bucket_cap=8,
                                                pk_slots=4096),
                        stats_warmup_blocks=2, reservoir_rows=1024,
                        max_pairs_per_block=512,
                        verify_jaccard=True)


def stream_deferred_smoke_config() -> StreamConfig:
    """Smoke streaming with the re-binarize-after-freeze warmup hook.

    ``stats_warmup_blocks=0`` defers the MAD freeze to ``flush()``: every
    block stays buffered while the reservoir absorbs the whole trace, and
    the freeze then binarizes the buffered warmup fingerprints with the
    matured statistics. On the smoke trace (reservoir ≥ total rows) the
    self-computed statistics equal the offline two-pass statistics
    exactly, closing the ~88% self-stats pair-recall gap to 100% (pinned
    by the golden test). Host memory is O(trace) — a finite-trace /
    backfill configuration, not an unbounded-stream one.
    """
    return StreamConfig(block_fingerprints=64,
                        index=StreamIndexConfig(n_buckets=2048,
                                                bucket_cap=8),
                        stats_warmup_blocks=0, reservoir_rows=1024)


def stream_dirty_smoke_config() -> StreamConfig:
    """Quality-hardened smoke streaming: the dirty-data path.

    On clean data this configuration is **bit-identical** to
    ``stream_smoke_config`` (pinned by tests): the reorder horizon only
    *delays* block emission by 3 000 samples (30 s) so late or duplicated
    chunks can still be reconciled; the sample-exact duplicate detector
    can only fire on bit-exact repeated windows (continuous noise never
    repeats exactly); and ``saturation_limit=10`` sits at 2× the largest
    lifetime bucket traffic any clean smoke trace produces (≈5, measured
    across seeds — repeating events share buckets only a handful of
    times, while a repeating glitch hammers the same buckets tens to
    thousands of times).

    ``dup_sig_tables`` stays 0 here: on the smoke LSH config (t=20, k=4)
    the strongest legitimate repeating events can collide in up to all 20
    tables on some seeds, so the signature-level duplicate guard is a
    per-deployment knob rather than a default (see ``StreamConfig``).

    ``occ_limit=30`` is the in-step §6.5 occurrence limiter. Its counter
    is the raw partner-collision count (table×slot signature matches at
    id distance ≥ ``min_dt`` — the §6.3 lookups-per-query skew signal):
    the densest legitimate repeater on the parity-pinned smoke traces
    accumulates ≤ 25 collisions over a whole trace (measured per station
    across the test seeds), while the
    fingerprints of an *additive* glitch train — pulses riding the live
    noise floor, invisible to the sample-exact duplicate guard — collide
    with their ring-resident siblings in most tables at once and land at
    60–100+. 30 splits the regimes: clean bit-parity is pinned, and the
    glitch-train spurious stream drops ≥ 10× (vs ~2–3× from the
    saturation quarantine alone). The partner-count ring covers the
    longest smoke trace so counts never recycle mid-test.
    """
    return StreamConfig(block_fingerprints=64,
                        index=StreamIndexConfig(n_buckets=2048,
                                                bucket_cap=8,
                                                occ_slots=4096),
                        stats_warmup_blocks=2, reservoir_rows=1024,
                        reorder_horizon_samples=3000,
                        saturation_limit=10,
                        dup_window_fingerprints=512,
                        occ_limit=30)


def stream_bounded_smoke_config() -> StreamConfig:
    """CPU-scale *bounded* streaming: sliding window + rolling filter.

    Window lengths are sized to the smoke traces (hundreds of
    fingerprints) so tests and benches exercise expiry and several window
    closes without needing hours of synthetic data.
    """
    return StreamConfig(block_fingerprints=64,
                        index=StreamIndexConfig(n_buckets=2048,
                                                bucket_cap=8),
                        stats_warmup_blocks=2, reservoir_rows=1024,
                        window_fingerprints=128,
                        filter_window_fingerprints=64)


def latency_config() -> DetectConfig:
    """Real-time alerting detection config (the e2e hot-path benchmark).

    Small spectral images (8×8) at a 1 s fingerprint lag: per-block
    compute shrinks until the dispatch pipeline — not FLOPs — bounds
    end-to-end throughput, the regime of a monitoring network pushing
    short blocks for low alert latency.
    """
    fp = FingerprintConfig(stft_len=100, stft_hop=25, img_freq=8, img_time=8,
                           img_hop=4, top_k=16, mad_sample_rate=1.0)
    return DetectConfig(
        fingerprint=fp,
        lsh=LSHConfig(n_tables=8, n_funcs=4, n_matches=2, bucket_cap=4,
                      min_dt=fp.overlap_fingerprints, occurrence_frac=0.0),
        align=AlignConfig(min_cluster_size=1, min_cluster_sim=4),
    )


def stream_latency_smoke_config() -> StreamConfig:
    """Streaming block for ``latency_config``: 4 fingerprints per step =
    4 s alert latency at the 1 s lag."""
    return StreamConfig(block_fingerprints=4,
                        index=StreamIndexConfig(n_buckets=256, bucket_cap=4),
                        stats_warmup_blocks=4, reservoir_rows=512)


def stream_sharded_smoke_config() -> StreamConfig:
    """Sharded-pool smoke: the bounded streaming config with a larger
    block so each device-side step carries enough per-station work for
    the ``stations`` mesh split to beat single-device ``vmap`` on forced
    host devices (tiny blocks are dispatch-bound and sharding only adds
    transfer overhead). ``sharded`` is on by default in every config —
    this one exists so benches/tests name the sharded regime explicitly
    and get steady blocks past warmup quickly."""
    return StreamConfig(block_fingerprints=128,
                        index=StreamIndexConfig(n_buckets=2048,
                                                bucket_cap=8),
                        stats_warmup_blocks=1, reservoir_rows=1024,
                        sharded=True)


def serve_config():
    """Paper-scale serving tier: slots sized so one batched serving step
    amortizes across a rack of concurrent clients, with the admission
    queue bounded at ~2 s of queue wait at the expected service rate —
    beyond it requests shed instead of growing host state without bound.
    The serving pool refreshes every ingest chunk (~9 min of stream per
    block at the paper lag), so a served query never lags the corpus by
    more than one block."""
    from repro_torch.launch.serve_detect import ServeConfig
    return ServeConfig(n_slots=32, max_queue=1024, top_k=64,
                       refresh_every_chunks=1)


def serve_smoke_config():
    """CPU-scale serving tier matching the smoke streaming configs: a
    handful of slots and a queue bound small enough that overload tests
    shed on smoke-sized bursts."""
    from repro_torch.launch.serve_detect import ServeConfig
    return ServeConfig(n_slots=4, max_queue=8, top_k=32,
                       refresh_every_chunks=4)


# Chunk-parallel shapes (``core.detect.detect_step_sharded``):
# (n_chunks, samples_per_chunk). ``station_year`` ≈ one station-year of
# 100 Hz data (3.15e9 samples) in 512 shardable chunks.
SHAPES = {
    "station_year": (512, 6_150_000),
    "station_month": (512, 512_000),
}


def model_flops(shape_name: str) -> float:
    """Algorithmic FLOPs of the fingerprint+hash stages (MFU numerator).

    STFT matmuls + Haar matmuls + Min-Max hash compares; the sort-based
    search is comparison-bound and excluded (consistent with the paper's
    treatment of search as lookup-bound, §6.3).
    """
    n_chunks, chunk = SHAPES[shape_name]
    cfg = config()
    fp = cfg.fingerprint
    nf_frames = (chunk - fp.stft_len) // fp.stft_hop + 1
    n_fp = (nf_frames - fp.img_time) // fp.img_hop + 1
    lo, hi = fp.band_bins
    k_band = hi - lo
    stft = nf_frames * 2 * (2 * fp.stft_len * k_band)
    haar = n_fp * 2 * (fp.img_freq ** 2 * fp.img_time
                       + fp.img_time ** 2 * fp.img_freq)
    lcfg = cfg.lsh
    minmax = n_fp * fp.fp_dim * lcfg.n_hash_fns * 2
    return float(n_chunks) * (stft + haar + minmax)


def input_specs(shape_name: str) -> dict:
    """The inputs of ``detect_step_sharded`` at ``SHAPES[shape_name]``, as
    ``meta`` tensors (shape and dtype, no storage)."""
    n_chunks, chunk = SHAPES[shape_name]
    n_coeff = config().fingerprint.n_coeff
    return {
        "waveforms": torch.empty((n_chunks, chunk), dtype=torch.float32,
                                 device="meta"),
        "med": torch.empty((n_coeff,), dtype=torch.float32, device="meta"),
        "mad": torch.empty((n_coeff,), dtype=torch.float32, device="meta"),
    }
