"""fast_seismic — the paper's own workload (the reference's widths).

Paper-faithful knobs: 100 Hz input, 8192-dim fingerprints (32×128 spectral
images, 2-bit sign encoding), t=100 tables / k=8 funcs / m=2 matches (the
optimized §6.3 setting), 1% occurrence filter, 3–20 Hz band. The values
are those of ``repro.configs.fast_seismic``.
"""
from __future__ import annotations

from repro_torch.core.align import AlignConfig
from repro_torch.core.detect import DetectConfig
from repro_torch.core.fingerprint import FingerprintConfig
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
