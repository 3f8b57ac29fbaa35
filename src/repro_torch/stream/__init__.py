"""Streaming detection in PyTorch: the resident LSH index, the per-block
detection core shared with the batch driver, chunk ingestion and the
``StreamingDetector`` (see ``stream.engine``), whose station pool splits
over a ``stations`` device mesh (``repro_torch.dist``) with the
``pool_step_*_sharded`` entries."""
from repro_torch.stream.engine import (ALERT_COLS,  # noqa: F401
                                       RollingPairFilter, StationStream,
                                       StreamingDetector, StreamStats,
                                       block_coeffs, events_from_rows,
                                       events_to_rows,
                                       host_occurrence_filter,
                                       ingest_chunks, merge_boundary_rows,
                                       pairs_from_triplets,
                                       pool_block_coeffs, stream_step)
from repro_torch.stream.fused import (FusedState,  # noqa: F401
                                      init_pool_state, init_state,
                                      pool_step_advance,
                                      pool_step_advance_sharded,
                                      pool_step_block,
                                      pool_step_block_sharded, step_advance,
                                      step_block)
from repro_torch.stream.index import (QC_FIELDS, IndexState,  # noqa: F401
                                      StreamIndexConfig, compact_pairs,
                                      expire, index_stats, init_index,
                                      init_pool, insert, query, slice_state,
                                      stack_states, verify_pairs)
from repro_torch.stream.ingest import (StreamConfig,  # noqa: F401
                                       StreamingMAD, WaveformRing)
from repro_torch.stream.telemetry import (METRICS_SCHEMA,  # noqa: F401
                                          StreamTelemetry, metrics_snapshot)
