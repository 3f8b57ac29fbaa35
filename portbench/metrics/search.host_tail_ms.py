"""Mean wall milliseconds a search call spends in ``core.align`` (the
harness's synced spans around the compaction, ``merge_channels``,
``cluster_station`` and ``associate_network``), over the calls not
traced."""
from harness import readers

read = readers.span_mean("host_tail_ms")
