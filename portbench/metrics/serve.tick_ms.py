"""Mean wall milliseconds of the dispatched ticks before the profiler
started (``ServeDetectEngine.tick``, which ends in its device-to-host
copy), the harness's span around each."""
from harness import readers

read = readers.span_mean("tick_ms")
