"""95th percentile (ms) of the queue waits (``QueryRequest.queue_wait_s``:
submission to a slot) of the requests finished before the profiler
started."""
from harness import readers

read = readers.counter("queue_wait_p95_ms")
