"""Mean wall milliseconds a call spends in ``core.lsh.search`` (the
harness's synced span around each station's call, summed a call), over
the calls not traced."""
from harness import readers

read = readers.span_mean("search_ms")
