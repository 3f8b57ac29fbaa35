"""Mean wall milliseconds a replay call spends in the program's
``host_tail`` span (pairs from the host triplets, the occurrence filter,
the alignment), over the calls not traced."""
from harness import readers

read = readers.span_mean("host_tail_ms")
