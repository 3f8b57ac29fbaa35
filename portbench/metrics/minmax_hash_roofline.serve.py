"""``minmax_hash``'s share (%) of its roofline in the traced ticks (a
launch a tick, over the 4 stations × 32 slots × 256 rows)."""
from harness import readers

read = readers.roofline("minmax_hash")
