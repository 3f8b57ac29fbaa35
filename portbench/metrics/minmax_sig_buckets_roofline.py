"""``minmax_sig_buckets``'s share (%) of its roofline in the traced replay
call (a launch a block)."""
from harness import readers

read = readers.roofline("minmax_sig_buckets")
