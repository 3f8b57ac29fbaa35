"""``minmax_hash``'s share (%) of its roofline in the traced call of
the archive search (a launch a station)."""
from harness import readers

read = readers.roofline("minmax_hash")
