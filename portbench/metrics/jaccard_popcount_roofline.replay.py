"""``jaccard_popcount``'s share (%) of its roofline in the traced replay
call (a launch a block, over the pairs the index emitted)."""
from harness import readers

read = readers.roofline("jaccard_popcount")
