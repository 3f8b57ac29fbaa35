"""``jaccard_popcount``'s share (%) of its roofline in the traced search
call (a launch a station, over the search's pair slots)."""
from harness import readers

read = readers.roofline("jaccard_popcount")
