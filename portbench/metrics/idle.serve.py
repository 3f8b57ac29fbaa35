"""Share (%) of the traced stretch of ticks in which the device was idle."""
from harness import readers

read = readers.idle
