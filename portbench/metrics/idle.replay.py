"""Share (%) of the traced replay call in which the device was idle."""
from harness import readers

read = readers.idle
