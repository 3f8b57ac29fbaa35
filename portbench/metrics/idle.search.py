"""Share (%) of the traced search call in which the device was idle."""
from harness import readers

read = readers.idle
