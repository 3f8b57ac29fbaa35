"""Share (%) of the traced stretch in which the device was idle while the
host was inside a ``serve.tick`` span (``idle.serve`` less this is the
idle time between ticks)."""
from harness import program_spans

read = program_spans.idle_in_tick
