"""Share (%) of the dispatched query rows that were live, before the
profiler started: the valid fingerprints of the requests finished by
then over those ticks' dispatches × slots × block fingerprints."""
from harness import readers

read = readers.counter("live_share")
