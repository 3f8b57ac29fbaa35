"""Mean milliseconds a traced ``serve.tick`` spends admitting requests and
assembling its slot batch (its ``serve.admit`` and ``serve.assemble``
spans: the blocks split, stacked and put on the device)."""
from harness import program_spans

read = program_spans.per_tick_ms("serve.admit", "serve.assemble")
