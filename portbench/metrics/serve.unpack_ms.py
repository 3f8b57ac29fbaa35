"""Mean milliseconds a traced ``serve.tick`` spends in ``serve.unpack``:
the match lists taken from the fetched tables, and the completions."""
from harness import program_spans

read = program_spans.per_tick_ms("serve.unpack")
