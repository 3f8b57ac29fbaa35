"""Mean wall milliseconds a call spends in the program's ``fused_step``
spans (the block core: fingerprint, hash, index step and verify, each
span ending in its device-to-host copy), over the calls not traced."""
from harness import readers

read = readers.span_mean("fused_step_ms")
