"""Observability for the port: wall-clock spans (``obsv.spans``)."""
from repro_torch.obsv.spans import SpanTracer  # noqa: F401
