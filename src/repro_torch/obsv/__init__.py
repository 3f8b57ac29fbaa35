"""Observability for the port: the host metrics registry
(``obsv.metrics``) and wall-clock spans (``obsv.spans``)."""
from repro_torch.obsv.metrics import (Counter, Gauge, Histogram,  # noqa: F401
                                      MetricsRegistry, merge_counts,
                                      render_prometheus)
from repro_torch.obsv.spans import SpanTracer  # noqa: F401
