"""Data-pipeline stages built on the FAST search (corpus deduplication)."""
