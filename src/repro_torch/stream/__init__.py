"""Resident LSH index, the per-block detection core and the host helpers
the batch replay shares with the streaming driver."""
