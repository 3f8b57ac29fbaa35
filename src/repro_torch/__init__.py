"""FAST earthquake detection (LSH over seismic fingerprints) in PyTorch.

The port of ``repro`` (JAX) to PyTorch and CUDA for an NVIDIA H100. It
imports nothing of ``repro`` or JAX. Entry points and state constructors
(``detect_events``, ``hash_mappings``, ``init_index``, ``convert.*``, ...)
put their work on ``cuda`` unless the caller passes ``device="cpu"``, and
raise without CUDA (``utils.resolve_device``).
"""
