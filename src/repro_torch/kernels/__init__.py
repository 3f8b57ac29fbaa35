"""Hand-written CUDA kernels of the main path, their plain PyTorch
versions, and the device-dispatching wrappers (``kernels.ops``)."""
