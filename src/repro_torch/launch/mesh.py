"""Production and host meshes (the counterpart of ``repro.launch.mesh``).

Functions, not module constants, so that importing this module touches
no process group. Single pod: 16 × 16 = 256 ranks (data × model);
multi-pod: 2 × 16 × 16 = 512 with a leading ``pod`` axis used for data
parallelism. Like ``jax.make_mesh``, each raises when the ranks of the
default process group do not match the shape, and the message names the
shape.
"""
from __future__ import annotations

from repro_torch.dist import LMMesh


def make_production_mesh(*, multi_pod: bool = False) -> LMMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return LMMesh(shape, axes)


def make_host_mesh(shape=(2, 4), axes=("data", "model")) -> LMMesh:
    """A small mesh for multi-process tests (gloo ranks on the CPU)."""
    return LMMesh(shape, axes)
