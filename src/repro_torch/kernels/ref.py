"""Plain PyTorch versions of the port's kernels, plus the fixed
DFT and Haar matrices (counterpart of ``repro.kernels.ref``).

The plain versions live beside their kernels (``kernels/<name>.py``);
this module gathers them under the reference's names so tests and
``chip_smoke.py`` can hold each kernel against its plain version.
``minmax_hash`` keeps the reference's (N, D) bits interface; the kernel's
own plain version on packed words is ``kernels.minmax_hash.plain_raw``.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.kernels.flash_attention import \
    plain as flash_attention  # noqa: F401
from repro_torch.kernels.flash_attention import \
    plain_bwd as flash_attention_bwd  # noqa: F401
from repro_torch.kernels.flash_attention import \
    plain_with_lse as flash_attention_with_lse  # noqa: F401
from repro_torch.kernels.haar2d import plain as haar2d  # noqa: F401
from repro_torch.kernels.jaccard_popcount import \
    plain as jaccard_popcount  # noqa: F401
from repro_torch.kernels.minmax_hash import minmax as minmax_hash  # noqa: F401
from repro_torch.kernels.minmax_hash import \
    plain as minmax_sig_buckets  # noqa: F401
from repro_torch.kernels.mamba_scan import plain as mamba_scan  # noqa: F401
from repro_torch.kernels.mamba_scan import \
    plain_bwd as mamba_scan_bwd  # noqa: F401
from repro_torch.kernels.occurrence_filter import \
    plain as occurrence_filter  # noqa: F401
from repro_torch.kernels.stft_mag import plain as stft_mag  # noqa: F401


def haar_matrix(n: int) -> np.ndarray:
    """Full multilevel orthonormal 1-D Haar transform matrix (n x n), n=2^k.

    Row-ordering: [approximation, detail(level=log2(n)) ... detail(level=1)],
    the recursive H_n = [[H_{n/2} ⊗ avg], [I_{n/2} ⊗ diff]].
    """
    assert n & (n - 1) == 0, f"haar size {n} must be a power of two"
    h = np.array([[1.0]])
    while h.shape[0] < n:
        m = h.shape[0]
        top = np.kron(h, np.array([[1.0, 1.0]]) / math.sqrt(2.0))
        bot = np.kron(np.eye(m), np.array([[1.0, -1.0]]) / math.sqrt(2.0))
        h = np.concatenate([top, bot], axis=0)
    return h.astype(np.float32)


def dft_matrices(frame_len: int, n_freq: int) -> tuple[np.ndarray, np.ndarray]:
    """Real/imag DFT analysis matrices (frame_len, n_freq) for rfft bins."""
    t = np.arange(frame_len)[:, None]
    k = np.arange(n_freq)[None, :]
    ang = -2.0 * np.pi * t * k / frame_len
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)

