"""Exact Jaccard of candidate pairs from the packed-fingerprint ring.

The CUDA kernel (``csrc/jaccard_popcount.cu``) replaces the Pallas kernel
``repro/kernels/jaccard_popcount.py:jaccard_popcount`` and fuses the ring
gathers of ``verify_pairs``: it takes the (S, P, W) ring and the two
(S, M) slot vectors. ``plain`` computes the same function in PyTorch with
the same interface; ``kernels.ops.jaccard_popcount`` picks by device.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import utils
from repro_torch.kernels import _build


def plain(pk: torch.Tensor, i1: torch.Tensor,
          i2: torch.Tensor) -> torch.Tensor:
    """pk (S, P, W) int32 words, i1/i2 (S, M) ring slots → (S, M) fp32
    popcount(a & b) / popcount(a | b), 0 where the union is empty."""
    s = torch.arange(pk.shape[0], device=pk.device)[:, None]
    a = pk[s, i1.long()]
    b = pk[s, i2.long()]
    inter = utils.popcount(a & b).sum(dim=-1)
    union = utils.popcount(a | b).sum(dim=-1)
    jac = inter.to(torch.float32) / union.clamp(min=1).to(torch.float32)
    return torch.where(union > 0, jac, torch.zeros_like(jac))


def launch(pk: torch.Tensor, i1: torch.Tensor, i2: torch.Tensor,
           out: torch.Tensor) -> None:
    """Launch the CUDA kernel; i1/i2 int32 (S, M), contiguous."""
    lib = _build.load("jaccard_popcount")
    fn = lib.jaccard_popcount_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p]
    stations, ring, n_words = pk.shape
    rc = fn(pk.data_ptr(), stations, ring, n_words, i1.data_ptr(),
            i2.data_ptr(), i1.shape[1], out.data_ptr(),
            torch.cuda.current_stream(pk.device).cuda_stream)
    _build.check(rc, "jaccard_popcount")
