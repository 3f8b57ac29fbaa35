"""Exact Jaccard of candidate pairs from the packed-fingerprint ring.

The CUDA kernel (``csrc/jaccard_popcount.cu``) replaces the Pallas kernel
``repro/kernels/jaccard_popcount.py:jaccard_popcount`` and fuses what its
callers do around it (``verify_pairs``, ``verify_jaccard``): the valid
mask, the ring modulo, the gathers and the mask of the scores. It takes
the (S, P, W) ring, the two (S, M) id vectors and an optional (S, M)
valid mask. ``plain`` computes the same function in PyTorch with the same
interface; ``kernels.ops.jaccard_popcount`` picks by device. ``plan``
picks the kernel's loads from the ring's width and alignment.
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from repro_torch import utils
from repro_torch.kernels import _build

# The kernel's plan (csrc/jaccard_popcount.cu): lanes a pair for 16-byte
# and for 4-byte loads, and loads a lane a row a round at most. 16 lanes
# of 4 loads a row at the paper's 256 words: 8 or 32 lanes were up to 5%
# slower on the H100 (tools/kernel_variants.py, run `design`).
VECTOR_LANES = 16
SCALAR_LANES = 32
MAX_LOADS = 8


@dataclasses.dataclass(frozen=True)
class Plan:
    vector: bool     # 16-byte loads (else 4-byte words)
    lanes: int       # lanes scoring one pair: 4, 8, 16 or 32
    loads: int       # loads a lane a row a round: 1, 2, 4 or 8


def _pow2_at_least(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


def plan(n_words: int, address: int) -> Plan:
    """16-byte loads where every row starts on 16 bytes (the ring's
    ``address`` on 16 bytes, ``n_words`` a multiple of 4), else 4-byte
    words; as few lanes a pair as the row needs (4 to the plan's lanes),
    and enough loads a lane to cover the row in one round where 8 do."""
    vector = n_words % 4 == 0 and address % 16 == 0
    elems = n_words // 4 if vector else n_words
    lanes = min(VECTOR_LANES if vector else SCALAR_LANES,
                max(4, _pow2_at_least(elems)))
    loads = min(MAX_LOADS, _pow2_at_least(-(-elems // lanes)))
    return Plan(vector, lanes, max(loads, 1))


def plain(pk: torch.Tensor, i1: torch.Tensor, i2: torch.Tensor,
          valid: torch.Tensor | None = None) -> torch.Tensor:
    """pk (S, P, W) int32 words, i1/i2 (S, M) integer ids, valid (S, M)
    bool or None → (S, M) fp32 popcount(a & b) / popcount(a | b) of rows
    ``pk[s, i1 % P]`` and ``pk[s, i2 % P]`` (Python's modulo); 0 where the
    union is empty or the slot is not valid (its ids are not used)."""
    ring = pk.shape[1]
    if valid is not None:
        i1 = torch.where(valid, i1, 0)
        i2 = torch.where(valid, i2, 0)
    s = torch.arange(pk.shape[0], device=pk.device)[:, None]
    a = pk[s, (i1 % ring).long()]
    b = pk[s, (i2 % ring).long()]
    inter = utils.popcount(a & b).sum(dim=-1)
    union = utils.popcount(a | b).sum(dim=-1)
    jac = inter.to(torch.float32) / union.clamp(min=1).to(torch.float32)
    jac = torch.where(union > 0, jac, torch.zeros_like(jac))
    return jac if valid is None else torch.where(valid, jac, 0.0)


def launch(pk: torch.Tensor, i1: torch.Tensor, i2: torch.Tensor,
           valid: torch.Tensor | None, out: torch.Tensor) -> None:
    """Launch the CUDA kernel; i1/i2 int32 and valid bool, all (S, M) and
    contiguous."""
    lib = _build.load("jaccard_popcount")
    fn = lib.jaccard_popcount_launch
    fn.restype = ctypes.c_int
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp, ci, ci, ci, vp, vp, vp, ci, ci, ci, ci, vp, vp]
    stations, ring, n_words = pk.shape
    p = plan(n_words, pk.data_ptr())
    rc = fn(pk.data_ptr(), stations, ring, n_words, i1.data_ptr(),
            i2.data_ptr(), None if valid is None else valid.data_ptr(),
            i1.shape[1], int(p.vector), p.lanes, p.loads, out.data_ptr(),
            torch.cuda.current_stream(pk.device).cuda_stream)
    _build.check(rc, "jaccard_popcount")
