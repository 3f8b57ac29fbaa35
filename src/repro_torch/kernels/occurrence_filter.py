"""The §6.5 occurrence filter over a masked pair stream.

The CUDA kernel (``csrc/occurrence_filter.cu``) replaces no Pallas kernel:
the JAX package runs the filter as four ``jax.ops.segment_*`` reductions
(``repro/core/lsh.occurrence_filter``), and ``plain`` is that arithmetic
in PyTorch (two ``segment_sum`` and two ``segment_max``, the masked slots
aimed at fingerprint 0 with weight 0). The kernel computes the same
integers touching only the valid slots, so a stream that is nearly all
masked (the offline search's t · cap · N slots) costs a read of its flags
and not ~17 M same-address atomics a scatter. ``kernels.ops.
occurrence_filter`` picks by device; ``plan`` picks the kernel's loads
from the arrays' alignment.
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from repro_torch import utils
from repro_torch.kernels import _build


@dataclasses.dataclass(frozen=True)
class Plan:
    vector: bool     # 4-byte flag words, 16-byte id / sim vectors


def plan(flag_addresses, word_addresses) -> Plan:
    """Vector accesses where every flag array starts on 4 bytes and every
    int32 array on 16, else bytes and words."""
    return Plan(all(a % 4 == 0 for a in flag_addresses)
                and all(a % 16 == 0 for a in word_addresses))


def plain(idx1: torch.Tensor, idx2: torch.Tensor, sim: torch.Tensor,
          valid: torch.Tensor, n_fp: int, cap: int
          ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(M,) int32 ids and sim, (M,) bool valid → (valid, sim, excluded
    (n_fp,) bool): a fingerprint in more than ``cap`` valid pairs is
    excluded, and so is every partner of one; a pair stays valid where
    neither end is excluded, its sim zeroed where it does not."""
    v = valid
    zero = torch.zeros_like(idx1)
    i1 = torch.where(v, idx1, zero)
    i2 = torch.where(v, idx2, zero)
    w = v.to(torch.int32)
    cnt = (utils.segment_sum(w, i1, n_fp) + utils.segment_sum(w, i2, n_fp))
    excluded = cnt > cap
    nb1 = utils.segment_max(
        torch.where(v, excluded[i2.long()].to(torch.int32),
                    zero), i1, n_fp)
    nb2 = utils.segment_max(
        torch.where(v, excluded[i1.long()].to(torch.int32), zero), i2, n_fp)
    excluded_full = excluded | (nb1 > 0) | (nb2 > 0)
    new_valid = v & ~excluded_full[i1.long()] & ~excluded_full[i2.long()]
    return (new_valid, torch.where(new_valid, sim, torch.zeros_like(sim)),
            excluded_full)


def launch(idx1: torch.Tensor, idx2: torch.Tensor, sim: torch.Tensor,
           valid: torch.Tensor, n_fp: int, cap: int, cnt: torch.Tensor,
           excluded: torch.Tensor, out_valid: torch.Tensor,
           out_sim: torch.Tensor) -> None:
    """Launch the CUDA kernel; all (M,) or (n_fp,) and contiguous, ``cnt``
    int32 scratch of n_fp."""
    lib = _build.load("occurrence_filter")
    fn = lib.occurrence_filter_launch
    fn.restype = ctypes.c_int
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp, vp, vp, vp, ctypes.c_longlong, ci, ci, ci, vp, vp,
                   vp, vp, vp]
    p = plan((valid.data_ptr(), out_valid.data_ptr()),
             (idx1.data_ptr(), idx2.data_ptr(), sim.data_ptr(),
              out_sim.data_ptr()))
    rc = fn(valid.data_ptr(), idx1.data_ptr(), idx2.data_ptr(),
            sim.data_ptr(), valid.shape[0], n_fp, cap, int(p.vector),
            cnt.data_ptr(), excluded.data_ptr(), out_valid.data_ptr(),
            out_sim.data_ptr(),
            torch.cuda.current_stream(valid.device).cuda_stream)
    _build.check(rc, "occurrence_filter")
