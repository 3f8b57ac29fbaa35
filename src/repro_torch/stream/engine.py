"""Host-side helpers shared by the batch driver and (later) the streaming
driver: triplets → masked ``Pairs`` and the §6.5 occurrence filter.

PyTorch counterpart of ``pairs_from_triplets`` and
``host_occurrence_filter`` in ``repro.stream.engine``. The streaming
detector itself comes with the streaming slice.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import utils
from repro_torch.core import lsh as lsh_mod
from repro_torch.core.lsh import INVALID, LSHConfig, Pairs


def pairs_from_triplets(tri: np.ndarray, pad_to: int = 1024,
                        device=None) -> Pairs:
    """(m, 3) host triplets (idx1, idx2, sim) → masked fixed-size ``Pairs``
    padded to a multiple of ``pad_to``, on ``cuda`` unless ``device``
    names another."""
    device = utils.resolve_device(device)
    tri = np.asarray(tri).reshape(-1, 3)
    m = tri.shape[0]
    size = max(pad_to, -(-max(m, 1) // pad_to) * pad_to)
    idx1 = np.full(size, INVALID, np.int32)
    idx2 = np.full(size, INVALID, np.int32)
    sim = np.zeros(size, np.int32)
    val = np.zeros(size, bool)
    idx1[:m] = tri[:, 0]
    idx2[:m] = tri[:, 1]
    sim[:m] = tri[:, 2]
    val[:m] = True
    return Pairs(*(torch.as_tensor(a, device=device)
                   for a in (idx1, idx2, sim, val)))


def host_occurrence_filter(pairs: Pairs, n_fp: int, lcfg: LSHConfig, *,
                           base: int = 0, limit: int | None = None
                           ) -> tuple[Pairs, torch.Tensor]:
    """The §6.5 occurrence filter over an accumulated pair set. ``base``
    rebases ids into [0, n_fp) first and restores them on the way out;
    ``limit`` overrides the ``frac * n_fp`` cap. Returns (filtered pairs,
    excluded-fingerprint mask over the rebased span)."""
    v = pairs.valid
    local = pairs if base == 0 else Pairs(
        idx1=torch.where(v, pairs.idx1 - base, INVALID),
        idx2=torch.where(v, pairs.idx2 - base, INVALID),
        sim=pairs.sim, valid=v)
    filt, excluded = lsh_mod.occurrence_filter(
        local, n_fp, lcfg.occurrence_frac, limit=limit)
    if base == 0:
        return filt, excluded
    keep = filt.valid
    return Pairs(idx1=torch.where(keep, pairs.idx1, INVALID),
                 idx2=torch.where(keep, pairs.idx2, INVALID),
                 sim=torch.where(keep, pairs.sim, 0),
                 valid=keep), excluded
