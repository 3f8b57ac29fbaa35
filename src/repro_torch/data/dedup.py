"""LSH near-duplicate detection for training data: the paper's pipeline as
a data-pipeline stage (counterpart of ``repro.data.dedup``).

Token sequences → n-gram shingles → feature-hashed sparse binary vectors,
packed into int32 words → ``core.lsh.search`` (Min-Max signatures through
the ``minmax_hash`` kernel, sort-based candidates) → exact Jaccard verify
(``jaccard_popcount``) → keep one representative of each verified pair.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import utils
from repro_torch.core import lsh as lsh_mod
from repro_torch.core.lsh import LSHConfig


@dataclasses.dataclass(frozen=True)
class DedupConfig:
    shingle: int = 8           # n-gram length
    feature_dim: int = 1024    # feature-hash buckets (fingerprint dim)
    lsh: LSHConfig = LSHConfig(n_tables=32, n_funcs=4, n_matches=2,
                               bucket_cap=8, min_dt=0,
                               occurrence_frac=0.0, seed=99)
    jaccard_threshold: float = 0.5   # exact verification threshold


def shingle_fingerprints(tokens: torch.Tensor,
                         cfg: DedupConfig) -> torch.Tensor:
    """(N, S) integer tokens → (N, feature_dim) bool shingle fingerprints:
    each n-gram's hash sets one feature bit."""
    n = tokens.shape[0]
    k = cfg.shingle
    windows = tokens.unfold(1, k, 1)                    # (N, S-k+1, k)
    h = torch.zeros(windows.shape[:2], dtype=torch.int64,
                    device=tokens.device)
    for i in range(k):
        h = utils.mix32(h ^ utils.hash_u32(windows[..., i], 0x51AB + i))
    out = torch.zeros((n, cfg.feature_dim), dtype=torch.bool,
                      device=tokens.device)
    return out.scatter_(1, h % cfg.feature_dim, True)


def find_duplicates(tokens, cfg: DedupConfig | None = None, device=None
                    ) -> tuple[np.ndarray, dict]:
    """(N, S) token sequences → (keep mask (N,) numpy bool, stats).

    Runs on the tensor's device, or puts numpy input on ``cuda`` unless
    ``device`` names another. A verified pair drops its higher index."""
    cfg = cfg or DedupConfig()
    tokens = utils.placed(tokens, device)
    packed = utils.pack_bits(shingle_fingerprints(tokens, cfg))
    pairs, _ = lsh_mod.search(packed, cfg.lsh)
    jac = lsh_mod.verify_jaccard(packed, pairs)
    dup = (pairs.valid & (jac >= cfg.jaccard_threshold)).cpu().numpy()
    keep = np.ones(tokens.shape[0], bool)
    keep[pairs.idx2.cpu().numpy()[dup]] = False
    return keep, {"candidate_pairs": int(pairs.count()),
                  "verified_dups": int(dup.sum()),
                  "dropped": int((~keep).sum())}
