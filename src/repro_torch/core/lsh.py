"""Min-Max LSH (paper §6): hash mappings, signatures, bucket ids, pair
thresholding and the §6.5 occurrence filter.

PyTorch counterpart of the parts of ``repro.core.lsh`` that the batch
detection path runs. Signatures are int32 tensors holding uint32 bit
patterns (the index only compares them for equality). Fingerprints enter
as packed int32 words (``fingerprint.binarize_coeffs``), which is what the
Min-Max kernel reads. Pair reductions work along the last dimension, so a
leading station axis needs no Python loop.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import utils
from repro_torch.kernels import ops

INVALID = 2**31 - 1


@dataclasses.dataclass(frozen=True)
class LSHConfig:
    """The reference's fields; ``use_pallas`` is accepted and ignored."""

    n_tables: int = 100          # t
    n_funcs: int = 8             # k  (Min-Max evaluates k/2 hash fns)
    n_matches: int = 2           # m  (matches out of t required)
    use_minmax: bool = True      # §6.2 (False = baseline MinHash)
    bucket_cap: int = 8          # rank window per bucket
    min_dt: int = 16             # self-match exclusion (overlapping windows)
    occurrence_frac: float = 0.01  # §6.5 (<=0 disables)
    seed: int = 1234
    use_pallas: bool = False

    @property
    def funcs_per_table(self) -> int:
        return self.n_funcs // 2 if self.use_minmax else self.n_funcs

    @property
    def n_hash_fns(self) -> int:
        return self.n_tables * self.funcs_per_table


@dataclasses.dataclass
class Pairs:
    """Fixed-size masked set of similar-fingerprint pairs (int32 ids,
    idx1 < idx2 where valid; sim = number of tables the pair collided in).
    """

    idx1: torch.Tensor
    idx2: torch.Tensor
    sim: torch.Tensor
    valid: torch.Tensor

    @property
    def dt(self) -> torch.Tensor:
        return torch.where(self.valid, self.idx2 - self.idx1,
                           torch.full_like(self.idx1, INVALID))

    def count(self) -> torch.Tensor:
        return self.valid.sum()


@dataclasses.dataclass
class VerifiedPairs(Pairs):
    """``Pairs`` plus ``jac``: the exact Jaccard of the two packed
    fingerprints (all-zero when verification is off)."""

    jac: torch.Tensor = None


def _invalid_like(x: torch.Tensor) -> torch.Tensor:
    return torch.full_like(x, INVALID)


# ---------------------------------------------------------------------------
# hash mappings + signatures (§6.1–6.2)
# ---------------------------------------------------------------------------


def hash_mappings(d: int, cfg: LSHConfig, device=None) -> torch.Tensor:
    """(d, n_hash_fns) int32 hash values in [0, 2**31), columns
    function-fastest within each table (bit-exact with the reference)."""
    device = utils.resolve_device(device)
    dims = torch.arange(d, dtype=torch.int64, device=device)[:, None]
    fns = torch.arange(cfg.n_hash_fns, dtype=torch.int64, device=device)
    h = utils.hash_combine(utils.hash_u32(dims, cfg.seed),
                           utils.hash_u32(fns[None, :], cfg.seed ^ 0xABCD))
    return (utils.mix32(h) >> 1).to(torch.int32)


def bucket_salts(n_tables: int, seed: int, device=None) -> torch.Tensor:
    """(t,) per-table bucket salts as int32 bit patterns."""
    t = torch.arange(n_tables, dtype=torch.int64,
                     device=utils.resolve_device(device))
    return utils.to_i32_bits(utils.hash_u32(t, seed ^ 0xB0C4E7))


def bucket_ids(sigs: torch.Tensor, n_buckets: int, seed: int) -> torch.Tensor:
    """(..., t) signatures → (..., t) bucket indices, salted per table."""
    salts = bucket_salts(sigs.shape[-1], seed, sigs.device)
    h = utils.hash_combine(sigs, salts)
    return (h & (n_buckets - 1)).to(torch.int32)


def _filler_signatures(n: int, t: int, cfg: LSHConfig,
                       device=None) -> torch.Tensor:
    """Unique-ish (N, t) signatures for invalid rows so they never collide."""
    device = utils.resolve_device(device)
    row = utils.hash_u32(torch.arange(n, dtype=torch.int64, device=device),
                         cfg.seed ^ 0x5EED)
    tbl = utils.hash_u32(torch.arange(t, dtype=torch.int64, device=device),
                         cfg.seed ^ 0x7AB1)
    return utils.to_i32_bits(utils.hash_combine(row[:, None], tbl[None, :]))


def signatures_and_buckets(
    packed: torch.Tensor, mappings: torch.Tensor, cfg: LSHConfig,
    n_buckets: int, valid: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Packed fingerprints (..., N, W) → (signatures, bucket ids), each
    (..., N, t) int32, through the Min-Max kernel with its fused fold +
    bucket epilogue. Rows where ``valid`` (..., N) is False get the filler
    signatures and their buckets."""
    lead = packed.shape[:-1]
    t = cfg.n_tables
    sig, bkt = ops.minmax_sig_buckets(
        packed.reshape(-1, packed.shape[-1]).contiguous(), mappings,
        bucket_salts(t, cfg.seed, packed.device),
        use_minmax=cfg.use_minmax, n_buckets=n_buckets)
    sig = sig.reshape(*lead, t)
    bkt = bkt.reshape(*lead, t)
    if valid is not None:
        filler = _filler_signatures(lead[-1], t, cfg, packed.device)
        v = valid[..., None]
        sig = torch.where(v, sig, filler)
        bkt = torch.where(v, bkt, bucket_ids(filler, n_buckets, cfg.seed))
    return sig, bkt


def signatures(packed: torch.Tensor, mappings: torch.Tensor, cfg: LSHConfig,
               valid: torch.Tensor | None = None) -> torch.Tensor:
    """Packed fingerprints (..., N, W) → per-table signatures (..., N, t)."""
    return signatures_and_buckets(packed, mappings, cfg, 1, valid)[0]


# ---------------------------------------------------------------------------
# pair thresholding (shared by the index query)
# ---------------------------------------------------------------------------


def count_pair_multiplicity(lo: torch.Tensor, hi: torch.Tensor,
                            n_matches: int) -> Pairs:
    """Sort (lo, hi) pairs along the last dim; a pair's multiplicity is
    the number of tables it collided in. INVALID endpoints sort last."""
    key = torch.sort(utils.lex_key(lo, hi), dim=-1).values
    lo_s = (key >> 32).to(torch.int32)
    hi_s = ((key & utils.MASK32) - 2**31).to(torch.int32)
    starts = utils.segment_starts(key)
    seg = utils.segment_ids_from_starts(starts)
    live = lo_s != INVALID
    counts = utils.segment_sum(live.to(torch.int32), seg, key.shape[-1])
    sim = counts.gather(-1, seg.to(torch.int64))
    valid = starts & live & (sim >= n_matches)
    return Pairs(idx1=lo_s, idx2=hi_s,
                 sim=torch.where(valid, sim, torch.zeros_like(sim)),
                 valid=valid)


def finalize_pairs(lo: torch.Tensor, hi: torch.Tensor,
                   cfg: LSHConfig) -> Pairs:
    """Per-table emission streams (INVALID in masked slots) → thresholded
    Pairs: the ``min_dt`` self-match exclusion and the m-of-t threshold."""
    if cfg.min_dt > 0:
        ok = (hi - lo) >= cfg.min_dt
        lo = torch.where(ok, lo, _invalid_like(lo))
        hi = torch.where(ok, hi, _invalid_like(hi))
    return count_pair_multiplicity(lo, hi, cfg.n_matches)


# ---------------------------------------------------------------------------
# occurrence filter (§6.5)
# ---------------------------------------------------------------------------


def occurrence_filter(pairs: Pairs, n_fp: int, frac: float,
                      limit: int | None = None
                      ) -> tuple[Pairs, torch.Tensor]:
    """Drop fingerprints matching more than ``frac`` of the partition, and
    their match partners. Ids of valid pairs lie in [0, n_fp). Returns
    (filtered pairs, excluded mask (n_fp,))."""
    v = pairs.valid
    zero = torch.zeros_like(pairs.idx1)
    i1 = torch.where(v, pairs.idx1, zero)
    i2 = torch.where(v, pairs.idx2, zero)
    w = v.to(torch.int32)
    cnt = (utils.segment_sum(w, i1, n_fp) + utils.segment_sum(w, i2, n_fp))
    cap = max(1, int(frac * n_fp)) if limit is None else max(1, int(limit))
    excluded = cnt > cap
    nb1 = utils.segment_max(
        torch.where(v, excluded[i2.long()].to(torch.int32),
                    zero), i1, n_fp)
    nb2 = utils.segment_max(
        torch.where(v, excluded[i1.long()].to(torch.int32), zero), i2, n_fp)
    excluded_full = excluded | (nb1 > 0) | (nb2 > 0)
    new_valid = v & ~excluded_full[i1.long()] & ~excluded_full[i2.long()]
    out = Pairs(idx1=pairs.idx1, idx2=pairs.idx2,
                sim=torch.where(new_valid, pairs.sim,
                                torch.zeros_like(pairs.sim)),
                valid=new_valid)
    return out, excluded_full
