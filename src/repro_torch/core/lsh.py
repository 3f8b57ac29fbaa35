"""Min-Max LSH (paper §6): hash mappings, signatures, bucket ids, the
sort-based candidate search, pair thresholding, the §6.5 occurrence
filter, the §6.4 partitioned search, skew diagnostics and exact verify.

PyTorch counterpart of ``repro.core.lsh``. Signatures are int32 tensors
holding uint32 bit patterns (the search only compares them for equality,
so the signed order of int32 is harmless: runs of equal keys stay
contiguous). Fingerprints enter as packed int32 words
(``fingerprint.binarize_coeffs`` / ``utils.pack_bits``; bit j of word w is
dimension 32 w + j), which is what the Min-Max kernels read. Pair
reductions work along the last dimension, so a leading station or table
axis needs no Python loop.

The offline entry points ``search`` and ``partitioned_search`` run where
their tensor lies, and put array input on ``cuda`` unless ``device``
names another (``utils.resolve_device``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import utils
from repro_torch.kernels import minmax_hash as _mm
from repro_torch.kernels import ops
from repro_torch.obsv import spans

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
    """Packed fingerprints (..., N, W) → per-table signatures (..., N, t).

    The raw Min-Max planes come from ``ops.minmax_hash`` and are folded as
    the reference folds them (``hash_combine(min, max)`` per function, or
    the min alone for MinHash, then the f-way fold per table). Rows where
    ``valid`` (..., N) is False get the filler signatures."""
    lead = packed.shape[:-1]
    t = cfg.n_tables
    mins, maxs = ops.minmax_hash(
        packed.reshape(-1, packed.shape[-1]).contiguous(), mappings)
    sig = utils.to_i32_bits(
        _mm.fold(mins, maxs, cfg.funcs_per_table, cfg.use_minmax))
    sig = sig.reshape(*lead, t)
    if valid is not None:
        filler = _filler_signatures(lead[-1], t, cfg, packed.device)
        sig = torch.where(valid.to(sig.device)[..., None], sig, filler)
    return sig


def minhash_signatures_baseline(packed: torch.Tensor,
                                cfg: LSHConfig) -> torch.Tensor:
    """Unoptimized MinHash (the paper's baseline): k hash functions per
    table, each signature the fold of k minima."""
    base = dataclasses.replace(cfg, use_minmax=False)
    mp = hash_mappings(32 * packed.shape[-1], base, packed.device)
    return signatures(packed, mp, base)


# ---------------------------------------------------------------------------
# sort-based bucket group-by → candidate pairs (§6.1 search)
# ---------------------------------------------------------------------------


def _pairs_one_table(keys: torch.Tensor, cap: int
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., N) signature keys, one row per table → (..., cap·N) canonical
    pair endpoints (lo, hi), INVALID in masked slots.

    Pairs join elements at rank distance 1..cap inside runs of equal keys.
    The sort is stable, as ``lax.sort`` is, so a run lists its ids in
    increasing order and the rank windows match the reference's."""
    n = keys.shape[-1]
    sk, order = torch.sort(keys, dim=-1, stable=True)
    si = order.to(torch.int32)
    a = torch.full((*keys.shape[:-1], cap, n), INVALID, dtype=torch.int32,
                   device=keys.device)
    b = a.clone()
    for w in range(1, min(cap, n - 1) + 1):
        same = sk[..., w:] == sk[..., :-w]
        a[..., w - 1, :n - w] = torch.where(same, si[..., :-w], INVALID)
        b[..., w - 1, :n - w] = torch.where(same, si[..., w:], INVALID)
    a = a.reshape(*keys.shape[:-1], cap * n)
    b = b.reshape(*keys.shape[:-1], cap * n)
    return torch.minimum(a, b), torch.maximum(a, b)


def candidate_pairs(sigs: torch.Tensor, cfg: LSHConfig) -> Pairs:
    """(N, t) signatures → Pairs of size t · bucket_cap · N (masked), all
    tables at once along a leading table axis."""
    lo, hi = _pairs_one_table(sigs.T, cfg.bucket_cap)     # (t, cap·N) each
    return finalize_pairs(lo.reshape(-1), hi.reshape(-1), cfg)


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


# ---------------------------------------------------------------------------
# whole search (+ partitioned variant, §6.4)
# ---------------------------------------------------------------------------


def search(packed, cfg: LSHConfig, valid=None, device=None
           ) -> tuple[Pairs, dict]:
    """Packed fingerprints (N, D/32) → similar pairs + search statistics
    (0-d tensors, as the reference returns them).

    While a ``torch.profiler`` records, the call is its annotation
    ``lsh.search`` (``obsv.spans.bridge``), with the stages
    ``lsh.signatures``, ``lsh.candidates`` (``candidate_pairs`` and its
    multiplicity sort), ``lsh.occurrence_filter`` and
    ``lsh.bucket_stats``."""
    with spans.bridge("lsh.search"):
        packed = utils.placed(packed, device)
        n = packed.shape[0]
        if valid is not None:
            valid = utils.placed(valid, packed.device)
        with spans.bridge("lsh.signatures"):
            mp = hash_mappings(32 * packed.shape[1], cfg, packed.device)
            sigs = signatures(packed, mp, cfg, valid=valid)
        with spans.bridge("lsh.candidates"):
            pairs = candidate_pairs(sigs, cfg)
            stats = {"pre_filter_pairs": pairs.count()}
        if cfg.occurrence_frac > 0:
            with spans.bridge("lsh.occurrence_filter"):
                pairs, excluded = occurrence_filter(pairs, n,
                                                    cfg.occurrence_frac)
                stats["excluded_fingerprints"] = excluded.sum()
        stats["pairs"] = pairs.count()
        with spans.bridge("lsh.bucket_stats"):
            stats.update(bucket_stats(sigs))
    return pairs, stats


def _partition_block(sigs: torch.Tensor, p: int, q: int, psize: int,
                     cfg: LSHConfig) -> Pairs:
    """Candidate pairs of partition block (p, q), in global ids; a cross
    block (p < q) keeps only pairs with one end in each partition.

    As in the reference, ``candidate_pairs`` applies ``min_dt`` to the
    block's local ids before the global ``min_dt`` check, so a cross pair
    whose local distance is below ``min_dt`` is dropped even when its
    global distance is not (ROADMAP, queue 3)."""
    ar = torch.arange(psize, dtype=torch.int32, device=sigs.device)
    sa = sigs[p * psize:(p + 1) * psize]
    if p == q:
        sig, gids = sa, p * psize + ar
    else:
        sig = torch.cat([sa, sigs[q * psize:(q + 1) * psize]])
        gids = torch.cat([p * psize + ar, q * psize + ar])
    pr = candidate_pairs(sig, cfg)
    v = pr.valid
    zero = torch.zeros_like(pr.idx1)
    g1 = torch.where(v, gids[torch.where(v, pr.idx1, zero).long()], INVALID)
    g2 = torch.where(v, gids[torch.where(v, pr.idx2, zero).long()], INVALID)
    if p != q:
        v = v & (pr.idx1 < psize) & (pr.idx2 >= psize)
    lo = torch.minimum(g1, g2)
    hi = torch.maximum(g1, g2)
    if cfg.min_dt > 0:
        v = v & ((hi - lo) >= cfg.min_dt)
    return Pairs(idx1=torch.where(v, lo, INVALID),
                 idx2=torch.where(v, hi, INVALID),
                 sim=torch.where(v, pr.sim, torch.zeros_like(pr.sim)),
                 valid=v)


def partitioned_search(packed, cfg: LSHConfig, n_partitions: int,
                       device=None) -> tuple[list[Pairs], dict]:
    """§6.4: memory-bounded search over partition pair-blocks.

    Signatures are computed once; candidate generation sorts only the keys
    of one block (p, q), p <= q, at a time, so the working set shrinks by
    about ``n_partitions``. Blocks come in the reference's order."""
    packed = utils.placed(packed, device)
    n = packed.shape[0]
    if n % n_partitions:
        raise ValueError(f"{n} fingerprints do not split into "
                         f"{n_partitions} equal partitions")
    psize = n // n_partitions
    mp = hash_mappings(32 * packed.shape[1], cfg, packed.device)
    sigs = signatures(packed, mp, cfg)
    out = [_partition_block(sigs, p, q, psize, cfg)
           for p in range(n_partitions) for q in range(p, n_partitions)]
    stats = {
        "blocks": len(out),
        "block_sort_keys": (2 * psize) * cfg.n_tables,
        "working_set_bytes": 2 * psize * cfg.n_tables
        * (4 + 4) * cfg.bucket_cap,
    }
    return out, stats


# ---------------------------------------------------------------------------
# diagnostics (§6.3) + exact verification
# ---------------------------------------------------------------------------


def bucket_stats(sigs: torch.Tensor) -> dict:
    """Skew diagnostics of (N, t) signatures: selectivity, lookups per
    query, largest bucket.

    The lookup count sum_b s(s - 1) is summed in int64 (the reference sums
    it in int32, which wraps once the total over tables passes 2**31); the
    two ratios are float32 divisions, as in the reference."""
    n, t = sigs.shape
    sk = torch.sort(sigs.T, dim=-1).values                    # (t, N)
    seg = utils.segment_ids_from_starts(utils.segment_starts(sk))
    sizes = utils.segment_sum(torch.ones_like(seg), seg, n)  # int32 (t, N)
    s64 = sizes.to(torch.int64)
    lookups = (s64 * (s64 - 1)).sum()
    avg = lookups.to(torch.float32) / torch.tensor(
        float(n * t), dtype=torch.float32, device=sigs.device)
    return {
        "selectivity": avg / torch.tensor(float(n), dtype=torch.float32,
                                          device=sigs.device),
        "avg_lookups_per_query": avg,
        "max_bucket": sizes.max(),
    }


@spans.traced("lsh.verify_jaccard")
def verify_jaccard(packed: torch.Tensor, pairs: Pairs) -> torch.Tensor:
    """Exact Jaccard of each valid pair's packed fingerprints, 0 elsewhere:
    one ``ops.jaccard_popcount`` call with a station axis of 1 (the valid
    mask and the gathers are fused into it; no host sync). Annotation
    ``lsh.verify_jaccard`` of a running profiler."""
    return ops.jaccard_popcount(packed[None], pairs.idx1[None],
                                pairs.idx2[None], pairs.valid[None])[0]


def brute_force_pairs(fp, threshold: float, min_dt: int = 0) -> np.ndarray:
    """O(N²) exact Jaccard join of (N, D) bool fingerprints, in numpy (the
    test oracle). Returns (P, 3) rows (idx1, idx2, jaccard)."""
    if isinstance(fp, torch.Tensor):
        fp = fp.cpu().numpy()
    fpb = np.asarray(fp, dtype=bool)
    inter = (fpb.astype(np.int32) @ fpb.T.astype(np.int32))
    sizes = fpb.sum(1)
    union = sizes[:, None] + sizes[None, :] - inter
    jac = np.where(union > 0, inter / np.maximum(union, 1), 0.0)
    n = fpb.shape[0]
    iu = np.triu_indices(n, k=max(1, min_dt))
    mask = jac[iu] >= threshold
    return np.stack([iu[0][mask], iu[1][mask], jac[iu][mask]], axis=1)
