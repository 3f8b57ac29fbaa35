"""Device-resident incremental LSH index (streaming replacement for §6).

PyTorch counterpart of ``repro.stream.index``. The hash tables are
fixed-capacity bucket arrays that live on the device across blocks:

  ``sig[S, t, B, C]``  stored per-table signature of each slot (int32
                       holding the uint32 pattern)
  ``ids[S, t, B, C]``  global fingerprint id of each slot (INVALID = empty)
  ``cursor[S, t, B]``  per-bucket ring write position (monotonic)

The station axis S and the table axis t are tensor dimensions: one call
serves every station and every table, where the reference ``vmap``s a
per-table function inside a per-station ``vmap``. The reference donates
its state buffers to each jitted step; here the functions update the
``IndexState`` tensors **in place** (``index_put_``, ``scatter_add_``,
``masked_fill_``) and return the same object. A batch's ids are shared by
all stations (stations ingest the same block cadence), so ``ids`` is (N,);
signatures, buckets and masks carry the station axis, (S, N, ...).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import utils
from repro_torch.core import lsh as lsh_mod
from repro_torch.core.lsh import INVALID, LSHConfig, Pairs, VerifiedPairs
from repro_torch.kernels import ops

# Layout of the per-step counter vector returned by ``guarded_step``
# (the reference's, field for field).
QC_FIELDS = (
    "duplicate_fingerprints",
    "saturated_lookups",
    "limited_pairs",
    "pairs_emitted",
    "masked_fingerprints",
    "raw_collisions",
    "quarantined_collisions",
    "overflow_pairs",
)


@dataclasses.dataclass(frozen=True)
class StreamIndexConfig:
    """Shape of the resident index (capacity knobs, not semantics)."""

    n_buckets: int = 4096     # buckets per table (power of two)
    bucket_cap: int = 8       # slots per bucket (ring, oldest evicted)
    occ_slots: int = 0        # per-fingerprint partner-count ring (0 = none)
    pk_slots: int = 0         # bit-packed fingerprint ring rows (0 = none)
    pk_words: int = 0         # int32 words per packed row (0 = derive)

    def __post_init__(self):
        if self.n_buckets <= 0 or self.n_buckets & (self.n_buckets - 1):
            raise ValueError(
                f"n_buckets must be a power of two, got {self.n_buckets}")
        if min(self.occ_slots, self.pk_slots, self.pk_words) < 0:
            raise ValueError("occ_slots, pk_slots and pk_words must be >= 0")

    def state_bytes(self, n_tables: int) -> int:
        slots = n_tables * self.n_buckets * self.bucket_cap
        return (slots * (4 + 4) + 2 * n_tables * self.n_buckets * 4
                + max(self.occ_slots, 1) * 4
                + max(self.pk_slots, 1) * max(self.pk_words, 1) * 4)


@dataclasses.dataclass
class IndexState:
    """One index per station, stacked on a leading S axis. All int32."""

    sig: torch.Tensor       # (S, t, B, C) uint32 patterns
    ids: torch.Tensor       # (S, t, B, C), INVALID where empty
    cursor: torch.Tensor    # (S, t, B) monotonic ring cursor
    inserted: torch.Tensor  # (S,) rows ever inserted
    traffic: torch.Tensor   # (S, t, B) insert traffic (decays with expire)
    occ: torch.Tensor       # (S, L) partner counts, ring keyed by id % L
    epoch: torch.Tensor     # (S,) last traffic-decay epoch
    pk: torch.Tensor        # (S, P, W) packed fingerprints, keyed id % P

    @property
    def shape(self) -> tuple[int, int, int]:
        """(t, B, C) — one station's table shape, as in the reference."""
        return tuple(self.sig.shape[1:])

    @property
    def n_stations(self) -> int:
        return self.sig.shape[0]


def init_index(lcfg: LSHConfig, icfg: StreamIndexConfig,
               n_stations: int = 1, device=None) -> IndexState:
    """An empty index for ``n_stations`` stations, on ``cuda`` unless
    ``device`` names another (``utils.resolve_device``)."""
    device = utils.resolve_device(device)
    s, t, b, c = n_stations, lcfg.n_tables, icfg.n_buckets, icfg.bucket_cap

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.int32, device=device)

    return IndexState(
        sig=zeros(s, t, b, c),
        ids=torch.full((s, t, b, c), INVALID, dtype=torch.int32,
                       device=device),
        cursor=zeros(s, t, b), inserted=zeros(s), traffic=zeros(s, t, b),
        occ=zeros(s, max(icfg.occ_slots, 1)), epoch=zeros(s),
        pk=zeros(s, max(icfg.pk_slots, 1), max(icfg.pk_words, 1)))


def init_pool(lcfg: LSHConfig, icfg: StreamIndexConfig, n_stations: int,
              device=None) -> IndexState:
    """An empty pool of ``n_stations`` indexes (the reference stacks
    ``n_stations`` copies of ``init_index``; here that is the S axis)."""
    return init_index(lcfg, icfg, n_stations, device)


def stack_states(states: list[IndexState]) -> IndexState:
    """Station-stacked states → one state with their stations in order."""
    return IndexState(**{
        f.name: torch.cat([getattr(s, f.name) for s in states])
        for f in dataclasses.fields(IndexState)})


def slice_state(pool: IndexState, station: int) -> IndexState:
    """One station's view of a pool state: a one-station ``IndexState``
    (S = 1) sharing the pool's storage."""
    return IndexState(**{
        f.name: getattr(pool, f.name)[station:station + 1]
        for f in dataclasses.fields(IndexState)})


def index_stats(state: IndexState) -> dict:
    """Occupancy / skew diagnostics of a one-station state, on the host
    (the reference's keys and values)."""
    if state.n_stations != 1:
        raise ValueError(f"index_stats takes one station's state "
                         f"(slice_state), got {state.n_stations} stations")
    occupied = (state.ids[0] != INVALID).cpu().numpy()
    per_bucket = occupied.sum(axis=2)
    return {
        "inserted": int(state.inserted[0]),
        "resident": int(occupied.sum()),
        "occupancy": float(occupied.mean()),
        "full_buckets": int((per_bucket == state.ids.shape[-1]).sum()),
        "max_bucket_fill": int(per_bucket.max()),
    }


def _by_table(x: torch.Tensor) -> torch.Tensor:
    """(S, N, t) → (S, t, N)."""
    return x.permute(0, 2, 1)


def _bucket_rows(state: IndexState, bk: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Occupants of each lookup's bucket: (S, t, N) buckets → stored
    (signatures, ids), each (S, t, N, C)."""
    c = state.sig.shape[-1]
    idx = bk.to(torch.int64)[..., None].expand(*bk.shape, c)
    return state.sig.gather(2, idx), state.ids.gather(2, idx)


def insert(state: IndexState, sigs: torch.Tensor, ids: torch.Tensor,
           cfg: LSHConfig, valid: torch.Tensor | None = None,
           buckets: torch.Tensor | None = None) -> IndexState:
    """Insert a batch of per-table signatures, in place.

    sigs (S, N, t); ids (N,) int32, monotone across the stream. Within a
    batch, same-bucket rows take consecutive ring positions in id order
    (stable sort + rank in run), so an overflowing bucket keeps its
    newest C rows.
    """
    s, t, b, c = state.sig.shape
    n = sigs.shape[1]
    if valid is None:
        valid = torch.ones((s, n), dtype=torch.bool, device=sigs.device)
    if buckets is None:
        buckets = lsh_mod.bucket_ids(sigs, b, cfg.seed)
    bk = _by_table(buckets)
    v = valid[:, None, :].expand(s, t, n)
    order_key = torch.where(v, bk, torch.full_like(bk, b))
    sb, perm = torch.sort(order_key, dim=-1, stable=True)
    rank = utils.rank_in_run(sb)
    _, lens = utils.run_lengths(sb)
    inb = sb < b
    keep = inb & (rank >= lens - c)
    cur = state.cursor.gather(-1, torch.where(inb, sb, 0).to(torch.int64))
    pos = (cur + rank) % c
    base = ((torch.arange(s, device=sb.device)[:, None, None] * t
             + torch.arange(t, device=sb.device)[None, :, None]) * (b * c))
    lin = (base + sb.to(torch.int64) * c + pos)[keep]
    state.sig.view(-1)[lin] = _by_table(sigs).gather(-1, perm)[keep]
    state.ids.view(-1)[lin] = ids.to(torch.int32)[perm][keep]
    adds = v.to(torch.int32)
    state.cursor.scatter_add_(-1, bk.to(torch.int64), adds)
    state.traffic.scatter_add_(-1, bk.to(torch.int64), adds)
    state.inserted += valid.sum(dim=-1, dtype=torch.int32)
    return state


def query(state: IndexState, sigs: torch.Tensor, qids: torch.Tensor,
          cfg: LSHConfig, buckets: torch.Tensor | None = None,
          qvalid: torch.Tensor | None = None, saturation: int = 0,
          counts: int = 0, max_pairs: int = 0):
    """Stored partners of a signature batch → thresholded (S, t·N·C) Pairs.

    Only partners with stored id < query id are emitted. ``qvalid`` (S, N)
    suppresses emission for flagged rows; ``saturation`` > 0 drops hits in
    buckets whose traffic exceeds it. ``counts`` also returns the (S, 2)
    [raw collisions, quarantined collisions]; ``max_pairs`` > 0 compacts.

    sigs may carry a slot axis, (S, Q, N, t) with ``qids`` (N,) shared by
    every slot (the serving tier's batches): the slots fold into one
    gather (the index is never copied once a slot), and each (station,
    slot) row keeps its own id test, m-of-t count and compaction, giving
    Pairs (S, Q, M) equal to Q separate calls. ``buckets`` and ``qvalid``
    then carry the same slot axis.
    """
    s, t, b, c = state.sig.shape
    q = sigs.shape[1] if sigs.dim() == 4 else 0
    if q:
        n = sigs.shape[2]
        sigs = sigs.reshape(s, q * n, t)
        if buckets is not None:
            buckets = buckets.reshape(s, q * n, t)
        if qvalid is not None:
            qvalid = qvalid.reshape(s, q * n)
        qids = qids.repeat(q)
    if buckets is None:
        buckets = lsh_mod.bucket_ids(sigs, b, cfg.seed)
    bk = _by_table(buckets)
    occ_sig, occ_id = _bucket_rows(state, bk)
    qid = qids.to(torch.int32)[None, None, :, None]
    raw = ((occ_sig == _by_table(sigs)[..., None]) & (occ_id != INVALID)
           & (occ_id < qid))
    hit = raw
    n_quar = torch.zeros(s, dtype=torch.int32, device=raw.device)
    if saturation > 0:
        ok = (state.traffic.gather(-1, bk.to(torch.int64))
              <= saturation)[..., None]
        hit = hit & ok
        if counts:
            n_quar = (raw & ~ok).sum(dim=(1, 2, 3), dtype=torch.int32)
    if qvalid is not None:
        hit = hit & qvalid[:, None, :, None]
    lo = torch.where(hit, occ_id, INVALID)
    hi = torch.where(hit, qid, INVALID)
    if q:   # (S, t, Q·N, C) → one row a (station, slot), ordered (t, N, C)
        lo, hi = (x.view(s, t, q, n, c).transpose(1, 2) for x in (lo, hi))
    rows = s * max(q, 1)
    pairs = lsh_mod.finalize_pairs(lo.reshape(rows, -1),
                                   hi.reshape(rows, -1), cfg)
    if max_pairs > 0:
        pairs, _ = compact_pairs(pairs, max_pairs)
    if q:
        pairs = Pairs(*(getattr(pairs, f.name).reshape(s, q, -1)
                        for f in dataclasses.fields(Pairs)))
    if not counts:
        return pairs
    n_raw = raw.sum(dim=(1, 2, 3), dtype=torch.int32)
    return pairs, torch.stack([n_raw, n_quar], dim=-1)


def expire(state: IndexState, min_id: torch.Tensor,
           half_life: int = 0) -> IndexState:
    """Sliding window, in place: drop entries with id < min_id (S,).

    ``half_life`` > 0 halves the traffic counter once per half-life
    boundary that ``min_id`` crossed, so saturation is window-relative.
    """
    min_id = min_id.to(torch.int32)
    state.ids.masked_fill_(state.ids < min_id[:, None, None, None], INVALID)
    if half_life > 0:
        new_epoch = torch.clamp(min_id, min=0) // half_life
        shift = torch.clamp(new_epoch - state.epoch, 0, 31)
        state.traffic.bitwise_right_shift_(shift[:, None, None])
        state.epoch.copy_(new_epoch)
    return state


# ---------------------------------------------------------------------------
# degenerate-similarity guards: duplicate probe + saturation
# ---------------------------------------------------------------------------


def duplicate_flags(state: IndexState, sigs: torch.Tensor, ids: torch.Tensor,
                    cfg: LSHConfig, dup_tables: int,
                    buckets: torch.Tensor | None = None,
                    valid: torch.Tensor | None = None) -> torch.Tensor:
    """(S, N) bool — rows whose signatures collide with resident entries
    (or earlier rows of the batch) in ≥ ``dup_tables`` tables at id
    distance ≥ ``min_dt``; flagged before insert."""
    s, t, b, c = state.sig.shape
    if buckets is None:
        buckets = lsh_mod.bucket_ids(sigs, b, cfg.seed)
    ids = ids.to(torch.int32)
    far = ids[:, None] - max(cfg.min_dt, 1)                  # (N, 1)
    occ_sig, occ_id = _bucket_rows(state, _by_table(buckets))
    hit = ((occ_sig == _by_table(sigs)[..., None]) & (occ_id != INVALID)
           & (occ_id <= far))
    resident = hit.any(dim=-1).sum(dim=1, dtype=torch.int32)   # (S, N)
    same = (sigs[:, :, None, :] == sigs[:, None, :, :]).sum(
        dim=-1, dtype=torch.int32)                              # (S, N, N)
    earlier = (ids[None, :] <= far)[None]
    if valid is not None:
        earlier = earlier & valid[:, None, :]
    intra = torch.where(earlier, same, 0).amax(dim=-1)
    dup = torch.maximum(resident, intra) >= dup_tables
    if valid is not None:
        dup = dup & valid
    return dup


def saturated_lookup_count(state: IndexState, buckets: torch.Tensor,
                           saturation: int,
                           valid: torch.Tensor | None = None) -> torch.Tensor:
    """(S,) count of valid (row, table) lookups in quarantined buckets."""
    cur = state.traffic.gather(-1, _by_table(buckets).to(torch.int64))
    hot = cur > saturation
    if valid is not None:
        hot = hot & valid[:, None, :]
    return hot.sum(dim=(1, 2), dtype=torch.int32)


def occurrence_limit_pairs(state: IndexState, sigs: torch.Tensor,
                           buckets: torch.Tensor, ids: torch.Tensor,
                           qvalid: torch.Tensor | None, cfg: LSHConfig,
                           pairs: Pairs, limit: int
                           ) -> tuple[IndexState, Pairs, torch.Tensor]:
    """In-dispatch §6.5 occurrence limiter: raw partner collisions (at id
    distance ≥ ``min_dt``) are added to both endpoints' counters in the
    ``occ`` ring (in place), and pairs touching a fingerprint past
    ``limit`` are dropped. Returns (state, limited pairs, (S,) dropped)."""
    s = state.sig.shape[0]
    ring = state.occ.shape[-1]
    ids = ids.to(torch.int32)
    far = ids[:, None] - (max(cfg.min_dt, 1) - 1)
    occ_sig, occ_id = _bucket_rows(state, _by_table(buckets))
    hit = ((occ_sig == _by_table(sigs)[..., None]) & (occ_id != INVALID)
           & (occ_id < far))
    if qvalid is not None:
        hit = hit & qvalid[:, None, :, None]
    q_counts = hit.sum(dim=(1, 3), dtype=torch.int32)          # (S, N)
    state.occ.scatter_add_(
        -1, (ids % ring).to(torch.int64).expand(s, -1), q_counts)
    pslot = torch.where(hit, occ_id % ring, 0).reshape(s, -1)
    state.occ.scatter_add_(-1, pslot.to(torch.int64),
                           hit.reshape(s, -1).to(torch.int32))
    hot = state.occ > limit
    v = pairs.valid
    s1 = torch.where(v, pairs.idx1 % ring, 0).to(torch.int64)
    s2 = torch.where(v, pairs.idx2 % ring, 0).to(torch.int64)
    keep = v & ~hot.gather(-1, s1) & ~hot.gather(-1, s2)
    dropped = (v & ~keep).sum(dim=-1, dtype=torch.int32)
    limited = Pairs(idx1=pairs.idx1, idx2=pairs.idx2,
                    sim=torch.where(keep, pairs.sim, 0), valid=keep)
    return state, limited, dropped


# ---------------------------------------------------------------------------
# emission epilogue: compaction + exact-Jaccard verify
# ---------------------------------------------------------------------------


def compact_pairs(pairs: Pairs, max_pairs: int
                  ) -> tuple[Pairs, torch.Tensor]:
    """Keep the first ``max_pairs`` valid stream positions (the stream is
    (idx1, idx2)-sorted, so the lexicographically smallest pairs), padded
    from the stream head; returns (compacted pairs, (S,) overflow)."""
    m = pairs.valid.shape[-1]
    k = min(max_pairs, m)
    pos = torch.arange(m, dtype=torch.int64, device=pairs.valid.device)
    score = torch.where(pairs.valid, 2 * m - pos, m - pos)
    take = torch.topk(score, k, dim=-1, sorted=True).indices
    kept = pairs.valid.gather(-1, take)
    overflow = (pairs.valid.sum(dim=-1, dtype=torch.int32)
                - kept.sum(dim=-1, dtype=torch.int32))
    return Pairs(idx1=pairs.idx1.gather(-1, take),
                 idx2=pairs.idx2.gather(-1, take),
                 sim=pairs.sim.gather(-1, take), valid=kept), overflow


def verify_pairs(state: IndexState, pairs: Pairs) -> torch.Tensor:
    """Exact Jaccard of compacted candidates from the packed ring, in one
    ``kernels.ops.jaccard_popcount`` call (the valid mask, the ring modulo
    and the gathers are fused into the kernel). Invalid rows score 0."""
    return ops.jaccard_popcount(state.pk, pairs.idx1, pairs.idx2,
                                pairs.valid)


def guarded_step(state: IndexState, sigs: torch.Tensor, buckets: torch.Tensor,
                 ids: torch.Tensor, valid: torch.Tensor | None,
                 cfg: LSHConfig, window: int, saturation: int = 0,
                 dup_tables: int = 0, occ_limit: int = 0, counters: int = 0,
                 packed: torch.Tensor | None = None, max_pairs: int = 0,
                 verify: int = 0, min_jac: float = 0.0
                 ) -> tuple[IndexState, Pairs, torch.Tensor]:
    """expire → duplicate guard → insert → saturation-guarded query →
    occurrence limiter → emission compaction + exact-Jaccard verify.

    The reference's ``guarded_step`` over every station at once; the
    state is updated in place. sigs/buckets (S, N, t), ids (N,), valid and
    packed (S, N[, W]). Returns (state, pairs (S, ...), qc (S, 8) int32 in
    ``QC_FIELDS`` order). ``verify`` > 0 (1 or 2: both use
    ``kernels.ops``) needs ``max_pairs`` > 0 and returns VerifiedPairs.
    """
    s, n = sigs.shape[0], sigs.shape[1]
    dev = sigs.device
    ids = ids.to(torch.int32)
    zero = torch.zeros(s, dtype=torch.int32, device=dev)
    if occ_limit > 0:
        ring = state.occ.shape[-1]
        state.occ[:, (ids % ring).to(torch.int64)] = 0
    if window > 0:
        if valid is None:
            newest = (ids[-1] + 1).expand(s)
        else:
            newest = torch.where(valid, ids + 1, ids[0]).amax(dim=-1)
        expire(state, newest - window,
               half_life=window if saturation > 0 else 0)
    ins_valid, qvalid = valid, None
    qc_dup = zero
    if dup_tables > 0:
        v = (torch.ones((s, n), dtype=torch.bool, device=dev)
             if valid is None else valid)
        dup = duplicate_flags(state, sigs, ids, cfg, dup_tables,
                              buckets=buckets, valid=v)
        ins_valid = v & ~dup
        qvalid = ins_valid
        qc_dup = dup.sum(dim=-1, dtype=torch.int32)
    if verify > 0:
        # stash this block's packed rows at id % ring; suppressed rows
        # keep the slot's previous contents
        if max_pairs <= 0:
            raise ValueError("verify requires max_pairs (compaction)")
        slot = (ids % state.pk.shape[1]).to(torch.int64)
        rows = packed.to(torch.int32)
        if ins_valid is not None:
            rows = torch.where(ins_valid[..., None], rows, state.pk[:, slot])
        state.pk[:, slot] = rows
    insert(state, sigs, ids, cfg, valid=ins_valid, buckets=buckets)
    qc_sat = (saturated_lookup_count(state, buckets, saturation,
                                     valid=ins_valid)
              if saturation > 0 else zero)
    qc_raw = qc_quar = zero
    if counters:
        pairs, qcounts = query(state, sigs, ids, cfg, buckets=buckets,
                               qvalid=qvalid, saturation=saturation,
                               counts=1)
        qc_raw, qc_quar = qcounts[:, 0], qcounts[:, 1]
    else:
        pairs = query(state, sigs, ids, cfg, buckets=buckets, qvalid=qvalid,
                      saturation=saturation)
    qc_occ = zero
    if occ_limit > 0:
        state, pairs, qc_occ = occurrence_limit_pairs(
            state, sigs, buckets, ids, qvalid, cfg, pairs, occ_limit)
    qc_overflow = zero
    if max_pairs > 0:
        pairs, qc_overflow = compact_pairs(pairs, max_pairs)
        if verify == 0:
            jac = torch.zeros(pairs.valid.shape, dtype=torch.float32,
                              device=dev)
        else:
            jac = verify_pairs(state, pairs)
            if min_jac > 0.0:
                floor = torch.tensor(min_jac, dtype=torch.float32, device=dev)
                keep = pairs.valid & (jac >= floor)
                pairs = Pairs(idx1=pairs.idx1, idx2=pairs.idx2,
                              sim=torch.where(keep, pairs.sim, 0),
                              valid=keep)
                jac = torch.where(keep, jac, torch.zeros_like(jac))
        pairs = VerifiedPairs(idx1=pairs.idx1, idx2=pairs.idx2,
                              sim=pairs.sim, valid=pairs.valid, jac=jac)
    qc_pairs = qc_masked = zero
    if counters:
        qc_pairs = pairs.valid.sum(dim=-1, dtype=torch.int32)
        if valid is not None:
            qc_masked = (~valid).sum(dim=-1, dtype=torch.int32)
    return state, pairs, torch.stack(
        [qc_dup, qc_sat, qc_occ, qc_pairs, qc_masked, qc_raw, qc_quar,
         qc_overflow], dim=-1).to(torch.int32)
