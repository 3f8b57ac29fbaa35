"""Spatiotemporal alignment (paper §7): triplets → earthquake detections.

PyTorch counterpart of ``repro.core.align`` (channel merge, station
clustering, network association). The reference's multi-operand
``lax.sort(..., num_keys=2)`` becomes a stable sort of one int64
lexicographic key (``utils.lex_key``) and a gather of the other operands;
segment reductions become scatters over a segment-id vector. All values
stay int32, so wrap-around matches the reference bit for bit.
``align_streamed`` is the host-side external merge (paper §7.2) for
triplet sets larger than memory: numpy, spill files and a heap merge, a
copy of the reference's. While a ``torch.profiler`` records,
``merge_channels``, ``cluster_station`` and ``associate_network`` are
each its annotation ``align.<name>`` (``obsv.spans.traced``).
"""
from __future__ import annotations

import dataclasses
import heapq
import os
import tempfile
from typing import Iterable, Sequence

import numpy as np
import torch

from repro_torch import utils
from repro_torch.core.lsh import INVALID, Pairs
from repro_torch.obsv import spans


@dataclasses.dataclass(frozen=True)
class AlignConfig:
    channel_threshold: int = 4     # combined-sim threshold after merge
    gap: int = 10                  # max idx1 gap within a diagonal cluster
    dt_merge_tol: int = 2          # adjacent-diagonal merge distance
    min_cluster_size: int = 2      # prune small clusters
    min_cluster_sim: int = 6
    dt_tol: int = 2                # network: inter-event-time tolerance
    onset_tol: int = 30            # network: arrival-window tolerance
    min_stations: int = 2
    max_group_extent: int = 0      # network group onset-span cap (0 = off)


@dataclasses.dataclass
class Events:
    """Per-station candidate events (masked). onset/dt in fingerprint lags."""

    dt: torch.Tensor
    onset: torch.Tensor
    extent: torch.Tensor     # idx_max - idx_min of the cluster
    size: torch.Tensor       # similar-pair count in the cluster
    score: torch.Tensor      # summed similarity
    valid: torch.Tensor

    def count(self) -> torch.Tensor:
        return self.valid.sum()


def _lex_sort(k1: torch.Tensor, k2: torch.Tensor, *rest: torch.Tensor):
    """Stable sort by (k1, k2); returns the sorted keys and operands."""
    order = torch.sort(utils.lex_key(k1, k2), stable=True).indices
    return tuple(x[order] for x in (k1, k2, *rest))


def _shift1(x: torch.Tensor, fill: int) -> torch.Tensor:
    """[fill, x[0], ..., x[-2]] — each row's predecessor."""
    return torch.cat([torch.full_like(x[:1], fill), x[:-1]])


def _sort_triplets(dt, idx1, sim, valid):
    k1 = torch.where(valid, dt, INVALID)
    k2 = torch.where(valid, idx1, INVALID)
    return _lex_sort(k1, k2, sim, valid.to(torch.int32))


@spans.traced("align.merge_channels")
def merge_channels(triplets: Sequence[tuple], threshold: int) -> Pairs:
    """Sum similarity of identical (dt, idx1) across channels; threshold.

    ``triplets``: sequence of (dt, idx1, sim, valid) per channel (§7.1).
    """
    dt = torch.cat([t[0] for t in triplets])
    idx1 = torch.cat([t[1] for t in triplets])
    sim = torch.cat([t[2] for t in triplets])
    valid = torch.cat([t[3].bool() for t in triplets])
    dt_s, idx_s, sim_s, val_s = _sort_triplets(dt, idx1, sim, valid)
    p = dt_s.shape[0]
    starts = utils.segment_starts(dt_s) | utils.segment_starts(idx_s)
    seg = utils.segment_ids_from_starts(starts).long()
    tot = utils.segment_sum(torch.where(val_s > 0, sim_s, 0), seg, p)[seg]
    keep = starts & (val_s > 0) & (tot >= threshold)
    return Pairs(idx1=torch.where(keep, idx_s, INVALID),
                 idx2=torch.where(keep, idx_s + dt_s, INVALID),
                 sim=torch.where(keep, tot, 0), valid=keep)


@spans.traced("align.cluster_station")
def cluster_station(pairs: Pairs, cfg: AlignConfig) -> Events:
    """Cluster triplets along diagonals into candidate events (§7.1/7.2):
    per-diagonal gap clustering, then one adjacent-diagonal merge pass over
    clusters sorted by (idx_min, dt)."""
    dt_s, idx_s, sim_s, val_s = _sort_triplets(pairs.dt, pairs.idx1,
                                               pairs.sim, pairs.valid)
    p = dt_s.shape[0]
    live = val_s > 0

    # stage 1: per-diagonal gap clustering
    new = ((dt_s != _shift1(dt_s, INVALID))
           | ((idx_s - _shift1(idx_s, INVALID)) > cfg.gap)
           | ~live)
    cid = utils.segment_ids_from_starts(new)
    c_count = utils.segment_sum(live.to(torch.int32), cid, p)
    c_score = utils.segment_sum(torch.where(live, sim_s, 0), cid, p)
    c_dt = utils.segment_min(torch.where(live, dt_s, INVALID), cid, p)
    c_imin = utils.segment_min(torch.where(live, idx_s, INVALID), cid, p)
    c_imax = utils.segment_max(torch.where(live, idx_s, -1), cid, p)
    c_valid = c_count > 0

    # stage 2: adjacent-diagonal merge (clusters sorted by idx_min, dt)
    s_imin, s_dt, s_imax, s_count, s_score, s_val = _lex_sort(
        torch.where(c_valid, c_imin, INVALID),
        torch.where(c_valid, c_dt, INVALID),
        c_imax, c_count, c_score, c_valid.to(torch.int32))
    s_live = s_val > 0
    sep = ((torch.abs(s_dt - _shift1(s_dt, INVALID)) > cfg.dt_merge_tol)
           | (s_imin > _shift1(s_imax, -INVALID) + cfg.gap)
           | ~s_live)
    gid = utils.segment_ids_from_starts(sep)
    g = gid.long()
    g_count = utils.segment_sum(torch.where(s_live, s_count, 0), gid, p)[g]
    g_score = utils.segment_sum(torch.where(s_live, s_score, 0), gid, p)[g]
    g_dt = utils.segment_min(torch.where(s_live, s_dt, INVALID), gid, p)[g]
    g_imin = utils.segment_min(torch.where(s_live, s_imin, INVALID),
                               gid, p)[g]
    g_imax = utils.segment_max(torch.where(s_live, s_imax, -1), gid, p)[g]
    keep = (sep & s_live & (g_count >= cfg.min_cluster_size)
            & (g_score >= cfg.min_cluster_sim))
    return Events(dt=torch.where(keep, g_dt, INVALID),
                  onset=torch.where(keep, g_imin, INVALID),
                  extent=torch.where(keep, g_imax - g_imin, 0),
                  size=torch.where(keep, g_count, 0),
                  score=torch.where(keep, g_score, 0),
                  valid=keep)


@spans.traced("align.associate_network")
def associate_network(events: Sequence[Events], cfg: AlignConfig,
                      n_stations: int, with_onsets: bool = False) -> dict:
    """Group per-station events by (dt, onset); require ≥ min_stations.

    A group's station multiplicity is its number of distinct stations —
    what the reference gets as the popcount of a segmented OR of station
    bitmasks — counted here from a (groups × S) presence matrix.
    ``with_onsets`` adds the dense (p, S) ``station_onset`` (each group's
    earliest onset at each station, ``INVALID`` where absent) and
    ``station_score`` (summed score) matrices the locate tier stacks over.
    """
    if n_stations <= 0:
        raise ValueError(f"n_stations must be positive, got {n_stations}")
    if len(events) != n_stations:
        raise ValueError(f"got {len(events)} per-station Events for "
                         f"n_stations={n_stations}")
    dt = torch.cat([e.dt for e in events])
    onset = torch.cat([e.onset for e in events])
    score = torch.cat([e.score for e in events])
    valid = torch.cat([e.valid for e in events])
    sid = torch.cat([torch.full_like(e.dt, i) for i, e in enumerate(events)])
    p = dt.shape[0]
    dt_s, on_s, sc_s, sid_s, val_s = _lex_sort(
        torch.where(valid, dt, INVALID), torch.where(valid, onset, INVALID),
        score, sid, valid.to(torch.int32))
    live = val_s > 0
    new = ((torch.abs(dt_s - _shift1(dt_s, INVALID)) > cfg.dt_tol)
           | (torch.abs(on_s - _shift1(on_s, INVALID)) > cfg.onset_tol)
           | ~live)
    gid = utils.segment_ids_from_starts(new)
    g = gid.long()
    present = torch.zeros((p + 1, n_stations), dtype=torch.bool,
                          device=dt.device)
    present[torch.where(live, g, p), sid_s.long()] = True
    n_st = present[:p].sum(dim=1, dtype=torch.int32)[g]
    g_score = utils.segment_sum(torch.where(live, sc_s, 0), gid, p)[g]
    g_dt = utils.segment_min(torch.where(live, dt_s, INVALID), gid, p)[g]
    g_onset = utils.segment_min(torch.where(live, on_s, INVALID), gid, p)[g]
    g_on_max = utils.segment_max(torch.where(live, on_s, -1), gid, p)[g]
    span = torch.clamp(g_on_max - g_onset, min=0)
    keep = new & live & (n_st >= cfg.min_stations)
    if cfg.max_group_extent > 0:
        keep &= span <= cfg.max_group_extent
    out = {
        "dt": torch.where(keep, g_dt, INVALID),
        "onset": torch.where(keep, g_onset, INVALID),
        "onset_span": torch.where(keep, span, 0),
        "n_stations": torch.where(keep, n_st, 0),
        "score": torch.where(keep, g_score, 0),
        "valid": keep,
    }
    if with_onsets:
        # (S, p) rows: a row's value lands in its own station's row only
        live_st = (sid_s[None, :] == torch.arange(
            n_stations, dtype=sid_s.dtype, device=dt.device)[:, None]) \
            & live[None, :]
        seg = gid.expand(n_stations, p)
        onset_mat = utils.segment_min(
            torch.where(live_st, on_s[None, :], INVALID), seg, p).T[g]
        score_mat = utils.segment_sum(
            torch.where(live_st, sc_s[None, :], 0), seg, p).T[g]
        out["station_onset"] = torch.where(keep[:, None], onset_mat, INVALID)
        out["station_score"] = torch.where(keep[:, None], score_mat, 0)
    return out


# ---------------------------------------------------------------------------
# out-of-core channel merge (paper §7.2, host side)
# ---------------------------------------------------------------------------


def align_streamed(channel_chunks: Sequence[Iterable[np.ndarray]],
                   threshold: int, tmpdir: str | None = None) -> np.ndarray:
    """External sort-merge-reduce of triplet chunks larger than memory.

    ``channel_chunks``: per channel, an iterable of (n, 3) int arrays with
    columns (dt, idx1, sim). Each chunk is sorted and spilled to disk
    (``tmpdir``, default a new temporary directory); a heap merge streams
    them back, summing the sim of equal consecutive (dt, idx1) rows and
    keeping sums ≥ ``threshold``. Returns an (m, 3) int64 array.
    """
    tmp = tmpdir or tempfile.mkdtemp(prefix="fast_align_")
    spill_files = []
    for ci, chunks in enumerate(channel_chunks):
        for gi, arr in enumerate(chunks):
            arr = np.asarray(arr, np.int64)
            order = np.lexsort((arr[:, 1], arr[:, 0]))
            path = os.path.join(tmp, f"c{ci}_g{gi}.npy")
            np.save(path, arr[order])
            spill_files.append(path)

    def stream(path):
        arr = np.load(path, mmap_mode="r")
        for row in arr:
            yield (int(row[0]), int(row[1]), int(row[2]))

    out = []
    cur_key, cur_sim = None, 0
    for dt, idx1, sim in heapq.merge(*[stream(p) for p in spill_files]):
        if (dt, idx1) == cur_key:
            cur_sim += sim
        else:
            if cur_key is not None and cur_sim >= threshold:
                out.append((cur_key[0], cur_key[1], cur_sim))
            cur_key, cur_sim = (dt, idx1), sim
    if cur_key is not None and cur_sim >= threshold:
        out.append((cur_key[0], cur_key[1], cur_sim))
    return np.asarray(out, np.int64).reshape(-1, 3)
