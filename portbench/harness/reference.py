"""Plain reference of FAST detection (Yoon et al. 2015; Rong et al. 2018).

Written from the method's definitions in plain PyTorch and NumPy, with no
kernel and nothing of the program under test: it works out again what
the program derives from the waveforms (the §5.2 statistics, the
fingerprints, the Min-Max signatures and buckets, the block index's
resident sets, the pairs, the §6.5 occurrence filter, the §7 channel
merge, station clustering and network association). One station is
processed at a time, so a station-day fits beside nothing else.

Float32 products run with TF32 off unless ``tf32=True`` is passed: that
switch is the benchmark's control (the nearest precision below float32).

Settings come from the configuration file's ``fingerprint``, ``lsh``,
``align`` and ``replay`` groups (plain dicts).
"""
from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

MASK = 0xFFFFFFFF
GOLDEN = 0x9E3779B9
INVALID = 2**31 - 1


# ---------------------------------------------------------------------------
# 32-bit hashing (murmur3 finalizer, boost-style combine), uint32 in int64
# ---------------------------------------------------------------------------


def _mul(x: torch.Tensor, m: int) -> torch.Tensor:
    return ((x * (m & 0xFFFF)) + (((x * (m >> 16)) & 0xFFFF) << 16)) & MASK


def mix32(x: torch.Tensor) -> torch.Tensor:
    x = x & MASK
    x = x ^ (x >> 16)
    x = _mul(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def hash_u32(x: torch.Tensor, seed: int) -> torch.Tensor:
    s = (int(seed) & MASK) * GOLDEN & MASK
    return mix32(((x & MASK) + s) & MASK)


def combine(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = a & MASK, b & MASK
    return a ^ ((b + GOLDEN + ((a << 6) & MASK) + (a >> 2)) & MASK)


# ---------------------------------------------------------------------------
# fingerprints (§5)
# ---------------------------------------------------------------------------


def band_bins(fp: dict) -> tuple[int, int]:
    n_rfft = fp["stft_len"] // 2 + 1
    lo = int(math.ceil(fp["band_lo_hz"] * fp["stft_len"] / fp["fs"]))
    hi = int(math.floor(fp["band_hi_hz"] * fp["stft_len"] / fp["fs"])) + 1
    lo = max(0, min(lo, n_rfft - 1))
    return lo, max(lo + 1, min(hi, n_rfft))


def n_fingerprints(fp: dict, n_samples: int) -> int:
    frames = max(0, (n_samples - fp["stft_len"]) // fp["stft_hop"] + 1)
    return max(0, (frames - fp["img_time"]) // fp["img_hop"] + 1)


def _pool(n_in: int, n_out: int) -> np.ndarray:
    """Average over ``n_out`` near-equal spans of ``n_in`` bins, a bin cut
    by a span edge shared by the area each side holds."""
    edges = np.linspace(0.0, n_in, n_out + 1)
    m = np.zeros((n_in, n_out))
    for j in range(n_out):
        for i in range(n_in):
            m[i, j] = max(0.0, min(edges[j + 1], i + 1) - max(edges[j], i))
    return (m / m.sum(axis=0, keepdims=True)).astype(np.float32)


def _haar(n: int) -> np.ndarray:
    """Orthonormal multilevel Haar analysis matrix: the approximation row,
    then the details from the coarsest level to the finest."""
    h = np.ones((1, 1))
    while h.shape[0] < n:
        m = h.shape[0]
        top = np.kron(h, [[1.0, 1.0]]) / math.sqrt(2.0)
        bot = np.kron(np.eye(m), [[1.0, -1.0]]) / math.sqrt(2.0)
        h = np.concatenate([top, bot])
    return h.astype(np.float32)


@contextlib.contextmanager
def precision(tf32: bool):
    """Float32 products with TF32 on or off, restored on exit."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def coefficients(wave: torch.Tensor, fp: dict) -> torch.Tensor:
    """(T,) float32 waveform → (N, img_freq·img_time) Haar coefficients of
    the banded, pooled power spectrogram's images."""
    dev = wave.device
    length, hop = fp["stft_len"], fp["stft_hop"]
    lo, hi = band_bins(fp)
    t = np.arange(length)[:, None]
    k = np.arange(lo, hi)[None, :]
    ang = -2.0 * np.pi * t * k / length
    dft = torch.as_tensor(np.concatenate([np.cos(ang), np.sin(ang)], 1)
                          .astype(np.float32), device=dev)
    window = torch.as_tensor(np.hanning(length).astype(np.float32),
                             device=dev)
    n_img = n_fingerprints(fp, wave.shape[0])
    n_frames = (n_img - 1) * fp["img_hop"] + fp["img_time"]
    frames = wave[:(n_frames - 1) * hop + length].unfold(0, length, hop)
    spec = torch.matmul(frames * window, dft)
    nb = hi - lo
    power = spec[:, :nb] ** 2 + spec[:, nb:] ** 2
    pooled = torch.matmul(power, torch.as_tensor(
        _pool(nb, fp["img_freq"]), device=dev))         # (frames, F)
    hf = torch.as_tensor(_haar(fp["img_freq"]), device=dev)
    ht = torch.as_tensor(_haar(fp["img_time"]), device=dev)
    out = torch.empty((n_img, fp["img_freq"] * fp["img_time"]),
                      dtype=torch.float32, device=dev)
    step = 4096
    for a in range(0, n_img, step):
        b = min(n_img, a + step)
        idx = (torch.arange(a, b, device=dev)[:, None] * fp["img_hop"]
               + torch.arange(fp["img_time"], device=dev)[None, :])
        img = pooled[idx].transpose(1, 2)                # (n, F, T)
        out[a:b] = torch.matmul(hf, torch.matmul(img, ht.T)).reshape(b - a, -1)
    return out


def _median(x: torch.Tensor) -> torch.Tensor:
    s = torch.sort(x, dim=0).values
    n = x.shape[0]
    return (s[(n - 1) // 2] + s[n // 2]) * 0.5


def statistics(coeffs: torch.Tensor, fp: dict, station: int
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """§5.2 median and MAD a coefficient over a row sample: at rate < 1,
    ``max(2, round(N·rate))`` rows of a CPU ``torch.randperm`` seeded
    ``stft_len + station`` (the sampling rule the configuration fixes)."""
    rate = fp["mad_sample_rate"]
    if rate < 1.0:
        n = coeffs.shape[0]
        g = torch.Generator().manual_seed(int(fp["stft_len"] + station))
        rows = torch.randperm(n, generator=g)[:max(2, int(round(n * rate)))]
        coeffs = coeffs[rows.to(coeffs.device)]
    med = _median(coeffs)
    return med, _median(torch.abs(coeffs - med[None, :]))


def binarize(coeffs: torch.Tensor, med: torch.Tensor, mad: torch.Tensor,
             top_k: int) -> torch.Tensor:
    """Top-K |z| a row (ties at the K-th kept) as sign bits: bit 2c set
    for a kept positive coefficient c, bit 2c + 1 for a kept negative."""
    z = (coeffs - med[None, :]) / (mad[None, :] + 1e-9)
    a = torch.abs(z)
    kth = torch.topk(a, top_k, dim=1).values[:, -1:]
    kept = a >= kth
    return torch.stack([kept & (z > 0), kept & (z < 0)], -1).reshape(
        z.shape[0], -1)


def pack(bits: torch.Tensor) -> torch.Tensor:
    """(N, D) bool → (N, D/32) int64 words, bit j of word w = dim 32w + j."""
    b = bits.to(torch.int64).reshape(bits.shape[0], -1, 32)
    return (b << torch.arange(32, device=bits.device)).sum(-1)


def fingerprints(wave: torch.Tensor, fp: dict, station: int) -> torch.Tensor:
    """(T,) waveform → (N, 2·n_coeff) bool fingerprints."""
    c = coefficients(wave, fp)
    med, mad = statistics(c, fp, station)
    return binarize(c, med, mad, fp["top_k"])


# ---------------------------------------------------------------------------
# Min-Max signatures and buckets (§6.1–6.2)
# ---------------------------------------------------------------------------


def signatures(bits: torch.Tensor, lsh: dict, n_buckets: int = 0
               ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """(N, D) fingerprints → (N, t) table signatures (uint32 in int64) and,
    with ``n_buckets``, their salted bucket ids. Function h of table j is
    column j·f + h of the hash matrix, each ``combine(min, max)`` of its
    values over the set dimensions, folded from 0 over the f functions."""
    dev = bits.device
    n, d = bits.shape
    t, f = lsh["n_tables"], lsh["n_funcs"] // 2
    seed = lsh["seed"]
    dims = torch.arange(d, device=dev)[:, None]
    fns = torch.arange(t * f, device=dev)[None, :]
    maps = (mix32(combine(hash_u32(dims, seed), hash_u32(fns, seed ^ 0xABCD)))
            >> 1).to(torch.int32)                            # (D, t·f)
    nnz = bits.sum(1)
    kmax = int(nnz.max()) if n else 1
    sig = torch.empty((n, t), dtype=torch.int64, device=dev)
    step = max(1, (1 << 28) // (kmax * t * f))
    for a in range(0, n, step):
        blk = bits[a:a + step]
        pos = torch.argsort((~blk).to(torch.int8), dim=1,
                            stable=True)[:, :kmax]
        # pad each row with its own first set dimension (min/max unchanged)
        pos = torch.where(torch.arange(kmax, device=dev)[None, :]
                          < nnz[a:a + step, None], pos, pos[:, :1])
        vals = maps[pos]                                     # (n, k, t·f)
        per = combine(vals.amin(1).to(torch.int64),
                      vals.amax(1).to(torch.int64)).reshape(-1, t, f)
        acc = torch.zeros(per.shape[:2], dtype=torch.int64, device=dev)
        for h in range(f):
            acc = combine(acc, per[..., h])
        sig[a:a + step] = acc
    if not n_buckets:
        return sig, None
    salts = hash_u32(torch.arange(t, device=dev), seed ^ 0xB0C4E7)
    return sig, combine(sig, salts[None, :]) & (n_buckets - 1)


def _count(lo: torch.Tensor, hi: torch.Tensor, n: int, lsh: dict
           ) -> np.ndarray:
    """Candidate endpoints, one a table collision → (P, 3) int64 rows
    (idx1, idx2, tables) of pairs at distance ≥ min_dt colliding in ≥ m
    tables, sorted by (idx1, idx2)."""
    ok = (hi - lo) >= lsh["min_dt"]
    key, cnt = torch.unique(lo[ok] * n + hi[ok], return_counts=True)
    keep = cnt >= lsh["n_matches"]
    key, cnt = key[keep], cnt[keep]
    return torch.stack([key // n, key % n, cnt], 1).cpu().numpy()


def replay_pairs(sig: torch.Tensor, bkt: torch.Tensor, lsh: dict,
                 replay: dict) -> list[np.ndarray]:
    """Pairs that the block index emits for one station, per block.

    Blocks of ``block_fingerprints`` are inserted whole, then queried: a
    bucket keeps the ``bucket_cap`` newest ids inserted so far, and a
    fingerprint pairs with each resident id below its own of equal
    signature. Each block keeps its ``max_pairs_per_block`` smallest
    (idx1, idx2) pairs. Returns one (P, 3) array a block."""
    n, t = sig.shape
    dev = sig.device
    b, cap = replay["block_fingerprints"], replay["bucket_cap"]
    ids = torch.arange(n, device=dev)
    key = (bkt.T * n + ids[None, :]).contiguous()            # (t, n)
    sk, sid = torch.sort(key, dim=1)
    sb = sk // n
    ss = sig.T.gather(1, sid)
    end = torch.clamp((sid // b + 1) * b, max=n)
    last = torch.searchsorted(sk, sb * n + end) - 1          # newest resident
    los, his = [], []
    for w in range(1, cap):
        j = torch.arange(w, n, device=dev)
        i = j - w
        hit = ((sb[:, i] == sb[:, j]) & (ss[:, i] == ss[:, j])
               & (i[None, :] > last[:, j] - cap))
        los.append(sid[:, i][hit])
        his.append(sid[:, j][hit])
    rows = _count(torch.cat(los), torch.cat(his), n, lsh)
    out = []
    blk = rows[:, 1] // b
    for k in range(-(-n // b)):
        out.append(rows[blk == k][:replay["max_pairs_per_block"]])
    return out


def search_pairs(sig: torch.Tensor, lsh: dict) -> np.ndarray:
    """Whole-partition search: in each table, ids sorted by (signature,
    id) pair with the next ``bucket_cap`` ids of the same signature."""
    n, t = sig.shape
    dev = sig.device
    ids = torch.arange(n, device=dev)
    order = torch.sort(sig.T * n + ids[None, :], dim=1).indices
    ss = sig.T.gather(1, order)
    los, his = [], []
    for w in range(1, min(lsh["bucket_cap"], n - 1) + 1):
        hit = ss[:, w:] == ss[:, :-w]
        los.append(order[:, :-w][hit])
        his.append(order[:, w:][hit])
    a, c = torch.cat(los), torch.cat(his)
    return _count(torch.minimum(a, c), torch.maximum(a, c), n, lsh)


def jaccard(bits: torch.Tensor, rows: np.ndarray) -> np.ndarray:
    """Exact Jaccard (float32) of each (idx1, idx2, ·) row's fingerprints."""
    if not len(rows):
        return np.zeros(0, np.float32)
    idx = torch.as_tensor(rows[:, :2], device=bits.device)
    a, b = bits[idx[:, 0]], bits[idx[:, 1]]
    inter = (a & b).sum(1).to(torch.float32)
    union = (a | b).sum(1).to(torch.float32)
    return torch.where(union > 0, inter / union,
                       torch.zeros_like(inter)).cpu().numpy()


# ---------------------------------------------------------------------------
# §6.5 occurrence filter and §7 alignment (NumPy, int64)
# ---------------------------------------------------------------------------


def occurrence_filter(rows: np.ndarray, n: int, frac: float) -> np.ndarray:
    """Drop pairs touching a fingerprint with more than ``frac·n``
    partners, or a partner of one."""
    if frac <= 0 or n <= 0 or not len(rows):
        return rows
    lo, hi = rows[:, 0], rows[:, 1]
    cnt = np.bincount(lo, minlength=n) + np.bincount(hi, minlength=n)
    over = cnt > max(1, int(frac * n))
    out = over.copy()
    out[lo[over[hi]]] = True
    out[hi[over[lo]]] = True
    return rows[~out[lo] & ~out[hi]]


def station_events(rows: np.ndarray, align: dict) -> np.ndarray:
    """One channel's pairs → (E, 5) events (dt, onset, extent, size,
    score): pairs whose tables reach ``channel_threshold``, clustered
    along each diagonal at idx1 gaps ≤ ``gap``, then clusters sorted by
    (first idx1, dt) merged with their predecessor where dt moves by ≤
    ``dt_merge_tol`` and the start lies ≤ ``gap`` past its end; groups of
    ≥ ``min_cluster_size`` pairs and ≥ ``min_cluster_sim`` summed tables
    are events."""
    rows = rows[rows[:, 2] >= align["channel_threshold"]]
    if not len(rows):
        return np.zeros((0, 5), np.int64)
    dt, idx, sim = rows[:, 1] - rows[:, 0], rows[:, 0], rows[:, 2]
    o = np.lexsort((idx, dt))
    dt, idx, sim = dt[o], idx[o], sim[o]
    new = np.ones(len(dt), bool)
    new[1:] = (dt[1:] != dt[:-1]) | (idx[1:] - idx[:-1] > align["gap"])
    s = np.flatnonzero(new)
    c_dt, c_imin = dt[s], idx[s]
    c_imax = np.maximum.reduceat(idx, s)
    c_cnt = np.diff(np.append(s, len(dt)))
    c_sc = np.add.reduceat(sim, s)
    o = np.lexsort((c_dt, c_imin))
    c_dt, c_imin, c_imax, c_cnt, c_sc = (x[o] for x in
                                          (c_dt, c_imin, c_imax, c_cnt, c_sc))
    sep = np.ones(len(c_dt), bool)
    sep[1:] = ((np.abs(c_dt[1:] - c_dt[:-1]) > align["dt_merge_tol"])
               | (c_imin[1:] > c_imax[:-1] + align["gap"]))
    g = np.flatnonzero(sep)
    g_dt = np.minimum.reduceat(c_dt, g)
    g_on = np.minimum.reduceat(c_imin, g)
    g_end = np.maximum.reduceat(c_imax, g)
    g_cnt = np.add.reduceat(c_cnt, g)
    g_sc = np.add.reduceat(c_sc, g)
    keep = (g_cnt >= align["min_cluster_size"]) & (g_sc
                                                   >= align["min_cluster_sim"])
    return np.stack([g_dt, g_on, g_end - g_on, g_cnt, g_sc], 1)[keep]


def network_detections(events: list[np.ndarray], align: dict) -> np.ndarray:
    """Per-station events → (G, 5) detections (dt, onset, onset span,
    stations, score): events sorted by (dt, onset), station order within
    ties, start a new group where dt moves by > ``dt_tol`` or the onset by
    > ``onset_tol`` from the previous event; groups seen at ≥
    ``min_stations`` distinct stations are detections."""
    ev = [np.column_stack([e[:, 0], e[:, 1], e[:, 4],
                           np.full(len(e), st)]) for st, e in
          enumerate(events) if len(e)]
    if not ev:
        return np.zeros((0, 5), np.int64)
    ev = np.concatenate(ev)
    o = np.lexsort((ev[:, 1], ev[:, 0]))
    dt, on, sc, st = ev[o].T
    new = np.ones(len(dt), bool)
    new[1:] = ((np.abs(dt[1:] - dt[:-1]) > align["dt_tol"])
               | (np.abs(on[1:] - on[:-1]) > align["onset_tol"]))
    g = np.flatnonzero(new)
    gid = np.cumsum(new) - 1
    seen = np.unique(gid * len(events) + st) // len(events)
    n_st = np.bincount(seen, minlength=len(g))
    g_dt = np.minimum.reduceat(dt, g)
    g_on = np.minimum.reduceat(on, g)
    span = np.maximum.reduceat(on, g) - g_on
    g_sc = np.add.reduceat(sc, g)
    keep = n_st >= align["min_stations"]
    if align.get("max_group_extent", 0) > 0:
        keep &= span <= align["max_group_extent"]
    return np.stack([g_dt, g_on, span, n_st, g_sc], 1)[keep]


# ---------------------------------------------------------------------------
# whole cells
# ---------------------------------------------------------------------------


def replay(waveforms: np.ndarray, cfg: dict, device, tf32: bool = False
           ) -> dict:
    """(S, T) waveforms through the block replay → {"pairs": per station
    (P, 3) post-filter rows, "events": per station (E, 5), "detections":
    (G, 5), "block_pairs": per station the per-block emitted rows}."""
    fp, lsh, rp = cfg["fingerprint"], cfg["lsh"], cfg["replay"]
    out = {"pairs": [], "events": [], "block_pairs": []}
    with precision(tf32):
        for st in range(waveforms.shape[0]):
            wave = torch.as_tensor(waveforms[st], device=device)
            bits = fingerprints(wave, fp, st)
            sig, bkt = signatures(bits, lsh, rp["n_buckets"])
            del bits
            blocks = replay_pairs(sig, bkt, lsh, rp)
            rows = np.concatenate(blocks)
            rows = occurrence_filter(rows, sig.shape[0],
                                     lsh["occurrence_frac"])
            out["block_pairs"].append(blocks)
            out["pairs"].append(rows)
            out["events"].append(station_events(rows, cfg["align"]))
    out["detections"] = network_detections(out["events"], cfg["align"])
    return out


def search(waveforms: np.ndarray, cfg: dict, device, tf32: bool = False
           ) -> dict:
    """(S, T) waveforms through the whole-partition search → {"packed":
    per station (N, D/32) int64 words, "pairs": per station (P, 3)
    post-filter rows, "jac": their Jaccard, "events", "detections"}."""
    fp, lsh = cfg["fingerprint"], cfg["lsh"]
    out = {"packed": [], "pairs": [], "jac": [], "events": []}
    with precision(tf32):
        for st in range(waveforms.shape[0]):
            wave = torch.as_tensor(waveforms[st], device=device)
            bits = fingerprints(wave, fp, st)
            sig, _ = signatures(bits, lsh)
            rows = occurrence_filter(search_pairs(sig, lsh), bits.shape[0],
                                     lsh["occurrence_frac"])
            out["packed"].append(pack(bits))
            out["pairs"].append(rows)
            out["jac"].append(jaccard(bits, rows))
            out["events"].append(station_events(rows, cfg["align"]))
    out["detections"] = network_detections(out["events"], cfg["align"])
    return out


# ---------------------------------------------------------------------------
# the live network: the stream's pool and the query service
# ---------------------------------------------------------------------------


def stream_pool(waveforms: np.ndarray, cfg: dict, device, tf32: bool = False
                ) -> list[dict]:
    """The pool a stream builds from (S, T) waveforms, a station at a
    time: the §5.2 statistics frozen over the first ``stats_warmup_blocks``
    blocks (every row: they fit the reservoir), every fingerprint inserted
    in id order, each bucket keeping its ``bucket_cap`` newest. Returns per
    station {"med", "mad", "ids" (t, B, cap) int64 (-1 where empty),
    "sigs" (t, B, cap)}."""
    fp, lsh, st_cfg = cfg["fingerprint"], cfg["lsh"], cfg["stream"]
    warm = st_cfg["stats_warmup_blocks"] * st_cfg["block_fingerprints"]
    if warm > st_cfg["reservoir_rows"]:
        raise ValueError("the warm-up rows overflow the reservoir: the "
                         "reference does not follow its sampling")
    nb, cap = st_cfg["index"]["n_buckets"], st_cfg["index"]["bucket_cap"]
    out = []
    with precision(tf32):
        for st in range(waveforms.shape[0]):
            wave = torch.as_tensor(waveforms[st], device=device)
            c = coefficients(wave, fp)
            first = c[:warm]
            med = _median(first)
            mad = _median(torch.abs(first - med[None, :]))
            bits = binarize(c, med, mad, fp["top_k"])
            del c
            sig, bkt = signatures(bits, lsh, nb)
            del bits
            n, t = sig.shape
            ids = torch.arange(n, device=device)
            key, order = torch.sort(bkt.T * n + ids[None, :], dim=1)
            b_s, s_s = key // n, sig.T.gather(1, order)
            # rank from the newest within each bucket's run
            pos = torch.arange(n, device=device)[None, :]
            ends = torch.ones_like(b_s, dtype=torch.bool)
            ends[:, :-1] = b_s[:, 1:] != b_s[:, :-1]
            last = torch.flip(torch.cummin(torch.flip(
                torch.where(ends, pos, n), [1]), dim=1).values, [1])
            rank = last - pos
            keep = rank < cap
            tab_ids = torch.full((t, nb, cap), -1, dtype=torch.int64,
                                 device=device)
            tab_sig = torch.zeros((t, nb, cap), dtype=torch.int64,
                                  device=device)
            tt = torch.arange(t, device=device)[:, None].expand(t, n)
            tab_ids[tt[keep], b_s[keep], rank[keep]] = order[keep]
            tab_sig[tt[keep], b_s[keep], rank[keep]] = s_s[keep]
            out.append({"med": med, "mad": mad, "ids": tab_ids,
                        "sigs": tab_sig})
    return out


def serve_matches(window: np.ndarray, pool: list[dict], cfg: dict, device,
                  tf32: bool = False) -> list[tuple]:
    """A query window's match list against the pool: per station, each
    query fingerprint pairs with every resident id of equal signature in
    ≥ m tables (the count its similarity); a station keeps the first
    ``max_pairs_per_block`` pairs by (id, query row), then the ``top_k``
    by similarity, ties to the earlier. Returns (station, id, sim) rows
    in station order."""
    fp, lsh = cfg["fingerprint"], cfg["lsh"]
    cap_pairs = max(cfg["stream"]["max_pairs_per_block"],
                    cfg["serve"]["top_k"])
    k = cfg["serve"]["top_k"]
    nb = cfg["stream"]["index"]["n_buckets"]
    out = []
    with precision(tf32):
        c = coefficients(torch.as_tensor(window, device=device), fp)
        for st, p in enumerate(pool):
            bits = binarize(c, p["med"], p["mad"], fp["top_k"])
            sig, bkt = signatures(bits, lsh, nb)
            q, t = sig.shape
            tt = torch.arange(t, device=device)[None, :].expand(q, t)
            ids = p["ids"][tt, bkt]                      # (q, t, cap)
            hit = (ids >= 0) & (p["sigs"][tt, bkt] == sig[..., None])
            rows = torch.arange(q, device=device)[:, None, None].expand(
                ids.shape)
            key, cnt = torch.unique(ids[hit] * q + rows[hit],
                                    return_counts=True)
            ok = cnt >= lsh["n_matches"]
            key, cnt = key[ok][:cap_pairs], cnt[ok][:cap_pairs]
            order = torch.sort(cnt, descending=True, stable=True).indices[:k]
            out += [(st, int(i), int(s)) for i, s in
                    zip((key[order] // q).tolist(), cnt[order].tolist())]
    return out
