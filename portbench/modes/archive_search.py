"""Archive reprocessing by the paper's whole-partition search: each call
takes one partition through, station by station,
``core.fingerprint.fingerprints_from_waveform`` (the §5.2 statistics on
the rows ``fingerprint.sample_rows`` draws, seeded ``stft_len +
station``), ``core.lsh.search`` and ``core.lsh.verify_jaccard``, then
``core.align.merge_channels`` and ``cluster_station`` a station and
``associate_network`` over all of them. The search's fixed-size output
(a slot a table, rank and fingerprint, nearly all empty) is compacted to
its valid pairs on the device before the alignment, as
``detect_events``' host triplets are: uncompacted, the 16 stations' slots make
``associate_network`` allocate past the card's 80 GB. ``archive_rate``
is as in the replay cell.

The harness's own spans: ``search`` around each ``lsh.search`` and
``host_tail`` around the ``core.align`` calls, each ending in a device
synchronisation, summed a call. A ``--trace 1`` run profiles one whole
call on the sampled partition and leaves it out of the span means.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from harness import archive, cost, reference


def _call(state: dict, part: int, keep: bool) -> tuple[dict, dict]:
    from repro_torch.core import align, fingerprint, lsh
    dcfg, dev = state["dcfg"], state["device"]
    fcfg, lcfg, acfg = dcfg.fingerprint, dcfg.lsh, dcfg.align
    wave = torch.as_tensor(state["parts"][part], device=dev)
    n_fp = state["n_fp"]
    spans = {"search_ms": 0.0, "host_tail_ms": 0.0}
    # the first kept call keeps its fingerprints, digested once the window
    # has closed; every kept call keeps its pairs, Jaccard and alignment
    out = {"packed": [] if keep and not state["kept_fp"] else None,
           "pairs": [], "jac": []}
    state["kept_fp"] |= keep
    events = []
    for st in range(wave.shape[0]):
        rows = fingerprint.sample_rows(n_fp, fcfg.mad_sample_rate,
                                       fcfg.stft_len + st)
        _, packed = fingerprint.fingerprints_from_waveform(wave[st], fcfg,
                                                           rows=rows)
        t0 = time.perf_counter()
        pairs, _ = lsh.search(packed, lcfg)
        archive.sync(dev)
        spans["search_ms"] += (time.perf_counter() - t0) * 1e3
        jac = lsh.verify_jaccard(packed, pairs)
        t0 = time.perf_counter()
        at = pairs.valid.nonzero(as_tuple=True)
        found = lsh.Pairs(pairs.idx1[at], pairs.idx2[at], pairs.sim[at],
                          pairs.valid[at])
        merged = align.merge_channels(
            [(found.dt, found.idx1, found.sim, found.valid)],
            acfg.channel_threshold)
        events.append(align.cluster_station(merged, acfg))
        archive.sync(dev)
        spans["host_tail_ms"] += (time.perf_counter() - t0) * 1e3
        if keep:
            if out["packed"] is not None:
                out["packed"].append(packed)
            out["pairs"].append((found.idx1, found.idx2, found.sim))
            out["jac"].append(jac[at])
    t0 = time.perf_counter()
    det = align.associate_network(events, acfg, len(events))
    archive.sync(dev)
    spans["host_tail_ms"] += (time.perf_counter() - t0) * 1e3
    out.update(events=events, det=det)
    return spans, out if keep else None


def digest(packed: torch.Tensor) -> torch.Tensor:
    """(N, W) packed words (uint32 patterns in int32 or int64) → (N,)
    int64 digests, equal for equal rows."""
    w = torch.Generator().manual_seed(0)
    mult = torch.randint(1, 2**62, (packed.shape[1],), generator=w) | 1
    return ((packed.to(torch.int64) & 0xFFFFFFFF)
            * mult.to(packed.device)).sum(1)


def setup(cfg: dict, traffic: dict, seed: int, device) -> dict:
    state = archive.setup(cfg, traffic, seed, device)
    state.update(dcfg=archive.port_config(cfg), kept_fp=False,
                 n_fp=reference.n_fingerprints(cfg["fingerprint"],
                                               state["parts"][0].shape[1]))
    _call(state, int(state["cycle"][-1]), False)
    archive.sync(device)
    return state


def _kept(out: dict) -> dict:
    """A call's outputs as host rows: (station, idx1, idx2, tables) pairs
    with their Jaccard, events, detections, and the fingerprint digests
    where the call kept its fingerprints."""
    pairs, jac = set(), {}
    for st, (p, j) in enumerate(zip(out["pairs"], out["jac"])):
        i1, i2, sim = torch.stack(p).cpu().numpy().tolist()
        pairs |= {(st, a, b, c) for a, b, c in zip(i1, i2, sim)}
        jac.update({(st, a, b): x for a, b, x in
                    zip(i1, i2, j.cpu().numpy().tolist())})
    return {"digest": (None if out["packed"] is None else
                       [digest(p).cpu().numpy() for p in out["packed"]]),
            "pairs": pairs, "jac": jac,
            "events": set().union(*(archive.event_rows(st, e)
                                    for st, e in enumerate(out["events"]))),
            "detections": archive.detection_rows(out["det"])}


def window(state: dict, seconds: float, trace_on: bool) -> dict:
    return archive.window(state, seconds, trace_on, _call, _kept)


def check(state: dict) -> dict:
    cfg = state["cfg"]
    ref = reference.search(state["parts"][state["sampled"]], cfg,
                           state["device"])
    state["bound_ms"] = _bounds(cfg, ref)
    return compare(state["kept"], ref, state.setdefault("checked", {}))


def ref_kept(ref: dict) -> dict:
    """A reference run's outputs as a kept call (the control's place)."""
    jac = {(st, int(r[0]), int(r[1])): float(j)
           for st, (rows, js) in enumerate(zip(ref["pairs"], ref["jac"]))
           for r, j in zip(rows, js)}
    return {**archive.ref_kept(ref), "jac": jac,
            "digest": [digest(p).cpu().numpy() for p in ref["packed"]]}


def compare(kept: list[dict], ref: dict, counts: dict | None = None
            ) -> dict:
    """``archive.gaps``, the share of fingerprint rows that differ (in the
    calls that kept them) and the widest Jaccard gap of a pair both
    found."""
    out = archive.gaps(kept, ref, counts)
    want = ref_kept(ref)
    n_rows = sum(len(d) for d in want["digest"])
    digested = [k["digest"] for k in kept if k["digest"] is not None]
    out["fp_rows_gap"] = 1.0 if not digested else 0.0
    out["jac_gap"] = 0.0
    for dig in digested:
        diff = sum(int((a != b).sum()) for a, b in zip(dig, want["digest"]))
        out["fp_rows_gap"] = max(out["fp_rows_gap"], diff / max(1, n_rows))
    for k in kept:
        common = want["jac"].keys() & k["jac"].keys()
        out["jac_gap"] = max([out["jac_gap"]] + [
            abs(k["jac"][key] - want["jac"][key]) for key in common])
    return out


def _bounds(cfg: dict, ref: dict) -> dict:
    """Least time of one call's kernel launches: a ``minmax_hash`` and a
    ``jaccard_popcount`` launch a station, the latter over the search's
    pair slots, valid where the reference's filtered pairs are."""
    fp, lsh = cfg["fingerprint"], cfg["lsh"]
    words = 2 * fp["img_freq"] * fp["img_time"] // 32
    h = lsh["n_tables"] * lsh["n_funcs"] // 2
    mm = jac = 0.0
    for packed, rows in zip(ref["packed"], ref["pairs"]):
        n = packed.shape[0]
        mm += cost.bound_ms(cost.minmax_hash(n, words, h, n * fp["top_k"]))
        slots = lsh["n_tables"] * lsh["bucket_cap"] * n
        jac += cost.bound_ms(cost.jaccard_popcount(
            1, slots, words, len(rows), len(np.unique(rows[:, :2]))))
    return {"minmax_hash": mm, "jaccard_popcount": jac}


def control(cfg: dict, traffic: dict, seed: int, device) -> dict:
    """The TF32 reference in the program's place on the seed's sampled
    partition, held to the float32 reference."""
    _, sampled = archive.plan(seed, traffic)
    wave = archive.partition(seed, sampled, traffic, device)
    ref = reference.search(wave, cfg, device)
    return compare([ref_kept(reference.search(wave, cfg, device,
                                              tf32=True))], ref)
