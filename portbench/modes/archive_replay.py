"""Archive reprocessing through the block core: each call is
``repro_torch.core.detect.detect_events`` on one partition (all stations
pooled, a fresh index a call) with the configuration's ``replay``
settings, back to back. ``archive_rate`` is the station-hours of all the
calls over all the window's time; the window ends with the first call
that finishes past ``seconds``.

Per call the program's ``SpanTracer`` (passed as ``tracer=``) gives the
``fused_step`` and ``host_tail`` totals. A ``--trace 1`` run profiles one
whole call on the sampled partition and leaves it out of the span means.
"""
from __future__ import annotations

import numpy as np

from harness import archive, cost, reference


def _stream_config(cfg: dict, n_fp: int):
    from repro_torch.stream.index import StreamIndexConfig
    from repro_torch.stream.ingest import StreamConfig
    rp = cfg["replay"]
    return StreamConfig(
        block_fingerprints=rp["block_fingerprints"],
        index=StreamIndexConfig(n_buckets=rp["n_buckets"],
                                bucket_cap=rp["bucket_cap"], pk_slots=n_fp),
        max_pairs_per_block=rp["max_pairs_per_block"],
        verify_jaccard=rp["verify_jaccard"])


def _call(state: dict, part: int, keep: bool) -> tuple[dict, tuple]:
    from repro_torch.core.detect import detect_events
    from repro_torch.obsv.spans import SpanTracer
    tr = SpanTracer()
    det, events, _, stats = detect_events(
        state["parts"][part], state["dcfg"], scfg=state["scfg"],
        keep_pairs=keep, tracer=tr, device=state["device"])
    spans = {"fused_step_ms": tr.total_s("fused_step") * 1e3,
             "host_tail_ms": tr.total_s("host_tail") * 1e3}
    return spans, (det, events, stats["_station_pairs"]) if keep else None


def _rows(out: tuple) -> dict:
    det, events, pairs = out
    return {"pairs": set().union(*(archive.pair_rows(st, p.idx1, p.idx2,
                                                     p.sim, p.valid)
                                   for st, p in enumerate(pairs))),
            "events": set().union(*(archive.event_rows(st, e)
                                    for st, e in enumerate(events))),
            "detections": archive.detection_rows(det)}


def setup(cfg: dict, traffic: dict, seed: int, device) -> dict:
    state = archive.setup(cfg, traffic, seed, device)
    n_fp = reference.n_fingerprints(cfg["fingerprint"],
                                    state["parts"][0].shape[1])
    state.update(dcfg=archive.port_config(cfg),
                 scfg=_stream_config(cfg, n_fp), n_fp=n_fp)
    _call(state, int(state["cycle"][-1]), False)
    archive.sync(device)
    return state


def window(state: dict, seconds: float, trace_on: bool) -> dict:
    return archive.window(state, seconds, trace_on, _call, _rows)


def check(state: dict) -> dict:
    cfg = state["cfg"]
    ref = reference.replay(state["parts"][state["sampled"]], cfg,
                           state["device"])
    state["bound_ms"] = _bounds(cfg, ref, state)
    return archive.gaps(state["kept"], ref, state.setdefault("checked", {}))


def _bounds(cfg: dict, ref: dict, state: dict) -> dict:
    """Least time of the kernels' launches over one call on the sampled
    partition: a ``minmax_sig_buckets`` and a ``jaccard_popcount`` launch
    a block, the latter on the pairs the reference's index emitted."""
    fp, lsh, rp = cfg["fingerprint"], cfg["lsh"], cfg["replay"]
    s, b = len(ref["block_pairs"]), rp["block_fingerprints"]
    words = 2 * fp["img_freq"] * fp["img_time"] // 32
    h = lsh["n_tables"] * lsh["n_funcs"] // 2
    sig = jac = 0.0
    for k in range(len(ref["block_pairs"][0])):
        n = s * b
        sig += cost.bound_ms(cost.minmax_sig_buckets(
            n, words, h, lsh["n_tables"], n * fp["top_k"]))
        rows = [r[k] for r in (ref["block_pairs"][st] for st in range(s))]
        live = sum(len(r) for r in rows)
        distinct = sum(len(np.unique(r[:, :2])) for r in rows)
        jac += cost.bound_ms(cost.jaccard_popcount(
            s, rp["max_pairs_per_block"], words, live, distinct))
    return {"minmax_sig_buckets": sig, "jaccard_popcount": jac}


def control(cfg: dict, traffic: dict, seed: int, device) -> dict:
    """The TF32 reference in the program's place on the seed's sampled
    partition, held to the float32 reference."""
    _, sampled = archive.plan(seed, traffic)
    wave = archive.partition(seed, sampled, traffic, device)
    ref = reference.replay(wave, cfg, device)
    return archive.gaps([archive.ref_kept(reference.replay(
        wave, cfg, device, tf32=True))], ref)
