"""A live network's similarity-query service, open loop.

Set-up pushes ``pool_hours`` of the seed's waveforms for ``stations``
stations through ``repro_torch.stream.StreamingDetector`` in
``push_s`` chunks and flushes it (the steady state the stream's sliding
window is sized for), then serves from
``launch.serve_detect.ServeDetectEngine.from_detector``. Requests are
``window_s`` windows, each starting on a pool fingerprint with seeded
noise added, drawn from ``distinct_windows`` made in set-up. In the
window ``rate_per_s`` × ``seconds`` requests fall due at seeded uniform
times (a Poisson process given its count); the loop submits each once
due and ticks while any is pending. Set-up ends by collecting its
garbage and freezing what it leaves (``gc.freeze``). A request's latency
runs from its due time to its completion; a shed request counts as
failed.
``query_p95_ms`` is the 95th percentile of all served requests'.

A ``--trace 1`` run starts and stops the profiler once before the window
(its first start stalls for seconds, which would back the queue up past
its bound), then profiles the ticks from ``profile_s`` before the close
of arrivals to the last one, and exports the trace after them. The
per-layer readings of the ticks and of admission (``serve.tick_ms``,
``serve.queue_wait_p95_ms``, ``serve.live_share``) cover the ticks before
the profiler started and the requests finished by then.
"""
from __future__ import annotations

import collections
import gc
import time

import numpy as np
import torch

from harness import archive, cost, reference, synth, trace


def stream_config(cfg: dict):
    from repro_torch.stream.index import StreamIndexConfig
    from repro_torch.stream.ingest import StreamConfig
    return StreamConfig(**{**cfg["stream"],
                           "index": StreamIndexConfig(
                               **cfg["stream"]["index"])})


def make_windows(wave: np.ndarray, cfg: dict, traffic: dict,
                 seed: int) -> list[np.ndarray]:
    """The seed's ``distinct_windows`` query windows: station i % S, each
    starting on a random pool fingerprint, with ``window_noise`` × N(0, 1)
    added."""
    fp = cfg["fingerprint"]
    lag = fp["img_hop"] * fp["stft_hop"]
    win = int(traffic["window_s"] * traffic["synth"]["fs"])
    rng = np.random.default_rng([int(seed) & (2**63 - 1), 3])
    n_win = traffic["distinct_windows"]
    first = rng.integers(0, (wave.shape[1] - win) // lag, n_win)
    noise = traffic["window_noise"] * rng.standard_normal(
        (n_win, win)).astype(np.float32)
    return [wave[i % wave.shape[0], f * lag:f * lag + win] + noise[i]
            for i, f in enumerate(first)]


def setup(cfg: dict, traffic: dict, seed: int, device) -> dict:
    from repro_torch.launch.serve_detect import (QueryRequest,
                                                 ServeDetectEngine)
    from repro_torch.stream import StreamingDetector
    s, fs = traffic["stations"], traffic["synth"]["fs"]
    wave = synth.partition(seed, 0, traffic["synth"], s,
                           traffic["pool_hours"], device)
    det = StreamingDetector(archive.port_config(cfg), stream_config(cfg),
                            n_stations=s, device=device)
    push = int(traffic["push_s"] * fs)
    for a in range(0, wave.shape[1], push):
        det.push(wave[:, a:a + push])
    det.flush()
    srv = cfg["serve"]
    engine = ServeDetectEngine.from_detector(
        det, n_slots=srv["n_slots"], top_k=srv["top_k"],
        max_queue=srv["max_queue"])
    del det
    windows = make_windows(wave, cfg, traffic, seed)
    n_win = len(windows)
    for k in range(2 * srv["n_slots"]):
        engine.submit(QueryRequest(rid=-1 - k, window=windows[k % n_win]))
    engine.drain()
    archive.sync(device)
    # set-up's objects (the imports, the pool's build, the windows) live for
    # the whole run: collect once and take them out of the collector's
    # reach, so that no generation-2 pass over them stalls a tick in the
    # window (one took 171-174 ms early in a window on the H100's host)
    gc.collect()
    gc.freeze()
    return {"cfg": cfg, "traffic": traffic, "device": device, "seed": seed,
            "wave": wave, "engine": engine, "windows": windows,
            "valid_fp": reference.n_fingerprints(cfg["fingerprint"],
                                                 len(windows[0])),
            "attempted": 0, "failed": 0}


def window(state: dict, seconds: float, trace_on: bool) -> dict:
    from repro_torch.launch.serve_detect import QueryRequest
    eng, traffic = state["engine"], state["traffic"]
    n = int(round(traffic["rate_per_s"] * seconds))
    rng = np.random.default_rng([int(state["seed"]) & (2**63 - 1), 4])
    due = np.sort(rng.uniform(0.0, seconds, n))
    which = rng.integers(0, len(state["windows"]), n)
    reqs = [QueryRequest(rid=j, window=state["windows"][which[j]])
            for j in range(n)]
    prof_from = seconds - traffic["profile_s"] if trace_on else float("inf")
    stretch = trace.Stretch() if trace_on else None
    if trace_on:
        warm = trace.Stretch()
        warm.start()
        torch.ones(1, device=state["device"]).add_(1)
        warm.stop()
    ticks = []
    dispatch0 = eng.dispatches
    clock = time.perf_counter
    t0 = clock()
    t_prof, disp_prof = float("inf"), None
    i = 0
    while True:
        now = clock() - t0
        while i < n and due[i] <= now:
            eng.submit(reqs[i])
            i += 1
        if disp_prof is None and now >= prof_from:
            t_prof, disp_prof = clock(), eng.dispatches
            stretch.start()
        if eng.pending():
            ts = clock()
            if eng.tick() and disp_prof is None:
                ticks.append((clock() - ts) * 1e3)
        elif i < n:
            time.sleep(min(max(due[i] - now, 0.0), 1e-3))
        else:
            break
    traced_ticks = 0
    if disp_prof is not None:
        stretch.stop()
        traced_ticks = eng.dispatches - disp_prof
    else:
        disp_prof = eng.dispatches
    served = [r for r in reqs if r.outcome == "served"]
    lat = np.array([r.t_done - (t0 + due[r.rid]) for r in served])
    # the admission readings: requests finished before the profiler started
    before = [r for r in served if r.t_done < t_prof]
    wait = np.array([r.queue_wait_s for r in before])
    slots = (disp_prof - dispatch0) * eng.n_slots * eng.scfg.block_fingerprints
    state.update(attempted=n, failed=n - len(served),
                 answered=collections.defaultdict(list))
    for r in served:
        state["answered"][int(which[r.rid])].append(
            collections.Counter(r.matches))
    state["checked"] = {"requests": n, "served": len(served),
                        "ticks": eng.dispatches - dispatch0}
    fp, lsh = state["cfg"]["fingerprint"], state["cfg"]["lsh"]
    rows = eng.n_stations * eng.n_slots * eng.scfg.block_fingerprints
    words = 2 * fp["img_freq"] * fp["img_time"] // 32
    tick_bound = cost.bound_ms(cost.minmax_hash(
        rows, words, lsh["n_tables"] * lsh["n_funcs"] // 2,
        rows * fp["top_k"]))
    return {"e2e": {"query_p95_ms": (float(np.percentile(lat, 95)) * 1e3
                                     if len(lat) else float("inf"))},
            "ctx": {"spans": {"tick_ms": ticks},
                    "queue_wait_p95_ms": (float(np.percentile(wait, 95))
                                          * 1e3 if len(wait) else None),
                    "live_share": (100.0 * len(before) * state["valid_fp"]
                                   / slots if slots else None),
                    "bound_ms": {"minmax_hash": tick_bound * traced_ticks},
                    "trace": stretch.summary() if traced_ticks else None}}


def check(state: dict) -> dict:
    """Every served request whose window is among ``checked_windows``
    windows drawn from the seed (of those answered) against the
    reference's match list over the reference's pool: the rows in one
    multiset and not the other, over the reference's rows."""
    cfg, dev = state["cfg"], state["device"]
    del state["engine"]
    if state["device"].type == "cuda":
        torch.cuda.empty_cache()
    answered = sorted(state["answered"])
    if not answered:
        return {"matches_gap": 1.0}
    rng = np.random.default_rng([int(state["seed"]) & (2**63 - 1), 5])
    pick = rng.choice(answered, min(len(answered),
                                    state["traffic"]["checked_windows"]),
                      replace=False)
    pool = reference.stream_pool(state["wave"], cfg, dev)
    gap, compared, total = _gap(
        {w: state["answered"][w] for w in pick},
        {w: reference.serve_matches(state["windows"][w], pool, cfg, dev)
         for w in pick})
    state["checked"].update(requests_checked=compared, ref_matches=total)
    return {"matches_gap": gap}


def _gap(answered: dict, want: dict) -> tuple[float, int, int]:
    """Rows in one match multiset and not the other, summed over the
    answers, over the reference's rows summed alike."""
    diff = total = compared = 0
    for w, answers in answered.items():
        ref = collections.Counter(want[w])
        for got in answers:
            diff += sum(((got - ref) + (ref - got)).values())
            total += sum(ref.values())
            compared += 1
    return diff / max(1, total), compared, total


def control(cfg: dict, traffic: dict, seed: int, device) -> dict:
    """The TF32 reference's answers to ``checked_windows`` of the seed's
    windows held to the float32 reference's."""
    wave = synth.partition(seed, 0, traffic["synth"], traffic["stations"],
                           traffic["pool_hours"], device)
    windows = make_windows(wave, cfg, traffic, seed)
    pick = range(traffic["checked_windows"])
    pool = reference.stream_pool(wave, cfg, device)
    ctl = reference.stream_pool(wave, cfg, device, tf32=True)
    got = {w: [collections.Counter(reference.serve_matches(
        windows[w], ctl, cfg, device, tf32=True))] for w in pick}
    want = {w: reference.serve_matches(windows[w], pool, cfg, device)
            for w in pick}
    return {"matches_gap": _gap(got, want)[0]}
