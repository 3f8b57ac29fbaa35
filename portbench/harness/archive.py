"""What the archive cells share: the port's settings built from the
configuration file, the seeded partitions and their cycle, the program's
outputs as host rows, and the comparison with the reference.

A partition is ``stations`` × ``hours`` of waveform. Set-up makes
``partitions`` of them from the seed; the window cycles through them in a
seeded order that never repeats one back to back. The reference checks
every call the window made on one partition drawn from the seed.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from harness import runner, synth, trace


def port_config(cfg: dict):
    """The port's ``DetectConfig`` from the configuration file."""
    from repro_torch.core.align import AlignConfig
    from repro_torch.core.detect import DetectConfig
    from repro_torch.core.fingerprint import FingerprintConfig
    from repro_torch.core.lsh import LSHConfig
    return DetectConfig(fingerprint=FingerprintConfig(**cfg["fingerprint"]),
                        lsh=LSHConfig(**cfg["lsh"]),
                        align=AlignConfig(**cfg["align"]))


def plan(seed: int, traffic: dict) -> tuple[np.ndarray, int]:
    """The seed's cycle of partitions and its sampled partition."""
    n = traffic["partitions"]
    rng = np.random.default_rng([int(seed) & (2**63 - 1), 2**20])
    return rng.permutation(n), int(rng.integers(n))


def partition(seed: int, part: int, traffic: dict, device) -> np.ndarray:
    return synth.partition(seed, part, traffic["synth"], traffic["stations"],
                           traffic["hours"], device)


def setup(cfg: dict, traffic: dict, seed: int, device) -> dict:
    """The partitions, their cycle and the sampled one."""
    perm, sampled = plan(seed, traffic)
    parts = [partition(seed, p, traffic, device)
             for p in range(traffic["partitions"])]
    return {"cfg": cfg, "traffic": traffic, "device": device,
            "parts": parts, "cycle": perm, "sampled": sampled,
            "station_hours": traffic["stations"] * traffic["hours"],
            "attempted": 0, "failed": 0, "kept": []}


def sampled_call(state: dict, start: int) -> int:
    """The first of the window's calls from ``start`` on whose partition
    is the sampled one. The window runs at least to it, so the check has
    a call to compare; a traced run profiles the one from call 1 on (the
    reference's data then count its kernels' work)."""
    cyc = list(state["cycle"])
    i = start
    while cyc[i % len(cyc)] != state["sampled"]:
        i += 1
    return i


def ref_kept(ref: dict) -> dict:
    """A reference run's outputs in the layout of a kept call (the
    control's place in the comparison)."""
    pairs, events, dets = ref_sets(ref)
    return {"pairs": pairs, "events": events, "detections": dets}


def window(state: dict, seconds: float, trace_on: bool, call, to_rows
           ) -> dict:
    """Calls back to back, cycling the partitions, until one finishes past
    ``seconds`` (and the window holds a call on the sampled partition, and
    the traced one). ``call(state, part, keep)`` runs one partition and
    returns ({span: ms}, outputs, kept where ``keep``); ``to_rows`` turns
    kept outputs into host rows once the window has closed.
    ``archive_rate`` is every call's station-hours over the window's
    time; the span means leave out the traced call."""
    profile_at = sampled_call(state, 1) if trace_on else -1
    last = max(profile_at, sampled_call(state, 0))
    cycle = state["cycle"]
    calls, outs, prof = [], [], []
    t_start = time.perf_counter()
    i = 0
    while True:
        part = int(cycle[i % len(cycle)])
        keep = part == state["sampled"]
        t_call = time.perf_counter()
        if i == profile_at:
            with trace.profiled(prof):
                spans, out = call(state, part, keep)
        else:
            spans, out = call(state, part, keep)
        t_end = time.perf_counter()
        calls.append({"spans": spans, "wall_ms": (t_end - t_call) * 1e3,
                      "profiled": i == profile_at})
        if keep:
            outs.append(out)
        i += 1
        if t_end - t_start >= seconds and i > last:
            break
    state["attempted"] = i
    state["checked"] = {"call_ms": [round(c["wall_ms"], 1) for c in calls]}
    state["kept"] = [to_rows(o) for o in outs]
    steady = [c["spans"] for c in calls if not c["profiled"]]
    return {"e2e": {"archive_rate": i * state["station_hours"]
                    / (t_end - t_start)},
            "ctx": {"spans": {k: [c[k] for c in steady] for k in steady[0]},
                    "trace": prof[0].summary() if prof else None}}


def pair_rows(st: int, idx1, idx2, sim, valid) -> set:
    v = valid.cpu().numpy().astype(bool)
    cols = [x.cpu().numpy()[v].tolist() for x in (idx1, idx2, sim)]
    return {(st, *r) for r in zip(*cols)}


def event_rows(st: int, ev) -> set:
    v = ev.valid.cpu().numpy().astype(bool)
    cols = [x.cpu().numpy()[v].tolist()
            for x in (ev.dt, ev.onset, ev.extent, ev.size, ev.score)]
    return {(st, *r) for r in zip(*cols)}


def detection_rows(det: dict) -> set:
    v = det["valid"].cpu().numpy().astype(bool)
    cols = [det[k].cpu().numpy()[v].tolist()
            for k in ("dt", "onset", "onset_span", "n_stations", "score")]
    return set(zip(*cols))


def ref_sets(ref: dict) -> tuple[set, set, set]:
    pairs = {(st, *map(int, r)) for st, rows in enumerate(ref["pairs"])
             for r in rows}
    events = {(st, *map(int, r)) for st, rows in enumerate(ref["events"])
              for r in rows}
    return pairs, events, {tuple(map(int, r)) for r in ref["detections"]}


def gaps(kept: list[dict], ref: dict, counts: dict | None = None) -> dict:
    """The widest share of rows that a kept call and the reference do not
    share, of pairs, events and detections. ``counts`` receives the
    calls compared and the reference's rows."""
    counts = {} if counts is None else counts
    pairs, events, dets = ref_sets(ref)
    counts.update(calls_checked=len(kept), ref_pairs=len(pairs),
                  ref_events=len(events), ref_detections=len(dets))
    if not kept:
        return {"pairs_gap": 1.0, "events_gap": 1.0, "detections_gap": 1.0}
    out = {"pairs_gap": 0.0, "events_gap": 0.0, "detections_gap": 0.0}
    for k in kept:
        out["pairs_gap"] = max(out["pairs_gap"], runner.set_gap(k["pairs"],
                                                                pairs))
        out["events_gap"] = max(out["events_gap"],
                                runner.set_gap(k["events"], events))
        out["detections_gap"] = max(out["detections_gap"],
                                    runner.set_gap(k["detections"], dets))
    return out


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)

