#!/usr/bin/env python3
"""Write ``tests/golden/located_scenario.json``: the JAX reference's
located batch scenario, for the port to be held to.

    JAX_PLATFORMS=cpu PYTHONPATH=src python3 tools/located_golden.py

The scenario is ``benchmarks/bench_stream.py``'s ``located_scenario_point``
(the moveout-consistency A/B): a 6-station ``physical_geometry`` network,
600 s at 100 Hz, 3 sources × 4 events, with independent repeating-noise
bursts at every station whose (dt, onset) coincide across stations by
chance. Three ``repro.core.detect.detect_events`` runs on the CPU:

* ``golden`` — the clean trace (no bursts), location off: the true
  association set;
* ``pairwise`` — the noisy trace with ``locate_config()`` and
  ``reject_inconsistent=False`` (located, nothing gated);
* ``gated`` — the noisy trace with ``locate_config()`` (the 2-lag moveout
  gate drops inconsistent groups).

The file holds the configuration (the synthetic data's fields and every
fingerprint, LSH, alignment and location field that differs from its
default, so a reader rebuilds each config from its own package), every
associated group of each run (the rows whose ``n_stations`` is nonzero:
``dt``, ``onset``, ``n_stations``, ``valid`` and, located, ``x_km``,
``y_km``, ``magnitude`` (null for NaN), ``consistent``, ``n_used``), and
the summary counts the benchmark reports. It needs jax; readers of the
JSON (``chip_smoke.py``, ``tests/test_torch_locate.py``) do not.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent.parent
OUT = ROOT / "tests" / "golden" / "located_scenario.json"

SYNTH = dict(duration_s=600.0, n_stations=6, n_sources=3,
             events_per_source=4, event_snr=3.0, seed=3,
             physical_geometry=True, repeating_noise_period_s=45.0,
             repeating_noise_amp=4.0)
FINGERPRINT = dict(img_time=16, img_hop=4, top_k=200, mad_sample_rate=1.0)
LSH = dict(n_tables=100, n_funcs=4, n_matches=2, bucket_cap=8,
           occurrence_frac=0.05)
# the association's onset tolerance is 10 s of fingerprint lags
ONSET_TOL_S = 10.0
ALIGN = dict(channel_threshold=3, min_cluster_sim=4, min_cluster_size=1,
             min_stations=2)
# multiplicity the false-association count is taken at: two stations
# always admit a zero-residual origin, so the gate decides from three on
MIN_STATIONS_FALSE = 3
# origin error is measured over the true groups with at least this many
MIN_STATIONS_ERR = 4


def summarize(golden: dict, pairwise: dict, gated: dict, stats: dict,
              acfg, source_xy: np.ndarray, coarse_cell_km: float) -> dict:
    """The benchmark's summary counts from the three runs' detections
    (numpy dicts); ``stats`` are the gated run's."""
    gv = np.asarray(golden["valid"], bool)
    gold = np.stack([golden["dt"][gv], golden["onset"][gv]], axis=1)

    def classify(det):
        idx = np.nonzero(np.asarray(det["valid"], bool)
                         & (det["n_stations"] >= MIN_STATIONS_FALSE))[0]
        is_true = np.array([bool(np.any(
            (np.abs(gold[:, 0] - det["dt"][g]) <= acfg.dt_tol)
            & (np.abs(gold[:, 1] - det["onset"][g]) <= acfg.onset_tol)))
            for g in idx], bool)
        return idx, is_true

    bi, bt = classify(pairwise)
    gi, gt = classify(gated)
    errs = []
    for g, t in zip(gi, gt):
        if (t and gated["n_stations"][g] >= MIN_STATIONS_ERR
                and np.isfinite(gated["x_km"][g])):
            p = np.array([gated["x_km"][g], gated["y_km"][g]])
            errs.append(float(np.min(np.linalg.norm(source_xy - p,
                                                    axis=1))))
    med = float(np.median(errs)) if errs else None
    gvalid = np.asarray(gated["valid"], bool)
    return {
        "golden_groups": int(gv.sum()),
        "multi3_groups_pairwise": int(bi.size),
        "multi3_groups_gated": int(gi.size),
        "false_assoc_pairwise": int((~bt).sum()),
        "false_assoc_gated": int((~gt).sum()),
        "true_kept_pairwise": int(bt.sum()),
        "true_kept_gated": int(gt.sum()),
        "moveout_rejected": int(stats.get("moveout_rejected", 0)),
        "located_groups": int(np.isfinite(gated["x_km"][gvalid]).sum()),
        "median_origin_err_km": med,
        "median_origin_err_cells": (med / coarse_cell_km
                                    if med is not None else None),
    }


def group_rows(det: dict, located: bool) -> dict:
    """Column lists over the associated groups (``n_stations`` > 0)."""
    idx = np.nonzero(np.asarray(det["n_stations"]) > 0)[0]
    cols = {"dt": det["dt"][idx].tolist(),
            "onset": det["onset"][idx].tolist(),
            "n_stations": det["n_stations"][idx].tolist(),
            "valid": np.asarray(det["valid"], bool)[idx].tolist()}
    if located:
        for k in ("x_km", "y_km", "magnitude"):
            v = np.asarray(det[k], np.float64)[idx]
            cols[k] = [None if not np.isfinite(x) else float(x) for x in v]
        cols["consistent"] = np.asarray(det["consistent"],
                                        bool)[idx].tolist()
        cols["n_used"] = np.asarray(det["n_used"])[idx].tolist()
    return cols


def main() -> int:
    sys.path.insert(0, str(ROOT / "src"))
    from repro import core
    from repro.configs.fast_seismic import locate_config
    from repro.core.detect import DetectConfig, detect_events
    from repro.core.synth import SynthConfig, make_dataset

    fcfg = core.FingerprintConfig(**FINGERPRINT)
    lsh = dict(LSH, min_dt=fcfg.overlap_fingerprints)
    align = dict(ALIGN, onset_tol=int(ONSET_TOL_S * fcfg.fs
                                      / fcfg.lag_samples))
    lcfg, acfg = core.LSHConfig(**lsh), core.AlignConfig(**align)
    loc = locate_config()
    cfg = DetectConfig(fingerprint=fcfg, lsh=lcfg, align=acfg, locate=loc)
    n_st = SYNTH["n_stations"]
    clean = make_dataset(SynthConfig(**SYNTH))
    noisy = make_dataset(SynthConfig(
        **SYNTH, repeating_noise_stations=tuple(range(n_st))))

    def run(wf, locate):
        c = dataclasses.replace(cfg, locate=locate)
        det, _, _, stats = detect_events(
            wf, c, station_xy=noisy.station_xy if locate else None)
        return {k: np.asarray(v) for k, v in det.items()}, stats

    golden, _ = run(clean.waveforms, None)
    pairwise, _ = run(noisy.waveforms,
                      dataclasses.replace(loc, reject_inconsistent=False))
    gated, gstats = run(noisy.waveforms, loc)
    out = {
        "synth": SYNTH, "noisy_stations": list(range(n_st)),
        "fingerprint": FINGERPRINT, "lsh": lsh, "align": align,
        "locate": dataclasses.asdict(loc),
        "summary": summarize(golden, pairwise, gated, gstats, acfg,
                             noisy.source_xy, loc.coarse_cell_km),
        "runs": {"golden": group_rows(golden, False),
                 "pairwise": group_rows(pairwise, True),
                 "gated": group_rows(gated, True)},
    }
    OUT.write_text(json.dumps(out, indent=1) + "\n")
    print(json.dumps(out["summary"]))
    print(f"wrote {OUT.relative_to(ROOT)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
