"""The port's streaming telemetry (``repro_torch.stream.telemetry``) on
the CPU: the properties of the reference's ``tests/test_telemetry.py``
streaming section, on the port, with the reference's own run beside it.

* telemetry off is bit-identical on a dirty (gap + glitch) trace: the same
  pair set and quality counters, the step counters' telemetry tail at
  zero while the guard fields keep counting; both runs equal the
  reference's;
* the device's step counters reconcile with the host's accounting on a
  dirty pooled run, and equal the reference's drop breakdown;
* a detector snapshot carries the registry, the uptime and the watchdog
  state, and the restored detector keeps counting on top;
* ``metrics_snapshot`` has the reference's keys at every level (schema
  ``stream-metrics/v1``; the spans add the port's ``dup_hash``), and the
  Prometheus exposition the reference's metric names and label sets,
  every line parseable, written atomically;
* the serving hooks and ``serve_view`` count as the reference's do, and
  ``locate_view`` reads the reference's all-zero view; ``record_locate``
  feeds it as the reference's does (registry and Prometheus text equal).
"""
import _torch_threads  # noqa: F401  (one torch thread a process)
import dataclasses
import pathlib
import re
import sys

import numpy as np
import pytest

from repro.configs import fast_seismic as jfast
from repro.core import synth as jsynth
from repro.stream import engine as jengine
from repro.stream import telemetry as jtele
from repro_torch.configs import fast_seismic as tfast
from repro_torch.core import synth as tsynth
from repro_torch.stream import QC_FIELDS, METRICS_SCHEMA, metrics_snapshot
from repro_torch.stream import engine as tengine
from repro_torch.stream import telemetry as ttele

ROOT = str(pathlib.Path(__file__).parent.parent)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)             # the benchmarks package

from benchmarks.common import frozen_smoke_stats as _frozen  # noqa: E402

PKGS = {"ref": (jengine, jfast, jsynth), "port": (tengine, tfast, tsynth)}
# a Prometheus sample line: name, optional {labels}, a number
_LINE = re.compile(r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^}]*\})? '
                   r'(-?[0-9.e+-]+|\+Inf|NaN)$')


def _raw_pairs(st):
    tri = (np.concatenate(st.triplets, axis=0) if st.triplets
           else np.zeros((0, 3), np.int64))
    return set(zip(tri[:, 0].tolist(), tri[:, 1].tolist()))


def _stream(pkg, scfg, wf, med_mad, n_stations=1, n_chunks=10):
    engine, fast, _ = PKGS[pkg]
    kw = {} if pkg == "ref" else {"device": "cpu"}
    det = engine.StreamingDetector(fast.smoke_config(), scfg,
                                   n_stations=n_stations, med_mad=med_mad,
                                   **kw)
    wf = np.atleast_2d(np.asarray(wf, np.float32))
    for chunk in np.array_split(wf, n_chunks, axis=1):
        det.push(chunk if n_stations > 1 else chunk[0])
    det.flush()
    return [_raw_pairs(st) for st in det.stations], det


def _scenario(pkg, n_stations=1, glitch_stations=(0,)):
    """The reference telemetry tests' dirty scenario: 2 gaps and one
    150 s glitch train."""
    synth = PKGS[pkg][2]
    base = synth.SynthConfig(duration_s=600.0, n_stations=n_stations,
                             n_sources=2, events_per_source=5,
                             event_snr=3.0, seed=3)
    return synth.make_scenario_dataset(synth.ScenarioConfig(
        base=base, n_gaps=2, gap_dur_s=(2.0, 5.0),
        glitch_stations=glitch_stations, glitch_trains=1,
        glitch_train_dur_s=150.0, seed=1))


@pytest.fixture(scope="module")
def dirty():
    scen = _scenario("port")
    return scen, _frozen(jfast.smoke_config(), scen.clean.waveforms[0])


def _scfg(pkg, **replace):
    scfg = PKGS[pkg][1].stream_dirty_smoke_config()
    return dataclasses.replace(scfg, **replace) if replace else scfg


def test_telemetry_off_bit_parity_on_dirty_trace(dirty):
    scen, med_mad = dirty
    assert _scfg("port").telemetry
    (on,), det_on = _stream("port", _scfg("port"), scen.waveforms[0],
                            med_mad)
    (off,), det_off = _stream("port", _scfg("port", telemetry=False),
                              scen.waveforms[0], med_mad)
    (ref,), det_ref = _stream("ref", _scfg("ref", telemetry=False),
                              scen.waveforms[0], med_mad)
    assert on == off == ref
    assert det_on.quality_summary() == det_off.quality_summary() \
        == det_ref.quality_summary()
    d_on = det_on.telemetry.drop_breakdown()
    assert d_on["pairs_emitted"] > 0
    assert d_on["masked_fingerprints"] > 0
    assert d_on["raw_collisions"] >= d_on["pairs_emitted"]
    d_off = det_off.telemetry.drop_breakdown()
    assert d_off == det_ref.telemetry.drop_breakdown()
    for name in ("pairs_emitted", "masked_fingerprints", "raw_collisions",
                 "quarantined_collisions"):
        assert d_off[name] == 0
    for name in ("duplicate_fingerprints", "saturated_lookups",
                 "limited_pairs"):
        assert d_off[name] == d_on[name]


@pytest.fixture(scope="module")
def pooled(dirty):
    """The dirty scenario on 2 stations (glitch on station 1), pooled, in
    both packages."""
    _, med_mad = dirty
    out = {}
    for pkg in PKGS:
        scen = _scenario(pkg, n_stations=2, glitch_stations=(1,))
        out[pkg] = _stream(pkg, _scfg(pkg), scen.waveforms, med_mad,
                           n_stations=2)
    return out


def test_device_host_counter_reconciliation_pooled(pooled):
    sets, det = pooled["port"]
    assert det.pooled
    reg = det.telemetry.registry
    drops = det.telemetry.drop_breakdown()
    for i, st in enumerate(det.stations):
        dev = reg.counter("step_pairs_emitted_total", station=str(i)).value
        assert dev == st.stats.pairs
    assert drops["pairs_emitted"] == sum(st.stats.pairs
                                         for st in det.stations)
    q = det.quality_summary()
    for name in ("saturated_lookups", "limited_pairs"):
        assert drops[name] == q[name]
    assert drops["duplicate_fingerprints"] <= q["duplicate_fingerprints"]
    assert drops["pairs_emitted"] > 0
    assert drops["masked_fingerprints"] > 0
    rates = det.telemetry.drop_rates()
    denom = drops["pairs_emitted"] + drops["limited_pairs"]
    assert rates["limited_pairs"] == \
        pytest.approx(drops["limited_pairs"] / denom, abs=1e-6)
    assert 0.0 <= rates["masked_fingerprints"] <= 1.0
    ref_sets, ref_det = pooled["ref"]
    assert sets == ref_sets
    assert drops == ref_det.telemetry.drop_breakdown()
    assert rates == ref_det.telemetry.drop_rates()
    assert q == ref_det.quality_summary()


@pytest.mark.parametrize("src", ["port", "ref"])
def test_detector_snapshot_restores_telemetry(dirty, tmp_path, src):
    """A restored port detector (from its own snapshot or the
    reference's) resumes the counters, the uptime and the watchdog EMA,
    and keeps counting on top."""
    scen, med_mad = dirty
    chunks = np.array_split(np.atleast_2d(scen.waveforms[0]), 10, axis=1)
    engine, fast, _ = PKGS[src]
    kw = {} if src == "ref" else {"device": "cpu"}
    det = engine.StreamingDetector(fast.smoke_config(), _scfg(src),
                                   n_stations=1, med_mad=med_mad, **kw)
    for c in chunks[:6]:
        det.push(c[0])
    drops_mid = det.telemetry.drop_breakdown()
    wd_mid = (det.telemetry.watchdog.ema, det.telemetry.watchdog.n)
    det.snapshot(str(tmp_path))
    det2, _ = tengine.StreamingDetector.restore(
        str(tmp_path), tfast.smoke_config(), _scfg("port"), device="cpu")
    assert det2.telemetry.drop_breakdown() == drops_mid
    assert (det2.telemetry.watchdog.ema, det2.telemetry.watchdog.n) == wd_mid
    assert det2.telemetry.uptime_s() > 0
    for c in chunks[6:]:
        det2.push(c[0])
    det2.flush()
    drops_end = det2.telemetry.drop_breakdown()
    assert drops_end["pairs_emitted"] >= drops_mid["pairs_emitted"]
    assert drops_end["pairs_emitted"] == det2.stations[0].stats.pairs


def _keys(tree, path=()) -> set:
    """Every key path of a nested dict, list entries keyed by index."""
    out = set()
    items = (tree.items() if isinstance(tree, dict)
             else enumerate(tree) if isinstance(tree, list) else ())
    for k, v in items:
        out.add(path + (k,))
        out |= _keys(v, path + (k,))
    return out


def _prom_series(text: str) -> set:
    """(metric name, labels without ``le``) of every sample line."""
    out = set()
    for ln in text.strip().split("\n"):
        if ln.startswith("# TYPE "):
            continue
        name, _, _ = ln.partition(" ")
        base, _, labels = name.partition("{")
        pairs = tuple(sorted(p for p in labels.rstrip("}").split(",")
                             if p and not p.startswith("le=")))
        out.add((base, pairs))
    return out


def test_metrics_snapshot_schema_and_prometheus_surface(pooled, tmp_path):
    _, det = pooled["port"]
    _, ref = pooled["ref"]
    m = det.metrics_snapshot()
    m2 = metrics_snapshot(det)
    wall_keys = ("uptime_s", "rtf")
    assert {k: v for k, v in m.items() if k not in wall_keys} == \
        {k: v for k, v in m2.items() if k not in wall_keys}
    assert m["schema"] == METRICS_SCHEMA == jtele.METRICS_SCHEMA
    # the port's spans add ``dup_hash`` (the duplicate guard's hashing,
    # timed inside ``ingest``); every other key is the reference's
    assert set(m) == set(ref.metrics_snapshot())
    assert {k for k in _keys(m) if k[:2] != ("spans", "dup_hash")} == \
        _keys(ref.metrics_snapshot())
    assert set(m["drops"]) == set(QC_FIELDS)
    assert m["quality"] == det.quality_summary()
    assert m["serve"]["served"] == 0 and m["serve"]["shed"] == 0
    assert m["locate"]["passes"] == 0 and m["locate"]["located"] == 0
    assert m["histograms"]["fused_step_wall_seconds"]["count"] == \
        m["watchdog"]["steps"] > 0
    for name in ("ingest", "fused_step", "host_tail"):
        assert m["spans"][name]["count"] > 0
    assert m["stream"]["pairs"] == m["drops"]["pairs_emitted"]
    text = det.telemetry.prometheus(det)
    for ln in text.strip().split("\n"):
        assert ln.startswith("# TYPE ") or _LINE.match(ln), ln
    assert _prom_series(text) == _prom_series(ref.telemetry.prometheus(ref))
    assert [ln for ln in text.split("\n") if ln.startswith("# TYPE")] == \
        [ln for ln in ref.telemetry.prometheus(ref).split("\n")
         if ln.startswith("# TYPE")]
    assert 'repro_step_pairs_emitted_total{station="0"} ' in text
    assert 'repro_quality_suppressed_fingerprints_total{station="1"}' in text
    path = tmp_path / "metrics.prom"
    det.telemetry.write_prometheus(str(path), det)
    assert path.read_text().startswith("# TYPE")
    assert [p.name for p in tmp_path.iterdir()] == ["metrics.prom"]


def test_serving_hooks_count_as_the_references():
    """The same sequence of serving events on both hubs gives the same
    ``serve_view`` (latency buckets included); ``locate_view`` is the
    reference's all-zero view, as no location tier runs."""
    views = []
    for tele in (ttele, jtele):
        hub = tele.StreamTelemetry(2)
        for ok in (True, True, False, True):
            hub.record_serve_admission(ok)
        hub.record_serve_tick(0, 3)
        hub.record_serve_tick(2, 1)
        hub.record_serve_done(0.001, 0.004, 0.005)
        hub.record_serve_done(0.002, 0.010, 0.012)
        hub.record_serve_refresh()
        views.append((hub.serve_view(), hub.locate_view(),
                      hub.registry.snapshot()))
    assert views[0] == views[1]
    serve = views[0][0]
    assert (serve["accepted"], serve["shed"], serve["served"]) == (3, 1, 2)
    assert (serve["ticks"], serve["dispatches"], serve["slot_ticks"]) == \
        (2, 1, 2)
    locate = views[0][1]
    assert (locate["passes"], locate["groups"], locate["located"],
            locate["moveout_rejected"], locate["stack_wall"]["count"]) == \
        (0, 0, 0, 0, 0)


def test_locate_hook_counts_as_the_references():
    views = []
    for tele in (ttele, jtele):
        hub = tele.StreamTelemetry(4)
        hub.record_locate(groups=5, located=3, rejected=2, wall=0.004)
        hub.record_locate(groups=1, located=1, rejected=0, wall=0.0005)
        views.append((hub.locate_view(), hub.registry.snapshot(),
                      hub.registry.render()))
    assert views[0] == views[1]
    locate = views[0][0]
    assert (locate["passes"], locate["groups"], locate["located"],
            locate["moveout_rejected"], locate["stack_wall"]["count"]) == \
        (2, 6, 4, 2, 2)


def test_heartbeat_carries_the_serve_view(pooled):
    _, det = pooled["port"]
    _, ref = pooled["ref"]
    beat = det.telemetry.heartbeat(det)
    assert sorted(beat) == sorted(ref.telemetry.heartbeat(ref))
    assert beat["serve"] == det.telemetry.serve_view()
    assert det.telemetry.heartbeat_line(det).startswith("HEARTBEAT {")


def test_raw_walls_fill_as_the_references(dirty):
    """``capture_raw_walls``: None until captured; once captured, the
    fused-step and host-tail hooks append a wall each as the reference's
    do (the same counts on the same stream, one a histogram sample)."""
    scen, med_mad = dirty
    counts = {}
    for pkg in PKGS:
        engine, fast, _ = PKGS[pkg]
        kw = {} if pkg == "ref" else {"device": "cpu"}
        det = engine.StreamingDetector(fast.smoke_config(), _scfg(pkg),
                                       med_mad=med_mad, **kw)
        assert det.telemetry.raw_walls is None
        walls = det.telemetry.capture_raw_walls()
        assert det.telemetry.capture_raw_walls() is walls
        for chunk in np.array_split(scen.waveforms[0], 10):
            det.push(chunk)
        det.flush()
        assert all(w >= 0.0 for v in walls.values() for w in v)
        counts[pkg] = {k: len(v) for k, v in walls.items()}
    assert counts["port"] == counts["ref"]
    assert counts["port"]["fused_step"] > 0
    assert counts["port"]["host_tail"] > 0
    tele = ttele.StreamTelemetry()
    tele.record_fused_wall("0", 0.5)
    tele.record_host_tail(0, 0.25)
    assert tele.raw_walls is None
