"""The port's streaming driver (``repro_torch.stream.StreamingDetector``)
as a whole, on the CPU, against the JAX package's.

Both packages take the same numpy chunks (made from a seed) and the same
frozen statistics where the test gives them:

* the golden's four runs on ``tests/golden/stream_pairs.json``'s trace:
  two-pass statistics reproduce ``stream_two_pass_pairs`` exactly; the
  self-computed statistics give the reference's own self-stats pair set;
  the deferred freeze and compact + verify (no overflow) reproduce the
  two-pass set;
* fused equals unfused, pooled equals sequential, the dirty-data config
  on clean data equals the smoke config;
* bounded mode (sliding window + rolling filter, 3 stations): alerts,
  finalize detections and per-station stats equal the reference's;
  dirty deliveries (NaN runs, late and repeated chunks, a mid-stream
  flush) too, solo and pooled;
* the stream equals the batch driver ``detect_events`` on one
  ``StreamConfig`` (the two drivers share the detection core);
* ``ingest_chunks`` returns the reference's counts;
* the location tier (``located_smoke_config``, ``station_xy``) on the
  reference's located stream test's trace: alert rows exact but for the
  location columns (±1 milli-km), finalize's located detections (integer
  columns exact, floats within rtol 1e-5 / atol 1e-4) and the locate
  view equal the reference's; the amplitude timelines equal bin for bin;
* elastic membership: the reference's add / remove sequence gives its
  per-station stats and raises its ``ValueError`` s, and on the bounded
  3-station trace a station joining and leaving mid-stream leaves the
  reference's result, with the other stations as an uninterrupted run's;
* the detector needs CUDA unless the CPU is asked for.
"""
import _torch_threads  # noqa: F401  (one torch thread a process)
import dataclasses
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import fast_seismic as jfast
from repro.core import fingerprint as jfp
from repro.core import synth as jsynth
from repro.stream import engine as jengine
from repro_torch.configs import fast_seismic as tfast
from repro_torch.core import detect as tdetect
from repro_torch.stream import engine as tengine

ROOT = pathlib.Path(__file__).resolve().parents[1]
GOLD = json.loads((ROOT / "tests" / "golden" / "stream_pairs.json")
                  .read_text())
PKGS = {"ref": (jengine, jfast), "port": (tengine, tfast)}
# wall-clock entries of the ingest summaries: equal only by accident
WALL_KEYS = ("wall_s", "chunk_ms_p50", "chunk_ms_p95", "chunks_per_s",
             "samples_per_s")


def _detector(pkg, scfg_name, n_stations=1, med_mad=None, **replace):
    engine, fast = PKGS[pkg]
    scfg = getattr(fast, scfg_name)()
    if replace:
        scfg = dataclasses.replace(scfg, **replace)
    kw = {} if pkg == "ref" else {"device": "cpu"}
    return engine.StreamingDetector(fast.smoke_config(), scfg,
                                    n_stations=n_stations, med_mad=med_mad,
                                    **kw)


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _pairs(p) -> set:
    v = _np(p.valid)
    return set(zip(_np(p.idx1)[v].tolist(), _np(p.idx2)[v].tolist(),
                   _np(p.sim)[v].tolist()))


def _rows(ev) -> list:
    v = _np(ev.valid)
    return sorted(zip(*(_np(getattr(ev, k))[v].tolist()
                        for k in ("dt", "onset", "extent", "size", "score"))))


def _finish(det) -> dict:
    """Everything a run leaves: finalize's detections / events / stats,
    each station's post-filter triplets, alerts and the drop counters."""
    detections, events, stats = det.finalize()
    for s in stats.get("ingest", []):
        for k in WALL_KEYS:
            s.pop(k)
    return {
        "detections": None if detections is None else
        {k: _np(v).tolist() for k, v in detections.items()},
        "events": [_rows(e) for e in events],
        "stats": stats,
        "pairs": [_pairs(st.finalize()[1]) for st in det.stations],
        "alerts": [a.tolist() for a in det.alerts],
        "drops": det.telemetry.drop_breakdown(),
    }


def _push_all(det, wf, schedule):
    for start, stop, offset in schedule:
        det.push(wf[..., start:stop], offset)


def _both(scfg_name, wf, schedule, n_stations=1, med_mad=None, **replace):
    out = {}
    for pkg in PKGS:
        det = _detector(pkg, scfg_name, n_stations, med_mad, **replace)
        _push_all(det, wf, schedule)
        out[pkg] = _finish(det)
    return out["port"], out["ref"]


def _even(n, n_chunks):
    cuts = np.linspace(0, n, n_chunks + 1).astype(int)
    return [(a, b, None) for a, b in zip(cuts[:-1], cuts[1:])]


@pytest.fixture(scope="module")
def golden():
    cfg = jfast.smoke_config()
    ds = jsynth.make_dataset(jsynth.SynthConfig(**GOLD["synth"]))
    wf = ds.waveforms[0]
    med, mad = jfp.mad_stats(jfp.coeffs_from_waveform(jnp.asarray(wf),
                                                      cfg.fingerprint),
                             1.0, jax.random.PRNGKey(0))
    return wf, (np.asarray(med), np.asarray(mad))


def _golden_pairs(golden, scfg_name, two_pass, pkg="port", **replace):
    wf, med_mad = golden
    det = _detector(pkg, scfg_name, med_mad=med_mad if two_pass else None,
                    **replace)
    _push_all(det, wf, _even(wf.size, GOLD["n_chunks"]))
    _, pairs, _ = det.stations[0].finalize()
    return {p[:2] for p in _pairs(pairs)}, det


GOLDEN_RUNS = {
    # the reference golden test's _stream_pairs default config
    "two_pass": ("stream_smoke_config", True, dict(reservoir_rows=2048)),
    "deferred": ("stream_deferred_smoke_config", False, {}),
    "compact_verify": ("stream_compact_smoke_config", True, {}),
}


@pytest.mark.parametrize("run", GOLDEN_RUNS)
def test_golden_stream_pairs_exact(golden, run):
    name, two_pass, replace = GOLDEN_RUNS[run]
    got, det = _golden_pairs(golden, name, two_pass, **replace)
    want = {tuple(p) for p in GOLD["stream_two_pass_pairs"]}
    assert got == want, (sorted(got - want), sorted(want - got))
    off = {tuple(p) for p in GOLD["offline_pairs"]}
    assert off <= got
    drops = det.telemetry.drop_breakdown()
    assert drops["overflow_pairs"] == 0
    assert drops["pairs_emitted"] > 0


def test_golden_self_stats_equal_the_reference(golden):
    """Self-computed reservoir statistics (warm-up 2 blocks): the port's
    reservoir draws the reference's rows, so its pair set is the
    reference's — stronger than the golden's recall floor."""
    runs = [_golden_pairs(golden, "stream_smoke_config", False, pkg,
                          reservoir_rows=2048)[0] for pkg in ("port", "ref")]
    assert runs[0] == runs[1]
    off = {tuple(p) for p in GOLD["offline_pairs"]}
    assert len(off & runs[0]) / len(off) >= GOLD["self_stats_recall"] - 0.03


@pytest.mark.parametrize("given", [True, False], ids=["given", "self"])
def test_fused_equals_unfused(golden, given):
    wf, med_mad = golden
    got = {}
    for fused in (True, False):
        det = _detector("port", "stream_smoke_config",
                        med_mad=med_mad if given else None, fused=fused,
                        pooled=fused)
        _push_all(det, wf, _even(wf.size, 10))
        got[fused] = _finish(det)
    assert got[True]["pairs"] == got[False]["pairs"]
    assert got[True]["events"] == got[False]["events"]
    assert len(got[True]["pairs"][0]) > 0


@pytest.mark.parametrize("given", [True, False], ids=["given", "self"])
def test_dirty_config_on_clean_data_equals_smoke(golden, given):
    wf, med_mad = golden
    runs = []
    for name in ("stream_smoke_config", "stream_dirty_smoke_config"):
        det = _detector("port", name, med_mad=med_mad if given else None)
        _push_all(det, wf, _even(wf.size, 10))
        runs.append(_finish(det))
    assert runs[0]["pairs"] == runs[1]["pairs"]
    assert len(runs[0]["pairs"][0]) > 0
    assert all(v == 0 for v in runs[1]["stats"]["quality"].values())


@pytest.fixture(scope="module")
def bounded():
    """The reference tests' ``_bounded_setup`` trace: 3 stations, 600 s."""
    ds = jsynth.make_dataset(jsynth.SynthConfig(
        duration_s=600.0, n_stations=3, n_sources=2, events_per_source=5,
        event_snr=3.0, seed=11))
    return ds.waveforms


def _pushes(n, step=6000):
    return [(a, min(a + step, n), None) for a in range(0, n, step)]


def test_bounded_mode_matches_reference(bounded):
    """Sliding window + rolling filter, pooled over 3 stations: alert rows
    (with the LOC_NONE / MAG_NONE columns), finalize detections, events
    and per-station stats equal the reference's."""
    port, ref = _both("stream_bounded_smoke_config", bounded,
                      _pushes(bounded.shape[1]), n_stations=3)
    assert port == ref
    assert sum(len(a) for a in port["alerts"]) >= 1
    assert port["stats"]["detections"] >= 1
    alert = np.concatenate([np.asarray(a) for a in port["alerts"]])
    assert (alert[:, 5:7] == tengine.LOC_NONE).all()
    assert (alert[:, 7] == tengine.MAG_NONE).all()


def test_pooled_equals_sequential(bounded):
    runs = []
    for pooled in (True, False):
        det = _detector("port", "stream_bounded_smoke_config", 3,
                        pooled=pooled)
        assert det.pooled == pooled
        _push_all(det, bounded, _pushes(bounded.shape[1]))
        runs.append(_finish(det))
    for key in ("detections", "events", "pairs", "alerts", "drops"):
        assert runs[0][key] == runs[1][key], key
    for i in range(3):
        for k in ("fingerprints", "pairs", "events", "windows"):
            assert (runs[0]["stats"][f"station{i}_{k}"]
                    == runs[1]["stats"][f"station{i}_{k}"]), (i, k)


def _dirty(wf: np.ndarray, seed: int):
    """NaN runs on one station (per-station gap masks in a pool), late
    and repeated chunks at offsets, on the reference's bounded trace."""
    rng = np.random.default_rng(seed)
    wf = wf.copy()
    wf[-1, 21_000:22_500] = np.nan
    wf[0, 40_000:40_300] = np.nan
    sched, pos, n = [], 0, wf.shape[1]
    while pos < n:
        step = int(rng.integers(1_500, 7_000))
        sched.append((pos, min(pos + step, n), pos))
        if rng.random() < 0.25 and pos > 3_000:
            back = pos - int(rng.integers(100, 2_500))
            sched.append((back, back + int(rng.integers(50, 2_000)), back))
        pos += step
    return wf, sched


@pytest.mark.parametrize("n_stations", [1, 3])
def test_dirty_deliveries_match_reference(bounded, n_stations):
    """Gap-masked blocks (the block route, halo still primed), late and
    repeated chunks, the reorder horizon and the duplicate guard: pairs,
    events, quality counters and drops equal the reference's, solo and
    pooled."""
    wf, sched = _dirty(bounded[:n_stations], seed=n_stations)
    port, ref = _both("stream_dirty_smoke_config", wf, sched, n_stations)
    assert port == ref
    q = port["stats"]["quality"]
    assert q["missing_samples"] > 0 and q["suppressed_fingerprints"] > 0
    assert q["duplicate_samples"] + q["late_dropped_samples"] > 0


@pytest.mark.parametrize("pooled", [True, False])
def test_mid_stream_flush_matches_reference(bounded, pooled):
    """A flush mid-stream runs a zero-padded tail, which leaves the halo
    dirty: the next block must re-seed, and the pair sets stay the
    reference's."""
    out = {}
    for pkg in PKGS:
        det = _detector(pkg, "stream_smoke_config", 2, pooled=pooled)
        for k, (a, b, _) in enumerate(_pushes(bounded.shape[1], 7_000)):
            det.push(bounded[:2, a:b])
            if k in (3, 5):
                det.flush()
        out[pkg] = _finish(det)
    assert out["port"] == out["ref"]
    assert any(out["port"]["pairs"])


def test_stream_equals_the_batch_driver(bounded):
    """One detection core, two drivers: the streaming detector in parity
    mode, given the statistics ``detect_events`` computes per station,
    gives ``detect_events``' post-filter triplets and events on the same
    ``StreamConfig`` (the stream takes the advance route)."""
    cfg = tfast.smoke_config()
    scfg = tfast.stream_compact_smoke_config()
    wave = torch.as_tensor(bounded)
    meds, mads = tdetect.station_stats(wave, cfg.fingerprint)
    _, b_events, _, b_stats = tdetect.detect_events(
        bounded, cfg, scfg=scfg, keep_pairs=True, device="cpu")
    det = tengine.StreamingDetector(
        cfg, scfg, n_stations=3, device="cpu",
        med_mad=(torch.stack(meds), torch.stack(mads)))
    _push_all(det, bounded, _pushes(bounded.shape[1]))
    got = _finish(det)
    assert got["pairs"] == [_pairs(p) for p in b_stats["_station_pairs"]]
    assert got["events"] == [_rows(e) for e in b_events]
    assert got["stats"]["detections"] == b_stats["detections"]
    assert sum(len(p) for p in got["pairs"]) > 0


def test_ingest_chunks_counts_match_reference(bounded):
    out = {}
    for pkg in PKGS:
        det = _detector(pkg, "stream_bounded_smoke_config", 3)
        beats = []
        res = PKGS[pkg][0].ingest_chunks(det, bounded, n_chunks=12,
                                         skip=5_000, warmup_chunks=2,
                                         metrics_every=4,
                                         heartbeat=beats.append)
        beat = json.loads(beats[-1].split(" ", 1)[1])
        out[pkg] = ({k: res[k] for k in ("chunks", "timed_chunks",
                                         "samples")},
                    len(beats), {k: beat[k] for k in ("chunks", "pairs",
                                                      "drop_rates",
                                                      "quality")},
                    sorted(beat))
    assert out["port"][:3] == out["ref"][:3]
    assert out["port"][3] == out["ref"][3]


def test_station_stream_and_solo_detector_agree(golden):
    """A bare ``StationStream`` pushed directly equals the one-station
    detector built around it."""
    wf, med_mad = golden
    cfg, scfg = tfast.smoke_config(), tfast.stream_smoke_config()
    st = tengine.StationStream(cfg, scfg, med_mad=med_mad, device="cpu")
    det = tengine.StreamingDetector(cfg, scfg, med_mad=med_mad,
                                    device="cpu")
    for a, b, _ in _even(wf.size, 7):
        st.push(wf[a:b])
        det.push(wf[a:b])
    assert _pairs(st.finalize()[1]) == _pairs(det.stations[0].finalize()[1])
    assert tengine.events_to_rows(st.finalize()[0]).shape[1] == 5


def test_rolling_filter_and_row_helpers_match_reference(rng):
    """``RollingPairFilter`` over the same triplet stream, the event-row
    round trip and ``merge_boundary_rows``."""
    cfg_t, cfg_j = tfast.smoke_config(), jfast.smoke_config()
    filt_t = tengine.RollingPairFilter(cfg_t, 64, 128, device="cpu")
    filt_j = jengine.RollingPairFilter(cfg_j, 64, 128)
    for base in range(0, 640, 64):
        lo = rng.integers(max(0, base - 120), base + 64, 40)
        dt = rng.choice([12, 13, 40, 41, 90], 40)
        tri = np.stack([lo, lo + dt, rng.integers(2, 9, 40)], 1)
        tri = tri[tri[:, 1] < base + 64]
        for f in (filt_t, filt_j):
            f.add(tri)
            f.advance(base + 64)
    filt_t.close_all(640)
    filt_j.close_all(640)
    np.testing.assert_array_equal(filt_t.all_rows(), filt_j.all_rows())
    assert filt_t.all_rows().shape[0] > 0
    for k in ("windows_closed", "pairs_seen", "pairs_kept", "peak_rows"):
        assert getattr(filt_t, k) == getattr(filt_j, k), k
    rows = filt_t.all_rows()
    ev = tengine.events_from_rows(rows, device="cpu")
    np.testing.assert_array_equal(tengine.events_to_rows(ev), rows)
    np.testing.assert_array_equal(
        tengine.merge_boundary_rows(rows, cfg_t.align),
        jengine.merge_boundary_rows(rows, cfg_j.align))


@pytest.fixture(scope="module")
def located_trace():
    """``tests/test_stream.py::test_streaming_located_alerts_end_to_end``'s
    trace: 4 stations, 900 s, physical geometry, seed 11."""
    return jsynth.make_dataset(jsynth.SynthConfig(
        duration_s=900.0, n_stations=4, n_sources=2, events_per_source=6,
        event_snr=3.0, seed=11, physical_geometry=True))


def _located_run(pkg, ds):
    engine, fast = PKGS[pkg]
    kw = {} if pkg == "ref" else {"device": "cpu"}
    det = engine.StreamingDetector(
        fast.located_smoke_config(), fast.stream_bounded_smoke_config(),
        n_stations=4, station_xy=ds.station_xy, **kw)
    assert det.locating
    for start in range(0, ds.waveforms.shape[1], 6000):
        det.push(ds.waveforms[:, start:start + 6000])
    amps = [dict(d) for d in det._amp]
    alerts = np.concatenate(det.alerts, axis=0)
    detections, _, stats = det.finalize()
    return {"alerts": alerts, "amps": amps, "stats": stats,
            "detections": {k: _np(v) for k, v in detections.items()},
            "view": det.telemetry.locate_view()}


def test_located_stream_matches_reference(located_trace):
    got = _located_run("port", located_trace)
    want = _located_run("ref", located_trace)
    a, b = got["alerts"], want["alerts"]
    assert a.shape == b.shape and a.shape[0] >= 1
    np.testing.assert_array_equal(np.delete(a, [5, 6], axis=1),
                                  np.delete(b, [5, 6], axis=1))
    assert np.abs(a[:, 5:7] - b[:, 5:7]).max() <= 1
    assert (a[:, 5] != tengine.LOC_NONE).any()
    assert (a[:, 7] != tengine.MAG_NONE).any()
    assert got["amps"] == want["amps"]
    gd, wd = got["detections"], want["detections"]
    assert set(gd) == set(wd)
    for k in wd:
        w = np.asarray(wd[k])
        assert gd[k].dtype == w.dtype and gd[k].shape == w.shape, k
        if w.dtype.kind == "f":
            np.testing.assert_array_equal(np.isnan(gd[k]), np.isnan(w), k)
            ok = ~np.isnan(w)
            np.testing.assert_allclose(gd[k][ok], w[ok], rtol=1e-5,
                                       atol=1e-4, err_msg=k)
        else:
            np.testing.assert_array_equal(gd[k], w, err_msg=k)
    for k in ("moveout_rejected", "detections", "alerts"):
        assert got["stats"][k] == want["stats"][k], k
    for k in ("passes", "groups", "located", "moveout_rejected"):
        assert got["view"][k] == want["view"][k], k
    assert got["view"]["stack_wall"]["count"] == got["view"]["passes"] >= 2


def _elastic_sequence(pkg):
    """``tests/test_sharded_pool.py::test_elastic_add_remove_station``:
    returns each ``ValueError`` message and the per-station stats."""
    engine, fast = PKGS[pkg]
    cfg, scfg = fast.latency_config(), fast.stream_latency_smoke_config()
    kw = {} if pkg == "ref" else {"device": "cpu"}
    rng = np.random.default_rng(3)
    chunk = scfg.block_fingerprints * cfg.fingerprint.lag_samples
    det = engine.StreamingDetector(cfg, scfg, n_stations=2, **kw)
    errors = []
    with pytest.raises(ValueError, match="live pool") as e:
        det.add_station()                     # stats not frozen yet
    errors.append(str(e.value))
    for _ in range(scfg.stats_warmup_blocks + 4):
        det.push(rng.standard_normal((2, chunk)).astype(np.float32))
    assert det.pstate is not None
    assert det.add_station() == 2 and len(det.stations) == 3
    joined = det.stations[2].ring
    assert joined.start == det.stations[0].ring.start
    assert joined.quality["missing_samples"] > 0
    for _ in range(4):
        det.push(rng.standard_normal((3, chunk)).astype(np.float32))
    assert all(st.stats.chunks > 0 for st in det.stations)
    det.remove_station(1)
    assert [st._pool_idx for st in det.stations] == [0, 1]
    for _ in range(2):
        det.push(rng.standard_normal((2, chunk)).astype(np.float32))
    with pytest.raises(ValueError, match="last station") as e:
        det.remove_station(0), det.remove_station(0)
    errors.append(str(e.value))
    with pytest.raises(IndexError):
        det.remove_station(5)
    _, _, stats = det.finalize()
    for s in stats["ingest"]:
        for k in WALL_KEYS:
            s.pop(k)
    return errors, stats, joined.quality


def test_elastic_add_remove_matches_reference():
    got, want = _elastic_sequence("port"), _elastic_sequence("ref")
    assert got == want


@pytest.mark.parametrize("case", ["not_pooled", "add_locating",
                                  "remove_locating", "remove_not_live"])
def test_elastic_refusals_match_reference(case):
    """Every ``ValueError`` of the reference's ``add_station`` /
    ``remove_station``, the two that refuse while locating included."""
    msgs = []
    for pkg in ("port", "ref"):
        engine, fast = PKGS[pkg]
        kw = {} if pkg == "ref" else {"device": "cpu"}
        scfg = fast.stream_smoke_config()
        cfg = fast.smoke_config()
        if case == "not_pooled":
            scfg = dataclasses.replace(scfg, pooled=False)
        if case.endswith("locating"):
            cfg = fast.located_smoke_config()
            kw["station_xy"] = np.zeros((2, 2), np.float32)
        det = engine.StreamingDetector(cfg, scfg, n_stations=2, **kw)
        call = (det.add_station if case in ("not_pooled", "add_locating")
                else lambda: det.remove_station(0))
        with pytest.raises(ValueError) as e:
            call()
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_elastic_stream_matches_reference():
    """The bounded 3-station trace with a fourth station joining halfway
    (the pool is live from push 5) and leaving at push 8, in both packages: the
    finished runs are equal, and stations 0–2 end as in an uninterrupted
    run of the same three stations."""
    ds = jsynth.make_dataset(jsynth.SynthConfig(
        duration_s=600.0, n_stations=4, n_sources=2, events_per_source=5,
        event_snr=3.0, seed=11))
    wf = ds.waveforms
    pushes = _even(wf.shape[1], 10)
    out = {}
    for pkg in PKGS:
        det = _detector(pkg, "stream_bounded_smoke_config", 3)
        for i, (a, b, _) in enumerate(pushes):
            if i == 5:
                det.add_station()
            if i == 8:
                det.remove_station(3)
            det.push(wf[:len(det.stations), a:b])
        out[pkg] = _finish(det)
    assert out["port"] == out["ref"]
    solo = _detector("port", "stream_bounded_smoke_config", 3)
    _push_all(solo, wf[:3], pushes)
    base = _finish(solo)
    assert out["port"]["events"] == base["events"]
    for i in range(3):
        for k in ("fingerprints", "pairs", "windows", "events"):
            assert out["port"]["stats"][f"station{i}_{k}"] == \
                base["stats"][f"station{i}_{k}"], (i, k)
    assert sum(map(len, base["events"])) > 0


def test_detector_needs_cuda_unless_the_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tengine.StreamingDetector(tfast.smoke_config(),
                                  tfast.stream_smoke_config())
    det = _detector("port", "stream_smoke_config")
    assert det.stations[0].state.sig.device.type == "cpu"


def test_per_station_statistics_must_match_the_station_count(golden):
    _, (med, mad) = golden
    with pytest.raises(ValueError, match="3 rows"):
        _detector("port", "stream_smoke_config", 3,
                  med_mad=(np.stack([med] * 2), np.stack([mad] * 2)))


def test_clean_stream_takes_the_advance_route(bounded, monkeypatch):
    """After the seeding block, every clean block goes through
    ``pool_step_advance`` with only its (S, advance) new samples; the
    first block after the freeze and the zero-padded flush tail go
    through ``pool_step_block``."""
    from repro_torch.stream import fused as tfused
    calls = {"advance": [], "block": []}
    for name in ("pool_step_advance", "pool_step_block"):
        inner = getattr(tfused, name)

        def spy(state, x, *a, _inner=inner, _key=name[10:], **kw):
            calls[_key].append(tuple(x.shape))
            return _inner(state, x, *a, **kw)
        monkeypatch.setattr(tfused, name, spy)
    det = _detector("port", "stream_bounded_smoke_config", 3)
    _push_all(det, bounded, _pushes(bounded.shape[1]))
    det.finalize()
    fcfg = tfast.smoke_config().fingerprint
    adv = det.stations[0].ring.advance
    assert len(calls["block"]) == 2
    assert calls["block"][0] == (3, fcfg.block_samples(64))
    assert calls["advance"] and set(calls["advance"]) == {(3, adv)}
    assert (len(calls["advance"]) + 2
            == det.stations[0].stats.blocks)
