"""The port's scenario generator (``repro_torch.core.synth``'s dirty-data
half) and the fault-injection properties of the reference's
``tests/test_scenarios.py``, on the CPU.

* ``make_scenario_dataset`` gives the reference's arrays bit for bit
  (dirty waveforms with their NaNs, the clean trace, the missing and
  corrupt masks, the injection logs, ``clean_fp_ids``) on every
  configuration of ``tests/test_scenarios.py`` and the scenario
  benchmark's two pinned streams;
* the port's ``StreamingDetector`` holds that file's properties: a gap
  scenario's clean portion equals the clean golden, a pooled station
  dropout leaves the healthy station untouched, the duplicate guard's
  budget, a re-delivered chunk changes nothing, the glitch train is cut
  ≥ 10× with the clean portion exact, and a dirty stream's snapshot
  round trip equals the uninterrupted run (each run equal to the
  reference's where the reference run is cheap).

The ``bench_*`` schema tests stay the reference's.
"""
import _torch_threads  # noqa: F401  (one torch thread a process)
import dataclasses
import pathlib
import sys

import numpy as np
import pytest

from repro.configs import fast_seismic as jfast
from repro.core import synth as jsynth
from repro.stream import engine as jengine
from repro_torch.configs import fast_seismic as tfast
from repro_torch.core import synth as tsynth
from repro_torch.stream import engine as tengine

ROOT = str(pathlib.Path(__file__).parent.parent)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)             # the benchmarks package

from benchmarks.bench_stream import (additive_bench_scenario,  # noqa: E402
                                     bench_scenario)
from benchmarks.common import frozen_smoke_stats as _frozen  # noqa: E402


def _base(**over):
    kw = dict(duration_s=600.0, n_stations=1, n_sources=2,
              events_per_source=5, event_snr=3.0, seed=3)
    kw.update(over)
    return kw


# the ScenarioConfig fields (base as SynthConfig kwargs) of every
# scenario tests/test_scenarios.py and tests/test_telemetry.py stream
SCENARIOS = {
    "gaps": dict(base=_base(), n_gaps=4, gap_dur_s=(2.0, 8.0), seed=7),
    "dropout": dict(base=_base(n_stations=2), dropout_stations=(1,),
                    dropout_dur_s=90.0, seed=5),
    "dup_blocks": dict(base=_base(), n_dup_blocks=2, dup_block_dur_s=20.0,
                       dup_spacing_s=60.0, seed=2),
    "clean_300s": dict(base=_base(duration_s=300.0)),
    "clean": dict(base=_base()),
    "clock_drift": dict(base=_base(n_stations=3, seed=11),
                        clock_drift_stations=(2,), clock_drift_ppm=200.0,
                        seed=4),
    "snapshot_mix": dict(base=_base(), n_gaps=3, n_dup_blocks=1,
                         dup_block_dur_s=20.0, dup_spacing_s=60.0,
                         glitch_stations=(0,), glitch_trains=1,
                         glitch_train_dur_s=100.0, seed=6),
    "telemetry_dirty": dict(base=_base(n_stations=2), n_gaps=2,
                            gap_dur_s=(2.0, 5.0), glitch_stations=(1,),
                            glitch_trains=1, glitch_train_dur_s=150.0,
                            seed=1),
    "jittered_additive": dict(base=_base(), glitch_stations=(0,),
                              glitch_trains=2, glitch_replace=False,
                              glitch_jitter=0.3, seed=9),
}
BENCH = {"bench_scenario": bench_scenario,
         "additive_bench_scenario": additive_bench_scenario}


def _as_kwargs(cfg) -> dict:
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    kw["base"] = dataclasses.asdict(cfg.base)
    return kw


def _make(synth, kw):
    kw = dict(kw)
    base = synth.SynthConfig(**kw.pop("base"))
    return synth.make_scenario_dataset(synth.ScenarioConfig(base=base,
                                                            **kw))


@pytest.mark.parametrize("name", list(SCENARIOS) + list(BENCH))
def test_scenario_arrays_equal_the_reference(name):
    kw = (SCENARIOS[name] if name in SCENARIOS
          else _as_kwargs(BENCH[name](600.0)))
    port, ref = _make(tsynth, kw), _make(jsynth, kw)
    for field in ("waveforms", "missing", "corrupt"):
        a, b = getattr(port, field), getattr(ref, field)
        assert a.dtype == b.dtype and a.shape == b.shape, field
        np.testing.assert_array_equal(a, b, err_msg=field)
    assert port.clean.waveforms.tobytes() == ref.clean.waveforms.tobytes()
    np.testing.assert_array_equal(port.clean.event_times,
                                  ref.clean.event_times)
    assert port.injections == ref.injections
    for st in range(port.waveforms.shape[0]):
        np.testing.assert_array_equal(port.clean_fp_ids(st, 1000, 200),
                                      ref.clean_fp_ids(st, 1000, 200))
    if name != "clean" and name != "clean_300s":
        assert port.missing.any() or port.corrupt.any()


def test_colored_noise_equals_the_reference():
    got = tsynth._colored_noise(np.random.default_rng(4), 3000, 1.5)
    want = jsynth._colored_noise(np.random.default_rng(4), 3000, 1.5)
    assert got.tobytes() == want.tobytes()
    assert tsynth._glitch_template(100.0).tobytes() == \
        jsynth._glitch_template(100.0).tobytes()


# ---------------------------------------------------------------------------
# the fault-injection properties, on the port
# ---------------------------------------------------------------------------


def _raw_pairs(st):
    tri = (np.concatenate(st.triplets, axis=0) if st.triplets
           else np.zeros((0, 3), np.int64))
    return set(zip(tri[:, 0].tolist(), tri[:, 1].tolist()))


def _run(scfg, wf, med_mad, n_stations=1, n_chunks=10, pkg="port"):
    engine, fast = ((tengine, tfast) if pkg == "port" else (jengine, jfast))
    kw = {"device": "cpu"} if pkg == "port" else {}
    det = engine.StreamingDetector(fast.smoke_config(), scfg,
                                   n_stations=n_stations, med_mad=med_mad,
                                   **kw)
    wf = np.atleast_2d(np.asarray(wf, np.float32))
    for chunk in np.array_split(wf, n_chunks, axis=1):
        det.push(chunk if n_stations > 1 else chunk[0])
    det.flush()
    return [_raw_pairs(st) for st in det.stations], det


def _clean_ids(scen, station):
    fcfg = tfast.smoke_config().fingerprint
    return set(scen.clean_fp_ids(station, fcfg.window_samples,
                                 fcfg.lag_samples).tolist())


def _restrict(pairs, ids):
    return {p for p in pairs if p[0] in ids and p[1] in ids}


def _stats(scen):
    return _frozen(jfast.smoke_config(), scen.clean.waveforms[0])


def test_gap_scenario_no_spurious_and_exact_clean_recall():
    scfg = tfast.stream_dirty_smoke_config()
    scen = _make(tsynth, SCENARIOS["gaps"])
    med_mad = _stats(scen)
    (clean,), _ = _run(scfg, scen.clean.waveforms[0], med_mad)
    (dirty,), det = _run(scfg, scen.waveforms[0], med_mad)
    (ref,), ref_det = _run(jfast.stream_dirty_smoke_config(),
                           scen.waveforms[0], med_mad, pkg="ref")
    assert dirty == ref
    q = det.quality_summary()
    assert q == ref_det.quality_summary()
    assert q["missing_samples"] == int(scen.missing.sum())
    assert q["suppressed_fingerprints"] > 0
    ok = _clean_ids(scen, 0)
    n_fp = tfast.smoke_config().fingerprint.n_fingerprints(
        scen.waveforms.shape[1])
    bad = set(range(n_fp)) - ok
    assert not any(a in bad or b in bad for a, b in dirty)
    assert dirty == _restrict(clean, ok)
    assert len(dirty) > 0


def test_station_dropout_pooled_isolation():
    scfg = tfast.stream_dirty_smoke_config()
    scen = _make(tsynth, SCENARIOS["dropout"])
    med_mad = _stats(scen)
    clean_sets, _ = _run(scfg, scen.clean.waveforms, med_mad, n_stations=2)
    dirty_sets, det = _run(scfg, scen.waveforms, med_mad, n_stations=2)
    assert det.pooled
    assert dirty_sets[0] == clean_sets[0]
    ok1 = _clean_ids(scen, 1)
    n_fp = tfast.smoke_config().fingerprint.n_fingerprints(
        scen.waveforms.shape[1])
    bad1 = set(range(n_fp)) - ok1
    assert not any(a in bad1 or b in bad1 for a, b in dirty_sets[1])
    assert dirty_sets[1] == _restrict(clean_sets[1], ok1)
    _, _, stats = det.finalize()
    assert stats["quality"]["suppressed_fingerprints"] > 0


def test_duplicate_block_guard_budget():
    scen = _make(tsynth, SCENARIOS["dup_blocks"])
    med_mad = _stats(scen)
    (clean,), _ = _run(tfast.stream_dirty_smoke_config(),
                       scen.clean.waveforms[0], med_mad)
    (unguarded,), _ = _run(tfast.stream_smoke_config(), scen.waveforms[0],
                           med_mad)
    (guarded,), det = _run(tfast.stream_dirty_smoke_config(),
                           scen.waveforms[0], med_mad)
    assert len(unguarded - clean) > len(guarded - clean)
    assert len(guarded - clean) <= 6
    assert det.quality_summary()["duplicate_fingerprints"] > 0
    ok = _clean_ids(scen, 0)
    assert _restrict(guarded, ok) == _restrict(clean, ok)


def test_duplicate_chunk_redelivery_is_noop():
    scfg = tfast.stream_dirty_smoke_config()
    scen = _make(tsynth, SCENARIOS["clean"])
    wf = scen.clean.waveforms[0]
    med_mad = _stats(scen)
    chunks = np.array_split(wf, 10)
    offs = np.cumsum([0] + [c.size for c in chunks])[:-1]
    dets = [tengine.StreamingDetector(tfast.smoke_config(), scfg,
                                      med_mad=med_mad, device="cpu")
            for _ in range(2)]
    for off, c in zip(offs, chunks):
        dets[0].push(c, int(off))
        dets[1].push(c, int(off))
        dets[1].push(c, int(off))       # every chunk delivered twice
    for d in dets:
        d.flush()
    assert _raw_pairs(dets[0].stations[0]) == _raw_pairs(dets[1].stations[0])
    q = dets[1].quality_summary()
    assert q["duplicate_samples"] + q["late_dropped_samples"] == int(wf.size)


def test_glitch_train_scenario_10x_reduction():
    scen = _make(tsynth, _as_kwargs(bench_scenario(600.0)))
    med_mad = _stats(scen)
    (clean,), _ = _run(tfast.stream_dirty_smoke_config(),
                       scen.clean.waveforms[0], med_mad)
    (unguarded,), _ = _run(tfast.stream_smoke_config(), scen.waveforms[0],
                           med_mad)
    (guarded,), det = _run(tfast.stream_dirty_smoke_config(),
                           scen.waveforms[0], med_mad)
    spurious_u = len(unguarded - clean)
    spurious_g = len(guarded - clean)
    assert spurious_u >= 10
    assert spurious_u / max(spurious_g, 1) >= 10.0, (spurious_u, spurious_g)
    ok = _clean_ids(scen, 0)
    ref = _restrict(clean, ok)
    assert len(ref) > 0
    assert _restrict(guarded, ok) == ref
    assert det.quality_summary()["duplicate_fingerprints"] > 0


def test_dirty_stream_snapshot_roundtrip(tmp_path):
    """Stop and restore mid-dirty-stream: the restored run equals the
    uninterrupted one, quality state included; the restored run of the
    reference's snapshot too."""
    cfg, scfg = tfast.smoke_config(), tfast.stream_dirty_smoke_config()
    scen = _make(tsynth, SCENARIOS["snapshot_mix"])
    wf = scen.waveforms[0]
    med_mad = _stats(scen)
    chunks = np.array_split(wf, 12)
    run = tengine.StreamingDetector(cfg, scfg, med_mad=med_mad,
                                    device="cpu")
    ref = jengine.StreamingDetector(jfast.smoke_config(),
                                    jfast.stream_dirty_smoke_config(),
                                    med_mad=med_mad)
    for c in chunks[:6]:
        run.push(c)
        ref.push(c)
    run.snapshot(str(tmp_path / "port"), step=6)
    ref.snapshot(str(tmp_path / "ref"), step=6)
    restored = []
    for src in ("port", "ref"):
        det, step = tengine.StreamingDetector.restore(
            str(tmp_path / src), cfg, scfg, device="cpu")
        assert step == 6
        restored.append(det)
    for c in chunks[6:]:
        run.push(c)
        for det in restored:
            det.push(c)
    whole = tengine.StreamingDetector(cfg, scfg, med_mad=med_mad,
                                      device="cpu")
    for c in chunks:
        whole.push(c)
    e0, p0, f0 = whole.stations[0].finalize()
    outs = [det.stations[0].finalize() for det in [run] + restored]
    for e, p, f in outs:
        np.testing.assert_array_equal(p0.idx1.numpy(), p.idx1.numpy())
        np.testing.assert_array_equal(p0.valid.numpy(), p.valid.numpy())
        np.testing.assert_array_equal(tengine.events_to_rows(e0),
                                      tengine.events_to_rows(e))
        assert f == f0
    assert f0["quality"]["duplicate_fingerprints"] > 0
    assert f0["quality"]["missing_samples"] > 0
