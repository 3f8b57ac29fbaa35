"""The port's checkpoints (``repro_torch.train.checkpoint``) and detector
snapshots (``StreamingDetector.snapshot`` / ``restore``) against the JAX
package's, on the CPU.

* ``save_checkpoint`` / ``restore_flat`` round-trip, prune, overwrite
  atomically, and write the reference's layout: either package reads the
  other's step directory, with the same keys, shapes and dtypes;
* cross-load, both ways: a reference detector's snapshot restores into
  the port, and a port snapshot into the reference, mid-warm-up (pending
  blocks) and after the statistics froze, pooled (``stream_smoke_config``,
  2 stations) and bounded (``stream_bounded_smoke_config``, 3 stations);
  the restored detector finishes the stream with the uninterrupted
  reference run's pair triplets, events, alerts, quality and drops at
  tolerance 0;
* a port snapshot's manifest names the reference's keys, shapes and
  dtypes (uint32 signatures and packed rows, uint64 duplicate hashes),
  its integer leaves equal the reference's and its coefficient leaves
  (the reservoir, the statistics) agree within fp32 tolerance;
* the layout check refuses a mismatched ``StreamConfig`` with the
  reference's message; older snapshots (2-column alert keys, 4-column
  alert rows, no guard leaves) restore as the reference restores them;
* a located detector's snapshot (``located_smoke_config``, 4 stations
  with geometry, amplitude timelines in ``detector/amp<i>``) cross-loads
  both ways: the timelines restore bin for bin, and the restored stream
  finishes with the uninterrupted reference run's alerts, located
  detections, events, stats and locate counters at tolerance 0.
"""
import _torch_threads  # noqa: F401  (one torch thread a process)
import dataclasses
import json

import numpy as np
import pytest
import torch

from repro.configs import fast_seismic as jfast
from repro.core import synth as jsynth
from repro.stream import engine as jengine
from repro.train import checkpoint as jckpt
from repro_torch.configs import fast_seismic as tfast
from repro_torch.stream import engine as tengine
from repro_torch.train import checkpoint as tckpt

PKGS = {"ref": (jengine, jfast), "port": (tengine, tfast)}
WALL_KEYS = ("wall_s", "chunk_ms_p50", "chunk_ms_p95", "chunks_per_s",
             "samples_per_s")


@pytest.fixture(scope="module")
def trace():
    """The reference stream tests' bounded trace: 3 stations, 600 s."""
    return jsynth.make_dataset(jsynth.SynthConfig(
        duration_s=600.0, n_stations=3, n_sources=2, events_per_source=5,
        event_snr=3.0, seed=11)).waveforms


def _pushes(n, step=6000):
    return [(a, min(a + step, n)) for a in range(0, n, step)]


def _detector(pkg, scfg_name, n_stations, **replace):
    engine, fast = PKGS[pkg]
    scfg = getattr(fast, scfg_name)()
    if replace:
        scfg = dataclasses.replace(scfg, **replace)
    kw = {} if pkg == "ref" else {"device": "cpu"}
    return engine.StreamingDetector(fast.smoke_config(), scfg,
                                    n_stations=n_stations, **kw)


def _restore(pkg, path, scfg_name, **replace):
    engine, fast = PKGS[pkg]
    scfg = getattr(fast, scfg_name)()
    if replace:
        scfg = dataclasses.replace(scfg, **replace)
    kw = {} if pkg == "ref" else {"device": "cpu"}
    return engine.StreamingDetector.restore(str(path), fast.smoke_config(),
                                            scfg, **kw)


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _finish(det) -> dict:
    """What a run leaves: detections, events, stats (walls dropped),
    per-station post-filter triplets, every alert row and the drops."""
    detections, events, stats = det.finalize()
    for s in stats.get("ingest", []):
        for k in WALL_KEYS:
            s.pop(k)
    rows = [np.asarray(a) for a in det.alerts]
    out = {
        "detections": None if detections is None else
        {k: _np(v).tolist() for k, v in detections.items()},
        "events": [], "pairs": [],
        "stats": stats,
        "alerts": (np.concatenate(rows).tolist() if rows else []),
        "drops": det.telemetry.drop_breakdown(),
        "quality": det.quality_summary(),
    }
    for st in det.stations:
        ev, pairs, _ = st.finalize()
        v = _np(ev.valid)
        out["events"].append(sorted(zip(*(
            _np(getattr(ev, k))[v].tolist()
            for k in ("dt", "onset", "extent", "size", "score")))))
        pv = _np(pairs.valid)
        out["pairs"].append(sorted(zip(_np(pairs.idx1)[pv].tolist(),
                                       _np(pairs.idx2)[pv].tolist(),
                                       _np(pairs.sim)[pv].tolist())))
    return out


# ---------------------------------------------------------------------------
# the checkpoint module
# ---------------------------------------------------------------------------


def _state():
    g = torch.Generator().manual_seed(0)
    return {"params": {"w": torch.randn((8, 4), generator=g),
                       "b": torch.zeros(4)},
            "opt": {"m": np.ones((8, 4), np.float32),
                    "step": np.asarray(3, np.int32)},
            "sig": np.arange(6, dtype=np.uint32) * 0x9E3779B1}


def test_roundtrip_and_layout_read_by_the_reference(tmp_path):
    state = _state()
    tckpt.save_checkpoint(str(tmp_path), 7, state, extra={"it": {"p": 5}})
    flat, extra, step = tckpt.restore_flat(str(tmp_path))
    ref_flat, ref_extra, ref_step = jckpt.restore_flat(str(tmp_path))
    assert (extra, step) == (ref_extra, ref_step) == ({"it": {"p": 5}}, 7)
    assert sorted(flat) == sorted(ref_flat) == sorted(
        ["params\x1fw", "params\x1fb", "opt\x1fm", "opt\x1fstep", "sig"])
    np.testing.assert_array_equal(flat["params\x1fw"],
                                  state["params"]["w"].numpy())
    assert flat["sig"].dtype == np.uint32 and flat["opt\x1fstep"].shape == ()
    for k in flat:
        np.testing.assert_array_equal(flat[k], ref_flat[k])


def test_manifest_equals_the_reference_writers(tmp_path):
    """The same state written by both packages: identical manifests and
    arrays (the port reads the reference's file too)."""
    state = _state()
    jax_state = {"params": {k: v.numpy() for k, v in state["params"].items()},
                 "opt": state["opt"], "sig": state["sig"]}
    tckpt.save_checkpoint(str(tmp_path / "port"), 1, state)
    jckpt.save_checkpoint(str(tmp_path / "ref"), 1, jax_state)
    man = [json.loads((tmp_path / p / "step_00000001" / "manifest.json")
                      .read_text()) for p in ("port", "ref")]
    assert man[0] == man[1]
    a, _, _ = tckpt.restore_flat(str(tmp_path / "ref"))
    b, _, _ = tckpt.restore_flat(str(tmp_path / "port"))
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype
        np.testing.assert_array_equal(a[k], b[k])


def test_background_save_and_prune(tmp_path):
    threads = [tckpt.save_checkpoint(str(tmp_path), s, _state(),
                                     background=True, keep=2)
               for s in (1, 2, 3)]
    for t in threads:
        t.join()
    steps = tckpt.list_steps(str(tmp_path))
    assert steps[-1] == 3 and len(steps) <= 2
    assert tckpt.latest_step(str(tmp_path)) == 3


def test_no_partial_dirs_on_overwrite(tmp_path):
    tckpt.save_checkpoint(str(tmp_path), 1, _state())
    tckpt.save_checkpoint(str(tmp_path), 1, _state())
    assert [p.name for p in tmp_path.iterdir()] == ["step_00000001"]


def test_restore_flat_without_checkpoints_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        tckpt.restore_flat(str(tmp_path / "none"))
    assert tckpt.latest_step(str(tmp_path / "none")) is None


# ---------------------------------------------------------------------------
# detector snapshots: cross-load both ways
# ---------------------------------------------------------------------------


CROSS = {
    # (StreamConfig, stations, chunks before the snapshot)
    "pooled_warmup": ("stream_smoke_config", 2, 3),
    "pooled_frozen": ("stream_smoke_config", 2, 6),
    "bounded_frozen": ("stream_bounded_smoke_config", 3, 6),
}


@pytest.fixture(scope="module")
def uninterrupted(trace):
    """The reference's uninterrupted run of each CROSS configuration."""
    out = {}
    for name, (scfg_name, n, _) in CROSS.items():
        det = _detector("ref", scfg_name, n)
        for a, b in _pushes(trace.shape[1]):
            det.push(trace[:n, a:b])
        out[name] = _finish(det)
    return out


@pytest.mark.parametrize("direction", ["ref_to_port", "port_to_ref"])
@pytest.mark.parametrize("case", CROSS)
def test_cross_load_continues_the_stream_exactly(trace, uninterrupted,
                                                 tmp_path, case, direction):
    scfg_name, n, k = CROSS[case]
    src, dst = direction.split("_to_")
    pushes = _pushes(trace.shape[1])
    det = _detector(src, scfg_name, n)
    for a, b in pushes[:k]:
        det.push(trace[:n, a:b])
    det.snapshot(str(tmp_path), step=k)
    restored, step = _restore(dst, tmp_path, scfg_name)
    assert step == k and restored.pooled == det.pooled
    if case == "pooled_warmup":
        assert restored.stations[0].pending and not \
            restored.stations[0].stats_frozen
    else:
        assert all(st.stats_frozen for st in restored.stations)
    for a, b in pushes[k:]:
        restored.push(trace[:n, a:b])
    got = _finish(restored)
    assert got == uninterrupted[case]
    assert sum(map(len, got["pairs"])) + len(got["alerts"]) > 0


def test_port_snapshot_layout_equals_the_references(trace, tmp_path):
    """Same stream in both packages → the same keys, shapes and dtypes in
    the manifest, and equal arrays apart from wall times."""
    for pkg in PKGS:
        det = _detector(pkg, "stream_dirty_smoke_config", 2)
        for a, b in _pushes(trace.shape[1])[:7]:
            det.push(trace[:2, a:b])
        det.snapshot(str(tmp_path / pkg), step=7)
    man = {pkg: json.loads((tmp_path / pkg / "step_00000007" /
                            "manifest.json").read_text())
           for pkg in PKGS}
    assert man["port"]["keys"] == man["ref"]["keys"]
    keys = man["port"]["keys"]
    assert keys["s0/index/sig"]["dtype"] == "uint32"
    assert keys["s0/index/pk"]["dtype"] == "uint32"
    assert keys["s0/dup/hash"]["dtype"] == "uint64"
    arrays = {pkg: tckpt.restore_flat(str(tmp_path / pkg))[0]
              for pkg in PKGS}
    for k, v in arrays["ref"].items():
        if "chunk_wall_s" in k:
            continue
        if v.dtype.kind == "f":     # coefficients: fp32 tolerance
            np.testing.assert_allclose(arrays["port"][k], v, rtol=1e-5,
                                       atol=1e-5 * np.abs(v).max(initial=0),
                                       err_msg=k)
        else:                       # integer and sample leaves: exact
            np.testing.assert_array_equal(arrays["port"][k], v, err_msg=k)
    extra = {pkg: man[pkg]["extra"] for pkg in PKGS}
    assert extra["port"]["scfg"] == extra["ref"]["scfg"]
    for st_p, st_r in zip(extra["port"]["stations"],
                          extra["ref"]["stations"]):
        for key in ("ring", "mad", "frozen", "processed_fp", "qc"):
            assert st_p[key] == st_r[key], key


def test_layout_check_refuses_a_mismatched_config(trace, tmp_path):
    det = _detector("port", "stream_smoke_config", 2)
    det.push(trace[:2, :6000])
    det.snapshot(str(tmp_path))
    errors = []
    for pkg in PKGS:
        with pytest.raises(ValueError) as e:
            _restore(pkg, tmp_path, "stream_smoke_config",
                     block_fingerprints=32)
        errors.append(str(e.value))
    assert errors[0] == errors[1]
    assert "block_fingerprints=64" in errors[0]


def _rewrite(path, step, edit):
    """Load a snapshot, apply ``edit(arrays, extra)``, write it back."""
    arrays, extra, _ = tckpt.restore_flat(str(path))
    edit(arrays, extra)
    tckpt.save_checkpoint(str(path), step, arrays, extra=extra)


def test_older_snapshots_restore_as_the_reference_restores_them(trace,
                                                                tmp_path):
    """2-column alert keys, 4-column alert rows and a station without the
    guard leaves (traffic, occ, epoch, pk) and the vbuf ring restore to
    the reference's state, and both continue to the same result."""
    scfg = "stream_bounded_smoke_config"
    det = _detector("ref", scfg, 3)
    pushes = _pushes(trace.shape[1])
    for a, b in pushes[:7]:
        det.push(trace[:, a:b])
    det.snapshot(str(tmp_path), step=7)

    def edit(arrays, extra):
        arrays["detector/emitted"] = arrays["detector/emitted"][:, :2]
        arrays["detector/alerts"] = arrays["detector/alerts"][:, :4]
        for k in ("index/traffic", "index/occ", "index/epoch",
                  "index/pk", "ring/vbuf"):
            del arrays[f"s1/{k}"]
    _rewrite(tmp_path, 7, edit)
    out = {}
    for pkg in PKGS:
        restored, _ = _restore(pkg, tmp_path, scfg)
        alerts = np.concatenate(restored.alerts)
        assert (alerts[:, 5:7] == tengine.LOC_NONE).all()
        assert (alerts[:, 7] == tengine.MAG_NONE).all()
        emitted = restored._emitted.tolist()
        for a, b in pushes[7:]:
            restored.push(trace[:, a:b])
        out[pkg] = (emitted, _finish(restored))
    assert out["port"] == out["ref"]
    assert len(out["port"][0]) > 0


@pytest.fixture(scope="module")
def located():
    """The reference's located stream test's trace (4 stations, 900 s,
    physical geometry, seed 11) and the reference's uninterrupted run."""
    ds = jsynth.make_dataset(jsynth.SynthConfig(
        duration_s=900.0, n_stations=4, n_sources=2, events_per_source=6,
        event_snr=3.0, seed=11, physical_geometry=True))
    det = _located_detector("ref", ds.station_xy)
    for a, b in _pushes(ds.waveforms.shape[1]):
        det.push(ds.waveforms[:, a:b])
    return ds, _located_finish(det)


def _located_detector(pkg, station_xy):
    engine, fast = PKGS[pkg]
    kw = {} if pkg == "ref" else {"device": "cpu"}
    return engine.StreamingDetector(
        fast.located_smoke_config(), fast.stream_bounded_smoke_config(),
        n_stations=4, station_xy=station_xy, **kw)


def _located_finish(det) -> dict:
    """``_finish`` with NaN (unlocated rows) written as None, so equal
    runs compare equal, plus the locate counters."""
    view = det.telemetry.locate_view()
    out = _finish(det)
    out["detections"] = {
        k: [None if isinstance(x, float) and np.isnan(x) else x for x in v]
        for k, v in out["detections"].items()}
    out["locate"] = {k: view[k] for k in ("passes", "groups", "located",
                                          "moveout_rejected")}
    return out


@pytest.mark.parametrize("direction", ["ref_to_port", "port_to_ref"])
def test_amplitude_timelines_cross_load(located, tmp_path, direction):
    ds, want = located
    src, dst = direction.split("_to_")
    pushes = _pushes(ds.waveforms.shape[1])
    k = len(pushes) // 2
    det = _located_detector(src, ds.station_xy)
    for a, b in pushes[:k]:
        det.push(ds.waveforms[:, a:b])
    det.snapshot(str(tmp_path), step=k)
    arrays, _, _ = tckpt.restore_flat(str(tmp_path))
    amp = [arrays[f"detector/amp{i}"] for i in range(4)]
    assert all(a.dtype == np.float64 and a.shape[1] == 2 and a.shape[0]
               for a in amp)
    engine, fast = PKGS[dst]
    kw = {} if dst == "ref" else {"device": "cpu"}
    restored, step = engine.StreamingDetector.restore(
        str(tmp_path), fast.located_smoke_config(),
        fast.stream_bounded_smoke_config(), station_xy=ds.station_xy, **kw)
    assert step == k and restored.locating
    assert restored._amp == det._amp
    for a, b in pushes[k:]:
        restored.push(ds.waveforms[:, a:b])
    got = _located_finish(restored)
    # the restored registry carries the first half's counters
    assert got == want
    assert any(row[5] != tengine.LOC_NONE for row in got["alerts"])


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_solo_round_trip_with_pending_blocks(trace, tmp_path, fused):
    """A one-station detector (fused, and the unfused chain whose pending
    blocks carry their coefficients) snapshotted mid-warm-up and restored
    in the port finishes as the uninterrupted port run does."""
    pushes = _pushes(trace.shape[1])
    knobs = dict(fused=fused, pooled=fused)
    full = _detector("port", "stream_smoke_config", 1, **knobs)
    for a, b in pushes:
        full.push(trace[0, a:b])
    want = _finish(full)
    det = _detector("port", "stream_smoke_config", 1, **knobs)
    for a, b in pushes[:3]:
        det.push(trace[0, a:b])
    assert det.stations[0].pending
    det.snapshot(str(tmp_path))
    restored, step = _restore("port", tmp_path, "stream_smoke_config",
                              **knobs)
    assert step == 3
    for a, b in pushes[3:]:
        restored.push(trace[0, a:b])
    assert _finish(restored) == want
