"""The port's location / magnitude tier (``repro_torch.core.locate``) and
the association pieces it stands on, against the JAX package's, on the
CPU.

* ``locate_groups`` at the smoke and the paper ``LocateConfig`` on the
  same seeded onsets (stations absent from groups, groups with no station
  at all): origins, t0 and residuals within rtol 1e-5 / atol 1e-4,
  ``n_used`` and ``consistent`` exact; ``travel_time_lags`` alike;
* ``associate_network(with_onsets=True)``: every output, the (p, S)
  ``station_onset`` and ``station_score`` matrices included, bit-exact;
* the host functions (``station_weights``, ``weighted_median``,
  ``relative_magnitude``, ``fingerprint_amplitudes``,
  ``magnitudes_from_onsets``) equal on the same inputs;
* ``locate_detections`` scatters back to det rows and refuses an
  association without onsets;
* ``detect_events`` located on ``tests/test_locate.py``'s scenario: the
  integer columns exact, the float columns within the tolerance above;
* the located batch scenario (``tools/located_golden.py``, 6 stations ×
  600 s, three runs): every associated group's integer columns equal to
  ``tests/golden/located_scenario.json``, origins within the paper
  config's finest cell (``cell_km``), magnitudes within 1e-5, the summary
  counts equal and the median origin error within 0.01 km;
* ``align.align_streamed`` against the reference's on its test's data;
* the location configs equal the reference's.

The float arithmetic is the reference's (float32, the same operation
order), but XLA on the CPU contracts dx² + dy² into one fused
multiply-add and divides by constants through reciprocals, so the two
travel-time surfaces differ by an ulp here and there, and where two
candidate cells of the finest level tie to within that ulp, ``argmin``
can pick the neighbour: one group of the located scenario's 80 lands one
finest cell (0.26 km) from the reference's. Hence the golden's origins
are held to one finest cell (``cell_km`` + 1e-4 km, the float32 spacing of
two neighbouring candidates), as on the card.
"""
import _torch_threads  # noqa: F401  (one torch thread a process)
import dataclasses
import json
import pathlib
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import fast_seismic as jfast
from repro.core import align as jalign
from repro.core import locate as jloc
from repro.core import synth as jsynth
from repro.core.detect import detect_events as j_detect_events
from repro_torch import core as tcore
from repro_torch.configs import fast_seismic as tfast
from repro_torch.core import align as talign
from repro_torch.core import locate as tloc
from repro_torch.core import synth as tsynth
from repro_torch.core.detect import DetectConfig
from repro_torch.core.detect import detect_events as t_detect_events
from repro_torch.core.lsh import INVALID

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from tools.located_golden import group_rows, summarize  # noqa: E402

GOLDEN = json.loads((ROOT / "tests" / "golden" / "located_scenario.json")
                    .read_text())
RTOL, ATOL = 1e-5, 1e-4
LOC_CFGS = {"smoke": "locate_smoke_config", "paper": "locate_config"}
FLOAT_COLS = ("x_km", "y_km", "t0", "residual", "magnitude",
              "station_weight")


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _onsets(rng, cfg, n_groups, n_st, lag_s, absent=0.25):
    """Seeded physical onsets (origins on the grid, rounded to lags, with
    lag noise), a share of stations absent, two groups with none."""
    xy = rng.uniform(2.5, 47.5, (n_st, 2)).astype(np.float32)
    src = rng.uniform(0.0, cfg.extent_km, (n_groups, 2)).astype(np.float32)
    tt = np.asarray(jloc.travel_time_lags(jnp.asarray(src), jnp.asarray(xy),
                                          cfg, jnp.float32(lag_s)))
    on = np.round(200 + tt + rng.normal(0, 0.7, tt.shape)).astype(np.int32)
    on[rng.random(on.shape) < absent] = INVALID
    on[[1, n_groups - 1]] = INVALID
    return on, xy


def _ref_locate(on, w, xy, lag_s, cfg):
    out = jloc.locate_groups(jnp.asarray(on), jnp.asarray(w),
                             jnp.asarray(xy), jnp.float32(lag_s), cfg)
    return {k: np.asarray(v) for k, v in out.items()}


def _port_locate(on, w, xy, lag_s, cfg):
    out = tloc.locate_groups(torch.as_tensor(on), torch.as_tensor(w),
                             torch.as_tensor(xy), np.float32(lag_s), cfg)
    return {k: v.numpy() for k, v in out.items()}


@pytest.mark.parametrize("name", LOC_CFGS)
def test_locate_configs_match_reference(name):
    j = getattr(jfast, LOC_CFGS[name])()
    t = getattr(tfast, LOC_CFGS[name])()
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert (j.cell_km, j.coarse_cell_km) == (t.cell_km, t.coarse_cell_km)
    jl, tl = jfast.located_smoke_config(), tfast.located_smoke_config()
    for part in ("fingerprint", "lsh", "align", "locate"):
        assert dataclasses.asdict(getattr(jl, part)) == \
            dataclasses.asdict(getattr(tl, part)), part


@pytest.mark.parametrize("name", LOC_CFGS)
@pytest.mark.parametrize("seed,n_groups,n_st,lag_s", [
    (0, 64, 6, 0.5), (1, 33, 4, 2.0), (2, 7, 16, 2.0)])
def test_locate_groups_matches_reference(name, seed, n_groups, n_st, lag_s):
    cfg = getattr(tfast, LOC_CFGS[name])()
    rng = np.random.default_rng(seed)
    on, xy = _onsets(rng, cfg, n_groups, n_st, lag_s)
    w = rng.uniform(0.0, 1.0, n_st).astype(np.float32)
    want = _ref_locate(on, w, xy, lag_s, cfg)
    got = _port_locate(on, w, xy, lag_s, cfg)
    assert set(got) == set(want)
    for k in ("xy", "t0", "residual"):
        assert got[k].dtype == np.float32
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL,
                                   err_msg=k)
    for k in ("n_used", "consistent"):
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["n_used"][1] == 0 and got["n_used"][-1] == 0
    assert got["consistent"].any()


def test_locate_groups_recovers_origin_and_flags_coincidence():
    """The reference test's physics on the port: a physical moveout
    localizes within two coarse cells and passes the gate; random onsets
    fail it."""
    cfg = tloc.LocateConfig(grid_n=12, extent_km=50.0, refine_levels=3,
                            moveout_tol_lags=2.0)
    xy = np.random.default_rng(1).uniform(2.5, 47.5, (6, 2)).astype(
        np.float32)
    src = np.array([30.0, 12.0], np.float32)
    tt = tloc.travel_time_lags(torch.as_tensor(src), torch.as_tensor(xy),
                               cfg, np.float32(0.5)).numpy()
    good = np.round(100.0 + tt).astype(np.int32)
    bad = np.array([100, 160, 115, 180, 140, 105], np.int32)
    out = _port_locate(np.stack([good, bad]), np.ones(6, np.float32), xy,
                       0.5, cfg)
    assert np.linalg.norm(out["xy"][0] - src) <= 2 * cfg.coarse_cell_km
    assert out["consistent"].tolist() == [True, False]
    assert out["residual"][0] < out["residual"][1]


@pytest.mark.parametrize("lag_s", [0.5, 2.0])
def test_travel_time_lags_matches_reference(lag_s):
    cfg = tfast.locate_config()
    rng = np.random.default_rng(4)
    xy = rng.uniform(0, 50, (5, 2)).astype(np.float32)
    cand = rng.uniform(0, 50, (3, 7, 2)).astype(np.float32)
    want = np.asarray(jloc.travel_time_lags(
        jnp.asarray(cand), jnp.asarray(xy), cfg, jnp.float32(lag_s)))
    got = tloc.travel_time_lags(torch.as_tensor(cand), torch.as_tensor(xy),
                                cfg, np.float32(lag_s)).numpy()
    assert got.shape == want.shape == (3, 7, 5)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def _events(rng, n_st, n_ev, pkg):
    """Per-station Events with clustered (dt, onset) so groups form
    across stations, some rows invalid."""
    out = []
    for _ in range(n_st):
        dt = rng.choice([40, 41, 90, 200], n_ev).astype(np.int32)
        onset = (rng.choice([100, 130, 400, 900], n_ev)
                 + rng.integers(-6, 7, n_ev)).astype(np.int32)
        score = rng.integers(1, 30, n_ev).astype(np.int32)
        valid = rng.random(n_ev) < 0.8
        dt[~valid] = INVALID
        onset[~valid] = INVALID
        cols = (dt, onset, np.zeros(n_ev, np.int32),
                np.ones(n_ev, np.int32), score, valid)
        if pkg == "ref":
            out.append(jalign.Events(*(jnp.asarray(c) for c in cols)))
        else:
            out.append(talign.Events(*(torch.as_tensor(c) for c in cols)))
    return out


@pytest.mark.parametrize("n_st,n_ev,max_extent", [
    (3, 16, 0), (5, 24, 0), (5, 24, 20), (33, 6, 0)])
def test_associate_network_with_onsets_bit_exact(n_st, n_ev, max_extent):
    acfg = talign.AlignConfig(max_group_extent=max_extent)
    jcfg = jalign.AlignConfig(**dataclasses.asdict(acfg))
    want = jalign.associate_network(
        _events(np.random.default_rng(n_st), n_st, n_ev, "ref"), jcfg,
        n_st, with_onsets=True)
    got = talign.associate_network(
        _events(np.random.default_rng(n_st), n_st, n_ev, "port"), acfg,
        n_st, with_onsets=True)
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    assert got["station_onset"].shape == (n_st * n_ev, n_st)
    assert bool(got["valid"].any())


def _qualities(rng, n):
    keys = ("gap_samples", "missing_samples", "late_dropped_samples",
            "rejected_samples", "duplicate_samples",
            "duplicate_fingerprints", "masked_fingerprints",
            "saturated_lookups")
    return [{k: int(rng.integers(0, 3000)) * int(rng.random() < 0.5)
             for k in keys} for _ in range(n)]


def _amp_table(rng, n_st):
    table = rng.uniform(0.1, 5.0, (n_st, 400))
    table[rng.random(table.shape) < 0.1] = np.nan

    def amp(st, i):
        if not 0 <= i < table.shape[1] or np.isnan(table[st, i]):
            return None
        return float(table[st, i])
    return amp


HOST = {
    "station_weights": lambda m, rng: m.station_weights(
        _qualities(rng, 7), rng.integers(0, 20000, 7).tolist(),
        rng.integers(0, 400, 7).tolist(), tfast.locate_config()),
    "weighted_median": lambda m, rng: [m.weighted_median(
        np.where(rng.random(9) < 0.2, np.nan, rng.normal(size=9)),
        rng.uniform(0, 2, 9)) for _ in range(20)],
    "relative_magnitude": lambda m, rng: [m.relative_magnitude(
        rng.uniform(-0.5, 3, 6), rng.uniform(-0.5, 30, 6),
        rng.uniform(0, 1, 6)) for _ in range(20)],
    "fingerprint_amplitudes": lambda m, rng: m.fingerprint_amplitudes(
        np.where(rng.random(5003) < 0.01, np.nan,
                 rng.normal(size=5003)).astype(np.float32), 200, 3375),
    "magnitudes_from_onsets": lambda m, rng: m.magnitudes_from_onsets(
        np.where(rng.random((12, 5)) < 0.3, INVALID,
                 rng.integers(0, 300, (12, 5))).astype(np.int32),
        rng.integers(1, 90, 12), rng.random(12) < 0.8, _amp_table(rng, 5),
        rng.uniform(0.05, 1, 5).astype(np.float32),
        rng.integers(0, 20, (12, 5))),
}


@pytest.mark.parametrize("name", HOST)
def test_host_functions_equal_reference(name):
    got = HOST[name](tloc, np.random.default_rng(5))
    want = HOST[name](jloc, np.random.default_rng(5))
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    assert np.isfinite(np.asarray(got, np.float64)).any()


def test_locate_detections_scatters_back_to_det_rows():
    cfg = tloc.LocateConfig(grid_n=10, refine_levels=2, pad_groups=8,
                            moveout_tol_lags=2.0)
    rng = np.random.default_rng(3)
    on, xy = _onsets(rng, cfg, 5, 6, 0.5, absent=0.0)
    det = {"valid": np.arange(5) == 2, "station_onset": on}
    got = tloc.locate_detections(det, xy, np.ones(6, np.float32), 0.5, cfg,
                                 device="cpu")
    want = jloc.locate_detections(det, xy, np.ones(6, np.float32), 0.5, cfg)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL,
                                   err_msg=k)
    assert np.isfinite(got["x_km"][2]) and np.isnan(got["x_km"][[0, 1, 3, 4]]
                                                    ).all()
    with pytest.raises(ValueError, match="with_onsets"):
        tloc.locate_detections({"valid": det["valid"]}, xy,
                               np.ones(6, np.float32), 0.5, cfg,
                               device="cpu")


def _same_detections(got: dict, want: dict):
    assert set(got) == set(want)
    for k in want:
        g, w = _np(got[k]), np.asarray(want[k])
        assert g.shape == w.shape and g.dtype == w.dtype, k
        if k in FLOAT_COLS:
            np.testing.assert_array_equal(np.isnan(g), np.isnan(w),
                                          err_msg=k)
            ok = ~np.isnan(w)
            np.testing.assert_allclose(g[ok], w[ok], rtol=RTOL, atol=ATOL,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)


def test_detect_events_located_matches_reference():
    """``tests/test_locate.py::test_located_batch_scenario_origin_error``'s
    data through both packages' located batch driver."""
    ds = jsynth.make_dataset(jsynth.SynthConfig(
        seed=3, n_stations=6, duration_s=600.0, n_sources=3,
        events_per_source=4, event_snr=3.0, physical_geometry=True))
    want, _, _, wstats = j_detect_events(
        ds.waveforms, jfast.located_smoke_config(), station_xy=ds.station_xy)
    got, _, _, gstats = t_detect_events(
        ds.waveforms, tfast.located_smoke_config(),
        station_xy=ds.station_xy, device="cpu")
    _same_detections(got, want)
    for k in ("moveout_rejected", "detections"):
        assert gstats[k] == wstats[k], k
    v = _np(got["valid"]) & (_np(got["n_stations"]) >= 4)
    assert v.sum() >= 2
    assert np.isfinite(got["magnitude"][v]).all()


def test_detect_events_without_geometry_is_unlocated():
    """A locate config without ``station_xy`` stops at the pairwise
    association, as the reference does."""
    ds = tsynth.make_dataset(tsynth.SynthConfig(
        duration_s=300.0, n_stations=3, n_sources=2, events_per_source=3,
        event_snr=3.0, seed=2, physical_geometry=True))
    det, _, _, stats = t_detect_events(ds.waveforms,
                                       tfast.located_smoke_config(),
                                       device="cpu")
    assert "station_onset" not in det and "x_km" not in det
    assert "moveout_rejected" not in stats


def _golden_run(det: dict) -> dict:
    return {k: _np(v) for k, v in det.items()}


@pytest.fixture(scope="module")
def scenario():
    """The located scenario's three runs through the port on the CPU,
    configured from the golden file alone."""
    g = GOLDEN
    fcfg = tcore.FingerprintConfig(**g["fingerprint"])
    cfg = DetectConfig(fingerprint=fcfg, lsh=tcore.LSHConfig(**g["lsh"]),
                       align=tcore.AlignConfig(**g["align"]),
                       locate=tloc.LocateConfig(**g["locate"]))
    clean = tsynth.make_dataset(tsynth.SynthConfig(**g["synth"]))
    noisy = tsynth.make_dataset(tsynth.SynthConfig(
        **g["synth"], repeating_noise_stations=tuple(g["noisy_stations"])))

    def run(wf, locate):
        det, _, _, stats = t_detect_events(
            wf, dataclasses.replace(cfg, locate=locate),
            station_xy=noisy.station_xy if locate else None, device="cpu")
        return _golden_run(det), stats

    golden, _ = run(clean.waveforms, None)
    pairwise, _ = run(noisy.waveforms, dataclasses.replace(
        cfg.locate, reject_inconsistent=False))
    gated, gstats = run(noisy.waveforms, cfg.locate)
    return {"golden": golden, "pairwise": pairwise, "gated": gated,
            "stats": gstats, "cfg": cfg, "source_xy": noisy.source_xy}


@pytest.mark.parametrize("run", ["golden", "pairwise", "gated"])
def test_located_scenario_groups_equal_golden(scenario, run):
    got = group_rows(scenario[run], run != "golden")
    want = GOLDEN["runs"][run]
    assert set(got) == set(want)
    cell = scenario["cfg"].locate.cell_km
    for k, w in want.items():
        if k in ("x_km", "y_km", "magnitude"):
            g = np.array([np.nan if x is None else x for x in got[k]])
            w = np.array([np.nan if x is None else x for x in w])
            np.testing.assert_array_equal(np.isnan(g), np.isnan(w), k)
            # one finest cell, as float32 places it (0.2604217 km apart
            # for a cell_km of 0.2604167), so the cell plus ATOL
            tol = 1e-5 if k == "magnitude" else cell + ATOL
            assert np.all(np.abs(g - w)[~np.isnan(w)] <= tol), k
        else:
            assert got[k] == w, k
    assert len(got["dt"]) > 0


def test_located_scenario_summary_equals_golden(scenario):
    s = scenario
    got = summarize(s["golden"], s["pairwise"], s["gated"], s["stats"],
                    s["cfg"].align, s["source_xy"],
                    s["cfg"].locate.coarse_cell_km)
    want = GOLDEN["summary"]
    assert set(got) == set(want)
    for k in want:
        if k.startswith("median_origin_err"):
            assert abs(got[k] - want[k]) <= 0.01, k
        else:
            assert got[k] == want[k], k
    # the acceptance of the reference's benchmark
    assert want["false_assoc_gated"] < want["false_assoc_pairwise"]
    assert want["true_kept_gated"] == want["true_kept_pairwise"]


def test_align_streamed_matches_reference(tmp_path):
    """``tests/test_align.py::test_align_streamed_matches_in_memory`` on
    the port, and equal to the reference's output row for row."""
    chans, expect = [], {}
    rng = np.random.default_rng(0)
    for _ in range(2):
        chunks = []
        for _ in range(3):
            rows = np.stack([rng.integers(0, 6, 25), rng.integers(0, 12, 25),
                             rng.integers(1, 4, 25)], axis=1)
            chunks.append(rows)
            for d, i, s in rows:
                expect[(int(d), int(i))] = expect.get((int(d), int(i)),
                                                      0) + int(s)
        chans.append(chunks)
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    got = talign.align_streamed(chans, threshold=5,
                                tmpdir=str(tmp_path / "t"))
    want = jalign.align_streamed(chans, threshold=5,
                                 tmpdir=str(tmp_path / "j"))
    assert got.dtype == np.int64 and got.shape[1] == 3
    np.testing.assert_array_equal(got, want)
    assert {(int(d), int(i)): int(s) for d, i, s in got} == \
        {k: v for k, v in expect.items() if v >= 5}
    assert talign.align_streamed([], threshold=1,
                                 tmpdir=str(tmp_path)).shape == (0, 3)
