"""The port's detection serving tier (``repro_torch.launch.serve_detect``)
against the JAX package's, on the CPU.

On the reference serving tests' corpus (``latency_config``, 2 stations,
60 s ingested in 1,000-sample pushes):

* the port's pooled serving state equals the reference's (index leaves
  bit for bit, statistics within fp32 tolerance), and the port's
  ``ServeDetectEngine`` over the reference's state, converted, returns
  the reference engine's match lists exactly, order included (ties in
  similarity go to the earlier candidate, as ``jax.lax.top_k`` breaks
  them), with one slot and with four;
* ``index.query`` with a slot axis equals ``index.query`` run once a
  (station, slot), dense, compacted, masked and saturated;
* the properties of ``tests/test_serve.py`` hold on the port: batched
  ticks equal sequential single-slot serving, shedding is deterministic,
  idle ticks do no host work, a lazy state queues until the first
  refresh, the interleaved session serves while ingesting, the empty,
  all-shed and unfinished-request guards hold, ``--restore`` validates
  the station count, a bare ``--metrics-file`` is written, and
  ``main([..., "--device", "cpu"])`` prints a ``RESULT`` with hits;
* ``pool_serving_state`` returns copies that a later push leaves alone;
* ``--locate`` prints the reference's ``ALERT`` rows and RESULT
  ``located`` block, and ``--restore`` into a wider ``--stations`` grows
  the restored pool as the reference's does.
"""
import _torch_threads  # noqa: F401  (one torch thread a process)
import dataclasses
import json

import numpy as np
import pytest
import torch

from repro.configs import fast_seismic as jfast
from repro.core import synth as jsynth
from repro.launch import serve_detect as jserve
from repro.stream import engine as jengine
from repro.stream import index as jindex
from repro_torch import convert
from repro_torch.configs import fast_seismic as tfast
from repro_torch.core import lsh as tlsh
from repro_torch.launch import serve_detect as tserve
from repro_torch.stream import engine as tengine
from repro_torch.stream import index as tindex
from repro_torch.stream.index import IndexState


def _ingest(det, wf):
    for start in range(0, wf.shape[1], 1000):
        det.push(wf[:, start: start + 1000])
    det.flush()
    assert all(st.stats_frozen for st in det.stations)
    return det


@pytest.fixture(scope="module")
def corpus():
    """The reference serving tests' corpus, ingested by both packages."""
    ds = jsynth.make_dataset(jsynth.SynthConfig(
        duration_s=60.0, n_stations=2, n_sources=2, events_per_source=4,
        event_snr=3.0, seed=7))
    ref = _ingest(jengine.StreamingDetector(
        jfast.latency_config(), jfast.stream_latency_smoke_config(),
        n_stations=2), ds.waveforms)
    port = _ingest(tengine.StreamingDetector(
        tfast.latency_config(), tfast.stream_latency_smoke_config(),
        n_stations=2, device="cpu"), ds.waveforms)
    return {"ds": ds, "ref": ref, "port": port,
            "cfg": tfast.latency_config(),
            "scfg": tfast.stream_latency_smoke_config(),
            "serving": port.pool_serving_state()}


def _engine(corpus, n_slots=4, max_queue=64, **kw):
    state, med, mad = corpus["serving"]
    return tserve.ServeDetectEngine(corpus["cfg"], corpus["scfg"], state,
                                    (med, mad), n_slots=n_slots,
                                    max_queue=max_queue, device="cpu", **kw)


def _windows(corpus, n, win_s=8.0, seed=5):
    """Random windows of station 0 (the reference tests' draw), then one
    window starting at each event's arrival: the ones that hit."""
    ds = corpus["ds"]
    wf = ds.waveforms[0]
    fs = corpus["cfg"].fingerprint.fs
    win = int(win_s * fs)
    starts = list(np.random.default_rng(seed).integers(0, wf.size - win,
                                                       size=n))
    starts += [min(int(ds.arrival_time(i, 0) * fs), wf.size - win)
               for i in range(len(ds.event_times))]
    return [wf[s: s + win] for s in starts]


def _requests(corpus, n, module=tserve, **kw):
    return [module.QueryRequest(rid=i, window=w)
            for i, w in enumerate(_windows(corpus, n, **kw))]


def _leaves(state) -> dict:
    return {f.name: np.asarray(getattr(state, f.name))
            for f in dataclasses.fields(state)}


# ---------------------------------------------------------------------------
# parity with the reference
# ---------------------------------------------------------------------------


def test_port_serving_state_equals_the_reference(corpus):
    r_state, r_med, r_mad = corpus["ref"].pool_serving_state()
    p_state, p_med, p_mad = corpus["serving"]
    want = convert.index_state(_leaves(r_state), "cpu")
    for f in dataclasses.fields(IndexState):
        assert torch.equal(getattr(p_state, f.name),
                           getattr(want, f.name)), f.name
    for got, ref in ((p_med, r_med), (p_mad, r_mad)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5,
                                   atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("n_slots", [1, 4])
def test_match_lists_equal_the_reference(corpus, n_slots):
    """Both engines over the reference's serving state (the port's
    converted): identical (station, id, sim) lists, in order."""
    r_state, r_med, r_mad = corpus["ref"].pool_serving_state()
    cfg, scfg = jfast.latency_config(), jfast.stream_latency_smoke_config()
    ref_eng = jserve.ServeDetectEngine(cfg, scfg, r_state, (r_med, r_mad),
                                       n_slots=n_slots)
    port_eng = tserve.ServeDetectEngine(
        corpus["cfg"], corpus["scfg"],
        convert.index_state(_leaves(r_state), "cpu"),
        convert.med_mad(r_med, r_mad, "cpu"), n_slots=n_slots, device="cpu")
    ref_reqs = _requests(corpus, 6, jserve)
    port_reqs = _requests(corpus, 6)
    r_stats, p_stats = ref_eng.run(ref_reqs), port_eng.run(port_reqs)
    for a, b in zip(ref_reqs, port_reqs):
        assert b.matches == a.matches
        assert (b.outcome, b.ticks) == (a.outcome, a.ticks)
    for k in ("requests", "served", "shed", "stations", "ticks",
              "dispatches", "hit_requests"):
        assert p_stats[k] == r_stats[k], k
    assert p_stats["hit_requests"] >= 2
    # ties in similarity are the rule: the order is the reference's
    assert any(len({s for _, _, s in r.matches}) < len(r.matches)
               for r in port_reqs)


def test_active_and_latency_windows_follow_the_reference(corpus):
    """After every tick, ``active()`` and the lengths of the per-request
    latency deques equal the reference engine's on the same requests (two
    slots, a queue of three: three shed, three served over the ticks)."""
    r_state, r_med, r_mad = corpus["ref"].pool_serving_state()
    cfg, scfg = jfast.latency_config(), jfast.stream_latency_smoke_config()
    engines = {
        "ref": jserve.ServeDetectEngine(cfg, scfg, r_state, (r_med, r_mad),
                                        n_slots=2, max_queue=3),
        "port": tserve.ServeDetectEngine(
            corpus["cfg"], corpus["scfg"],
            convert.index_state(_leaves(r_state), "cpu"),
            convert.med_mad(r_med, r_mad, "cpu"), n_slots=2, max_queue=3,
            device="cpu")}

    def view(eng):
        return eng.active(), {k: (len(v), v.maxlen)
                              for k, v in sorted(eng.lat.items())}

    assert tserve.LATENCY_WINDOW == jserve.LATENCY_WINDOW
    assert view(engines["port"]) == view(engines["ref"])
    for name, module in (("ref", jserve), ("port", tserve)):
        for r in _requests(corpus, 6, module):
            engines[name].submit(r)
    views = []
    while engines["ref"].pending() or engines["port"].pending():
        views.append(view(engines["port"]))
        assert views[-1] == view(engines["ref"])
        for eng in engines.values():
            eng.tick()
    views.append(view(engines["port"]))
    assert views[-1] == view(engines["ref"])
    assert any(v[0] for v in views) and not views[-1][0]
    assert views[-1][1]["latency_s"][0] == 3
    port = engines["port"]
    assert all(a >= b for a, b in zip(port.lat["latency_s"],
                                      port.lat["service_s"]))


@pytest.mark.parametrize("max_pairs,saturation,masked",
                         [(0, 0, False), (40, 0, False), (40, 3, True)],
                         ids=["0", "40", "40-saturated-masked"])
def test_query_slots_equals_query_per_slot(max_pairs, saturation, masked):
    """The slot fold: each (station, slot) row of ``query`` over
    (S, Q, N, t) signatures (with slot-axis ``qvalid`` and ``buckets`` in
    the masked case) is ``query`` of that slot alone (the port's and the
    reference's), stored ids straddling the query ids included."""
    rng = np.random.default_rng(3)
    lcfg = tlsh.LSHConfig(n_tables=6, n_funcs=4, n_matches=2, min_dt=0)
    s, q, n, t, b, c = 2, 3, 5, 6, 8, 4
    sig = rng.integers(0, 4, (s, t, b, c)).astype(np.uint32)
    ids = rng.integers(-1, 40, (s, t, b, c)).astype(np.int32)
    ids[ids < 0] = tlsh.INVALID
    leaves = {"sig": sig, "ids": ids, "cursor": np.zeros((s, t, b), np.int32),
              "inserted": np.zeros(s, np.int32),
              "traffic": rng.integers(0, 6, (s, t, b)).astype(np.int32),
              "occ": np.zeros((s, 1), np.int32),
              "epoch": np.zeros(s, np.int32),
              "pk": np.zeros((s, 1, 1), np.uint32)}
    state = convert.index_state(leaves, "cpu")
    sigs = torch.as_tensor(rng.integers(0, 4, (s, q, n, t)), dtype=torch.int32)
    qids = torch.arange(n, dtype=torch.int32) + 20
    qvalid = (torch.as_tensor(rng.random((s, q, n)) < 0.7) if masked
              else None)
    buckets = tlsh.bucket_ids(sigs, b, lcfg.seed) if masked else None
    kw = dict(max_pairs=max_pairs, saturation=saturation)
    got = tindex.query(state, sigs, qids, lcfg, qvalid=qvalid,
                       buckets=buckets, **kw)
    for st in range(s):
        one = tindex.slice_state(state, st)
        jstate = jindex.IndexState(**{k: v[st] for k, v in leaves.items()})
        for slot in range(q):
            qv = None if qvalid is None else qvalid[st:st + 1, slot]
            bk = None if buckets is None else buckets[st:st + 1, slot]
            want = tindex.query(one, sigs[st:st + 1, slot], qids, lcfg,
                                qvalid=qv, buckets=bk, **kw)
            ref = jindex.query(jstate, sigs[st, slot].numpy().astype(
                np.uint32), qids.numpy(), lcfg,
                qvalid=None if qv is None else qv[0].numpy(), **kw)
            for f in ("idx1", "idx2", "sim", "valid"):
                row = getattr(got, f)[st, slot]
                assert torch.equal(row, getattr(want, f)[0]), f
                np.testing.assert_array_equal(row.numpy(),
                                              np.asarray(getattr(ref, f)))
    assert bool(got.valid.any())


# ---------------------------------------------------------------------------
# the reference's serving properties, on the port
# ---------------------------------------------------------------------------


def test_batched_ticks_match_sequential_single_slot(corpus):
    reqs_a, reqs_b = _requests(corpus, 6), _requests(corpus, 6)
    stats_a = _engine(corpus, n_slots=4).run(reqs_a)
    stats_b = _engine(corpus, n_slots=1).run(reqs_b)
    assert stats_a["served"] == stats_b["served"] == len(reqs_a)
    for ra, rb in zip(reqs_a, reqs_b):
        assert ra.outcome == rb.outcome == "served"
        assert ra.matches == rb.matches
    assert stats_a["hit_requests"] == stats_b["hit_requests"] >= 1
    assert stats_a["dispatches"] < stats_b["dispatches"]


def test_from_detector_serves_the_detectors_pool(corpus):
    """``from_detector`` installs the detector's pool on its device with
    its telemetry hub: the same answers as an engine given the state."""
    det = corpus["port"]
    eng = tserve.ServeDetectEngine.from_detector(det, n_slots=2)
    assert eng.serving_version == det.serving_version
    assert eng.telemetry is det.telemetry and eng.device == det.device
    reqs_a, reqs_b = _requests(corpus, 2), _requests(corpus, 2)
    eng.run(reqs_a)
    _engine(corpus, n_slots=2).run(reqs_b)
    assert [r.matches for r in reqs_a] == [r.matches for r in reqs_b]


def test_load_shedding_is_deterministic(corpus):
    eng = _engine(corpus, n_slots=2, max_queue=3)
    reqs = _requests(corpus, 10)
    over = len(reqs) - 3
    accepted = [eng.submit(r) for r in reqs]
    assert accepted == [True] * 3 + [False] * over
    shed = [r for r in reqs if r.outcome == "rejected"]
    assert len(shed) == over and all(r.done for r in shed)
    assert all(r.latency_s >= 0.0 for r in shed)
    assert len(eng.queue) == 3
    eng.drain()
    assert sum(1 for r in reqs if r.outcome == "served") == 3
    reg = eng.telemetry.registry
    assert reg.total("serve_shed_total") == over
    assert reg.counter("serve_requests_total", outcome="served").value == 3
    summary = eng.summary(reqs, 1.0)
    assert summary["shed"] == over and summary["served"] == 3


def test_idle_ticks_do_no_host_work(corpus, monkeypatch):
    eng = _engine(corpus, n_slots=4)

    def boom(*a, **k):
        raise AssertionError("idle tick reached the serving step")

    monkeypatch.setattr(tserve, "_serve_step", boom)
    for _ in range(3):
        assert eng.tick() == 0
    assert eng.ticks == 3 and eng.dispatches == 0
    reg = eng.telemetry.registry
    assert reg.total("serve_ticks_total") == 3
    assert reg.total("serve_dispatches_total") == 0


TICK_CHILDREN = ["serve.admit", "serve.assemble", "serve.step",
                 "serve.fetch", "serve.unpack"]


def test_tick_spans_and_request_records(corpus, tmp_path, monkeypatch):
    """Under a CPU profiler: one ``serve.tick`` a dispatch with its five
    children in order, one ``serve.request`` record a served request over
    the dispatches that held it, and the match lists of an engine whose
    tracer writes no records."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.obsv.spans import SpanTracer
    plain = _requests(corpus, 5)
    _engine(corpus, n_slots=2).run(plain)
    eng = _engine(corpus, n_slots=2)
    eng.telemetry.tracer = SpanTracer(jsonl_path=str(tmp_path / "s.jsonl"))
    held = []
    real = tserve._serve_step

    def step(*a):
        held.append({r.rid for r in eng.slot_req if r is not None})
        return real(*a)

    monkeypatch.setattr(tserve, "_serve_step", step)
    reqs = _requests(corpus, 5)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        eng.run(reqs)
        assert eng.tick() == 0                      # idle: no span
    eng.telemetry.tracer.close()
    assert [r.matches for r in reqs] == [r.matches for r in plain]
    n = eng.dispatches
    assert n == len(held) > 1 and eng.ticks == n + 1

    trace = tmp_path / "trace.json"
    prof.export_chrome_trace(str(trace))
    ev = sorted((e for e in json.loads(trace.read_text())["traceEvents"]
                 if e.get("cat") == "user_annotation"
                 and e["name"].startswith("serve.")), key=lambda e: e["ts"])
    ticks = [e for e in ev if e["name"] == "serve.tick"]
    assert len(ticks) == n
    for t in ticks:
        kids = [e["name"] for e in ev if e is not t
                and t["ts"] <= e["ts"] <= t["ts"] + t["dur"]]
        assert kids == TICK_CHILDREN

    recs = [json.loads(x) for x in
            (tmp_path / "s.jsonl").read_text().splitlines()]
    tick_recs = [r for r in recs if r["name"] == "serve.tick"]
    assert [(r["tick"], r["slots"]) for r in tick_recs] == \
        [(i, len(h)) for i, h in enumerate(held)]
    for r in recs:
        if r["name"] in TICK_CHILDREN:
            parent = next(t for t in tick_recs if t["id"] == r["parent"])
            assert r["path"] == "serve.tick/" + r["name"]
            assert parent["ts"] <= r["ts"]
    done = {r["rid"]: r for r in recs if r["name"] == "serve.request"}
    assert sorted(done) == [r.rid for r in reqs]
    for req in reqs:
        rec = done[req.rid]
        at = [i for i, h in enumerate(held) if req.rid in h]
        assert (rec["first_tick"], rec["last_tick"]) == (at[0], at[-1])
        assert at == list(range(at[0], at[-1] + 1))
        assert rec["dur_s"] == pytest.approx(req.latency_s, abs=1e-3)
        assert rec["queue_wait_s"] == req.queue_wait_s
        assert rec["parent"] is None


def test_request_records_keep_the_tracers_clock(corpus, tmp_path):
    """An engine on a clock of its own writes ``serve.request`` on the
    tracer's clock, where its ``serve.tick`` records lie."""
    from repro_torch.obsv.spans import SpanTracer
    fake = iter(range(1, 10**6))
    eng = _engine(corpus, n_slots=2, clock=lambda: float(next(fake)))
    eng.telemetry.tracer = SpanTracer(jsonl_path=str(tmp_path / "s.jsonl"))
    reqs = _requests(corpus, 3)
    eng.run(reqs)
    eng.telemetry.tracer.close()
    recs = [json.loads(x) for x in
            (tmp_path / "s.jsonl").read_text().splitlines()]
    ticks = [r for r in recs if r["name"] == "serve.tick"]
    done = [r for r in recs if r["name"] == "serve.request"]
    assert len(done) == len(reqs) and ticks
    for r in done:
        first = ticks[r["first_tick"]]
        last = ticks[r["last_tick"]]
        assert r["ts"] <= first["ts"]
        assert last["ts"] <= r["ts"] + r["dur_s"] <= \
            last["ts"] + last["dur_s"]


def test_lazy_state_queues_until_first_refresh(corpus):
    eng = tserve.ServeDetectEngine(corpus["cfg"], corpus["scfg"], n_slots=2,
                                   max_queue=8, device="cpu")
    reqs = _requests(corpus, 3)[:3]
    for r in reqs:
        eng.submit(r)
    assert eng.tick() == 0 and eng.pending() == 3
    with pytest.raises(RuntimeError, match="serving state"):
        eng.drain()
    det = corpus["port"]
    assert eng.refresh_from(det) is True
    assert eng.serving_version == det.serving_version
    assert eng.refresh_from(det) is False             # version-gated
    eng.drain()
    assert all(r.outcome == "served" for r in reqs)
    assert eng.telemetry.registry.total("serve_state_refreshes_total") == 1


def test_interleaved_session_serves_while_ingesting(corpus):
    cfg, scfg, ds = corpus["cfg"], corpus["scfg"], corpus["ds"]
    det = tengine.StreamingDetector(cfg, scfg, n_stations=2, device="cpu")
    eng = tserve.ServeDetectEngine(cfg, scfg, n_slots=2, max_queue=16,
                                   telemetry=det.telemetry, device="cpu")
    session = tserve.ServeSession(det, eng, refresh_every_chunks=2)
    reqs = _requests(corpus, 6)[:6]
    chunks = np.array_split(ds.waveforms, 12, axis=1)
    for ci, chunk in enumerate(chunks):
        if ci % 2 == 0 and reqs[ci // 2:]:
            session.submit(reqs[ci // 2])
        session.ingest(chunk)
    served_live = sum(1 for r in reqs if r.outcome == "served")
    session.finish()
    assert all(r.done for r in reqs)
    assert sum(1 for r in reqs if r.outcome == "served") == 6
    assert session.refreshes >= 2
    assert eng.serving_version == det.serving_version
    assert served_live >= 1
    for r in reqs:
        assert r.latency_s >= r.service_s >= 0.0
        assert abs(r.latency_s - (r.queue_wait_s + r.service_s)) < 1e-6
    assert det.metrics_snapshot()["serve"]["served"] == 6


def test_empty_request_list_summary(corpus):
    stats = _engine(corpus, n_slots=2).run([])
    assert stats["requests"] == 0 and stats["served"] == 0
    assert stats["latency_ms_p50"] == 0.0 and stats["latency_ms_p99"] == 0.0


def test_all_shed_summary_has_no_percentile_crash(corpus):
    eng = _engine(corpus, n_slots=2, max_queue=0)
    reqs = _requests(corpus, 4)
    for r in reqs:
        eng.submit(r)
    stats = eng.summary(reqs, 1.0)
    assert stats["shed"] == len(reqs) and stats["served"] == 0
    assert stats["latency_ms_p50"] == 0.0


def test_unfinished_request_latency_is_guarded():
    r = tserve.QueryRequest(rid=0, window=np.zeros(16, np.float32))
    r.t_submit = 123.456
    assert r.latency_s == 0.0
    assert r.queue_wait_s == 0.0 and r.service_s == 0.0
    r.t_admit = 124.0
    assert r.service_s == 0.0
    r.t_done = 125.0
    assert r.latency_s > 0.0 and r.service_s > 0.0


def test_pool_serving_state_returns_copies(corpus):
    """The pooled step updates the pool in place: a serving state taken
    before further pushes must not change under them."""
    cfg, scfg, ds = corpus["cfg"], corpus["scfg"], corpus["ds"]
    det = tengine.StreamingDetector(cfg, scfg, n_stations=2, device="cpu")
    half = ds.waveforms.shape[1] // 2
    for start in range(0, half, 1000):
        det.push(ds.waveforms[:, start: start + 1000])
    assert det.pstate is not None
    state, med, mad = det.pool_serving_state()
    before = {k: v.copy() for k, v in _leaves(state).items()}
    v0 = det.serving_version
    for start in range(half, ds.waveforms.shape[1], 1000):
        det.push(ds.waveforms[:, start: start + 1000])
    assert det.serving_version > v0
    for k, v in _leaves(state).items():
        np.testing.assert_array_equal(v, before[k], err_msg=k)
    assert not torch.equal(state.ids, det.pstate.index.ids)
    assert med.data_ptr() != det.pstate.med.data_ptr()


def test_pool_serving_state_needs_frozen_statistics(corpus):
    det = tengine.StreamingDetector(corpus["cfg"], corpus["scfg"],
                                    n_stations=2, device="cpu")
    with pytest.raises(RuntimeError, match="frozen"):
        det.pool_serving_state()


def test_serve_configs_equal_the_references():
    for name in ("serve_config", "serve_smoke_config"):
        assert dataclasses.asdict(getattr(tfast, name)()) == \
            dataclasses.asdict(getattr(jfast, name)())


# ---------------------------------------------------------------------------
# the entry point
# ---------------------------------------------------------------------------


def test_main_on_the_cpu_prints_a_result_with_hits(capsys):
    stats = tserve.main(["--requests", "4", "--slots", "2",
                         "--duration-s", "400", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    result = [ln for ln in out if ln.startswith("RESULT ")]
    assert len(result) == 1
    assert json.loads(result[0][len("RESULT "):])["served"] == 4
    assert stats["hit_requests"] >= 1
    assert any(ln.startswith("# ingest quality ") for ln in out)


def test_restore_validates_station_count(tmp_path):
    det = tengine.StreamingDetector(tfast.smoke_config(),
                                    tfast.stream_smoke_config(),
                                    n_stations=3, device="cpu")
    det.snapshot(str(tmp_path), step=1)
    with pytest.raises(SystemExit, match="3-station.*--stations 2"):
        tserve.main(["--restore", "--snapshot-dir", str(tmp_path),
                     "--stations", "2", "--duration-s", "400",
                     "--device", "cpu"])


def test_snapshot_then_restore_serves_the_same_index(tmp_path, capsys):
    """The restartable-serving recipe: snapshot while ingesting, then
    resume from it; the resumed run re-ingests only the tail and serves
    the same answers as the uninterrupted run."""
    base = ["--requests", "3", "--slots", "2", "--duration-s", "400",
            "--device", "cpu", "--snapshot-dir", str(tmp_path)]
    first = tserve.main(base + ["--snapshot-every", "4"])
    resumed = tserve.main(base + ["--restore"])
    out = capsys.readouterr().out
    assert "# restored step 16: 40000 samples already ingested" in out
    for k in ("served", "hit_requests", "stations"):
        assert resumed[k] == first[k], k


def test_metrics_file_written_without_metrics_every(tmp_path):
    prom = tmp_path / "serve.prom"
    stats = tserve.main(["--requests", "2", "--slots", "2",
                         "--duration-s", "400", "--device", "cpu",
                         "--metrics-file", str(prom)])
    assert stats["served"] == 2
    text = prom.read_text()
    assert "repro_chunks_total" in text
    assert "repro_real_time_factor" in text
    assert not (tmp_path / "serve.prom.tmp").exists()


PKGS = {"ref": (jserve, jfast, jengine), "port": (tserve, tfast, tengine)}


def _grow(pkg, tmp_path):
    """``tests/test_serve.py::test_restore_grows_pool_elastically`` in
    ``pkg``: a 2-station snapshot restored with ``--stations 3``."""
    serve, fast, engine = PKGS[pkg]
    cfg, scfg = fast.smoke_config(), fast.stream_smoke_config()
    ds = jsynth.make_dataset(jsynth.SynthConfig(
        duration_s=400.0, n_stations=2, n_sources=1, events_per_source=3,
        event_snr=3.0, seed=5))
    kw = {} if pkg == "ref" else {"device": "cpu"}
    det = engine.StreamingDetector(cfg, scfg, n_stations=2, **kw)
    for start in range(0, ds.waveforms.shape[1], 6000):
        det.push(ds.waveforms[:, start:start + 6000])
    assert det.pstate is not None
    det.snapshot(str(tmp_path), step=1)
    argv = ["--restore", "--snapshot-dir", str(tmp_path), "--stations",
            "3", "--requests", "2", "--slots", "2", "--duration-s", "400"]
    return serve.main(argv + ([] if pkg == "ref" else ["--device", "cpu"]))


def test_restore_grows_pool_as_the_reference(tmp_path, capsys):
    got = _grow("port", tmp_path / "port")
    assert "# restored pool grown 2 -> 3 stations" in capsys.readouterr().out
    want = _grow("ref", tmp_path / "ref")
    assert got["stations"] == want["stations"] == 3
    for k in ("requests", "served", "shed", "ticks", "hit_requests",
              "ingest_quality"):
        assert got[k] == want[k], k


def _alert_lines(text: str) -> list:
    return [json.loads(ln[len("ALERT "):]) for ln in text.splitlines()
            if ln.startswith("ALERT ")]


def test_locate_serving_matches_reference(capsys):
    got = tserve.main(["--locate", "--device", "cpu"])
    got_alerts = _alert_lines(capsys.readouterr().out)
    want = jserve.main(["--locate"])
    want_alerts = _alert_lines(capsys.readouterr().out)
    assert got["located"] == want["located"]
    assert got_alerts == want_alerts and got["located"]["alerts"] >= 1
    assert got["located"]["located"] >= 1
    for k in ("served", "hit_requests", "stations", "ingest_quality"):
        assert got[k] == want[k], k
