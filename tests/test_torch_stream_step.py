"""The port's streaming step and its host-side companions against the JAX
package, on the CPU.

``fused.pool_step_advance`` / ``step_advance`` (the streaming steady
state: device halo + new samples) and the unfused ``engine.stream_step``
are held bit-exact against the reference's entries on the same halo,
samples and statistics at smoke widths — pairs, QC vector, index state and
halo — with the guards and the verify epilogue off and on; the port's
advance route is held against its own block route over consecutive
blocks; the pool helpers (``init_pool``, ``slice_state``,
``index_stats``) and the telemetry primitives (metrics registry, step
watchdog, span tracer, drop views) against the reference's.
"""
import _torch_threads  # noqa: F401  (one torch thread a process)
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fingerprint as jfp
from repro.core import lsh as jlsh
from repro.core import synth as jsynth
from repro.obsv import metrics as jmetrics
from repro.obsv import spans as jspans
from repro.stream import engine as jengine
from repro.stream import fused as jfused
from repro.stream import index as jidx
from repro.stream import telemetry as jtele
from repro.train import watchdog as jwd
from repro_torch import convert
from repro_torch.core import fingerprint as tfp
from repro_torch.core import lsh as tlsh
from repro_torch.obsv import metrics as tmetrics
from repro_torch.obsv import spans as tspans
from repro_torch.stream import engine as tengine
from repro_torch.stream import fused as tfused
from repro_torch.stream import index as tidx
from repro_torch.stream import telemetry as ttele
from repro_torch.train import watchdog as twd

FKW = dict(img_freq=16, img_time=32, img_hop=8, top_k=64, mad_sample_rate=1.0)
LKW = dict(n_tables=20, n_funcs=4, n_matches=2, bucket_cap=4, min_dt=4,
           occurrence_frac=0.05)
IKW = dict(n_buckets=256, bucket_cap=8, occ_slots=2048, pk_slots=2048,
           pk_words=32)
BLOCK = 32
KNOBS = {
    "plain": dict(counters=1),
    "guards": dict(window=96, saturation=12, dup_tables=14, occ_limit=40,
                   counters=1, max_pairs=128, verify=1),
}


@pytest.fixture(scope="module")
def data():
    """A 2-station smoke trace with repeats: station 0 copies a data block
    sample-exactly, station 1 carries a pulse train; reference statistics
    per station."""
    ds = jsynth.make_dataset(jsynth.SynthConfig(
        duration_s=400.0, n_stations=2, n_sources=2, events_per_source=4,
        event_snr=4.0, seed=7))
    wf = ds.waveforms.copy()
    wf[0, 14000:18000] = wf[0, 3000:7000]
    pulse = np.zeros(200, np.float32)
    pulse[:60] = 20 * np.sin(np.arange(60) * 0.5)
    wf[1, 8000:14000] = np.tile(pulse, 30)
    jc = jfp.FingerprintConfig(**FKW)
    meds, mads = [], []
    for st in range(2):
        coeffs = jfp.coeffs_from_waveform(jnp.asarray(wf[st]), jc)
        med, mad = jfp.mad_stats(coeffs, 1.0, jax.random.PRNGKey(0))
        meds.append(np.array(med))
        mads.append(np.array(mad))
    return {"waveforms": wf, "med": meds, "mad": mads}


def _cfgs():
    return (jfp.FingerprintConfig(**FKW), tfp.FingerprintConfig(**FKW),
            jlsh.LSHConfig(**LKW), tlsh.LSHConfig(**LKW))


def _eq(port, ref, what="") -> None:
    ref = np.asarray(ref)
    got = port.cpu().numpy()
    if ref.dtype == np.uint32:
        got = got.view(np.uint32)
    np.testing.assert_array_equal(got, ref, err_msg=what)


def _leaves(state) -> dict:
    return {f.name: np.array(getattr(state, f.name))
            for f in dataclasses.fields(state)}


def _state_eq(port: tidx.IndexState, refs: list) -> None:
    got = convert.index_state_to_numpy(port)
    for st, ref in enumerate(refs):
        for name, want in _leaves(ref).items():
            np.testing.assert_array_equal(got[name][st], want, err_msg=name)


def _pairs_eq(tp, jp) -> None:
    for f in dataclasses.fields(jp):
        _eq(getattr(tp, f.name), getattr(jp, f.name), f.name)


def _states(data, jc, jl, solo=False):
    icfg = jidx.StreamIndexConfig(**IKW)
    if solo:
        j = jfused.init_state(jidx.init_index(jl, icfg), jc.halo_samples,
                              data["med"][0], data["mad"][0])
    else:
        j = jfused.init_pool_state([jidx.init_index(jl, icfg)] * 2,
                                   jc.halo_samples, data["med"], data["mad"])
    t = convert.fused_state({"index": _leaves(j.index),
                             "halo": np.array(j.halo),
                             "med": np.array(j.med),
                             "mad": np.array(j.mad)}, "cpu")
    return j, t


def _block(data, jc, base, station=slice(None)):
    start = base * jc.lag_samples
    bs = jc.block_samples(BLOCK)
    assert start + bs <= data["waveforms"].shape[1]
    return np.ascontiguousarray(data["waveforms"][station, start:start + bs])


@pytest.mark.parametrize("knobs", KNOBS, ids=str)
def test_pool_step_advance_bit_exact(data, knobs):
    """Seed with the block entry, then four advance steps: every step's
    pairs, qc, index state and halo equal the reference's."""
    jc, tc, jl, tl = _cfgs()
    kw = KNOBS[knobs]
    jstate, tstate = _states(data, jc, jl)
    jmap = jlsh.hash_mappings(jc.fp_dim, jl)
    tmap = tlsh.hash_mappings(tc.fp_dim, tl, "cpu")
    blk = _block(data, jc, 0)
    valid = np.ones((2, BLOCK), bool)
    jstate, _, _ = jfused.pool_step_block(jstate, jnp.asarray(blk), jmap,
                                          jnp.int32(0), jnp.asarray(valid),
                                          jc, jl, **kw)
    tstate, _, _ = tfused.pool_step_block(tstate, torch.from_numpy(blk),
                                          tmap, 0, torch.from_numpy(valid),
                                          tc, tl, **kw)
    emitted = 0
    adv = BLOCK * jc.lag_samples
    for k in range(1, 5):
        new = np.ascontiguousarray(_block(data, jc, k * BLOCK)[:, -adv:])
        jstate, jpairs, jqc = jfused.pool_step_advance(
            jstate, jnp.asarray(new), jmap, jnp.int32(k * BLOCK), jc, jl,
            **kw)
        tstate, tpairs, tqc = tfused.pool_step_advance(
            tstate, torch.from_numpy(new), tmap, k * BLOCK, tc, tl, **kw)
        _pairs_eq(tpairs, jpairs)
        _eq(tqc, jqc, "qc")
        _eq(tstate.halo, jstate.halo, "halo")
        _state_eq(tstate.index, [jax.tree.map(lambda x, s=s: x[s],
                                              jstate.index)
                                 for s in range(2)])
        emitted += int(tqc[:, 3].sum())
    assert emitted > 0


@pytest.mark.parametrize("knobs", KNOBS, ids=str)
def test_step_advance_bit_exact_one_station(data, knobs):
    jc, tc, jl, tl = _cfgs()
    kw = KNOBS[knobs]
    jstate, tstate = _states(data, jc, jl, solo=True)
    jmap = jlsh.hash_mappings(jc.fp_dim, jl)
    tmap = tlsh.hash_mappings(tc.fp_dim, tl, "cpu")
    # the first advance starts from the zero halo, as after init_state
    for k in range(3):
        new = np.ascontiguousarray(
            _block(data, jc, k * BLOCK, 0)[-BLOCK * jc.lag_samples:])
        jstate, jpairs, jqc = jfused.step_advance(
            jstate, jnp.asarray(new), jmap, jnp.int32(k * BLOCK), jc, jl,
            **kw)
        tstate, tpairs, tqc = tfused.step_advance(
            tstate, torch.from_numpy(new), tmap, k * BLOCK, tc, tl, **kw)
        _pairs_eq(tpairs, jpairs)
        _eq(tqc, jqc, "qc")
        _eq(tstate.halo[0], jstate.halo, "halo")
        _state_eq(tstate.index, [jstate.index])


@pytest.mark.parametrize("knobs", KNOBS, ids=str)
def test_advance_route_equals_block_route(data, knobs):
    """The port against itself: after one seeding block, advancing with
    the new samples gives the block route's pairs, qc and state."""
    _, tc, _, tl = _cfgs()
    kw = KNOBS[knobs]
    icfg = tidx.StreamIndexConfig(**IKW)
    tmap = tlsh.hash_mappings(tc.fp_dim, tl, "cpu")
    states = [tfused.init_pool_state(
        [tidx.init_index(tl, icfg, 2, "cpu")], tc.halo_samples,
        data["med"], data["mad"]) for _ in range(2)]
    valid = torch.ones((2, BLOCK), dtype=torch.bool)
    adv, blk = states
    for k in range(5):
        block = torch.from_numpy(_block(data, tc, k * BLOCK))
        blk, bp, bq = tfused.pool_step_block(blk, block, tmap, k * BLOCK,
                                             valid, tc, tl, **kw)
        if k == 0:
            adv, ap, aq = tfused.pool_step_block(adv, block, tmap, 0, valid,
                                                 tc, tl, **kw)
        else:
            new = block[:, -BLOCK * tc.lag_samples:].contiguous()
            adv, ap, aq = tfused.pool_step_advance(adv, new, tmap,
                                                   k * BLOCK, tc, tl, **kw)
        assert torch.equal(aq, bq)
        for f in dataclasses.fields(bp):
            assert torch.equal(getattr(ap, f.name), getattr(bp, f.name))
        assert torch.equal(adv.halo, blk.halo)
        for f in dataclasses.fields(adv.index):
            assert torch.equal(getattr(adv.index, f.name),
                               getattr(blk.index, f.name)), f.name


@pytest.mark.parametrize("knobs", KNOBS, ids=str)
def test_stream_step_bit_exact(data, knobs):
    """The unfused chain, one station, fed the reference's coefficients:
    pairs, qc and state equal, masked block included."""
    jc, tc, jl, tl = _cfgs()
    kw = KNOBS[knobs]
    icfg = jidx.StreamIndexConfig(**IKW)
    jstate = jidx.init_index(jl, icfg)
    tstate = convert.index_state({k: v[None] for k, v in
                                  _leaves(jstate).items()}, "cpu")
    jmap = jlsh.hash_mappings(jc.fp_dim, jl)
    tmap = tlsh.hash_mappings(tc.fp_dim, tl, "cpu")
    med, mad = data["med"][0], data["mad"][0]
    for k in range(4):
        coeffs = np.array(jengine.block_coeffs(
            jnp.asarray(_block(data, jc, k * BLOCK, 0)), jc))
        valid = np.ones(BLOCK, bool)
        if k == 2:
            valid[5:20] = False
        jstate, jpairs, jqc = jengine.stream_step(
            jstate, jnp.asarray(coeffs), jnp.asarray(med), jnp.asarray(mad),
            jmap, jnp.int32(k * BLOCK), jnp.asarray(valid), jc, jl, **kw)
        tstate, tpairs, tqc = tengine.stream_step(
            tstate, torch.from_numpy(coeffs), torch.from_numpy(med),
            torch.from_numpy(mad), tmap, k * BLOCK, torch.from_numpy(valid),
            tc, tl, **kw)
        _pairs_eq(tpairs, jpairs)
        _eq(tqc, jqc, "qc")
        _state_eq(tstate, [jstate])


def test_block_coeffs_match_reference(data):
    jc, tc, _, _ = _cfgs()
    blocks = _block(data, jc, BLOCK)
    want = np.array(jengine.pool_block_coeffs(jnp.asarray(blocks), jc))
    got = tengine.pool_block_coeffs(torch.from_numpy(blocks), tc).numpy()
    tol = 1e-5 * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=tol)
    one = tengine.block_coeffs(torch.from_numpy(blocks[1]), tc).numpy()
    np.testing.assert_array_equal(one, got[1])


def test_pool_helpers_match_reference(rng):
    _, _, jl, tl = _cfgs()
    icfg = dict(n_buckets=64, bucket_cap=4)
    jpool = jidx.init_pool(jl, jidx.StreamIndexConfig(**icfg), 3)
    tpool = tidx.init_pool(tl, tidx.StreamIndexConfig(**icfg), 3, "cpu")
    _state_eq(tpool, [jax.tree.map(lambda x, s=s: x[s], jpool)
                      for s in range(3)])
    sigs = rng.integers(0, 2**32, (40, 20), dtype=np.uint32)
    sigs[20:] = sigs[:20]
    ids = np.arange(40, dtype=np.int32)
    one = jidx.insert(jidx.slice_state(jpool, 1), jnp.asarray(sigs),
                      jnp.asarray(ids), jl)
    view = tidx.slice_state(tpool, 1)
    assert view.n_stations == 1
    tidx.insert(view, torch.from_numpy(sigs.view(np.int32))[None],
                torch.from_numpy(ids), tl)
    _state_eq(view, [one])
    _state_eq(tidx.slice_state(tpool, 1), [one])    # a view of the pool
    assert tidx.index_stats(view) == jidx.index_stats(one)
    assert tidx.index_stats(tidx.slice_state(tpool, 0)) == \
        jidx.index_stats(jidx.slice_state(jpool, 0))
    with pytest.raises(ValueError, match="one station"):
        tidx.index_stats(tpool)


def test_init_state_takes_one_station_and_copies_stats(data):
    _, tc, _, tl = _cfgs()
    med = torch.from_numpy(data["med"][0].copy())
    st = tfused.init_state(tidx.init_index(tl, tidx.StreamIndexConfig(**IKW),
                                           1, "cpu"),
                           tc.halo_samples, med, data["mad"][0])
    assert st.halo.shape == (1, tc.halo_samples)
    med += 1.0
    assert not torch.equal(st.med[0], med)          # no aliasing
    with pytest.raises(ValueError):
        tfused.init_state(tidx.init_index(tl, tidx.StreamIndexConfig(**IKW),
                                          2, "cpu"),
                          tc.halo_samples, med, med)


def _record(reg):
    reg.counter("chunks_total", station="0").inc()
    reg.counter("chunks_total", station="1").inc(3)
    reg.counter("samples_total", station="0").set_total(7)
    reg.gauge("rtf").set(2.5)
    for v in (1e-6, 3e-4, 0.02, 0.02, 1.7, 400.0):
        reg.histogram("wall_seconds", station="pool").record(v)
        reg.histogram("wall_seconds", station="0").record(v / 3)


def test_metrics_registry_matches_reference():
    j, t = jmetrics.MetricsRegistry(), tmetrics.MetricsRegistry()
    _record(j)
    _record(t)
    assert t.render() == j.render()
    assert t.snapshot() == j.snapshot()
    assert t.total("chunks_total") == j.total("chunks_total") == 4
    assert (t.histogram_merged("wall_seconds").summary()
            == j.histogram_merged("wall_seconds").summary())
    back = tmetrics.MetricsRegistry()
    back.restore(j.snapshot())
    assert back.render() == j.render()
    counts = [{"a": 1, "b": 2}, {"b": 3, "c": 4}]
    assert tmetrics.merge_counts(counts) == jmetrics.merge_counts(counts)


def _ticks(times):
    it = iter(times)
    return lambda: next(it)


def test_watchdog_matches_reference():
    steps = [1.0, 1.1, 0.9, 1.0, 1.0, 1.0, 5.0, 1.0, 400.0, 1.0]
    clock = []
    t = 0.0
    for dt in steps:
        clock += [t, t + dt]
        t += dt + 1.0
    runs = []
    for mod in (jwd, twd):
        seen = []
        wd = mod.StepWatchdog(mod.WatchdogConfig(hang_timeout_s=300.0),
                              on_straggler=seen.append,
                              clock=_ticks(clock))
        for _ in steps:
            wd.step_start()
            wd.step_end()
        runs.append((wd.events, seen, wd.ema, wd.n))
    assert runs[0] == runs[1]
    assert [e["reason"] for e in runs[1][0]] == ["straggler", "hang"]


def test_span_tracer_matches_reference(tmp_path):
    recs = []
    for mod, name in ((jspans, "j.jsonl"), (tspans, "t.jsonl")):
        tr = mod.SpanTracer(jsonl_path=str(tmp_path / name),
                            clock=_ticks([0.0, 1.0, 1.5, 4.0, 5.0, 5.25]))
        with tr.span("ingest", station="pool"):
            with tr.span("fused_step", station=0):
                pass
        with tr.span("ingest"):
            pass
        tr.close()
        lines = [json.loads(x) for x in
                 (tmp_path / name).read_text().splitlines()]
        recs.append((lines, tr.summary(), tr.total_s("ingest")))
    # the reference's keys but ``ts``, with its values; the port's own
    # (``id``, ``parent``) are held in tests/test_torch_spans.py
    (ref, *ref_tot), (port, *port_tot) = recs
    assert len(port) == len(ref) and port_tot == ref_tot
    for p, r in zip(port, ref):
        assert {k: p[k] for k in r if k != "ts"} == \
            {k: v for k, v in r.items() if k != "ts"}
    assert recs[1][1] == {"ingest": {"count": 2, "total_s": 4.25},
                          "fused_step": {"count": 1, "total_s": 0.5}}


def test_telemetry_views_match_reference(rng):
    j, t = jtele.StreamTelemetry(2), ttele.StreamTelemetry(2)
    for step in range(5):
        for st in range(2):
            qc = rng.integers(0, 50, 8)
            j.record_step(st, qc)
            t.record_step(st, qc)
        j.record_chunk(step % 2, 0.01 * step, 6000)
        t.record_chunk(step % 2, 0.01 * step, 6000)
        j.record_fused_wall("pool", 0.002 * step)
        t.record_fused_wall("pool", 0.002 * step)
        j.record_host_tail("pool", 0.001)
        t.record_host_tail("pool", 0.001)
    assert t.drop_breakdown() == j.drop_breakdown()
    assert t.drop_rates() == j.drop_rates()
    assert t.registry.render() == j.registry.render()
    ring_q = {"gaps": 1, "gap_samples": 10}
    qc = {"duplicate_fingerprints": 2, "saturated_lookups": 0}
    assert ttele.quality_view(ring_q, qc) == jtele.quality_view(ring_q, qc)
