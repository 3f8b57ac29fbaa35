"""The port's sharded station pool on the CPU, against the JAX package.

The reference splits the pool over a ``stations`` mesh with a fully
manual ``shard_map``; the port drives one sub-pool a mesh device from one
process (``repro_torch.dist``). This jax cannot run the reference's own
sharded pool on forced host devices (its multi-device tests fail inside
the ``shard_map``), so the port's sharded path is held to what the
reference documents as bit-identical to it: its one-device ``vmap`` pool
(``pool_step_advance`` / ``pool_step_block``, the stream with
``sharded=False``). A mesh here names the CPU several times
(``[torch.device("cpu")] * k``), as a one-card machine names ``cuda:0``.

* the probe (``station_mesh``) and ``padded_pool_width``;
* ``pool_step_advance_sharded`` / ``pool_step_block_sharded`` at 4
  stations over a 3-wide mesh (2 pad rows): pairs, QC, halo and every
  index leaf equal the reference's pool entries; the delegation where S
  does not divide the mesh or there is no mesh;
* ``StreamingDetector`` under 2- and 3-wide meshes equals the port's
  unsharded stream and the reference's ``sharded=False`` stream; elastic
  add / remove under a mesh; a snapshot taken under one mesh width and
  restored under none or another; ``pool_serving_state``;
* ``detect_step_sharded`` against the reference's ``jax.vmap`` of
  ``detect_step`` (the body of its ``detect_step_sharded``);
* the configuration values (``SHAPES``, ``model_flops``,
  ``stream_sharded_smoke_config``, ``input_specs``).
"""
import _torch_threads  # noqa: F401  (one torch thread a process)
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import dist as jdist
from repro.configs import fast_seismic as jfast
from repro.core import detect as jdetect
from repro.core import fingerprint as jfp
from repro.core import lsh as jlsh
from repro.core import synth as jsynth
from repro.stream import engine as jengine
from repro.stream import fused as jfused
from repro.stream import index as jidx
from repro_torch import convert, dist
from repro_torch.configs import fast_seismic as tfast
from repro_torch.core import detect as tdetect
from repro_torch.core import fingerprint as tfp
from repro_torch.core import lsh as tlsh
from repro_torch.stream import engine as tengine
from repro_torch.stream import fused as tfused
from repro_torch.stream import index as tidx

CPU = torch.device("cpu")
SYNTH = dict(duration_s=600.0, n_sources=2, events_per_source=5,
             event_snr=3.0, seed=11)
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


def _mesh(k):
    return [CPU] * k


def _trace(n_stations):
    return jsynth.make_dataset(jsynth.SynthConfig(n_stations=n_stations,
                                                  **SYNTH)).waveforms


# -- the probe -----------------------------------------------------------


def test_station_mesh_probe():
    assert dist.station_mesh(devices=[CPU]) is None
    assert dist.station_mesh(1, devices=_mesh(3)) is None
    assert dist.station_mesh(4, devices=[]) is None
    mesh = dist.station_mesh(2, devices=_mesh(3))
    assert mesh.devices == (CPU, CPU) and mesh.axis == "stations"
    assert dist.station_mesh(5, devices=_mesh(3)).shape == {"stations": 3}
    assert dist.station_mesh(devices=["cpu"] * 4).size == 4
    if not torch.cuda.is_available():       # the default probes the cards
        assert dist.station_mesh(8) is None
    assert dist.STATION_AXIS == jdist.STATION_AXIS


@pytest.mark.parametrize("width", [1, 2, 3, 4])
def test_padded_pool_width_matches_reference(width):
    mesh = dist.StationMesh((CPU,) * width)
    for s in range(1, 10):
        want = jdist.padded_pool_width(s, mesh)   # reads mesh.shape only
        assert dist.padded_pool_width(s, mesh) == want
        assert want % width == 0 and s <= want < s + width
        assert dist.padded_pool_width(s, None) == s


# -- the sharded entries ---------------------------------------------------


@pytest.fixture(scope="module")
def data():
    """A 4-station smoke trace with repeats (station 0 copies a block
    sample-exactly, station 1 carries a pulse train) and each station's
    reference statistics."""
    wf = jsynth.make_dataset(jsynth.SynthConfig(
        duration_s=400.0, n_stations=4, n_sources=2, events_per_source=4,
        event_snr=4.0, seed=7)).waveforms.copy()
    wf[0, 14000:18000] = wf[0, 3000:7000]
    pulse = np.zeros(200, np.float32)
    pulse[:60] = 20 * np.sin(np.arange(60) * 0.5)
    wf[1, 8000:14000] = np.tile(pulse, 30)
    jc = jfp.FingerprintConfig(**FKW)
    meds, mads = [], []
    for st in range(4):
        coeffs = jfp.coeffs_from_waveform(jnp.asarray(wf[st]), jc)
        med, mad = jfp.mad_stats(coeffs, 1.0, jax.random.PRNGKey(0))
        meds.append(np.array(med))
        mads.append(np.array(mad))
    return {"waveforms": wf, "med": meds, "mad": mads}


def _states(data, pad):
    """The reference's 4-station pool and the port's, the port's with
    ``pad`` pad rows (a fresh index, station 0's statistics)."""
    jc, jl = jfp.FingerprintConfig(**FKW), jlsh.LSHConfig(**LKW)
    icfg = jidx.StreamIndexConfig(**IKW)
    j = jfused.init_pool_state([jidx.init_index(jl, icfg)] * 4,
                               jc.halo_samples, data["med"], data["mad"])
    meds = data["med"] + [data["med"][0]] * pad
    mads = data["mad"] + [data["mad"][0]] * pad
    p = jfused.init_pool_state([jidx.init_index(jl, icfg)] * (4 + pad),
                               jc.halo_samples, meds, mads)
    leaves = {f.name: np.array(getattr(p.index, f.name))
              for f in dataclasses.fields(p.index)}
    t = convert.fused_state({"index": leaves, "halo": np.array(p.halo),
                             "med": np.array(p.med), "mad": np.array(p.mad)},
                            "cpu")
    return j, t


def _block(data, base, pad=0):
    jc = jfp.FingerprintConfig(**FKW)
    start = base * jc.lag_samples
    blk = data["waveforms"][:, start:start + jc.block_samples(BLOCK)]
    return np.concatenate([blk, np.zeros((pad, blk.shape[1]), np.float32)])


def _same(port, ref, what):
    ref = np.asarray(ref)
    got = port.cpu().numpy()
    if ref.dtype == np.uint32:
        got = got.view(np.uint32)
    np.testing.assert_array_equal(got[:ref.shape[0]], ref, err_msg=what)


def _same_step(shards, pairs, qc, jstate, jpairs, jqc):
    for f in dataclasses.fields(jpairs):
        _same(getattr(pairs, f.name), getattr(jpairs, f.name), f.name)
    _same(qc, jqc, "qc")
    _same(torch.cat([s.halo for s in shards]), jstate.halo, "halo")
    got = convert.index_state_to_numpy(
        tidx.stack_states([s.index for s in shards]))
    for f in dataclasses.fields(jstate.index):
        np.testing.assert_array_equal(
            got[f.name][:4], np.array(getattr(jstate.index, f.name)),
            err_msg=f.name)


@pytest.mark.parametrize("knobs", KNOBS, ids=str)
def test_sharded_entries_equal_reference_pool(data, knobs):
    """A seeding block, then four advance steps and a masked block, all
    through the sharded entries at 4 stations over a 3-wide mesh (2 pad
    rows): every step's pairs, qc, halo and index leaves of the 4
    stations equal the reference's ``pool_step_block`` /
    ``pool_step_advance`` on its unpadded pool."""
    jc, jl = jfp.FingerprintConfig(**FKW), jlsh.LSHConfig(**LKW)
    tc, tl = tfp.FingerprintConfig(**FKW), tlsh.LSHConfig(**LKW)
    kw = KNOBS[knobs]
    mesh = dist.station_mesh(6, devices=_mesh(3))
    jstate, tstate = _states(data, pad=2)
    jmap = jlsh.hash_mappings(jc.fp_dim, jl)
    tmap = dist.replicate(tlsh.hash_mappings(tc.fp_dim, tl, "cpu"), mesh)
    valid = np.ones((6, BLOCK), bool)
    valid[4:] = False
    jstate, jpairs, jqc = jfused.pool_step_block(
        jstate, jnp.asarray(_block(data, 0)), jmap, jnp.int32(0),
        jnp.asarray(valid[:4]), jc, jl, **kw)
    with pytest.raises(TypeError, match="split_rows"):
        tfused.pool_step_block_sharded(
            tstate, torch.from_numpy(_block(data, 0, 2)), tmap, 0,
            torch.from_numpy(valid), tc, tl, **kw, mesh=mesh)
    shards, pairs, qc = tfused.pool_step_block_sharded(
        dist.split_rows(tstate, mesh),
        dist.put_rows(_block(data, 0, 2), mesh), tmap, 0,
        dist.put_rows(valid, mesh), tc, tl, **kw, mesh=mesh)
    assert isinstance(shards, list) and len(shards) == 3
    assert pairs.valid.device == CPU and qc.shape == (6, 8)
    _same_step(shards, pairs, qc, jstate, jpairs, jqc)
    adv = BLOCK * jc.lag_samples
    emitted = 0
    for k in range(1, 5):
        new = np.ascontiguousarray(_block(data, k * BLOCK, 2)[:, -adv:])
        jstate, jpairs, jqc = jfused.pool_step_advance(
            jstate, jnp.asarray(new[:4]), jmap, jnp.int32(k * BLOCK), jc,
            jl, **kw)
        # placed by rows from the host, as the detector places them, or
        # split from a tensor
        put = (dist.put_rows(new, mesh) if k % 2
               else dist.split_rows(torch.from_numpy(new), mesh))
        shards, pairs, qc = tfused.pool_step_advance_sharded(
            shards, put, tmap, k * BLOCK, tc, tl, **kw, mesh=mesh)
        _same_step(shards, pairs, qc, jstate, jpairs, jqc)
        emitted += int(qc[:4, 3].sum())
    assert emitted > 0
    masked = valid.copy()
    masked[2, 5:20] = False
    jstate, jpairs, jqc = jfused.pool_step_block(
        jstate, jnp.asarray(_block(data, 5 * BLOCK)), jmap,
        jnp.int32(5 * BLOCK), jnp.asarray(masked[:4]), jc, jl, **kw)
    shards, pairs, qc = tfused.pool_step_block_sharded(
        shards, dist.put_rows(_block(data, 5 * BLOCK, 2), mesh), tmap,
        5 * BLOCK, dist.put_rows(masked, mesh), tc, tl, **kw, mesh=mesh)
    _same_step(shards, pairs, qc, jstate, jpairs, jqc)


@pytest.mark.parametrize("devices", [None, [CPU], _mesh(3)],
                         ids=["no_mesh", "width_1", "width_3_of_4"])
def test_sharded_entries_delegate_as_the_reference(data, devices):
    """No mesh, a 1-wide mesh, or 4 rows on a 3-wide mesh: the sharded
    entries run the one-device pool entries (a whole ``FusedState`` comes
    back, pairs on the pool's device) and give their bits."""
    tc, tl = tfp.FingerprintConfig(**FKW), tlsh.LSHConfig(**LKW)
    mesh = (None if devices is None
            else dist.StationMesh(tuple(devices)))
    tmap = tlsh.hash_mappings(tc.fp_dim, tl, "cpu")
    valid = torch.ones((4, BLOCK), dtype=torch.bool)
    outs = []
    for sharded in (True, False):
        _, state = _states(data, pad=0)
        for k in range(2):
            blk = torch.from_numpy(_block(data, k * BLOCK))
            if sharded:
                state, pairs, qc = tfused.pool_step_block_sharded(
                    state, blk, tmap, k * BLOCK, valid, tc, tl,
                    **KNOBS["guards"], mesh=mesh)
                assert isinstance(state, tfused.FusedState)
            else:
                state, pairs, qc = tfused.pool_step_block(
                    state, blk, tmap, k * BLOCK, valid, tc, tl,
                    **KNOBS["guards"])
        outs.append((state, pairs, qc))
    (a, pa, qa), (b, pb, qb) = outs
    assert torch.equal(qa, qb)
    for f in dataclasses.fields(pa):
        assert torch.equal(getattr(pa, f.name), getattr(pb, f.name))
    for f in dataclasses.fields(a.index):
        assert torch.equal(getattr(a.index, f.name),
                           getattr(b.index, f.name))
    with pytest.raises(ValueError, match="needs its mesh"):
        tfused.pool_step_block_sharded([a], blk, tmap, 0, valid, tc, tl,
                                       mesh=None)


# -- the detector ------------------------------------------------------------


def _stream(pkg, n_stations, devices=None, cfg="smoke_config",
            scfg="stream_bounded_smoke_config", upto=None, det=None,
            start=0):
    wf = _trace(n_stations)
    if det is None:
        if pkg == "ref":
            det = jengine.StreamingDetector(
                jfast.smoke_config(), dataclasses.replace(
                    getattr(jfast, scfg)(), sharded=False),
                n_stations=n_stations)
        else:
            det = tengine.StreamingDetector(
                getattr(tfast, cfg)(), getattr(tfast, scfg)(),
                n_stations=n_stations, device="cpu", devices=devices)
    starts = list(range(0, wf.shape[1], 6000))
    for a in starts[start:upto]:
        det.push(wf[:, a:a + 6000])
    return det


def _result(det):
    dets, _, _ = det.finalize()
    dets = {k: np.asarray(v.cpu() if isinstance(v, torch.Tensor) else v)
            for k, v in dets.items()}
    alerts = [np.asarray(a).tolist() for a in det.alerts]
    return dets, alerts, [int(st.stats.pairs) for st in det.stations]


def _equal(a, b):
    assert a[0].keys() == b[0].keys()
    for k in a[0]:
        np.testing.assert_array_equal(a[0][k], b[0][k], err_msg=k)
    assert a[1] == b[1] and a[2] == b[2]


@pytest.fixture(scope="module")
def unsharded():
    """The 4-station bounded smoke stream: the reference's with
    ``sharded=False``, and the port's without a mesh."""
    return {"ref": _result(_stream("ref", 4)),
            "port": _result(_stream("port", 4))}


@pytest.mark.parametrize("width,pad", [(2, 0), (3, 2)])
def test_sharded_stream_equals_the_one_device_pool(unsharded, width, pad):
    det = _stream("port", 4, _mesh(width))
    assert det.mesh.size == width and det.pool_pad == pad
    assert isinstance(det.pstate, list) and len(det.pstate) == width
    assert all(s.halo.shape[0] == (4 + pad) // width for s in det.pstate)
    got = _result(det)
    _equal(got, unsharded["port"])
    _equal(got, unsharded["ref"])
    _equal(unsharded["port"], unsharded["ref"])
    assert sum(got[2]) > 0 and got[0]["valid"].sum() > 0


def test_sharded_pool_serving_state_equals_unsharded():
    """Under a 3-wide mesh with 2 pad rows the serving copy is the 4 real
    stations gathered onto the detector's device, equal to the unsharded
    pool's, and it survives later pushes."""
    a, b = _stream("port", 4, _mesh(3), upto=6), _stream("port", 4, upto=6)
    sa, sb = a.pool_serving_state(), b.pool_serving_state()
    assert sa[0].n_stations == 4 and sa[1].shape[0] == 4
    for x, y in zip((sa[1], sa[2]), (sb[1], sb[2])):
        assert torch.equal(x, y)
    before = sa[0].ids.clone()
    for f in dataclasses.fields(sa[0]):
        assert torch.equal(getattr(sa[0], f.name), getattr(sb[0], f.name))
    _stream("port", 4, det=a, start=6, upto=8)
    assert torch.equal(sa[0].ids, before)
    assert not torch.equal(a.pool_serving_state()[0].ids, before)


def _elastic(pkg, devices=None):
    """The reference's ``test_elastic_add_remove_station`` sequence; the
    port's under ``devices``, with the pad rows at each width."""
    engine, fast = ((jengine, jfast) if pkg == "ref"
                    else (tengine, tfast))
    cfg, scfg = fast.latency_config(), fast.stream_latency_smoke_config()
    if pkg == "ref":
        scfg = dataclasses.replace(scfg, sharded=False)
    kw = {} if pkg == "ref" else {"device": "cpu", "devices": devices}
    rng = np.random.default_rng(3)
    chunk = scfg.block_fingerprints * cfg.fingerprint.lag_samples
    det = engine.StreamingDetector(cfg, scfg, n_stations=2, **kw)
    pads = []

    def width():
        pads.append((det.pool_pad, det.mesh.size if det.mesh else None))

    with pytest.raises(ValueError, match="live pool"):
        det.add_station()
    for _ in range(scfg.stats_warmup_blocks + 4):
        det.push(rng.standard_normal((2, chunk)).astype(np.float32))
    width()
    assert det.add_station() == 2 and len(det.stations) == 3
    width()
    for _ in range(4):
        det.push(rng.standard_normal((3, chunk)).astype(np.float32))
    det.remove_station(1)
    width()
    assert [st._pool_idx for st in det.stations] == [0, 1]
    for _ in range(2):
        det.push(rng.standard_normal((2, chunk)).astype(np.float32))
    with pytest.raises(ValueError, match="last station"):
        det.remove_station(0), det.remove_station(0)
    width()                                 # one station: no mesh
    _, _, stats = det.finalize()
    for s in stats["ingest"]:
        for k in ("wall_s", "chunk_ms_p50", "chunk_ms_p95", "chunks_per_s",
                  "samples_per_s"):
            s.pop(k)
    return stats, pads


def test_elastic_add_remove_under_a_mesh():
    """Width 2 → 3 → 2 → 1 under a 2-wide mesh: the pool is re-probed,
    re-padded (0, 1, 0 pad rows) and re-split at each width, and the
    per-station stats equal the reference's and the port's unsharded
    run's."""
    got, pads = _elastic("port", _mesh(2))
    assert pads == [(0, 2), (1, 2), (0, 2), (0, None)]
    want, ref_pads = _elastic("ref")
    assert ref_pads == [(0, None)] * 4
    assert got == want


def test_snapshot_across_mesh_widths(unsharded, tmp_path):
    """``test_mesh_elastic_snapshot_roundtrip`` at 4 stations: snapshotted
    halfway under a 3-wide mesh (2 pad rows), restored with no mesh and
    under a 2-wide mesh, each finishes equal to the reference's
    uninterrupted run (the 3-wide run itself is
    ``test_sharded_stream_equals_the_one_device_pool``)."""
    wf = _trace(4)
    half = len(range(0, wf.shape[1], 6000)) // 2
    det = _stream("port", 4, _mesh(3), upto=half)
    assert det.pool_pad == 2
    det.snapshot(str(tmp_path))
    ref = unsharded["ref"]
    for devices, width in ((None, None), (_mesh(2), 2)):
        restored, step = tengine.StreamingDetector.restore(
            str(tmp_path), tfast.smoke_config(),
            tfast.stream_bounded_smoke_config(), device="cpu",
            devices=devices)
        assert step == half
        assert (restored.mesh.size if restored.mesh else None) == width
        assert restored.pool_pad == 0
        _equal(_result(_stream("port", 4, det=restored, start=half)), ref)


def test_a_mesh_device_that_cannot_take_a_shard_raises():
    """No silent fall back to one device: a mesh naming a device that
    cannot hold its shard fails when the pool is built."""
    if torch.cuda.is_available():
        pytest.skip("needs a machine without CUDA for the unusable device")
    with pytest.raises((RuntimeError, AssertionError)):
        _stream("port", 4, [CPU, torch.device("cuda", 0)])


# -- detect_step_sharded and the configuration --------------------------------


def test_detect_step_sharded_equals_reference_vmap():
    """4 smoke chunks over a 2-wide mesh, in two pooled calls and in one:
    every output equals the reference's ``jax.vmap(detect_step)`` over the
    same chunks, exactly. That ``vmap`` is the body of the reference's
    ``detect_step_sharded`` (its ``shard_map`` adds only the split), which
    this jax cannot run on a mesh of forced host devices."""
    ds = jsynth.make_dataset(jsynth.SynthConfig(
        duration_s=600.0, n_stations=1, n_sources=2, events_per_source=10,
        event_snr=3.0, seed=11, repeating_noise_stations=(0,)))
    chunks = np.ascontiguousarray(ds.waveforms[0, :60000].reshape(4, 15000))
    cfg = jfast.smoke_config()
    med, mad = jfp.mad_stats(jfp.coeffs_from_waveform(
        jnp.asarray(ds.waveforms[0]), cfg.fingerprint), 1.0,
        jax.random.PRNGKey(0))
    want = jax.vmap(functools.partial(jdetect.detect_step, cfg=cfg),
                    in_axes=(0, None, None))(jnp.asarray(chunks), med, mad)
    mesh = dist.station_mesh(devices=_mesh(2))
    for group in (None, 1):
        got = tdetect.detect_step_sharded(
            torch.from_numpy(chunks), np.array(med), np.array(mad),
            tfast.smoke_config(), mesh, group=group)
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(),
                                          np.asarray(want[k]), err_msg=k)
    assert int(np.asarray(want["pair_valid"]).sum()) > 0
    with pytest.raises(ValueError, match="divide"):
        tdetect.detect_step_sharded(chunks[:3], np.array(med),
                                    np.array(mad), tfast.smoke_config(),
                                    mesh)


def test_configs_match_reference():
    assert tfast.SHAPES == jfast.SHAPES
    for name in jfast.SHAPES:
        assert tfast.model_flops(name) == jfast.model_flops(name)
        want = jfast.input_specs(name)
        got = tfast.input_specs(name)
        assert got.keys() == want.keys()
        for k in want:
            assert tuple(got[k].shape) == want[k].shape
            assert got[k].dtype == torch.float32 and got[k].is_meta
            assert want[k].dtype == jnp.float32
    got, want = (tfast.stream_sharded_smoke_config(),
                 jfast.stream_sharded_smoke_config())
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
