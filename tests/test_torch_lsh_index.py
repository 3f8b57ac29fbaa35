"""repro_torch's Min-Max LSH and resident index against the JAX package,
bit-exact: hash mappings, salts, signatures and buckets fed the
reference's own fingerprint bits; the pair reductions; and
``guarded_step`` over several blocks with every guard on, starting from a
reference state carried across with ``repro_torch.convert``. The port
steps two stations at once (its station axis) where the reference steps
each station on its own.
"""
import _torch_threads  # noqa: F401  (one torch thread a process)
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fingerprint as jfp
from repro.core import lsh as jlsh
from repro.core import synth as jsynth
from repro.stream import fused as jfused
from repro.stream import index as jidx
from repro_torch import convert
from repro_torch.core import fingerprint as tfp
from repro_torch.core import lsh as tlsh
from repro_torch.stream import fused as tfused
from repro_torch.stream import index as tidx

FKW = dict(img_freq=16, img_time=32, img_hop=4, top_k=64, mad_sample_rate=1.0)
LKW = dict(n_tables=20, n_funcs=4, n_matches=2, bucket_cap=4, min_dt=8,
           occurrence_frac=0.05)
IKW = dict(n_buckets=256, bucket_cap=4, occ_slots=4096, pk_slots=4096,
           pk_words=32)
BLOCK = 64


@pytest.fixture(scope="module")
def data():
    """Reference fingerprints of a 2-station synthetic trace with the
    pathologies the guards exist for: station 0 repeats a data block
    sample-exactly (lag-aligned duplicate fingerprints), station 1 carries
    a train of identical pulses every two lags (a mega-bucket glitch)."""
    ds = jsynth.make_dataset(jsynth.SynthConfig(
        duration_s=420.0, n_stations=2, n_sources=2, events_per_source=4,
        repeating_noise_stations=(0,), event_snr=3.0, seed=3))
    wf = ds.waveforms.copy()
    wf[0, 12000:16000] = wf[0, 2000:6000]
    pulse = np.zeros(200, np.float32)
    pulse[:60] = 20 * np.sin(np.arange(60) * 0.5)
    wf[1, 6000:12000] = np.tile(pulse, 30)
    jc = jfp.FingerprintConfig(**FKW)
    bits, packed, meds, mads = [], [], [], []
    for st in range(2):
        coeffs = jfp.coeffs_from_waveform(jnp.asarray(wf[st]), jc)
        med, mad = jfp.mad_stats(coeffs, 1.0, jax.random.PRNGKey(0))
        b, p = jfp.binarize_coeffs(coeffs, jc, (med, mad))
        bits.append(np.array(b))
        packed.append(np.array(p))
        meds.append(np.array(med))
        mads.append(np.array(mad))
    return {"waveforms": wf, "bits": np.stack(bits),
            "packed": np.stack(packed), "med": meds, "mad": mads}


def _lcfgs(**kw):
    kw = dict(LKW, **kw)
    return jlsh.LSHConfig(**kw), tlsh.LSHConfig(**kw)


def _eq(port: torch.Tensor, ref) -> None:
    ref = np.asarray(ref)
    got = port.cpu().numpy()
    if ref.dtype == np.uint32:
        got = got.view(np.uint32)
    np.testing.assert_array_equal(got, ref)


def _packed_t(packed: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(packed).view(np.int32))


@pytest.mark.parametrize("d,n_funcs,use_minmax", [(1024, 4, True),
                                                  (8192, 8, True),
                                                  (512, 3, False)])
def test_hash_mappings_bit_exact(d, n_funcs, use_minmax):
    jl, tl = _lcfgs(n_tables=100 if d == 8192 else 20, n_funcs=n_funcs,
                    use_minmax=use_minmax)
    _eq(tlsh.hash_mappings(d, tl, "cpu"), jlsh.hash_mappings(d, jl))


def test_bucket_salts_ids_and_fillers_bit_exact(rng):
    _eq(tlsh.bucket_salts(100, 1234, "cpu"), jlsh.bucket_salts(100, 1234))
    sigs = rng.integers(0, 2**32, (37, 100), dtype=np.uint32)
    _eq(tlsh.bucket_ids(_packed_t(sigs), 16384, 1234),
        jlsh.bucket_ids(jnp.asarray(sigs), 16384, 1234))
    jl, tl = _lcfgs()
    _eq(tlsh._filler_signatures(50, 20, tl, "cpu"),
        jlsh._filler_signatures(50, 20, jl))


@pytest.mark.parametrize("masked,pallas", [(False, False), (True, False),
                                           (True, True)])
def test_signatures_and_buckets_bit_exact(data, masked, pallas):
    jl, tl = _lcfgs(use_pallas=pallas)
    d = data["bits"].shape[-1]
    n = 150
    mappings = jlsh.hash_mappings(d, jl)
    valid = np.ones((2, n), bool)
    if masked:
        valid[0, 10:40] = False
        valid[1, -7:] = False
    sig, bkt = tlsh.signatures_and_buckets(
        _packed_t(data["packed"][:, :n]), tlsh.hash_mappings(d, tl, "cpu"), tl, 256,
        torch.from_numpy(valid) if masked else None)
    for st in range(2):
        js, jb = jlsh.signatures_and_buckets(
            jnp.asarray(data["bits"][st, :n]), mappings, jl, 256,
            jnp.asarray(valid[st]) if masked else None)
        _eq(sig[st], js)
        _eq(bkt[st], jb)
    _eq(tlsh.signatures(_packed_t(data["packed"][0, :n]),
                        tlsh.hash_mappings(d, tl, "cpu"), tl),
        jlsh.signatures(jnp.asarray(data["bits"][0, :n]), mappings,
                        dataclasses.replace(jl, use_pallas=False)))


def _streams(rng, p=600, ids=200):
    inv = np.int32(2**31 - 1)
    a = rng.integers(0, ids, (2, p)).astype(np.int32)
    b = rng.integers(0, ids, (2, p)).astype(np.int32)
    lo, hi = np.minimum(a, b), np.maximum(a, b)
    dup = rng.integers(0, p, (2, p // 3))
    for s in range(2):
        lo[s, dup[s]] = lo[s, 0]
        hi[s, dup[s]] = hi[s, 0]
    off = rng.random((2, p)) < 0.3
    lo[off] = inv
    hi[off] = inv
    return lo, hi


def _pairs_eq(port, ref) -> None:
    for f in dataclasses.fields(ref):
        _eq(getattr(port, f.name), getattr(ref, f.name))


@pytest.mark.parametrize("min_dt", [0, 3])
def test_finalize_pairs_bit_exact(rng, min_dt):
    jl, tl = _lcfgs(min_dt=min_dt)
    lo, hi = _streams(rng)
    got = tlsh.finalize_pairs(torch.from_numpy(lo), torch.from_numpy(hi), tl)
    for s in range(2):
        want = jlsh.finalize_pairs(jnp.asarray(lo[s]), jnp.asarray(hi[s]), jl)
        _pairs_eq(tlsh.Pairs(*(getattr(got, f)[s] for f in
                               ("idx1", "idx2", "sim", "valid"))), want)


@pytest.mark.parametrize("max_pairs", [5, 60, 10_000])
def test_compact_pairs_bit_exact(rng, max_pairs):
    jl, tl = _lcfgs(min_dt=0, n_matches=1)
    lo, hi = _streams(rng)
    got, over = tidx.compact_pairs(
        tlsh.finalize_pairs(torch.from_numpy(lo), torch.from_numpy(hi), tl),
        max_pairs)
    for s in range(2):
        want, wover = jidx.compact_pairs(jlsh.finalize_pairs(
            jnp.asarray(lo[s]), jnp.asarray(hi[s]), jl), max_pairs)
        _pairs_eq(tlsh.Pairs(*(getattr(got, f)[s] for f in
                               ("idx1", "idx2", "sim", "valid"))), want)
        assert int(over[s]) == int(wover)


@pytest.mark.parametrize("limit", [None, 3])
def test_occurrence_filter_bit_exact(rng, limit):
    jl, _ = _lcfgs(min_dt=0, n_matches=1)
    lo, hi = _streams(rng, ids=60)
    jp = jlsh.finalize_pairs(jnp.asarray(lo[0]), jnp.asarray(hi[0]), jl)
    want, wex = jlsh.occurrence_filter(jp, 60, 0.05, limit=limit)
    got, ex = tlsh.occurrence_filter(
        convert.pairs({f.name: np.array(getattr(jp, f.name))
                       for f in dataclasses.fields(jp)}, "cpu"), 60, 0.05,
        limit=limit)
    _pairs_eq(got, want)
    _eq(ex, wex)


def _leaves(state) -> dict:
    return {f.name: np.array(getattr(state, f.name))
            for f in dataclasses.fields(state)}


def _state_eq(port: tidx.IndexState, refs: list) -> None:
    got = convert.index_state_to_numpy(port)
    for st, ref in enumerate(refs):
        for name, want in _leaves(ref).items():
            np.testing.assert_array_equal(got[name][st], want, err_msg=name)


def test_init_and_convert_round_trip():
    jl, tl = _lcfgs()
    jc, tc = jidx.StreamIndexConfig(**IKW), tidx.StreamIndexConfig(**IKW)
    port = tidx.init_index(tl, tc, n_stations=2, device="cpu")
    _state_eq(port, [jidx.init_index(jl, jc)] * 2)
    back = convert.index_state(convert.index_state_to_numpy(port), "cpu")
    for f in dataclasses.fields(port):
        assert torch.equal(getattr(back, f.name), getattr(port, f.name))
    assert tc.state_bytes(20) == jc.state_bytes(20)


def test_expire_with_half_life_bit_exact(rng):
    jl, tl = _lcfgs()
    jc = jidx.StreamIndexConfig(**IKW)
    ref = jidx.init_index(jl, jc)
    ids = rng.integers(0, 500, ref.ids.shape).astype(np.int32)
    traffic = rng.integers(0, 1000, ref.traffic.shape).astype(np.int32)
    ref = dataclasses.replace(ref, ids=jnp.asarray(ids),
                              traffic=jnp.asarray(traffic))
    port = convert.index_state(_leaves(ref), "cpu")
    for min_id in (-3, 130, 400):
        ref = jidx.expire(ref, jnp.int32(min_id), half_life=64)
        tidx.expire(port, torch.tensor([min_id]), half_life=64)
        _state_eq(port, [ref])


KNOBS = {
    "all_guards": dict(window=128, saturation=10, dup_tables=15, occ_limit=30,
                       counters=1, max_pairs=512, verify=1, min_jac=0.0),
    "tight_bounds": dict(window=0, saturation=3, dup_tables=4, occ_limit=8,
                         counters=1, max_pairs=16, verify=1, min_jac=0.2),
    "dense": dict(window=96, counters=1),
    "limit_overflow": dict(window=128, occ_limit=8, counters=1, max_pairs=1,
                           verify=1),
}
FIRES = {   # guard counters each knob set must see fire on this data
    "all_guards": ("duplicate_fingerprints",),
    "tight_bounds": ("duplicate_fingerprints", "saturated_lookups",
                     "quarantined_collisions"),
    "dense": ("raw_collisions",),
    "limit_overflow": ("limited_pairs", "overflow_pairs"),
}


@pytest.mark.parametrize("knobs", sorted(KNOBS))
def test_guarded_step_bit_exact_over_blocks(data, knobs):
    fires, knobs = FIRES[knobs], KNOBS[knobs]
    jl, tl = _lcfgs()
    jc, tc = jidx.StreamIndexConfig(**IKW), tidx.StreamIndexConfig(**IKW)
    d, n = data["bits"].shape[-1], data["bits"].shape[1]
    jmap, tmap = jlsh.hash_mappings(d, jl), tlsh.hash_mappings(d, tl, "cpu")
    jstep = jax.jit(functools.partial(jidx.guarded_step, cfg=jl, **knobs))
    refs = [jidx.init_index(jl, jc) for _ in range(2)]
    port = None
    qc_total = np.zeros(len(tidx.QC_FIELDS), np.int64)
    for k, base in enumerate(range(0, n, BLOCK)):
        rows = slice(base, min(base + BLOCK, n))
        bits = np.zeros((2, BLOCK, d), bool)
        packed = np.zeros((2, BLOCK, d // 32), np.uint32)
        bits[:, :rows.stop - base] = data["bits"][:, rows]
        packed[:, :rows.stop - base] = data["packed"][:, rows]
        valid = np.broadcast_to(np.arange(BLOCK) < n - base, (2, BLOCK)).copy()
        if k == 2:
            valid[1, 10:20] = False            # a gap on one station only
        use_mask = valid.all() is np.False_ or "dense" not in knobs
        ids = base + np.arange(BLOCK, dtype=np.int32)
        outs = []
        for st in range(2):
            v = jnp.asarray(valid[st]) if use_mask else None
            sig, bkt = jlsh.signatures_and_buckets(
                jnp.asarray(bits[st]), jmap, jl, jc.n_buckets, v)
            refs[st], pairs, qc = jstep(refs[st], sig, bkt, jnp.asarray(ids),
                                        v, packed=jnp.asarray(packed[st]))
            outs.append((sig, bkt, pairs, qc))
        if port is None:        # carry the reference's first step across
            port = tidx.stack_states([convert.index_state(_leaves(r), "cpu")
                                      for r in refs])
            continue
        tv = torch.from_numpy(valid) if use_mask else None
        tsig, tbkt = tlsh.signatures_and_buckets(
            _packed_t(packed), tmap, tl, tc.n_buckets, tv)
        port, tpairs, tqc = tidx.guarded_step(
            port, tsig, tbkt, torch.from_numpy(ids), tv, tl,
            packed=_packed_t(packed), **knobs)
        _state_eq(port, refs)
        for st, (sig, bkt, pairs, qc) in enumerate(outs):
            _eq(tsig[st], sig)
            _eq(tbkt[st], bkt)
            for f in dataclasses.fields(pairs):
                _eq(getattr(tpairs, f.name)[st], getattr(pairs, f.name))
            _eq(tqc[st], qc)
        qc_total += tqc.sum(dim=0).numpy()
    assert k >= 5                                # N >= 4 ported steps
    qc_total = dict(zip(tidx.QC_FIELDS, qc_total))
    assert qc_total["pairs_emitted"] > 0
    assert all(qc_total[name] > 0 for name in fires), qc_total


def test_pool_step_block_bit_exact(data):
    """The whole per-block core (fingerprint → hash → guarded step with
    compaction + verify) for a 2-station pool, from a carried state."""
    jc_f, tc_f = jfp.FingerprintConfig(**FKW), tfp.FingerprintConfig(**FKW)
    jl, tl = _lcfgs()
    knobs = dict(window=0, saturation=10, dup_tables=0, occ_limit=30,
                 counters=1, max_pairs=256, verify=1, min_jac=0.0)
    icfg = dict(IKW, pk_words=tc_f.fp_dim // 32)
    jidx_cfg = jidx.StreamIndexConfig(**icfg)
    jstate = jfused.init_pool_state(
        [jidx.init_index(jl, jidx_cfg) for _ in range(2)],
        jc_f.halo_samples, data["med"], data["mad"])
    leaves = {"index": _leaves(jstate.index), "halo": np.array(jstate.halo),
              "med": np.array(jstate.med), "mad": np.array(jstate.mad)}
    tstate = convert.fused_state(leaves, "cpu")
    jmap = jlsh.hash_mappings(jc_f.fp_dim, jl)
    tmap = tlsh.hash_mappings(tc_f.fp_dim, tl, "cpu")
    bs = jc_f.block_samples(BLOCK)
    for base in (0, BLOCK, 2 * BLOCK):
        start = base * jc_f.lag_samples
        blocks = np.ascontiguousarray(data["waveforms"][:, start:start + bs])
        valid = np.ones((2, BLOCK), bool)
        jstate, jpairs, jqc = jfused.pool_step_block(
            jstate, jnp.asarray(blocks), jmap, jnp.int32(base),
            jnp.asarray(valid), jc_f, jl, **knobs)
        tstate, tpairs, tqc = tfused.pool_step_block(
            tstate, torch.from_numpy(blocks), tmap, base,
            torch.from_numpy(valid), tc_f, tl, **knobs)
        _state_eq(tstate.index, [jax.tree.map(lambda x, s=st: x[s],
                                              jstate.index)
                                 for st in range(2)])
        for f in dataclasses.fields(jpairs):
            _eq(getattr(tpairs, f.name), getattr(jpairs, f.name))
        _eq(tqc, jqc)
        _eq(tstate.halo, jstate.halo)
    assert int(tqc[:, 3].sum()) > 0              # pairs were emitted


def test_step_block_bit_exact_for_one_station(data):
    """The one-station entry, from a reference solo state (no station
    axis) carried across; pairs and qc come back without the axis."""
    jc_f, tc_f = jfp.FingerprintConfig(**FKW), tfp.FingerprintConfig(**FKW)
    jl, tl = _lcfgs()
    knobs = dict(window=96, saturation=10, counters=1, max_pairs=64,
                 verify=1)
    icfg = dict(IKW, pk_words=tc_f.fp_dim // 32)
    jstate = jfused.init_state(
        jidx.init_index(jl, jidx.StreamIndexConfig(**icfg)),
        jc_f.halo_samples, data["med"][0], data["mad"][0])
    tstate = convert.fused_state(
        {"index": _leaves(jstate.index), "halo": np.array(jstate.halo),
         "med": np.array(jstate.med), "mad": np.array(jstate.mad)}, "cpu")
    jmap = jlsh.hash_mappings(jc_f.fp_dim, jl)
    tmap = tlsh.hash_mappings(tc_f.fp_dim, tl, "cpu")
    bs = jc_f.block_samples(BLOCK)
    valid = np.arange(BLOCK) < 50
    for base in (0, BLOCK):
        block = np.ascontiguousarray(
            data["waveforms"][0, base * jc_f.lag_samples:][:bs])
        jstate, jpairs, jqc = jfused.step_block(
            jstate, jnp.asarray(block), jmap, jnp.int32(base),
            jnp.asarray(valid), jc_f, jl, **knobs)
        tstate, tpairs, tqc = tfused.step_block(
            tstate, torch.from_numpy(block), tmap, base,
            torch.from_numpy(valid), tc_f, tl, **knobs)
        _state_eq(tstate.index, [jstate.index])
        for f in dataclasses.fields(jpairs):
            _eq(getattr(tpairs, f.name), getattr(jpairs, f.name))
        _eq(tqc, jqc)
        _eq(tstate.halo[0], jstate.halo)
