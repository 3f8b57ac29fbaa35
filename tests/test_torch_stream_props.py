"""Property tests of the port's streaming index and ingestion invariants.

The invariants of tests/test_stream_props.py, held on ``repro_torch``
alone (CPU, no JAX): insert→query is split-invariant, ring eviction never
resurrects ids, ``expire`` leaves nothing below its floor, chunked ingest
is sample-exact for random chunk lengths, gap-masked ingest is
sample-exact off the gaps with masks exactly the windows that touch one,
and reorder reconciliation is permutation-invariant within the horizon
(re-delivery a no-op). Each property runs through hypothesis and through
a deterministic seed sweep.
"""
import _torch_threads  # noqa: F401  (one torch thread a process)
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st

from repro_torch.core.fingerprint import FingerprintConfig
from repro_torch.core.lsh import INVALID, LSHConfig
from repro_torch.stream import StreamIndexConfig, WaveformRing
from repro_torch.stream import index as SI

CFG = LSHConfig(n_tables=12, n_funcs=4, n_matches=1, bucket_cap=8,
                min_dt=1, occurrence_frac=0.0)
SET = settings(max_examples=10, deadline=None)


def _sigs(a: np.ndarray) -> torch.Tensor:
    """(N, t) uint32 signatures → the port's (1, N, t) int32 patterns."""
    return torch.from_numpy(a.astype(np.uint32).view(np.int32))[None]


def _sigs_with_dups(rng, n, n_dups, t=CFG.n_tables):
    sigs = rng.integers(0, 2**32, (n, t), dtype=np.uint32)
    for _ in range(n_dups):
        src, dst = sorted(rng.integers(0, n, 2).tolist())
        if src != dst:
            sigs[dst] = sigs[src]
    return sigs


def _pair_map(pairs):
    v = pairs.valid[0].numpy()
    return dict(zip(zip(pairs.idx1[0].numpy()[v].tolist(),
                        pairs.idx2[0].numpy()[v].tolist()),
                    pairs.sim[0].numpy()[v].tolist()))


def _ids(a) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a), dtype=torch.int32)


def _splits(rng, n, k):
    cuts = np.unique(rng.integers(1, n, size=max(0, k - 1)))
    return np.split(np.arange(n), cuts)


def _fcfg():
    return FingerprintConfig(img_freq=8, img_time=16, img_hop=4, top_k=16,
                             mad_sample_rate=1.0)


def check_split_invariance(seed: int, n_batches: int):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(8, 40))
    sigs = _sigs_with_dups(rng, n, n_dups=int(rng.integers(1, 5)))
    icfg = StreamIndexConfig(n_buckets=1024, bucket_cap=n)  # no eviction
    one = SI.init_index(CFG, icfg, device="cpu")
    SI.insert(one, _sigs(sigs), _ids(np.arange(n)), CFG)
    expect = _pair_map(SI.query(one, _sigs(sigs), _ids(np.arange(n)), CFG))
    split = SI.init_index(CFG, icfg, device="cpu")
    got = {}
    for idx in _splits(rng, n, n_batches):
        SI.insert(split, _sigs(sigs[idx]), _ids(idx), CFG)
        got.update(_pair_map(SI.query(split, _sigs(sigs[idx]), _ids(idx),
                                      CFG)))
    assert got == expect, (seed, n_batches)


def check_eviction_never_resurrects(seed: int, cap: int, n_ins: int):
    rng = np.random.default_rng(seed)
    cfg = LSHConfig(n_tables=4, n_funcs=4, n_matches=1, bucket_cap=8,
                    min_dt=1, occurrence_frac=0.0)
    state = SI.init_index(cfg, StreamIndexConfig(n_buckets=64,
                                                 bucket_cap=cap),
                          device="cpu")
    sig = rng.integers(0, 2**32, (1, 4), dtype=np.uint32)
    for idx in _splits(rng, n_ins, int(rng.integers(1, n_ins + 1))):
        SI.insert(state, _sigs(np.tile(sig, (len(idx), 1))), _ids(idx), cfg)
    pairs = SI.query(state, _sigs(sig), _ids([n_ins]), cfg)
    partners = set(_pair_map(pairs))
    newest = {(i, n_ins) for i in range(max(0, n_ins - cap), n_ins)}
    assert partners == newest, (seed, cap, n_ins)


def check_expire_unreachable(seed: int):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(8, 48))
    sigs = _sigs_with_dups(rng, n, n_dups=int(rng.integers(2, 8)))
    state = SI.init_index(CFG, StreamIndexConfig(n_buckets=256,
                                                 bucket_cap=8), device="cpu")
    SI.insert(state, _sigs(sigs), _ids(np.arange(n)), CFG)
    min_id = int(rng.integers(0, n + 1))
    SI.expire(state, _ids([min_id]))
    resident = state.ids.numpy()
    resident = resident[resident != INVALID]
    assert (resident >= min_id).all(), (seed, min_id)
    pairs = SI.query(state, _sigs(sigs), _ids(1000 + np.arange(n)), CFG)
    assert all(i1 >= min_id for i1, _ in _pair_map(pairs)), (seed, min_id)


def check_chunked_ingest_sample_exact(seed: int):
    rng = np.random.default_rng(seed)
    fcfg = _fcfg()
    block_fp = int(rng.integers(2, 9))
    ring = WaveformRing(fcfg, block_fingerprints=block_fp)
    n_samples = int(rng.integers(4_000, 20_000))
    wf = rng.standard_normal(n_samples).astype(np.float32)
    pos, blocks = 0, []
    while pos < n_samples:
        step = int(rng.integers(1, 3_000))
        blocks.extend(ring.push(wf[pos: pos + step]))
        pos += step
    lag, bs = fcfg.lag_samples, fcfg.block_samples(block_fp)
    for base, blk, mask in blocks:
        assert mask is None
        np.testing.assert_array_equal(blk, wf[base * lag: base * lag + bs])
    tail = ring.flush_partial()
    got = len(blocks) * block_fp
    if tail is not None:
        base, blk, mask = tail
        n_valid = int(mask.sum())
        assert mask[:n_valid].all()
        extent = min(bs, n_samples - base * lag)
        np.testing.assert_array_equal(blk[:extent],
                                      wf[base * lag: base * lag + extent])
        assert (blk[extent:] == 0).all()
        assert (n_valid - 1) * lag + fcfg.window_samples <= extent
        got += n_valid
    assert got == fcfg.n_fingerprints(n_samples), (seed, got)


def _drain(ring):
    out = ring.flush_ready()
    tail = ring.flush_partial()
    if tail is not None:
        out.append(tail)
    return out


def _blocks_equal(a, b):
    assert len(a) == len(b), (len(a), len(b))
    for (b1, blk1, m1), (b2, blk2, m2) in zip(a, b):
        assert b1 == b2
        np.testing.assert_array_equal(blk1, blk2)
        if m1 is None or m2 is None:
            assert m1 is None or np.asarray(m1).all()
            assert m2 is None or np.asarray(m2).all()
        else:
            np.testing.assert_array_equal(m1, m2)


def check_gap_masked_ingest_sample_exact(seed: int):
    rng = np.random.default_rng(seed)
    fcfg = _fcfg()
    block_fp = int(rng.integers(2, 9))
    n_samples = int(rng.integers(6_000, 16_000))
    wf = rng.standard_normal(n_samples).astype(np.float32)
    missing = np.zeros(n_samples, bool)
    for _ in range(int(rng.integers(1, 4))):
        dur = int(rng.integers(50, 900))
        i0 = int(rng.integers(0, max(1, n_samples - dur)))
        missing[i0:i0 + dur] = True
    dirty = wf.copy()
    dirty[missing] = np.nan
    clean_ring = WaveformRing(fcfg, block_fingerprints=block_fp)
    dirty_ring = WaveformRing(fcfg, block_fingerprints=block_fp)
    clean_blocks, dirty_blocks = [], []
    pos = 0
    while pos < n_samples:
        step = int(rng.integers(1, 2_500))
        clean_blocks.extend(clean_ring.push(wf[pos: pos + step]))
        dirty_blocks.extend(dirty_ring.push(dirty[pos: pos + step]))
        pos += step
    clean_blocks += _drain(clean_ring)
    dirty_blocks += _drain(dirty_ring)
    assert dirty_ring.quality["missing_samples"] == int(missing.sum())
    w, lag = fcfg.window_samples, fcfg.lag_samples
    assert len(clean_blocks) == len(dirty_blocks)
    for (cb, cblk, cm), (db, dblk, dm) in zip(clean_blocks, dirty_blocks):
        assert cb == db
        ok = ~missing[cb * lag: cb * lag + dblk.size]
        ok = np.pad(ok, (0, dblk.size - ok.size))
        np.testing.assert_array_equal(dblk[ok], cblk[ok])
        assert (dblk[~ok] == 0).all()
        cmask = (np.ones(block_fp, bool) if cm is None
                 else np.asarray(cm, bool))
        dmask = (np.ones(block_fp, bool) if dm is None
                 else np.asarray(dm, bool))
        for i in range(block_fp):
            if not cmask[i]:
                assert not dmask[i]
                continue
            touches = missing[(cb + i) * lag: (cb + i) * lag + w].any()
            assert dmask[i] == (not touches), (seed, cb, i)


def check_reorder_permutation_invariant(seed: int):
    rng = np.random.default_rng(seed)
    fcfg = _fcfg()
    block_fp = int(rng.integers(2, 7))
    chunk_len = int(rng.integers(200, 1_200))
    n_chunks = int(rng.integers(8, 20))
    swap_span = 2
    horizon = (swap_span + 1) * chunk_len
    wf = rng.standard_normal(n_chunks * chunk_len).astype(np.float32)
    chunks = [(i * chunk_len, wf[i * chunk_len:(i + 1) * chunk_len])
              for i in range(n_chunks)]
    order = np.arange(n_chunks)
    for i in range(0, n_chunks - swap_span, swap_span + 1):
        seg = order[i:i + swap_span + 1]
        rng.shuffle(seg)
    ref = WaveformRing(fcfg, block_fp, reorder_horizon=horizon)
    got = WaveformRing(fcfg, block_fp, reorder_horizon=horizon)
    ref_blocks, got_blocks = [], []
    for off, c in chunks:
        ref_blocks.extend(ref.push(c, off))
    for k in order:
        got_blocks.extend(got.push(chunks[k][1], chunks[k][0]))
        if rng.random() < 0.3:            # duplicate re-delivery: a no-op
            got_blocks.extend(got.push(chunks[k][1], chunks[k][0]))
    ref_blocks += _drain(ref)
    got_blocks += _drain(got)
    _blocks_equal(ref_blocks, got_blocks)
    assert got.quality["late_dropped_samples"] == 0
    plain = WaveformRing(fcfg, block_fp)
    plain_blocks = []
    for off, c in chunks:
        plain_blocks.extend(plain.push(c, off))
    plain_blocks += _drain(plain)
    _blocks_equal(ref_blocks, plain_blocks)


@given(st.integers(0, 2**31 - 1), st.integers(1, 6))
@SET
def test_split_invariance_hyp(seed, n_batches):
    check_split_invariance(seed, n_batches)


@given(st.integers(0, 2**31 - 1), st.integers(1, 4), st.integers(5, 12))
@SET
def test_eviction_hyp(seed, cap, n_ins):
    check_eviction_never_resurrects(seed, cap, n_ins)


@given(st.integers(0, 2**31 - 1))
@SET
def test_expire_hyp(seed):
    check_expire_unreachable(seed)


@given(st.integers(0, 2**31 - 1))
@SET
def test_chunked_ingest_hyp(seed):
    check_chunked_ingest_sample_exact(seed)


@given(st.integers(0, 2**31 - 1))
@SET
def test_gap_masked_ingest_hyp(seed):
    check_gap_masked_ingest_sample_exact(seed)


@given(st.integers(0, 2**31 - 1))
@SET
def test_reorder_permutation_hyp(seed):
    check_reorder_permutation_invariant(seed)


@pytest.mark.parametrize("seed", range(5))
def test_split_invariance(seed):
    check_split_invariance(seed, n_batches=(seed % 5) + 1)


@pytest.mark.parametrize("seed,cap,n_ins",
                         [(0, 1, 5), (1, 2, 7), (2, 3, 12), (3, 4, 9)])
def test_eviction_never_resurrects(seed, cap, n_ins):
    check_eviction_never_resurrects(seed, cap, n_ins)


@pytest.mark.parametrize("seed", range(5))
def test_expire_unreachable(seed):
    check_expire_unreachable(seed)


@pytest.mark.parametrize("seed", range(4))
def test_chunked_ingest_sample_exact(seed):
    check_chunked_ingest_sample_exact(seed)


@pytest.mark.parametrize("seed", range(4))
def test_gap_masked_ingest_sample_exact(seed):
    check_gap_masked_ingest_sample_exact(seed)


@pytest.mark.parametrize("seed", range(4))
def test_reorder_permutation_invariant(seed):
    check_reorder_permutation_invariant(seed)
