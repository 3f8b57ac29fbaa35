"""The port's chunk ingestion against the JAX package's, on the CPU.

``repro_torch.stream.ingest.WaveformRing`` and ``StreamingMAD`` are host
numpy copies of the reference's; fed the same chunk sequences (uneven
splits, NaN runs, offsets that jump, come late or repeat, a reorder
horizon, a gap bound) both packages must emit the same blocks and masks,
count the same ``quality`` dicts, keep the same reservoir rows and give
the same statistics, at tolerance 0. Snapshots round-trip.
"""
import _torch_threads  # noqa: F401  (one torch thread a process)
import numpy as np
import pytest

from repro.core import fingerprint as jfp
from repro.stream import ingest as jingest
from repro_torch.core import fingerprint as tfp
from repro_torch.stream import ingest as tingest

FKW = dict(img_freq=8, img_time=16, img_hop=4, top_k=16, mad_sample_rate=1.0)


def _rings(block_fp, **kw):
    return (jingest.WaveformRing(jfp.FingerprintConfig(**FKW), block_fp,
                                 **kw),
            tingest.WaveformRing(tfp.FingerprintConfig(**FKW), block_fp,
                                 **kw))


def _same_items(got, want):
    assert len(got) == len(want)
    for (b1, blk1, m1), (b2, blk2, m2) in zip(got, want):
        assert b1 == b2
        np.testing.assert_array_equal(blk1, blk2)
        assert (m1 is None) == (m2 is None)
        if m1 is not None:
            np.testing.assert_array_equal(m1, m2)


def _same_tail(t, j):
    got, want = t.flush_partial(), j.flush_partial()
    assert (got is None) == (want is None)
    if got is not None:
        _same_items([got], [want])


def _same_state(t, j):
    np.testing.assert_array_equal(t.buf, j.buf)
    np.testing.assert_array_equal(t.vbuf, j.vbuf)
    assert (t.start, t.next_fp, t.samples_in, t.quality) == \
        (j.start, j.next_fp, j.samples_in, j.quality)


def _schedule(seed: int, n: int):
    """A dirty delivery schedule over n samples: (chunk, offset) pairs with
    uneven lengths, NaN runs, forward jumps, late and repeated chunks."""
    rng = np.random.default_rng(seed)
    wf = rng.standard_normal(n).astype(np.float32)
    out, pos = [], 0
    while pos < n:
        step = int(rng.integers(1, 2_500))
        chunk = wf[pos:pos + step].copy()
        if rng.random() < 0.3 and chunk.size > 4:
            a = int(rng.integers(0, chunk.size - 2))
            chunk[a:a + int(rng.integers(1, chunk.size - a))] = np.nan
        kind = rng.random()
        if kind < 0.15:                       # forward jump (a gap)
            pos += int(rng.integers(1, 1_500))
            chunk = wf[pos:pos + step]
        out.append((chunk, pos))
        if kind > 0.85 and out:               # late / repeated delivery
            back = int(rng.integers(0, max(1, pos)))
            out.append((wf[back:back + int(rng.integers(1, 800))], back))
        pos += chunk.size
    return out


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("horizon,max_gap", [(0, 0), (1_500, 0),
                                             (4_000, 1_000)])
def test_ring_matches_reference_on_dirty_schedules(seed, horizon, max_gap):
    jr, tr = _rings(int(seed % 4) + 2, reorder_horizon=horizon,
                    max_gap=max_gap)
    for chunk, off in _schedule(seed, 20_000):
        _same_items(tr.push(chunk, off), jr.push(chunk, off))
        _same_state(tr, jr)
    _same_items(tr.flush_ready(), jr.flush_ready())
    _same_tail(tr, jr)
    _same_state(tr, jr)
    assert tr.pending_samples == jr.pending_samples


@pytest.mark.parametrize("n,n_chunks", [(15_000, 1), (15_000, 7),
                                        (15_375, 30), (16_000, 3)])
def test_ring_contiguous_pushes_match_reference(n, n_chunks):
    wf = np.random.default_rng(n_chunks).standard_normal(n)
    jr, tr = _rings(5)
    for chunk in np.array_split(wf, n_chunks):
        _same_items(tr.push(chunk), jr.push(chunk))
    _same_tail(tr, jr)
    _same_state(tr, jr)


def test_ring_snapshot_restores_into_a_fresh_ring():
    sched = _schedule(11, 12_000)
    jr, tr = _rings(3, reorder_horizon=1_000)
    for chunk, off in sched[:len(sched) // 2]:
        jr.push(chunk, off)
        tr.push(chunk, off)
    arrays, scalars = tr.snapshot()
    ja, js = jr.snapshot()
    assert scalars == js
    for k in ja:
        np.testing.assert_array_equal(arrays[k], ja[k])
    fresh = tingest.WaveformRing(tfp.FingerprintConfig(**FKW), 3,
                                 reorder_horizon=1_000)
    fresh.restore(arrays, scalars)
    for chunk, off in sched[len(sched) // 2:]:
        _same_items(fresh.push(chunk, off), jr.push(chunk, off))
    _same_state(fresh, jr)


@pytest.mark.parametrize("n_rows,seed", [(400, 0), (64, 1), (17, 2)])
def test_reservoir_matches_reference(n_rows, seed):
    rng = np.random.default_rng(seed)
    coeffs = rng.standard_normal((300, 24)).astype(np.float32)
    jm = jingest.StreamingMAD(n_rows, 24, seed=seed)
    tm = tingest.StreamingMAD(n_rows, 24, seed=seed)
    for part in np.array_split(coeffs, 11):
        jm.update(part)
        tm.update(part)
        np.testing.assert_array_equal(tm.rows, jm.rows)
        assert (tm.seen, tm.filled) == (jm.seen, jm.filled)
    for got, want in zip(tm.stats(), jm.stats()):
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    arrays, scalars = tm.snapshot()
    fresh = tingest.StreamingMAD(n_rows, 24, seed=99)
    fresh.restore(arrays, scalars)
    more = rng.standard_normal((50, 24)).astype(np.float32)
    fresh.update(more)
    jm.update(more)
    np.testing.assert_array_equal(fresh.rows, jm.rows)


def test_stream_config_validation_matches_reference():
    bad = [dict(stats_warmup_blocks=-1), dict(occ_limit=3),
           dict(pooled=True, fused=False),
           dict(filter_window_fingerprints=10),
           dict(window_fingerprints=8, block_fingerprints=64),
           dict(max_pairs_per_block=-1), dict(verify_jaccard=True),
           dict(verify_pallas=True), dict(verify_min_jaccard=1.5)]
    for kw in bad:
        with pytest.raises(ValueError):
            jingest.StreamConfig(**kw)
        with pytest.raises(ValueError):
            tingest.StreamConfig(**kw)
