"""The batch detection path at the paper's widths, both packages, on the CPU.

``fast_seismic.config()`` unchanged except ``mad_sample_rate=1.0`` (the
reference's sampled rows come from ``jax.random`` and cannot be drawn in
torch), with the paper replay of ``fast_seismic.batch_replay_config``:
D = 8192 (32 x 128 images), top_k 400, t = 100 tables of f = 4 Min-Max
functions, m = 2, bucket_cap 4, 2^14 buckets, 256-fingerprint blocks,
4096 pairs per station-block with exact-Jaccard verify over a packed ring
that covers the trace, and the 1% occurrence filter.

The trace is short (3 stations x 20 min, events at SNR 6 so that the
32 s fingerprints see them) so the reference runs here; its Min-Max
hashing goes through its Pallas kernel in interpret mode, as
tests/test_kernels.py runs it, because the jnp oracle materialises an
(N, D, H) mask that needs several GB at these widths. The port must give
the same per-station pair triplets, the same stats and QC counters, the
same station events, the same detections and the same recall.
"""
import _torch_threads  # noqa: F401  (one torch thread a process)
import dataclasses

import numpy as np
import pytest

from repro.configs import fast_seismic as j_fast
from repro.core import synth as jsynth
from repro.core.detect import detect_events as j_detect_events
from repro.core.detect import recall_against_truth as j_recall
from repro.stream import ingest as jingest
from repro.stream.index import StreamIndexConfig as JIndexConfig
from repro_torch.configs import fast_seismic as t_fast
from repro_torch.core import detect as tdetect

SYNTH = dict(duration_s=1200.0, n_stations=3, n_sources=2,
             events_per_source=4, repeating_noise_stations=(0,),
             event_snr=6.0, seed=5)


def _exact_stats(cfg):
    return dataclasses.replace(
        cfg, fingerprint=dataclasses.replace(cfg.fingerprint,
                                             mad_sample_rate=1.0))


@pytest.fixture(scope="module")
def runs():
    ds = jsynth.make_dataset(jsynth.SynthConfig(**SYNTH))
    tcfg = _exact_stats(t_fast.config())
    jcfg = _exact_stats(j_fast.config())
    jcfg = dataclasses.replace(
        jcfg, lsh=dataclasses.replace(jcfg.lsh, use_pallas=True))
    n_fp = tcfg.fingerprint.n_fingerprints(ds.waveforms.shape[1])
    tscfg = t_fast.batch_replay_config(n_fp)
    jscfg = jingest.StreamConfig(
        block_fingerprints=tscfg.block_fingerprints,
        index=JIndexConfig(**dataclasses.asdict(tscfg.index)),
        max_pairs_per_block=tscfg.max_pairs_per_block,
        verify_jaccard=tscfg.verify_jaccard)
    want = j_detect_events(ds.waveforms, jcfg, scfg=jscfg, keep_pairs=True)
    got = tdetect.detect_events(ds.waveforms, tcfg, scfg=tscfg,
                                keep_pairs=True, device="cpu")
    return ds, tcfg, got, want


def _triplets(p) -> list:
    v = np.asarray(p.valid)
    return sorted(zip(np.asarray(p.idx1)[v].tolist(),
                      np.asarray(p.idx2)[v].tolist(),
                      np.asarray(p.sim)[v].tolist()))


@pytest.mark.parametrize("station", [0, 1, 2])
def test_paper_width_pair_sets_equal(runs, station):
    _, _, got, want = runs
    assert _triplets(got[3]["_station_pairs"][station]) == \
        _triplets(want[3]["_station_pairs"][station])


def test_paper_width_stats_and_detections_equal(runs):
    ds, tcfg, got, want = runs
    strip = lambda s: {k: v for k, v in s.items() if k != "_station_pairs"}
    assert strip(got[3]) == strip(want[3])
    assert got[3]["drops"]["pairs_emitted"] > 0
    assert got[3]["detections"] >= 1
    for k in want[0]:
        np.testing.assert_array_equal(got[0][k].cpu().numpy(),
                                      np.asarray(want[0][k]), err_msg=k)
    for te, je in zip(got[1], want[1]):
        for f in ("dt", "onset", "extent", "size", "score", "valid"):
            np.testing.assert_array_equal(getattr(te, f).cpu().numpy(),
                                          np.asarray(getattr(je, f)))
    assert tdetect.recall_against_truth(got[0], got[1], ds,
                                        tcfg.fingerprint) == \
        j_recall(want[0], want[1], ds, tcfg.fingerprint)
