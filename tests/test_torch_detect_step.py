"""The port's one-chunk ``detect_step`` against the reference's, on the CPU.

The reference runs under ``jax.jit`` as ``tests/test_detect_e2e.py``
runs it; both take the same 12,000-sample chunk and the reference's
``mad_stats`` at rate 1.0. Every output (pair ids, similarities, event
scores, masks) is an integer or a mask, and all must be equal; one case
turns the occurrence limiter on (``occ_limit`` with ``icfg.occ_slots``),
where it halves the chunk's pairs.
"""
import _torch_threads  # noqa: F401  (one torch thread a process)
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import align as jalign
from repro.core import detect as jdetect
from repro.core import fingerprint as jfp
from repro.core import lsh as jlsh
from repro.stream.index import StreamIndexConfig as JIndexConfig
from repro_torch.core import align as talign
from repro_torch.core import detect as tdetect
from repro_torch.core import synth as tsynth
from repro_torch.core.fingerprint import FingerprintConfig
from repro_torch.core.lsh import LSHConfig
from repro_torch.stream.index import StreamIndexConfig

CHUNK = 12000


def _cfgs():
    """``tests/test_detect_e2e.py:test_detect_step_jittable``'s narrow
    configuration, in both packages."""
    fcfg = FingerprintConfig(img_time=32, img_hop=8, top_k=64,
                             mad_sample_rate=1.0, img_freq=16)
    lcfg = LSHConfig(n_tables=100, n_funcs=4, n_matches=2, bucket_cap=8,
                     min_dt=fcfg.overlap_fingerprints, occurrence_frac=0.05)
    acfg = talign.AlignConfig(channel_threshold=3, min_cluster_sim=4,
                              min_cluster_size=1, min_stations=2,
                              onset_tol=int(10 * fcfg.fs / fcfg.lag_samples))
    port = tdetect.DetectConfig(fingerprint=fcfg, lsh=lcfg, align=acfg)
    ref = jdetect.DetectConfig(
        fingerprint=jfp.FingerprintConfig(**dataclasses.asdict(fcfg)),
        lsh=jlsh.LSHConfig(**dataclasses.asdict(lcfg)),
        align=jalign.AlignConfig(**dataclasses.asdict(acfg)))
    return port, ref


@pytest.fixture(scope="module")
def chunk():
    """Station 1's first 12,000 samples of the reference test's dataset,
    and the reference's statistics of that chunk."""
    ds = tsynth.make_dataset(tsynth.SynthConfig(
        duration_s=420.0, n_stations=3, n_sources=2, events_per_source=4,
        repeating_noise_stations=(0,), event_snr=3.0, seed=3))
    x = np.ascontiguousarray(ds.waveforms[1][:CHUNK], np.float32)
    fcfg = _cfgs()[1].fingerprint
    coeffs = jfp.wavelet_coeffs(jfp.spectral_images(
        jfp.spectrogram(jnp.asarray(x), fcfg), fcfg), fcfg)
    med, mad = jfp.mad_stats(coeffs, 1.0, jax.random.PRNGKey(0))
    return x, np.array(med), np.array(mad)


@pytest.mark.parametrize("occ_limit", [0, 20])
def test_detect_step_equals_the_reference(chunk, occ_limit):
    x, med, mad = chunk
    port_cfg, ref_cfg = _cfgs()
    bucket_cap = port_cfg.lsh.bucket_cap
    slots = 512 if occ_limit else 0
    want = jax.jit(functools.partial(
        jdetect.detect_step, cfg=ref_cfg, occ_limit=occ_limit,
        icfg=JIndexConfig(n_buckets=4096, bucket_cap=bucket_cap,
                          occ_slots=slots)))(jnp.asarray(x), med, mad)
    got = tdetect.detect_step(
        x, med, mad, port_cfg, occ_limit=occ_limit, device="cpu",
        icfg=StreamIndexConfig(n_buckets=4096, bucket_cap=bucket_cap,
                               occ_slots=slots))
    assert set(got) == set(want)
    assert bool(got["pair_valid"].any()) and bool(got["ev_valid"].any())
    for k, v in got.items():
        assert not v.is_floating_point(), k
        np.testing.assert_array_equal(v.numpy(), np.asarray(want[k]),
                                      err_msg=k)


def test_detect_step_limiter_needs_occ_slots_and_defaults_to_cuda(
        chunk, monkeypatch):
    x, med, mad = chunk
    port_cfg, _ = _cfgs()
    with pytest.raises(AssertionError, match="occ_slots"):
        tdetect.detect_step(x, med, mad, port_cfg, occ_limit=3,
                            device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tdetect.detect_step(x, med, mad, port_cfg)
