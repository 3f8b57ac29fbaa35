"""repro_torch.core.fingerprint against repro.core.fingerprint on the same
waveforms (made with numpy from a seed).

Float stages (spectrogram, spectral images, wavelet, MAD statistics) hold
to rtol 1e-5 and atol 1e-5 * max|x|: only the fp32 summation order of the
products differs. Given the same coefficients and statistics, the
binarized bits and packed words are bit-exact. The time-domain bandpass
(``FingerprintConfig(time_domain_bandpass=True)``) has the reference's
taps bit for bit and its ``jnp.convolve(x, taps, "same")`` output (every
length, taps longer than the trace included) within the same tolerance;
its fingerprints agree with the reference's on at least 99.9% of the bits.
"""
import _torch_threads  # noqa: F401  (one torch thread a process)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fingerprint as jfp
from repro_torch import convert
from repro_torch.core import fingerprint as tfp

KW = dict(img_freq=16, img_time=32, img_hop=8, top_k=64, mad_sample_rate=1.0)


@pytest.fixture(scope="module")
def wave():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 12000)).astype(np.float32)
    x[1, 3000:3600] += 4 * np.sin(np.arange(600) * 0.6).astype(np.float32)
    return x


def _close(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()))


def _cfgs(**extra):
    kw = dict(KW, **extra)
    return jfp.FingerprintConfig(**kw), tfp.FingerprintConfig(**kw)


def test_config_properties_match():
    for kw in (KW, {}, dict(stft_len=100, img_freq=8, img_time=8)):
        j, t = jfp.FingerprintConfig(**kw), tfp.FingerprintConfig(**kw)
        for name in ("n_rfft", "band_bins", "n_coeff", "fp_dim",
                     "window_samples", "lag_samples", "overlap_fingerprints",
                     "halo_samples"):
            assert getattr(j, name) == getattr(t, name), name
        for n in (0, 500, 12000, 86400 * 100):
            assert j.n_fingerprints(n) == t.n_fingerprints(n)
        assert j.block_samples(256) == t.block_samples(256)


@pytest.mark.parametrize("stft_len,hop", [(200, 25), (100, 30)])
def test_spectrogram_close(wave, stft_len, hop):
    jc, tc = _cfgs(stft_len=stft_len, stft_hop=hop)
    got = tfp.spectrogram(torch.from_numpy(wave), tc)
    for r in range(wave.shape[0]):
        _close(got[r], jfp.spectrogram(jnp.asarray(wave[r]), jc))


def test_spectrogram_of_one_trace_drops_the_batch_axis(wave):
    _, tc = _cfgs()
    one = tfp.spectrogram(torch.from_numpy(wave[0]), tc)
    both = tfp.spectrogram(torch.from_numpy(wave), tc)
    assert one.dim() == 2 and torch.equal(one, both[0])


def test_spectral_images_close(wave):
    jc, tc = _cfgs()
    spec = np.array(jfp.spectrogram(jnp.asarray(wave[1]), jc))
    _close(tfp.spectral_images(torch.from_numpy(spec), tc),
           jfp.spectral_images(jnp.asarray(spec), jc))


def test_wavelet_coeffs_close(wave):
    jc, tc = _cfgs()
    imgs = np.array(jfp.spectral_images(
        jfp.spectrogram(jnp.asarray(wave[1]), jc), jc))
    _close(tfp.wavelet_coeffs(torch.from_numpy(imgs), tc),
           jfp.wavelet_coeffs(jnp.asarray(imgs), jc))


def test_coeffs_from_waveform_close(wave):
    jc, tc = _cfgs()
    got = tfp.coeffs_from_waveform(torch.from_numpy(wave), tc)
    for r in range(wave.shape[0]):
        _close(got[r], jfp.coeffs_from_waveform(jnp.asarray(wave[r]), jc))


@pytest.mark.parametrize("n_rows", [41, 40])   # odd and even medians
def test_mad_stats_close_at_full_rate(rng, n_rows):
    coeffs = rng.standard_normal((n_rows, 96)).astype(np.float32)
    med, mad = tfp.mad_stats(torch.from_numpy(coeffs), 1.0)
    jmed, jmad = jfp.mad_stats(jnp.asarray(coeffs), 1.0,
                               jax.random.PRNGKey(0))
    _close(med, jmed)
    _close(mad, jmad)


def test_mad_stats_on_given_rows(rng):
    coeffs = rng.standard_normal((200, 32)).astype(np.float32)
    rows = tfp.sample_rows(200, 0.1, seed=3)
    assert rows.shape == (20,) and len(set(rows.tolist())) == 20
    assert torch.equal(rows, tfp.sample_rows(200, 0.1, seed=3))
    med, mad = tfp.mad_stats(torch.from_numpy(coeffs), 0.1, rows)
    jmed, jmad = jfp.mad_stats(jnp.asarray(coeffs[rows.numpy()]), 1.0,
                               jax.random.PRNGKey(0))
    _close(med, jmed)
    _close(mad, jmad)
    with pytest.raises(ValueError):
        tfp.mad_stats(torch.from_numpy(coeffs), 0.1)


def test_binarize_bit_exact_given_coefficients(wave):
    jc, tc = _cfgs()
    coeffs = np.array(jfp.coeffs_from_waveform(jnp.asarray(wave[1]), jc))
    jmed, jmad = jfp.mad_stats(jnp.asarray(coeffs), 1.0,
                               jax.random.PRNGKey(0))
    jbits, jpacked = jfp.binarize_coeffs(jnp.asarray(coeffs), jc,
                                         (jmed, jmad))
    bits, packed = tfp.binarize_coeffs(torch.from_numpy(coeffs), tc,
                                       convert.med_mad(jmed, jmad, "cpu"))
    np.testing.assert_array_equal(bits.numpy(), np.asarray(jbits))
    np.testing.assert_array_equal(packed.numpy().view(np.uint32),
                                  np.asarray(jpacked))


def test_topk_keeps_ties(rng):
    jc, tc = _cfgs(top_k=5)
    z = rng.standard_normal((4, 32)).astype(np.float32)
    z[0, :8] = 3.0                 # eight-way tie at the 5th value
    z[1, :3] = -2.5
    z[1, 3:6] = 2.5
    got = tfp.topk_binarize(torch.from_numpy(z), tc)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jfp.topk_binarize(
                                      jnp.asarray(z), jc)))
    assert int(got[0].sum()) == 8


def test_fingerprints_from_waveform_bit_exact(wave):
    jc, tc = _cfgs()
    jbits, jpacked = jfp.fingerprints_from_waveform(jnp.asarray(wave[0]), jc)
    bits, packed = tfp.fingerprints_from_waveform(torch.from_numpy(wave[0]),
                                                  tc)
    np.testing.assert_array_equal(bits.numpy(), np.asarray(jbits))
    np.testing.assert_array_equal(packed.numpy().view(np.uint32),
                                  np.asarray(jpacked))


def test_config_fields_match_reference():
    assert dataclasses.fields(tfp.FingerprintConfig) and \
        {f.name for f in dataclasses.fields(tfp.FingerprintConfig)} == \
        {f.name for f in dataclasses.fields(jfp.FingerprintConfig)}
    assert tfp.FingerprintConfig(time_domain_bandpass=True) \
        .time_domain_bandpass


@pytest.mark.parametrize("kw", [{}, dict(bp_taps=101, band_lo_hz=1.0),
                                dict(fs=40.0, band_hi_hz=15.0)])
def test_bandpass_kernel_equals_reference(kw):
    j, t = jfp.FingerprintConfig(**kw), tfp.FingerprintConfig(**kw)
    np.testing.assert_array_equal(tfp.bandpass_kernel(t),
                                  jfp.bandpass_kernel(j))


@pytest.mark.parametrize("n", [100, 254, 255, 256, 3001, 12000])
def test_bandpass_matches_reference(wave, n):
    jc, tc = _cfgs(time_domain_bandpass=True)
    got = tfp.bandpass(torch.from_numpy(wave[:, :n]), tc)
    assert got.shape == (2, max(n, tc.bp_taps))
    for r in range(2):
        _close(got[r], jfp.bandpass(jnp.asarray(wave[r, :n]), jc))


@pytest.mark.parametrize("n,frame_len,hop", [
    (12000, 200, 25), (1000, 64, 7), (50, 200, 25), (200, 200, 25)])
def test_frame_matches_reference(wave, n, frame_len, hop):
    want = np.asarray(jfp.frame(jnp.asarray(wave[0, :n]), frame_len, hop))
    got = tfp.frame(torch.from_numpy(wave[:, :n]), frame_len, hop)
    assert got.shape == (2, *want.shape)
    np.testing.assert_array_equal(got[0].numpy(), want)


def test_spectrogram_with_time_domain_bandpass_close(wave):
    jc, tc = _cfgs(time_domain_bandpass=True)
    got = tfp.spectrogram(torch.from_numpy(wave), tc)
    for r in range(wave.shape[0]):
        _close(got[r], jfp.spectrogram(jnp.asarray(wave[r]), jc))


def test_bandpass_fingerprints_agree(wave):
    """Fingerprints through the bandpass, with the reference's statistics:
    the bits agree on ≥ 99.9% (the filtered samples differ in the last
    fp32 bits, which can move a coefficient across the top-k edge)."""
    jc, tc = _cfgs(time_domain_bandpass=True)
    for r in range(wave.shape[0]):
        coeffs = jfp.coeffs_from_waveform(jnp.asarray(wave[r]), jc)
        med, mad = jfp.mad_stats(coeffs, 1.0, None)
        want, _ = jfp.fingerprints_from_waveform(jnp.asarray(wave[r]), jc,
                                                 med_mad=(med, mad))
        got, _ = tfp.fingerprints_from_waveform(
            torch.from_numpy(wave[r]), tc,
            med_mad=(torch.from_numpy(np.array(med)),
                     torch.from_numpy(np.array(mad))))
        assert got.shape == want.shape
        assert (got.numpy() == np.asarray(want)).mean() >= 0.999
