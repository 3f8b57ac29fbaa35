"""Seeded synthetic archive partitions, their noise drawn on the device.

The recipe of the repository's synthetic seismic data (a copy of its
generator's, rewritten for the device): FFT-shaped coloured background
noise, repeating earthquake sources (a P and a larger, later S burst of
damped in-band oscillation) arriving at every station with a per-source
delay, and a repeating three-spike noise pattern at chosen stations
(paper Figure 7). What differs from the original is the draw: the bulk
noise comes from a ``torch.Generator`` on the device, and every seed gets
the same number of events and bursts, each event placed at random inside
its own equal slot of the partition, so the work a partition asks for is
the same from seed to seed and only its arrangement moves.
"""
from __future__ import annotations

import numpy as np
import torch


def _rng(seed: int, part: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) & (2**63 - 1), int(part)])


def _template(rng: np.random.Generator, fs: float, dur_s: float,
              band: tuple[float, float]) -> np.ndarray:
    t = np.arange(int(dur_s * fs)) / fs
    fp, fs_ = rng.uniform(*band), rng.uniform(*band)
    s_delay = rng.uniform(0.8, 2.0)
    tau_p, tau_s = rng.uniform(0.3, 0.8), rng.uniform(0.8, 1.8)
    p = np.exp(-t / tau_p) * np.sin(2 * np.pi * fp * t + rng.uniform(0, 6.28))
    ts = np.clip(t - s_delay, 0, None)
    s = (np.exp(-ts / tau_s) * np.sin(2 * np.pi * fs_ * ts)
         * (t >= s_delay) * rng.uniform(1.5, 2.5))
    return (p + s).astype(np.float32)


def _spikes(fs: float) -> np.ndarray:
    t = np.arange(int(2.0 * fs)) / fs
    out = np.zeros(t.size)
    for k, t0 in enumerate((0.2, 0.8, 1.4)):
        out += (np.exp(-np.abs(t - t0) / 0.05)
                * np.sin(2 * np.pi * 9.0 * (t - t0)) * (1.0 - 0.2 * k))
    return (3.0 * out).astype(np.float32)


def _add(wave: np.ndarray, starts: np.ndarray, rows: np.ndarray,
         values: np.ndarray) -> None:
    """wave[row, start:start + L] += values (one (L,) row of values each),
    clipped at the end of the trace; in order, so overlaps add the same
    way every time."""
    pos = starts[:, None] + np.arange(values.shape[1])[None, :]
    ok = pos < wave.shape[1]
    np.add.at(wave, (np.broadcast_to(rows[:, None], pos.shape)[ok], pos[ok]),
              values[ok])


def partition(seed: int, part: int, syn: dict, n_stations: int,
              hours: float, device) -> np.ndarray:
    """Partition ``part`` of ``seed``: (n_stations, hours·3600·fs) float32
    on the host, its noise drawn on ``device``. ``syn`` holds the recipe
    (``fs``, ``noise_sigma``, ``n_sources``, ``events_per_source``,
    ``event_snr``, ``event_freq_hz``, ``event_duration_s``, ``delay_s``,
    ``repeating_noise_stations``, ``repeating_noise_rate_hz``)."""
    fs = syn["fs"]
    n = int(round(hours * 3600 * fs))
    rng = _rng(seed, part)
    g = torch.Generator(device=device).manual_seed(
        int(rng.integers(2**62)))
    w = torch.randn((n_stations, n), generator=g, device=device)
    spec = torch.fft.rfft(w)
    del w
    f = torch.fft.rfftfreq(n, d=1.0, device=device)
    spec *= 1.0 / torch.sqrt(torch.clamp(f * n * 0.01, min=1.0))
    wave = torch.fft.irfft(spec, n)
    del spec
    wave *= syn["noise_sigma"] / wave.std(dim=1, keepdim=True)
    wave = wave.cpu().numpy()

    dur = syn["event_duration_s"]
    tpl = np.stack([_template(rng, fs, dur, syn["event_freq_hz"])
                    for _ in range(syn["n_sources"])])
    delays = rng.uniform(*syn["delay_s"], size=(syn["n_sources"], n_stations))
    n_ev = syn["n_sources"] * syn["events_per_source"]
    src = rng.permutation(np.repeat(np.arange(syn["n_sources"]),
                                    syn["events_per_source"]))
    slot = n / fs / n_ev
    margin = dur + syn["delay_s"][1] + 2.0
    t0 = np.arange(n_ev) * slot + rng.uniform(5.0, slot - margin, size=n_ev)
    amp = syn["event_snr"] * syn["noise_sigma"] * rng.uniform(
        0.9, 1.1, size=(n_ev, n_stations))
    starts = ((t0[:, None] + delays[src]) * fs).astype(np.int64)
    rows = np.broadcast_to(np.arange(n_stations), (n_ev, n_stations))
    _add(wave, starts.ravel(), rows.ravel(),
         (amp[..., None] * tpl[src][:, None, :]).reshape(-1, tpl.shape[1]))

    spikes = _spikes(fs)
    bursts = int(n / fs * syn["repeating_noise_rate_hz"])
    for st in syn["repeating_noise_stations"]:
        b0 = (rng.uniform(0, n / fs - 3.0, size=bursts) * fs).astype(np.int64)
        _add(wave, b0, np.full(bursts, st),
             np.broadcast_to(spikes, (bursts, spikes.size)))
    return wave
