"""Synthetic seismic data generator (numpy only).

A copy of the clean-dataset half of ``repro.core.synth`` (``SynthConfig``,
``SynthDataset``, ``make_dataset``), so the port and ``chip_smoke.py``
need nothing of the JAX package. The same config gives the same traces,
draw for draw: reoccurring earthquakes with per-station travel-time
delays, P/S structure, correlated repeating noise (paper Figure 7),
out-of-band hum bursts and band-limited background noise. The dirty-data
scenario layer comes with a later slice.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class SynthConfig:
    fs: float = 100.0
    duration_s: float = 600.0
    n_stations: int = 3
    n_sources: int = 3
    events_per_source: int = 4
    event_freq_hz: tuple[float, float] = (5.0, 14.0)   # in-band
    event_duration_s: float = 6.0
    event_snr: float = 2.5
    noise_sigma: float = 1.0
    # correlated repeating noise (paper Fig 7) at these stations
    repeating_noise_stations: tuple[int, ...] = ()
    repeating_noise_rate_hz: float = 0.05   # bursts per second
    # > 0: bursts arrive *periodically* at this period with a random
    # station-local phase (± 1 s jitter) instead of Poisson times — the
    # shared-period / independent-phase shape of anthropogenic noise
    # (machinery on a common duty cycle). Inter-burst times then agree
    # across stations while onsets fit no physical moveout: the
    # cross-station coincidence pressure the located-association A/B
    # (bench_stream --assoc) measures. 0 keeps the Poisson draw path
    # and the golden traces byte-identical.
    repeating_noise_period_s: float = 0.0
    repeating_noise_amp: float = 1.0        # template multiplier
    # narrowband hum (outside 3-20 Hz band) at these stations
    hum_stations: tuple[int, ...] = ()
    hum_freq_hz: float = 30.0
    hum_amp: float = 1.5
    # physical station geometry: stations and sources get coordinates on
    # a [0, extent_km]² surface grid and arrival delays become real
    # travel times (hypocentral distance / velocity) instead of uniform
    # draws — located scenarios then have ground-truth origins. Opt-in:
    # the default (False) keeps the RNG draw sequence and therefore the
    # golden traces byte-identical.
    physical_geometry: bool = False
    extent_km: float = 50.0
    depth_km: float = 8.0
    velocity_km_s: float = 6.0
    seed: int = 0


@dataclasses.dataclass
class SynthDataset:
    waveforms: np.ndarray          # (n_stations, T) float32
    event_times: np.ndarray        # (n_events,) seconds (source origin time)
    event_sources: np.ndarray      # (n_events,) int
    arrival_delays: np.ndarray     # (n_sources, n_stations) seconds
    cfg: SynthConfig
    # physical-geometry ground truth (None unless cfg.physical_geometry)
    station_xy: np.ndarray | None = None   # (n_stations, 2) km
    source_xy: np.ndarray | None = None    # (n_sources, 2) km

    def arrival_time(self, ev: int, station: int) -> float:
        return float(self.event_times[ev]
                     + self.arrival_delays[self.event_sources[ev], station])


def _source_template(rng: np.random.Generator, cfg: SynthConfig) -> np.ndarray:
    """P + S wave burst: two damped oscillations, S delayed and larger."""
    n = int(cfg.event_duration_s * cfg.fs)
    t = np.arange(n) / cfg.fs
    fp = rng.uniform(*cfg.event_freq_hz)
    fs_ = rng.uniform(*cfg.event_freq_hz)
    s_delay = rng.uniform(0.8, 2.0)
    tau_p, tau_s = rng.uniform(0.3, 0.8), rng.uniform(0.8, 1.8)
    p = np.exp(-t / tau_p) * np.sin(2 * np.pi * fp * t + rng.uniform(0, 6.28))
    ts = np.clip(t - s_delay, 0, None)
    s = (np.exp(-ts / tau_s) * np.sin(2 * np.pi * fs_ * ts)
         * (t >= s_delay) * rng.uniform(1.5, 2.5))
    return (p + s).astype(np.float32)


def _colored_noise_fast(rng: np.random.Generator, n: int,
                        sigma: float) -> np.ndarray:
    """FFT-shaped background noise (vectorized; ~1/sqrt(f) above 1 Hz)."""
    w = rng.standard_normal(n).astype(np.float32)
    spec = np.fft.rfft(w)
    f = np.fft.rfftfreq(n, d=1.0)
    shape = 1.0 / np.sqrt(np.maximum(f * n * 0.01, 1.0))
    return (np.fft.irfft(spec * shape, n) * sigma
            / max(np.std(np.fft.irfft(spec * shape, n)), 1e-9)).astype(
                np.float32)


def _repeating_noise_template(rng: np.random.Generator,
                              cfg: SynthConfig) -> np.ndarray:
    """Three-spike pattern like Figure 7 — identical at every repeat."""
    n = int(2.0 * cfg.fs)
    t = np.arange(n) / cfg.fs
    out = np.zeros(n, np.float32)
    for k, t0 in enumerate((0.2, 0.8, 1.4)):
        env = np.exp(-np.abs(t - t0) / 0.05)
        out += env * np.sin(2 * np.pi * 9.0 * (t - t0)) * (1.0 - 0.2 * k)
    return out * 3.0


def make_dataset(cfg: SynthConfig) -> SynthDataset:
    rng = np.random.default_rng(cfg.seed)
    n = int(cfg.duration_s * cfg.fs)
    wf = np.stack([
        _colored_noise_fast(rng, n, cfg.noise_sigma)
        for _ in range(cfg.n_stations)])

    # sources & events
    templates = [_source_template(rng, cfg) for _ in range(cfg.n_sources)]
    station_xy = source_xy = None
    if cfg.physical_geometry:
        # a separate generator so the main draw sequence (and the golden
        # traces pinned on it) is untouched when geometry is off
        grng = np.random.default_rng(cfg.seed ^ 0x9E0C37)
        station_xy = grng.uniform(0.05 * cfg.extent_km, 0.95 * cfg.extent_km,
                                  size=(cfg.n_stations, 2))
        source_xy = grng.uniform(0.1 * cfg.extent_km, 0.9 * cfg.extent_km,
                                 size=(cfg.n_sources, 2))
        dist = np.sqrt(((source_xy[:, None, :]
                         - station_xy[None, :, :]) ** 2).sum(-1)
                       + cfg.depth_km ** 2)
        delays = dist / cfg.velocity_km_s
    else:
        delays = rng.uniform(1.0, 8.0, size=(cfg.n_sources, cfg.n_stations))
    ev_times, ev_src = [], []
    margin = cfg.event_duration_s + delays.max() + 2.0
    for s in range(cfg.n_sources):
        times = rng.uniform(5.0, cfg.duration_s - margin,
                            size=cfg.events_per_source)
        times = np.sort(times)
        # keep events apart so ground truth is unambiguous
        keep = np.concatenate([[True], np.diff(times) > 2 * margin])
        for t0 in times[keep]:
            ev_times.append(t0)
            ev_src.append(s)
    ev_times = np.asarray(ev_times)
    ev_src = np.asarray(ev_src, np.int32)

    amp = cfg.event_snr * cfg.noise_sigma
    for t0, s in zip(ev_times, ev_src):
        tpl = templates[s]
        for st in range(cfg.n_stations):
            i0 = int((t0 + delays[s, st]) * cfg.fs)
            seg = wf[st, i0:i0 + tpl.size]
            seg += amp * tpl[: seg.size] * rng.uniform(0.9, 1.1)

    # correlated repeating noise
    rep_tpl = _repeating_noise_template(rng, cfg)
    for st in cfg.repeating_noise_stations:
        if cfg.repeating_noise_period_s > 0:
            # shared period, independent station phase: exact spacing
            # keeps the repeats aligned to the fingerprint lag grid (the
            # duty-cycle regularity that makes anthropogenic noise
            # self-similar), so inter-burst times agree across stations
            # while the onsets fit no physical moveout — the coincidence
            # pressure of the located-association A/B
            p = cfg.repeating_noise_period_s
            t0s = np.arange(rng.uniform(0, p), cfg.duration_s - 3.0, p)
        else:
            n_bursts = int(cfg.duration_s * cfg.repeating_noise_rate_hz)
            t0s = rng.uniform(0, cfg.duration_s - 3.0, size=n_bursts)
        for t0 in t0s:
            i0 = int(max(t0, 0.0) * cfg.fs)
            seg = wf[st, i0:i0 + rep_tpl.size]
            seg += cfg.repeating_noise_amp * rep_tpl[: seg.size]

    # narrowband bursts: identical out-of-band (30 Hz) tone bursts that
    # repeat — stationary hum would be cancelled by the MAD normalization
    # (a robustness property verified in tests); the paper's Fig-18 noise
    # is bursty, which is what the bandpass filter must exclude
    burst_n = int(3.0 * cfg.fs)
    tb = np.arange(burst_n) / cfg.fs
    hum_tpl = (cfg.hum_amp * np.sin(2 * np.pi * cfg.hum_freq_hz * tb)
               * np.hanning(burst_n)).astype(np.float32)
    for st in cfg.hum_stations:
        n_bursts = max(1, int(cfg.duration_s * 0.08))
        for t0 in rng.uniform(0, cfg.duration_s - 4.0, size=n_bursts):
            i0 = int(t0 * cfg.fs)
            seg = wf[st, i0:i0 + burst_n]
            seg += hum_tpl[: seg.size]

    return SynthDataset(waveforms=wf.astype(np.float32),
                        event_times=ev_times, event_sources=ev_src,
                        arrival_delays=delays, cfg=cfg,
                        station_xy=station_xy, source_xy=source_xy)
