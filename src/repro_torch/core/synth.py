"""Synthetic seismic data generator (numpy only).

A copy of ``repro.core.synth``, so the port and ``chip_smoke.py`` need
nothing of the JAX package. The same config gives the same arrays, draw
for draw: reoccurring earthquakes with per-station travel-time delays,
P/S structure, correlated repeating noise (paper Figure 7), out-of-band
hum bursts and band-limited background noise (``make_dataset``), and the
deployment pathologies layered on a clean trace by
``make_scenario_dataset``: telemetry gaps and station dropouts (NaN),
duplicated data blocks, repeating instrument glitch trains and
clock-drifted copies, with masks of the missing and the altered samples.
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


def _colored_noise(rng: np.random.Generator, n: int, sigma: float) -> np.ndarray:
    w = rng.standard_normal(n).astype(np.float32)
    # cheap band-shaping: first-order smoothing + diff mix ≈ mid-band noise
    sm = np.empty_like(w)
    acc = 0.0
    a = 0.7
    for start in range(0, n, 1 << 20):  # chunked to keep it vectorizable
        chunk = w[start:start + (1 << 20)]
        out = np.empty_like(chunk)
        for i, x in enumerate(chunk):
            acc = a * acc + (1 - a) * x
            out[i] = acc
        sm[start:start + (1 << 20)] = out
    return (0.6 * w + 0.8 * sm) * sigma

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


# ---------------------------------------------------------------------------
# dirty-data scenarios: the deployment pathologies layered on a clean trace
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ScenarioConfig:
    """Fault-injection knobs over a clean ``SynthConfig`` trace.

    Missing data (gaps, dropouts) is marked with NaN — the wire format the
    streaming ingest treats as "sample never arrived". Corrupted-but-
    present data (duplicated blocks, glitch trains, drift) stays finite;
    the ``corrupt`` mask records where it lives so tests can separate the
    clean portion from the injected one.
    """

    base: SynthConfig = SynthConfig()
    # telemetry gaps: short spans of missing samples (NaN)
    n_gaps: int = 0
    gap_dur_s: tuple[float, float] = (2.0, 8.0)
    gap_stations: tuple[int, ...] | None = None   # None = any station
    # station dropout: one long missing span per listed station
    dropout_stations: tuple[int, ...] = ()
    dropout_start_frac: float = 0.45
    dropout_dur_s: float = 60.0
    # duplicated data blocks: an earlier span re-appears verbatim later
    # (telemetry repeat). dst - src is aligned to ``dup_align_samples`` so
    # the copy lands on the fingerprint lag grid (bit-exact duplicate
    # fingerprints, the worst case for the duplicate guard).
    n_dup_blocks: int = 0
    dup_block_dur_s: float = 20.0
    dup_spacing_s: float = 60.0
    dup_align_samples: int = 200
    # repeating instrument glitch trains: identical pulses at a fixed
    # period, in episodes. period = fingerprint lag makes consecutive
    # fingerprints inside a train near-identical — the mega-bucket /
    # spurious-pair generator the paper's §6.5 quality controls target.
    # ``glitch_replace=True`` models digital-origin artifacts (calibration
    # pulses, electronics steps) that *clobber* the sensor output — the
    # train is then sample-exact periodic, the worst duplicate case;
    # False adds the pulses on top of the live noise floor (near-exact at
    # the fingerprint level only — the saturation guard's case).
    glitch_stations: tuple[int, ...] = ()
    glitch_trains: int = 3
    glitch_train_dur_s: float = 24.0
    glitch_period_s: float = 2.0
    glitch_amp: float = 25.0
    glitch_replace: bool = True
    glitch_jitter: float = 0.0    # per-pulse amplitude jitter (0 = exact)
    # clock drift: the station's timeline resampled by (1 + ppm * 1e-6)
    clock_drift_stations: tuple[int, ...] = ()
    clock_drift_ppm: float = 0.0
    seed: int = 0


@dataclasses.dataclass
class ScenarioDataset:
    """A dirty stream plus everything needed to judge a detector on it."""

    clean: SynthDataset            # the underlying clean dataset
    waveforms: np.ndarray          # (S, T) float32, NaN where missing
    missing: np.ndarray            # (S, T) bool — samples that never arrived
    corrupt: np.ndarray            # (S, T) bool — samples altered in place
    injections: dict               # per-pathology logs (spans, stations)
    cfg: ScenarioConfig

    @property
    def station_xy(self) -> np.ndarray | None:
        """Ground-truth station geometry (physical-geometry bases only)."""
        return self.clean.station_xy

    @property
    def source_xy(self) -> np.ndarray | None:
        return self.clean.source_xy

    def clean_fp_ids(self, station: int, window_samples: int,
                     lag_samples: int) -> np.ndarray:
        """Fingerprint ids whose analysis window touches no injected
        pathology (neither missing nor corrupted samples) — the ids on
        which a guarded dirty run must match the clean golden exactly."""
        bad = self.missing[station] | self.corrupt[station]
        t = bad.shape[0]
        n = max(0, (t - window_samples) // lag_samples + 1)
        csum = np.concatenate([[0], np.cumsum(bad)])
        starts = np.arange(n) * lag_samples
        ok = (csum[starts + window_samples] - csum[starts]) == 0
        return np.nonzero(ok)[0].astype(np.int64)


def _glitch_template(fs: float) -> np.ndarray:
    """Repeating instrument glitch: a strong damped in-band oscillation
    (~1.5 s, 8 Hz). At the default amplitude it dominates the top-K
    anomalous coefficients of every window it lands in, so train
    fingerprints become near-identical (Jaccard ≳ 0.95) and collide in
    nearly all hash tables — the paper's mega-bucket pathology."""
    n = int(1.5 * fs)
    t = np.arange(n) / fs
    return (np.exp(-t / 0.5) * np.sin(2 * np.pi * 8.0 * t)).astype(
        np.float32)


def make_scenario_dataset(cfg: ScenarioConfig) -> ScenarioDataset:
    """Clean dataset + injected pathologies → a dirty stream with masks."""
    clean = make_dataset(cfg.base)
    rng = np.random.default_rng(cfg.seed ^ 0x5C3A51)
    wf = clean.waveforms.copy()
    s_n, t_n = wf.shape
    fs = cfg.base.fs
    missing = np.zeros((s_n, t_n), bool)
    corrupt = np.zeros((s_n, t_n), bool)
    inj: dict[str, list] = {"gaps": [], "dropouts": [], "dup_blocks": [],
                            "glitch_trains": [], "drift": []}

    gap_st = (tuple(range(s_n)) if cfg.gap_stations is None
              else cfg.gap_stations)
    for _ in range(cfg.n_gaps):
        st = int(gap_st[int(rng.integers(0, len(gap_st)))])
        dur = int(rng.uniform(*cfg.gap_dur_s) * fs)
        i0 = int(rng.integers(0, max(1, t_n - dur)))
        missing[st, i0:i0 + dur] = True
        inj["gaps"].append({"station": st, "start": i0, "len": dur})

    for st in cfg.dropout_stations:
        i0 = int(cfg.dropout_start_frac * t_n)
        dur = int(cfg.dropout_dur_s * fs)
        missing[st, i0:i0 + dur] = True
        inj["dropouts"].append({"station": st, "start": i0, "len": dur})

    blk = int(cfg.dup_block_dur_s * fs)
    align = max(1, int(cfg.dup_align_samples))
    spacing = (int(cfg.dup_spacing_s * fs) // align) * align
    for _ in range(cfg.n_dup_blocks):
        st = int(rng.integers(0, s_n))
        hi = max(align, t_n - blk - spacing)
        src = (int(rng.integers(0, hi)) // align) * align
        dst = src + spacing
        span = min(blk, t_n - dst)
        if span <= 0:      # trace too short for this spacing: no copy
            continue       # lands, so don't log a phantom injection
        wf[st, dst:dst + span] = wf[st, src:src + span]
        corrupt[st, dst:dst + span] = True
        inj["dup_blocks"].append({"station": st, "src": src, "dst": dst,
                                  "len": span})

    tpl = _glitch_template(fs)
    period = int(cfg.glitch_period_s * fs)
    train_n = int(cfg.glitch_train_dur_s * fs)
    for st in cfg.glitch_stations:
        for k in range(cfg.glitch_trains):
            # trains spaced evenly, start phase-locked to the pulse clock
            # (digital-origin artifacts fire on the instrument's clock, so
            # every repeat lands at the same phase mod period)
            slot = t_n / (cfg.glitch_trains + 1)
            i0 = int((k + 1) * slot - train_n / 2)
            i0 = max(0, min(i0, t_n - train_n - period))
            i0 = (i0 // period) * period
            for t0 in range(i0, i0 + train_n, period):
                amp = cfg.glitch_amp * cfg.base.noise_sigma
                if cfg.glitch_jitter > 0:
                    amp *= 1.0 + cfg.glitch_jitter * rng.uniform(-1.0, 1.0)
                seg = wf[st, t0:t0 + period]
                pulse = np.zeros(period, np.float32)
                pulse[: min(tpl.size, period)] = \
                    amp * tpl[: min(tpl.size, period)]
                if cfg.glitch_replace:
                    seg[:] = pulse[: seg.size]
                else:
                    seg += pulse[: seg.size]
            corrupt[st, i0:i0 + train_n + period] = True
            inj["glitch_trains"].append({"station": st, "start": i0,
                                         "len": train_n + period,
                                         "period": period})

    for st in cfg.clock_drift_stations:
        f = 1.0 + cfg.clock_drift_ppm * 1e-6
        src_t = np.clip(np.arange(t_n) * f, 0, t_n - 1)
        wf[st] = np.interp(src_t, np.arange(t_n), wf[st]).astype(np.float32)
        # the resample alters the station's entire timeline — nothing on
        # it is sample-comparable to the clean trace
        corrupt[st, :] = cfg.clock_drift_ppm != 0
        inj["drift"].append({"station": st, "ppm": cfg.clock_drift_ppm})

    dirty = wf.astype(np.float32).copy()
    dirty[missing] = np.nan
    return ScenarioDataset(clean=clean, waveforms=dirty, missing=missing,
                           corrupt=corrupt, injections=inj, cfg=cfg)
