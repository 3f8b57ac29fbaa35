"""Location / weighting / magnitude tier over the network association.

PyTorch counterpart of ``repro.core.locate``: the third stage of the
association anatomy, after ``core.align.associate_network`` (run with
``with_onsets=True``) has grouped per-station events by (dt, onset).

location
    ``locate_groups`` runs a migration/stacking pass: for candidate
    origins on a coarse-to-fine spatial grid, the per-station travel-time
    moveout is subtracted from the observed onsets and the quality-weighted
    residual is stacked; the argmin cell (refined ``refine_levels`` times)
    is the origin estimate, and a residual above ``moveout_tol_lags``
    marks a cross-station coincidence that fits no physical origin. The
    reference vmaps one group's stack under ``jax.jit``; here all groups
    go through one batched (G, grid_n², S) evaluation a refinement level,
    on the onsets' device, with no padding (torch compiles nothing per
    shape). No kernel of the port is involved: it is plain tensor
    arithmetic, float32 throughout as in the reference.
magnitude
    ``relative_magnitude`` sizes a detection from the amplitude ratio of
    the two occurrences of the repeating pair (weighted median of log10
    ratios). The weights and magnitudes are host numpy, a copy of the
    reference's.

Units: onsets and travel times in fingerprint lags, coordinates in km on
a [0, extent_km]² surface grid with a fixed focal depth.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch import utils
from repro_torch.core.lsh import INVALID

# alert-row sentinels (host/int64 side): location in milli-km, relative
# magnitude in milli-magnitudes
LOC_NONE = -1
MAG_NONE = -(1 << 31)


@dataclasses.dataclass(frozen=True)
class LocateConfig:
    grid_n: int = 12               # grid_n × grid_n candidate origins/level
    extent_km: float = 50.0        # surface grid spans [0, extent_km]²
    depth_km: float = 8.0          # fixed candidate focal depth
    velocity_km_s: float = 6.0     # homogeneous P speed
    refine_levels: int = 2         # coarse-to-fine argmin refinements
    refine_factor: float = 0.25    # span shrink per refinement level
    moveout_tol_lags: float = 4.0  # consistency: max weighted |residual|
    reject_inconsistent: bool = True   # drop groups failing the check
    min_weight: float = 0.05       # station quality-weight floor
    # the reference pads its device batch to this multiple (one jit trace
    # per padded size); the port takes any group count, so it is kept for
    # config parity only
    pad_groups: int = 32

    @property
    def coarse_cell_km(self) -> float:
        """Coarse-grid cell size — the origin-error unit the located-
        scenario acceptance (median error ≤ 2 cells) is judged in."""
        return self.extent_km / self.grid_n

    @property
    def cell_km(self) -> float:
        """Finest-level cell size after all refinements."""
        span = self.extent_km * self.refine_factor ** self.refine_levels
        return span / self.grid_n


# ---------------------------------------------------------------------------
# migration / stacking (device side)
# ---------------------------------------------------------------------------


def _f32(x, device) -> torch.Tensor:
    """A float32 0-d tensor on ``device``. Dividing by a tensor, not a
    Python number, keeps CUDA's true division (a CPU scalar divisor would
    become a multiply by its reciprocal, an ulp off the reference)."""
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _sum_last(x: torch.Tensor) -> torch.Tensor:
    """Sum over the (small) station axis left to right, the same order
    on every device."""
    acc = x[..., 0]
    for s in range(1, x.shape[-1]):
        acc = acc + x[..., s]
    return acc


def travel_time_lags(xy: torch.Tensor, station_xy: torch.Tensor,
                     cfg: LocateConfig, lag_s) -> torch.Tensor:
    """Travel time, in fingerprint lags, from origins ``xy`` (..., 2) to
    each station (S, 2) through the homogeneous halfspace: (..., S)."""
    dev = xy.device
    diff = xy[..., None, :] - station_xy
    d2 = diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1]
    dist = torch.sqrt(d2 + _f32(cfg.depth_km ** 2, dev))
    return dist / _f32(cfg.velocity_km_s, dev) / _f32(lag_s, dev)


def _grid_offsets(cfg: LocateConfig, device) -> torch.Tensor:
    """(grid_n², 2) unit-span candidate offsets in ``meshgrid(indexing=
    "ij")`` order, raveled — the reference's candidate order, so argmin
    ties resolve to the same cell."""
    offs = ((torch.arange(cfg.grid_n, dtype=torch.float32, device=device)
             + _f32(0.5, device)) / _f32(cfg.grid_n, device)
            - _f32(0.5, device))
    gx, gy = torch.meshgrid(offs, offs, indexing="ij")
    return torch.stack([gx.reshape(-1), gy.reshape(-1)], dim=1)


def locate_groups(onsets: torch.Tensor, weights: torch.Tensor,
                  station_xy: torch.Tensor, lag_s,
                  cfg: LocateConfig) -> dict:
    """Migration-stack ``(G, S)`` group onset matrices → per-group origin.

    ``onsets``: int32 lags, ``INVALID`` where a station is absent from
    the group; ``weights`` (S,) and ``station_xy`` (S, 2) float32 on the
    onsets' device. Returns ``xy`` (G, 2) km, ``t0`` (G,) lags,
    ``residual`` (G,) weighted mean |lags|, ``n_used`` (G,) int32
    stations stacked, and ``consistent`` — residual within
    ``moveout_tol_lags``. Each refinement level is one batched
    (G, grid_n², S) evaluation; ``argmin`` takes the first minimum, as the
    reference's does.
    """
    dev = onsets.device
    weights = weights.to(device=dev, dtype=torch.float32)
    station_xy = station_xy.to(device=dev, dtype=torch.float32)
    g = onsets.shape[0]
    present = onsets != INVALID
    w = torch.where(present,
                    torch.maximum(weights, _f32(cfg.min_weight, dev)),
                    _f32(0.0, dev)).expand(g, -1)
    wsum = torch.maximum(_sum_last(w), _f32(1e-9, dev))
    on = torch.where(present, onsets, 0).to(torch.float32)
    offs = _grid_offsets(cfg, dev)
    center = torch.full((g, 2), 0.5 * cfg.extent_km, dtype=torch.float32,
                        device=dev)
    span = _f32(cfg.extent_km, dev)
    t0 = resid = torch.zeros(g, dtype=torch.float32, device=dev)
    rows = torch.arange(g, device=dev)
    for _ in range(cfg.refine_levels + 1):
        cand = torch.clamp(center[:, None, :] + span * offs,
                           0.0, cfg.extent_km)                   # (G, K, 2)
        tt = travel_time_lags(cand, station_xy, cfg, lag_s)      # (G, K, S)
        d = on[:, None, :] - tt
        t0_k = _sum_last(w[:, None, :] * d) / wsum[:, None]     # (G, K)
        r_k = _sum_last(w[:, None, :] * torch.abs(d - t0_k[..., None])) \
            / wsum[:, None]
        best = torch.argmin(r_k, dim=1)
        center, t0, resid = cand[rows, best], t0_k[rows, best], r_k[rows, best]
        span = span * _f32(cfg.refine_factor, dev)
    return {"xy": center, "t0": t0, "residual": resid,
            "n_used": present.sum(dim=1, dtype=torch.int32),
            "consistent": resid <= _f32(cfg.moveout_tol_lags, dev)}


# ---------------------------------------------------------------------------
# station quality weights (host side, from the QC counters)
# ---------------------------------------------------------------------------


def station_weights(qualities: Sequence[dict], samples: Sequence[int],
                    fingerprints: Sequence[int],
                    cfg: LocateConfig) -> np.ndarray:
    """Per-station stack weights from the ingest/guard QC counters.

    Sample-level dirt (gaps, missing/late-dropped/rejected telemetry,
    duplicated spans) and fingerprint-level dirt (dup-probe and
    saturation-quarantine suppressions, validity-masked fingerprints)
    become rates against the station's own traffic; the weight is
    ``1 - rate`` floored at ``min_weight``.
    """
    sample_keys = ("gap_samples", "missing_samples", "late_dropped_samples",
                   "rejected_samples", "duplicate_samples")
    fp_keys = ("duplicate_fingerprints", "masked_fingerprints",
               "saturated_lookups")
    w = np.ones(len(qualities), np.float32)
    for i, q in enumerate(qualities):
        rate = (sum(int(q.get(k, 0)) for k in sample_keys)
                / max(int(samples[i]), 1)
                + sum(int(q.get(k, 0)) for k in fp_keys)
                / max(int(fingerprints[i]), 1))
        w[i] = min(1.0, max(cfg.min_weight, 1.0 - rate))
    return w


# ---------------------------------------------------------------------------
# relative magnitude (host side)
# ---------------------------------------------------------------------------


def weighted_median(values: np.ndarray, weights: np.ndarray) -> float:
    """Host weighted median (first value reaching half the weight mass)."""
    values = np.asarray(values, np.float64).reshape(-1)
    weights = np.asarray(weights, np.float64).reshape(-1)
    ok = np.isfinite(values) & (weights > 0)
    if not ok.any():
        return float("nan")
    v, w = values[ok], weights[ok]
    order = np.argsort(v)
    v, w = v[order], w[order]
    cw = np.cumsum(w)
    return float(v[np.searchsorted(cw, 0.5 * cw[-1])])


def relative_magnitude(amp_first: np.ndarray, amp_second: np.ndarray,
                       weights: np.ndarray) -> float:
    """Relative magnitude of the re-occurrence vs. its template: the
    weighted median of the members' log10 amplitude ratios. NaN when no
    member has two usable (finite, positive) amplitudes."""
    a1 = np.asarray(amp_first, np.float64).reshape(-1)
    a2 = np.asarray(amp_second, np.float64).reshape(-1)
    w = np.asarray(weights, np.float64).reshape(-1)
    ok = np.isfinite(a1) & np.isfinite(a2) & (a1 > 0) & (a2 > 0)
    return weighted_median(np.where(ok, np.log10(np.maximum(a2, 1e-30))
                                    - np.log10(np.maximum(a1, 1e-30)),
                                    np.nan),
                           np.where(ok, w, 0.0))


def fingerprint_amplitudes(waveform: np.ndarray, lag_samples: int,
                           window_samples: int) -> np.ndarray:
    """Per-fingerprint peak |amplitude|: max over each fingerprint's
    analysis window, as a lag-binned max + sliding max (host). NaN
    samples (missing telemetry) count as 0."""
    x = np.abs(np.nan_to_num(np.asarray(waveform, np.float32), nan=0.0))
    nb = -(-x.size // lag_samples)
    pad = np.zeros(nb * lag_samples, np.float32)
    pad[:x.size] = x
    bins = pad.reshape(nb, lag_samples).max(axis=1)
    w_bins = max(1, -(-window_samples // lag_samples))
    if w_bins > 1:
        bins = np.concatenate([bins, np.zeros(w_bins - 1, np.float32)])
        bins = np.lib.stride_tricks.sliding_window_view(
            bins, w_bins).max(axis=1)
    return bins


def magnitudes_from_onsets(station_onset: np.ndarray, dt: np.ndarray,
                           valid: np.ndarray, amp_fn,
                           weights: np.ndarray,
                           station_score: np.ndarray | None = None
                           ) -> np.ndarray:
    """Per-group relative magnitudes from the two occurrences' amplitudes.

    ``amp_fn(station, fp_index) -> float | None`` is the amplitude source:
    whole-trace peaks in the batch driver, the bounded timeline in the
    stream. A station's weight is its quality weight times the group's
    pair mass there (``station_score``). NaN where no station has both.
    """
    station_onset = np.asarray(station_onset)
    dt = np.asarray(dt)
    valid = np.asarray(valid)
    p, s = station_onset.shape
    mags = np.full(p, np.nan, np.float32)
    for g in np.nonzero(valid)[0]:
        a1, a2, w = [], [], []
        for st in range(s):
            o = int(station_onset[g, st])
            if o == INVALID:
                continue
            f = amp_fn(st, o)
            r = amp_fn(st, o + int(dt[g]))
            if f is None or r is None:
                continue
            a1.append(f)
            a2.append(r)
            ws = float(weights[st])
            if station_score is not None:
                ws *= max(float(station_score[g, st]), 0.0)
            w.append(ws)
        if a1:
            mags[g] = relative_magnitude(np.asarray(a1), np.asarray(a2),
                                         np.asarray(w))
    return mags


# ---------------------------------------------------------------------------
# host wrapper: det dict → located det dict
# ---------------------------------------------------------------------------


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def locate_detections(det: dict, station_xy: np.ndarray,
                      weights: np.ndarray, lag_s: float,
                      cfg: LocateConfig, device=None) -> dict:
    """Locate every valid associated group of an ``associate_network``
    output (run with ``with_onsets=True``).

    The valid groups' onset rows go through one ``locate_groups`` call on
    ``device`` (default: the device of ``det["station_onset"]`` when it is
    a tensor, else ``cuda``) and come back in one device→host copy,
    scattered into det-aligned numpy arrays: ``x_km`` / ``y_km`` / ``t0``
    / ``residual`` / ``n_used`` / ``consistent`` (NaN / 0 / False on
    invalid rows). The input dict is not modified.
    """
    if "station_onset" not in det:
        raise ValueError("locate_detections needs associate_network output "
                         "with with_onsets=True (no station_onset key)")
    onset_src = det["station_onset"]
    if device is None and isinstance(onset_src, torch.Tensor):
        device = onset_src.device
    dev = utils.resolve_device(device)
    v = _host(det["valid"]).astype(bool)
    onset_mat = _host(onset_src)
    p = onset_mat.shape[0]
    idx = np.nonzero(v)[0]
    g = idx.shape[0]
    x = np.full(p, np.nan, np.float32)
    y = np.full(p, np.nan, np.float32)
    t0 = np.full(p, np.nan, np.float32)
    resid = np.full(p, np.nan, np.float32)
    n_used = np.zeros(p, np.int32)
    consistent = np.zeros(p, bool)
    if g:
        out = locate_groups(
            torch.as_tensor(np.ascontiguousarray(onset_mat[idx]),
                            dtype=torch.int32, device=dev),
            torch.as_tensor(np.asarray(weights, np.float32), device=dev),
            torch.as_tensor(np.asarray(station_xy, np.float32), device=dev),
            np.float32(lag_s), cfg)
        host = torch.stack([out["xy"][:, 0], out["xy"][:, 1], out["t0"],
                            out["residual"], out["n_used"].to(torch.float32),
                            out["consistent"].to(torch.float32)]
                           ).cpu().numpy()
        x[idx], y[idx], t0[idx], resid[idx] = host[0], host[1], host[2], \
            host[3]
        n_used[idx] = host[4].astype(np.int32)
        consistent[idx] = host[5] > 0
    return {"x_km": x, "y_km": y, "t0": t0, "residual": resid,
            "n_used": n_used, "consistent": consistent}


def attach_location(det: dict, station_xy: np.ndarray,
                    weights: np.ndarray, lag_s: float, cfg: LocateConfig,
                    amp_fn, stats: dict | None = None, device=None) -> dict:
    """The full location/magnitude stage over an ``associate_network``
    output (with onsets): locate + size every valid group and return a
    new detections dict with the located columns attached (``x_km`` /
    ``y_km`` / ``t0`` / ``residual`` / ``n_used`` / ``consistent`` /
    ``magnitude`` / ``station_weight``, numpy). With
    ``reject_inconsistent``, groups failing the moveout check are masked
    out of ``valid`` (then numpy) and the count lands in
    ``stats["moveout_rejected"]``. Shared by the batch tail and the
    streaming finalize; ``amp_fn`` is the amplitude source.
    """
    loc = locate_detections(det, station_xy, weights, lag_s, cfg, device)
    out = dict(det)
    out.update(loc)
    out["station_weight"] = np.asarray(weights, np.float32)
    valid = _host(det["valid"]).astype(bool)
    out["magnitude"] = magnitudes_from_onsets(
        _host(det["station_onset"]), _host(det["dt"]), valid, amp_fn,
        weights, _host(det["station_score"]))
    if cfg.reject_inconsistent:
        now = valid & loc["consistent"]
        if stats is not None:
            stats["moveout_rejected"] = int(valid.sum() - now.sum())
        out["valid"] = now
    return out
