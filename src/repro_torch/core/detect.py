"""End-to-end FAST detection (paper Figure 2): the batch driver.

PyTorch counterpart of ``repro.core.detect``. ``detect_events`` replays
(S, T) archive traces through the pooled block step
(``stream.fused.pool_step_block``) — fingerprint, hash, guarded index
search and verify for all stations in one pass per block — then runs the
host tail: §6.5 occurrence filter → channel merge → station clustering →
network association.

Stages are attributed through ``obsv.SpanTracer`` spans, read back into
``StageTimes``: ``fingerprint_s`` is the §5.2 statistics pass,
``hashgen_s`` the hash mappings, ``fused_step_s`` the block replay (all
per-block device work) and ``align_s`` the host tail. On the card each
span ends in a device synchronisation, so the times are wall times of
finished work.

With ``cfg.locate`` (a ``core.locate.LocateConfig``) and ``station_xy``
given, the host tail ends in the location / magnitude tier: the
association keeps each group's per-station onsets, ``core.locate``
migration-stacks them on the device into an origin and a moveout
residual, and the groups are sized from whole-trace peak amplitudes
(``_locate_tail``).

``detect_step`` is the one-chunk core: a chunk's fingerprints through
one guarded index step over a fresh index, the occurrence filter and
station clustering, with fixed output shapes (the reference's jittable
core for chunk-parallel runs). ``detect_step_sharded`` runs a (C,
samples) array of chunks over a ``stations`` mesh (``dist.station_mesh``):
each device takes its contiguous block of chunks as the rows of pooled
calls of the same core, with no collective.

``detect_events`` runs on ``cuda`` unless ``device="cpu"`` is passed; it
raises when CUDA is missing and the CPU was not asked for.

The ``repro_torch.stream`` modules it drives are imported inside the
functions: they import ``core`` themselves, so a module-level import here
would make ``import repro_torch.stream.engine`` circular.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import dist, utils
from repro_torch.core import align as align_mod
from repro_torch.core import fingerprint as fp_mod
from repro_torch.core import lsh as lsh_mod
from repro_torch.core.align import AlignConfig, Events
from repro_torch.core import locate as locate_mod
from repro_torch.core.fingerprint import FingerprintConfig
from repro_torch.core.locate import LocateConfig
from repro_torch.core.lsh import LSHConfig, Pairs
from repro_torch.obsv.spans import SpanTracer


@dataclasses.dataclass(frozen=True)
class DetectConfig:
    fingerprint: FingerprintConfig = FingerprintConfig()
    lsh: LSHConfig = LSHConfig()
    align: AlignConfig = AlignConfig()
    # optional location/magnitude tier (core.locate); None = association
    # stops at the pairwise network stage
    locate: LocateConfig | None = None


@dataclasses.dataclass
class StageTimes:
    """Wall seconds per phase (see the module docstring)."""

    fingerprint_s: float = 0.0   # §5.2 statistics pass
    hashgen_s: float = 0.0       # hash-mapping construction
    fused_step_s: float = 0.0    # block replay: all per-block device work
    align_s: float = 0.0         # §6.5 filter + clustering + association

    def total(self) -> float:
        return (self.fingerprint_s + self.hashgen_s + self.fused_step_s
                + self.align_s)

    @classmethod
    def from_spans(cls, tracer) -> "StageTimes":
        return cls(fingerprint_s=tracer.total_s("fingerprint_stats"),
                   hashgen_s=tracer.total_s("hashgen"),
                   fused_step_s=tracer.total_s("fused_step"),
                   align_s=tracer.total_s("host_tail"))


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _locate_tail(detections: dict, waveforms: np.ndarray,
                 qc_sum: np.ndarray, n_fp: int,
                 station_xy: np.ndarray, cfg: DetectConfig,
                 stats: dict, dev: torch.device) -> dict:
    """Batch location/magnitude stage: QC-counter station weights →
    migration stack over the associated groups (on ``dev``) → relative
    magnitudes from whole-trace per-fingerprint peak amplitudes. Adds
    ``stats["moveout_rejected"]`` and returns a new detections dict with
    the located columns; ``reject_inconsistent`` masks failing groups out
    of ``valid``."""
    from repro_torch.stream import index as index_mod
    fcfg = cfg.fingerprint
    n_stations = waveforms.shape[0]
    qdicts = [{name: int(qc_sum[st, k])
               for k, name in enumerate(index_mod.QC_FIELDS)}
              for st in range(n_stations)]
    weights = locate_mod.station_weights(
        qdicts, [waveforms.shape[1]] * n_stations,
        [n_fp] * n_stations, cfg.locate)
    fp_amp = [locate_mod.fingerprint_amplitudes(
        waveforms[st], fcfg.lag_samples, fcfg.window_samples)
        for st in range(n_stations)]

    def amp(st, i):
        a = fp_amp[st]
        return float(a[i]) if 0 <= i < a.size else None

    return locate_mod.attach_location(
        detections, np.asarray(station_xy, np.float32), weights,
        fcfg.lag_samples / fcfg.fs, cfg.locate, amp, stats, device=dev)


def replay_config(lcfg: LSHConfig, block_fingerprints: int = 256,
                  n_buckets: int = 4096) -> StreamConfig:
    """Default ``StreamConfig`` for batch replay: the index bucket window
    matches the offline search's rank window (``bucket_cap``)."""
    from repro_torch.stream.index import StreamIndexConfig
    from repro_torch.stream.ingest import StreamConfig
    return StreamConfig(
        block_fingerprints=block_fingerprints,
        index=StreamIndexConfig(n_buckets=n_buckets,
                                bucket_cap=lcfg.bucket_cap))


def station_stats(wave: torch.Tensor, fcfg: FingerprintConfig
                  ) -> tuple[list[torch.Tensor], list[torch.Tensor]]:
    """The §5.2 statistics ``detect_events`` freezes, per station of the
    (S, T) waveforms: (meds, mads), each a list of (n_coeff,) tensors on
    ``wave``'s device. Sampled rows (``mad_sample_rate`` < 1) come from a
    CPU generator seeded ``stft_len + station``."""
    meds, mads = [], []
    for st in range(wave.shape[0]):
        coeffs = fp_mod.coeffs_from_waveform(wave[st], fcfg)
        rows = (None if fcfg.mad_sample_rate >= 1.0 else
                fp_mod.sample_rows(coeffs.shape[0], fcfg.mad_sample_rate,
                                   fcfg.stft_len + st))
        med, mad = fp_mod.mad_stats(coeffs, fcfg.mad_sample_rate, rows)
        del coeffs
        meds.append(med)
        mads.append(mad)
    return meds, mads


def detect_events(waveforms: np.ndarray, cfg: DetectConfig,
                  scfg: StreamConfig | None = None, keep_pairs: bool = False,
                  tracer: SpanTracer | None = None, device=None,
                  station_xy: np.ndarray | None = None
                  ) -> tuple[dict, list[Events], StageTimes, dict]:
    """(n_stations, T) waveforms → network detections, via the block core.

    Returns (network detections dict, per-station events, stage wall
    times, aggregate stats), as the reference does. ``scfg`` sizes the
    replay and switches on the in-step guards; ``keep_pairs`` stashes the
    per-station post-filter ``Pairs`` under ``stats["_station_pairs"]``.
    With ``scfg.telemetry`` the QC counters are summed into
    ``stats["drops"]`` and ``stats["station<i>_qc"]``. With ``cfg.locate``
    set, ``station_xy`` (S, 2) km given and ≥ 2 stations, the detections
    also carry located origins, moveout-consistency flags and relative
    magnitudes (numpy columns, ``core.locate.attach_location``), and
    ``stats["moveout_rejected"]`` counts the groups the gate dropped.

    The §5.2 statistics sample rows (``mad_sample_rate`` < 1) are drawn
    from a CPU ``torch.Generator`` seeded ``stft_len + station``; the
    reference's ``jax.random.choice`` draw cannot be reproduced in torch,
    so sampled statistics differ from the reference's (exact at rate 1).
    """
    from repro_torch.stream import fused as fused_mod
    from repro_torch.stream import index as index_mod
    from repro_torch.stream.engine import (host_occurrence_filter,
                                           pairs_from_triplets)
    dev = utils.resolve_device(device)
    waveforms = np.atleast_2d(np.asarray(waveforms, np.float32))
    n_stations = waveforms.shape[0]
    fcfg, lcfg, acfg = cfg.fingerprint, cfg.lsh, cfg.align
    if scfg is None:
        scfg = replay_config(lcfg)
    tracer = tracer or SpanTracer()
    stats: dict = {}
    n_fp = fcfg.n_fingerprints(waveforms.shape[1])
    wave_dev = torch.as_tensor(waveforms, device=dev)

    with tracer.span("fingerprint_stats"):
        meds, mads = station_stats(wave_dev, fcfg)
        _sync(dev)
    with tracer.span("hashgen"):
        mappings = lsh_mod.hash_mappings(fcfg.fp_dim, lcfg, dev)
        _sync(dev)

    ctr = 1 if scfg.telemetry else 0
    icfg = scfg.effective_index(fcfg.fp_dim)
    qc_sum = np.zeros((n_stations, len(index_mod.QC_FIELDS)), np.int64)
    state = fused_mod.init_pool_state(
        [index_mod.init_index(lcfg, icfg, 1, dev) for _ in range(n_stations)],
        fcfg.halo_samples, meds, mads)
    b = scfg.block_fingerprints
    bs = fcfg.block_samples(b)
    tri: list[list[np.ndarray]] = [[] for _ in range(n_stations)]
    for base in range(0, n_fp, b):
        with tracer.span("fused_step"):
            n_valid = min(b, n_fp - base)
            start = base * fcfg.lag_samples
            seg = wave_dev[:, start:start + bs]
            block = torch.zeros((n_stations, bs), dtype=torch.float32,
                                device=dev)
            block[:, :seg.shape[1]] = seg
            vmask = (torch.arange(b, device=dev) < n_valid).expand(
                n_stations, b)
            state, pairs, qc = fused_mod.pool_step_block(
                state, block, mappings, base, vmask, fcfg, lcfg,
                scfg.window_fingerprints, scfg.saturation_limit,
                scfg.dup_sig_tables, scfg.occ_limit, ctr,
                scfg.max_pairs_per_block, scfg.verify_code,
                scfg.verify_min_jaccard)
            # one transfer (and one sync) for the whole pooled output
            host = torch.stack([pairs.idx1, pairs.idx2, pairs.sim,
                                pairs.valid.to(torch.int32)]).cpu().numpy()
            qc_sum += qc.cpu().numpy().astype(np.int64)
            i1, i2, sim, pv = host[0], host[1], host[2], host[3] > 0
            for st in range(n_stations):
                m = pv[st]
                if m.any():
                    tri[st].append(np.stack(
                        [i1[st][m], i2[st][m], sim[st][m]],
                        axis=1).astype(np.int64))

    with tracer.span("host_tail"):
        station_events: list[Events] = []
        station_pairs: list[Pairs] = []
        for st in range(n_stations):
            tri_st = (np.concatenate(tri[st], axis=0) if tri[st]
                      else np.zeros((0, 3), np.int64))
            pairs = pairs_from_triplets(tri_st, device=dev)
            if lcfg.occurrence_frac > 0 and n_fp > 0:
                pairs, excluded = host_occurrence_filter(pairs, n_fp, lcfg)
                stats[f"station{st}_excluded"] = int(excluded.sum())
            stats[f"station{st}_pairs"] = int(pairs.count())
            stats[f"station{st}_fingerprints"] = n_fp
            merged = align_mod.merge_channels(
                [(pairs.dt, pairs.idx1, pairs.sim, pairs.valid)],
                acfg.channel_threshold)
            events = align_mod.cluster_station(merged, acfg)
            stats[f"station{st}_events"] = int(events.count())
            station_events.append(events)
            station_pairs.append(pairs)
        with_locate = (cfg.locate is not None and station_xy is not None
                       and n_stations >= 2)
        detections = align_mod.associate_network(
            station_events, acfg, n_stations, with_onsets=with_locate)
        if with_locate:
            detections = _locate_tail(detections, waveforms, qc_sum, n_fp,
                                      station_xy, cfg, stats, dev)
        _sync(dev)
    times = StageTimes.from_spans(tracer)
    stats["detections"] = int(detections["valid"].sum())
    if ctr:
        stats["drops"] = {
            name: int(qc_sum[:, k].sum())
            for k, name in enumerate(index_mod.QC_FIELDS)}
        for st in range(n_stations):
            stats[f"station{st}_qc"] = {
                name: int(qc_sum[st, k])
                for k, name in enumerate(index_mod.QC_FIELDS)}
    if keep_pairs:
        stats["_station_pairs"] = station_pairs
    return detections, station_events, times, stats


def _index_config(cfg: DetectConfig, icfg, occ_limit: int):
    from repro_torch.stream import index as index_mod
    if icfg is None:
        icfg = index_mod.StreamIndexConfig(n_buckets=4096,
                                           bucket_cap=cfg.lsh.bucket_cap)
    assert occ_limit == 0 or icfg.occ_slots > 0, \
        "occ_limit needs icfg.occ_slots (the partner-count ring)"
    return icfg


def _detect_rows(x: torch.Tensor, med: torch.Tensor, mad: torch.Tensor,
                 cfg: DetectConfig, icfg, window: int, saturation: int,
                 dup_tables: int, occ_limit: int) -> dict:
    """``detect_step`` on the R chunks of ``x`` (R, chunk_samples) at
    once: fingerprints, signatures and the guarded step (an R-row index,
    one fresh index a chunk) in one pooled call each, then each chunk's
    occurrence filter and clustering. Outputs stacked on a leading R
    axis; a row equals ``detect_step`` on that chunk alone."""
    from repro_torch.stream import index as index_mod
    fcfg, lcfg, acfg = cfg.fingerprint, cfg.lsh, cfg.align
    dev = x.device
    _, packed = fp_mod.fingerprints_from_waveform(x, fcfg,
                                                  med_mad=(med, mad))
    rows, n = packed.shape[0], packed.shape[1]
    mappings = lsh_mod.hash_mappings(fcfg.fp_dim, lcfg, dev)
    sigs, buckets = lsh_mod.signatures_and_buckets(packed, mappings, lcfg,
                                                   icfg.n_buckets)
    ids = torch.arange(n, dtype=torch.int32, device=dev)
    _, pooled, _ = index_mod.guarded_step(
        index_mod.init_index(lcfg, icfg, rows, dev), sigs, buckets, ids,
        None, lcfg, window, saturation=saturation, dup_tables=dup_tables,
        occ_limit=occ_limit)
    out = []
    for r in range(rows):
        pairs = Pairs(pooled.idx1[r], pooled.idx2[r], pooled.sim[r],
                      pooled.valid[r])
        if lcfg.occurrence_frac > 0:
            pairs, _ = lsh_mod.occurrence_filter(pairs, n,
                                                 lcfg.occurrence_frac)
        events = align_mod.cluster_station(pairs, acfg)
        out.append({
            "dt": pairs.dt, "idx1": pairs.idx1, "sim": pairs.sim,
            "pair_valid": pairs.valid,
            "ev_dt": events.dt, "ev_onset": events.onset,
            "ev_score": events.score, "ev_valid": events.valid})
    return {k: torch.stack([o[k] for o in out]) for k in out[0]}


def detect_step(waveform_chunk, med, mad, cfg: DetectConfig, icfg=None,
                window: int = 0, saturation: int = 0, dup_tables: int = 0,
                occ_limit: int = 0, device=None) -> dict:
    """One chunk's detection step, over a fresh index.

    ``waveform_chunk`` (chunk_samples,) includes its halo; ``med`` /
    ``mad`` (n_coeff,) are the frozen §5.2 statistics. The chunk's
    fingerprints go through one ``index.guarded_step`` against an empty
    index (the streaming core's insert / query, guards and limiter, no
    verify), then the §6.5 occurrence filter and station clustering. The
    quality knobs (``saturation``, ``dup_tables``, ``occ_limit``) default
    off; ``icfg`` sizes the index (``occ_limit`` > 0 needs
    ``icfg.occ_slots``). Inputs that are tensors stay on their device
    unless ``device`` names one; anything else goes to ``cuda`` unless
    ``device="cpu"``. Returns the pairs' ``dt`` / ``idx1`` / ``sim`` /
    ``pair_valid`` and the events' ``ev_dt`` / ``ev_onset`` /
    ``ev_score`` / ``ev_valid``, as the reference does."""
    icfg = _index_config(cfg, icfg, occ_limit)
    x = utils.placed(waveform_chunk, device).to(torch.float32)
    dev = x.device
    out = _detect_rows(x[None], utils.placed(med, dev),
                       utils.placed(mad, dev), cfg, icfg, window,
                       saturation, dup_tables, occ_limit)
    return {k: v[0] for k, v in out.items()}


def detect_step_sharded(waveforms, med, mad, cfg: DetectConfig, mesh, *,
                        icfg=None, window: int = 0, saturation: int = 0,
                        dup_tables: int = 0, occ_limit: int = 0,
                        group: int | None = None) -> dict:
    """``detect_step`` on every chunk of ``waveforms`` (C, chunk_samples)
    over ``mesh`` (a ``dist.StationMesh``; C a multiple of its width).

    The chunks are independent (the paper's §6.4 partition structure), so
    there is no collective: device k takes chunks k·C/d … (k+1)·C/d − 1
    and runs them as the rows of pooled calls of ``detect_step``'s core,
    ``group`` chunks a call (default: all of its chunks in one call); the
    devices' calls alternate, so every device has work queued before the
    host waits on any. ``med`` / ``mad`` are copied once to each distinct
    device; ``icfg`` and the quality knobs are ``detect_step``'s. Returns
    ``detect_step``'s outputs stacked on a leading C axis in chunk order
    (a row equals ``detect_step`` on that chunk), on the mesh's first
    device."""
    icfg = _index_config(cfg, icfg, occ_limit)
    c, d = waveforms.shape[0], mesh.size
    if c % d:
        raise ValueError(f"{c} chunks do not divide a {d}-wide mesh")
    per = c // d
    group = per if group is None else int(group)
    if group < 1:
        raise ValueError(f"group must be at least 1, got {group}")
    home = mesh.devices[0]
    stats = [dist.replicate(utils.placed(m, home).to(torch.float32), mesh)
             for m in (med, mad)]
    out: dict[str, torch.Tensor] = {}
    for g in range(0, per, group):
        for k, dev in enumerate(mesh.devices):
            lo, hi = k * per + g, k * per + min(g + group, per)
            with dist.on_device(dev):
                x = utils.placed(waveforms[lo:hi], dev).to(torch.float32)
                res = _detect_rows(x, stats[0][k], stats[1][k], cfg, icfg,
                                   window, saturation, dup_tables,
                                   occ_limit)
            for key, v in res.items():
                if key not in out:
                    out[key] = torch.empty((c, *v.shape[1:]),
                                           dtype=v.dtype, device=home)
                out[key][lo:hi].copy_(v)
    return out


def recall_against_truth(detections: dict, station_events: list[Events],
                         dataset, fcfg: FingerprintConfig,
                         tol_s: float = 6.0) -> dict:
    """Fraction of injected reoccurring events recovered (any station):
    an event counts when some station event onset (or its cluster end, or
    its partner occurrence) falls within ``tol_s`` of its arrival."""
    lag_s = fcfg.lag_samples / fcfg.fs
    hit = np.zeros(len(dataset.event_times), bool)
    for st, ev in enumerate(station_events):
        v = ev.valid.cpu().numpy()
        onsets = ev.onset.cpu().numpy()[v]
        if onsets.size == 0:
            continue
        extents = ev.extent.cpu().numpy()[v]
        dts = ev.dt.cpu().numpy()[v]
        cand_times = np.concatenate([
            onsets * lag_s, (onsets + extents) * lag_s,
            (onsets + dts) * lag_s])
        for i in range(len(dataset.event_times)):
            at = dataset.arrival_time(i, st)
            if np.any(np.abs(cand_times - at) < tol_s):
                hit[i] = True
    src, cnt = np.unique(dataset.event_sources, return_counts=True)
    detectable = np.isin(dataset.event_sources, src[cnt >= 2])
    n_det = int(detectable.sum())
    return {
        "recall": float(hit[detectable].sum() / max(n_det, 1)),
        "hits": int(hit[detectable].sum()),
        "detectable": n_det,
        "n_events": len(dataset.event_times),
    }
