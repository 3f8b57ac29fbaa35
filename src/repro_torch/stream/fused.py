"""The per-block detection core: fingerprint → hash → guarded index step.

PyTorch counterpart of ``repro.stream.fused``. ``_chunk_core`` runs one
block for a whole station pool: STFT → pooled spectral images → 2-D Haar
→ MAD-normalised top-K sign bits → Min-Max signatures and bucket ids →
``index.guarded_step``. The reference jits it once and ``vmap``s it over
stations; here the station axis is a tensor dimension and every stage is
one call for all stations. The reference donates ``FusedState`` to each
step; here ``FusedState`` is updated in place (index tables and halo) and
returned.

Two entries, each in a pool form and a one-station form:

* ``pool_step_advance`` / ``step_advance`` — the steady state of the
  streaming driver. Its input is only the block's new samples, (S,
  advance); the block is rebuilt on the device as ``cat([halo, new])``
  and its tail written back into ``halo`` in place, so the ring advance
  never crosses to the host.
* ``pool_step_block`` / ``step_block`` — the re-seeding entry (first block
  after a freeze, gap-masked blocks, masked flush tails) and the batch
  driver's entry: a whole framed block plus a fingerprint-valid mask; it
  reprimes the halo from the block tail.

The one-station forms are the pool forms on an S = 1 state (``init_state``)
with the station axis taken off the outputs.

``pool_step_advance_sharded`` / ``pool_step_block_sharded`` are the pool
entries over a ``stations`` mesh (``dist.station_mesh``): the state is one
``FusedState`` a mesh device, holding that shard's contiguous rows
(``dist.split_rows``), and every shard steps its rows on its own device
with the same core. Stations are independent, so there is no collective:
every shard's step is launched before any synchronisation, and the pairs
and QC come back in station order on the host, one copy a shard and one
synchronisation a device (``outputs_to_host``, the reference's one
``device_get`` of the station-sharded outputs). They delegate to the
one-device pool entries where the reference does: no mesh, a mesh
narrower than 2, or a pool width that the mesh does not divide.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import dist
from repro_torch.core import fingerprint as fp_mod
from repro_torch.core import lsh as lsh_mod
from repro_torch.core.fingerprint import FingerprintConfig
from repro_torch.core.lsh import LSHConfig, Pairs
from repro_torch.stream import index as index_mod
from repro_torch.stream.index import IndexState


@dataclasses.dataclass
class FusedState:
    """Everything the block step owns on the device, with a leading
    station axis: ``index`` (S, t, B, C), ``halo`` (S, halo_samples),
    ``med``/``mad`` (S, n_coeff)."""

    index: IndexState
    halo: torch.Tensor
    med: torch.Tensor
    mad: torch.Tensor


def init_pool_state(indexes: list[IndexState], halo_samples: int,
                    meds, mads) -> FusedState:
    """Stack per-station pieces into one pool state (leading S axis). The
    statistics are copied, so the state never aliases the caller's."""
    index = index_mod.stack_states(indexes)
    dev = index.sig.device
    return FusedState(
        index=index,
        halo=torch.zeros((index.n_stations, halo_samples),
                         dtype=torch.float32, device=dev),
        med=torch.stack([torch.as_tensor(m, dtype=torch.float32, device=dev)
                         for m in meds]),
        mad=torch.stack([torch.as_tensor(m, dtype=torch.float32, device=dev)
                         for m in mads]))


def init_state(index: IndexState, halo_samples: int, med, mad) -> FusedState:
    """The one-station state: ``index`` holds one station (S = 1), and
    ``med``/``mad`` are that station's (n_coeff,) statistics."""
    if index.n_stations != 1:
        raise ValueError(f"init_state takes one station's index, got "
                         f"{index.n_stations}")
    return init_pool_state([index], halo_samples, [med], [mad])


def _chunk_core(index: IndexState, med: torch.Tensor, mad: torch.Tensor,
                wave: torch.Tensor, mappings: torch.Tensor, base_id: int,
                valid: torch.Tensor | None, fcfg: FingerprintConfig,
                lcfg: LSHConfig, window: int, saturation: int = 0,
                dup_tables: int = 0, occ_limit: int = 0, counters: int = 0,
                max_pairs: int = 0, verify: int = 0, min_jac: float = 0.0
                ) -> tuple[IndexState, Pairs, torch.Tensor]:
    """One block for S stations: wave (S, block_samples), valid (S, N)."""
    coeffs = fp_mod.coeffs_from_waveform(wave, fcfg)
    bits, packed = fp_mod.binarize_coeffs(coeffs, fcfg, (med, mad))
    n = bits.shape[-2]
    sigs, buckets = lsh_mod.signatures_and_buckets(
        packed, mappings, lcfg, index.shape[1], valid=valid)
    ids = int(base_id) + torch.arange(n, dtype=torch.int32,
                                      device=wave.device)
    return index_mod.guarded_step(index, sigs, buckets, ids, valid, lcfg,
                                  window, saturation=saturation,
                                  dup_tables=dup_tables,
                                  occ_limit=occ_limit, counters=counters,
                                  packed=packed if verify > 0 else None,
                                  max_pairs=max_pairs, verify=verify,
                                  min_jac=min_jac)


def pool_step_advance(state: FusedState, new_samples: torch.Tensor,
                      mappings: torch.Tensor, base_id: int,
                      fcfg: FingerprintConfig, lcfg: LSHConfig,
                      window: int = 0, saturation: int = 0,
                      dup_tables: int = 0, occ_limit: int = 0,
                      counters: int = 0, max_pairs: int = 0,
                      verify: int = 0, min_jac: float = 0.0
                      ) -> tuple[FusedState, Pairs, torch.Tensor]:
    """The steady-state step: the device halo + the block's new samples
    (S, block_fingerprints · lag_samples) → pairs, every fingerprint
    valid. The block is ``cat([halo, new_samples])`` on the device and its
    tail becomes the new halo, in place. Returns (state, pairs (S, ...),
    qc (S, 8))."""
    wave = torch.cat([state.halo, new_samples], dim=-1)
    index, pairs, qc = _chunk_core(state.index, state.med, state.mad, wave,
                                   mappings, base_id, None, fcfg, lcfg,
                                   window, saturation, dup_tables, occ_limit,
                                   counters, max_pairs, verify, min_jac)
    state.halo.copy_(wave[:, -state.halo.shape[-1]:])
    state.index = index
    return state, pairs, qc


def pool_step_block(state: FusedState, blocks: torch.Tensor,
                    mappings: torch.Tensor, base_id: int,
                    valid: torch.Tensor, fcfg: FingerprintConfig,
                    lcfg: LSHConfig, window: int = 0, saturation: int = 0,
                    dup_tables: int = 0, occ_limit: int = 0,
                    counters: int = 0, max_pairs: int = 0,
                    verify: int = 0, min_jac: float = 0.0
                    ) -> tuple[FusedState, Pairs, torch.Tensor]:
    """A whole framed block per station (blocks (S, block_samples), valid
    (S, block_fingerprints)) through the core; the halo is reprimed from
    the block tail. Returns (state, pairs (S, ...), qc (S, 8))."""
    index, pairs, qc = _chunk_core(state.index, state.med, state.mad, blocks,
                                   mappings, base_id, valid, fcfg, lcfg,
                                   window, saturation, dup_tables, occ_limit,
                                   counters, max_pairs, verify, min_jac)
    state.halo.copy_(blocks[:, -state.halo.shape[-1]:])
    state.index = index
    return state, pairs, qc


def drop_station_axis(pairs: Pairs, qc: torch.Tensor
                      ) -> tuple[Pairs, torch.Tensor]:
    """A one-station step's pairs and qc without the station axis."""
    fields = {f.name: getattr(pairs, f.name)[0]
              for f in dataclasses.fields(pairs)}
    return type(pairs)(**fields), qc[0]


def step_advance(state: FusedState, new_samples: torch.Tensor,
                 mappings: torch.Tensor, base_id: int,
                 fcfg: FingerprintConfig, lcfg: LSHConfig, **knobs
                 ) -> tuple[FusedState, Pairs, torch.Tensor]:
    """``pool_step_advance`` for a one-station state: new_samples
    (advance,); pairs and qc come back without the station axis."""
    state, pairs, qc = pool_step_advance(state, new_samples[None], mappings,
                                         base_id, fcfg, lcfg, **knobs)
    return (state, *drop_station_axis(pairs, qc))


def step_block(state: FusedState, block: torch.Tensor, mappings: torch.Tensor,
               base_id: int, valid: torch.Tensor, fcfg: FingerprintConfig,
               lcfg: LSHConfig, **knobs) -> tuple[FusedState, Pairs,
                                                  torch.Tensor]:
    """``pool_step_block`` for a one-station state: block (block_samples,)
    and valid (N,); pairs and qc come back without the station axis."""
    state, pairs, qc = pool_step_block(state, block[None], mappings, base_id,
                                       valid[None], fcfg, lcfg, **knobs)
    return (state, *drop_station_axis(pairs, qc))


# ---------------------------------------------------------------------------
# the sharded station pool: the same pool entries over a station mesh
# ---------------------------------------------------------------------------


def _delegates(state, mesh) -> bool:
    """True where the reference runs its one-device pool: no mesh, a mesh
    narrower than 2, or a pool width that the mesh does not divide (a
    whole ``FusedState`` then steps as it is). The sharded form is the
    list of shards, one a mesh device."""
    width = mesh.size if mesh is not None else 1
    if isinstance(state, FusedState):
        if width < 2 or state.halo.shape[0] % width:
            return True
        raise TypeError(f"a whole pool of {state.halo.shape[0]} rows on a "
                        f"{width}-wide mesh: step its shards "
                        f"(dist.split_rows)")
    if width < 2:
        raise ValueError("a sharded pool state needs its mesh")
    return False


def _as_int32(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int32) if x.dtype == torch.float32 \
        else x.to(torch.int32)


def outputs_to_host(parts: list[tuple[Pairs, torch.Tensor]]
                    ) -> tuple[Pairs, torch.Tensor]:
    """Pool step outputs on the host: ``parts`` holds one (pairs, qc) a
    shard (one part for the one-device pool), each with a leading station
    axis on its own device. A part on a card is packed there into one
    int32 buffer (bool as 0 / 1, float32 by its bits, as ``jac`` of
    ``VerifiedPairs``) and copied into a pinned host buffer without
    waiting; each distinct card is then synchronised once. A part on the
    CPU is taken as it is. Returns the pairs (of the parts' class) and qc
    with the parts' rows in order."""
    names = [f.name for f in dataclasses.fields(parts[0][0])]
    staged, cards = [], []
    for pairs, qc in parts:
        cols = [getattr(pairs, n) for n in names] + [qc]
        if qc.device.type != "cuda":
            staged.append((None, cols))
            continue
        flat = torch.cat([_as_int32(c).reshape(-1) for c in cols])
        buf = torch.empty(flat.shape, dtype=torch.int32, pin_memory=True)
        buf.copy_(flat, non_blocking=True)
        staged.append((buf, cols))
        if qc.device not in cards:
            cards.append(qc.device)
    for dev in cards:
        torch.cuda.synchronize(dev)
    host = []
    for buf, cols in staged:
        if buf is None:
            host.append(cols)
            continue
        out, a = [], 0
        for c in cols:
            x = buf[a:a + c.numel()].view(c.shape)
            a += c.numel()
            out.append(x.view(torch.float32) if c.dtype == torch.float32
                       else x.to(c.dtype))
        host.append(out)
    cols = host[0] if len(host) == 1 else [torch.cat(c) for c in zip(*host)]
    return type(parts[0][0])(**dict(zip(names, cols))), cols[-1]


def _sharded(entry, state: list[FusedState], inputs: tuple[list, ...],
             mappings, base_id: int, fcfg: FingerprintConfig,
             lcfg: LSHConfig, knobs: dict, mesh
             ) -> tuple[list[FusedState], Pairs, torch.Tensor]:
    """``entry`` on every shard of ``state`` over ``mesh``, each launched
    on its device before any synchronisation; the pairs and qc of all
    shards on the host in station order (``outputs_to_host``)."""
    shards = list(state)
    for what, x in (("pool shards", shards), ("mappings", mappings),
                    *(("input blocks", x) for x in inputs)):
        if len(x) != mesh.size:
            raise ValueError(f"{len(x)} {what} for a {mesh.size}-wide mesh")
    outs = []
    for k, dev in enumerate(mesh.devices):
        with dist.on_device(dev):
            shards[k], pairs, qc = entry(shards[k], *[x[k] for x in inputs],
                                         mappings[k], base_id, fcfg, lcfg,
                                         **knobs)
        outs.append((pairs, qc))
    return (shards, *outputs_to_host(outs))


def pool_step_advance_sharded(state, new_samples, mappings, base_id: int,
                              fcfg: FingerprintConfig, lcfg: LSHConfig,
                              window: int = 0, saturation: int = 0,
                              dup_tables: int = 0, occ_limit: int = 0,
                              counters: int = 0, max_pairs: int = 0,
                              verify: int = 0, min_jac: float = 0.0, *,
                              mesh=None):
    """``pool_step_advance`` with the station axis split over ``mesh``.

    ``state``: one ``FusedState`` a mesh device (``dist.split_rows``);
    ``new_samples`` and ``mappings``: one tensor a shard, on its device
    (``dist.put_rows``, ``dist.replicate``). Each shard's index and halo
    are updated in place on its device. Returns (the shards, pairs (S,
    ...) and qc (S, 8) on the host in station order).

    Delegates to the one-device ``pool_step_advance`` on a whole
    ``FusedState`` (with whole inputs) when ``mesh`` is absent or
    narrower than 2, or when the pool's width does not divide it (a pool
    built without this mesh in hand); the delegate is the same
    per-station core, so both give the same bits."""
    knobs = dict(window=window, saturation=saturation,
                 dup_tables=dup_tables, occ_limit=occ_limit,
                 counters=counters, max_pairs=max_pairs, verify=verify,
                 min_jac=min_jac)
    if _delegates(state, mesh):
        return pool_step_advance(state, new_samples, mappings, base_id,
                                 fcfg, lcfg, **knobs)
    return _sharded(pool_step_advance, state, (new_samples,), mappings,
                    base_id, fcfg, lcfg, knobs, mesh)


def pool_step_block_sharded(state, blocks, mappings, base_id: int, valid,
                            fcfg: FingerprintConfig, lcfg: LSHConfig,
                            window: int = 0, saturation: int = 0,
                            dup_tables: int = 0, occ_limit: int = 0,
                            counters: int = 0, max_pairs: int = 0,
                            verify: int = 0, min_jac: float = 0.0, *,
                            mesh=None):
    """``pool_step_block`` over a ``stations`` mesh: ``blocks`` and
    ``valid`` one tensor a shard, as ``new_samples`` is in
    ``pool_step_advance_sharded``, which sets out the delegation."""
    knobs = dict(window=window, saturation=saturation,
                 dup_tables=dup_tables, occ_limit=occ_limit,
                 counters=counters, max_pairs=max_pairs, verify=verify,
                 min_jac=min_jac)
    if _delegates(state, mesh):
        return pool_step_block(state, blocks, mappings, base_id, valid,
                               fcfg, lcfg, **knobs)

    def entry(shard, blk, vld, maps, base, fc, lc, **kw):
        return pool_step_block(shard, blk, maps, base, vld, fc, lc, **kw)

    return _sharded(entry, state, (blocks, valid), mappings, base_id, fcfg,
                    lcfg, knobs, mesh)
