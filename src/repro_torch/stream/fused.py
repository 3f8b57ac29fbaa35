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
with the station axis taken off the outputs. There is one card, so the
reference's mesh-sharded pool entries have no counterpart.
"""
from __future__ import annotations

import dataclasses

import torch

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
