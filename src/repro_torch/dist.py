"""The station mesh: placement of the sharded detection pool.

PyTorch counterpart of the station half of ``repro.dist``. The reference
splits the stacked pool's leading station axis over a 1-axis ``stations``
device mesh and steps it under a fully manual ``shard_map`` with no
collective: stations are independent until the host-side association
tail. Its counterpart here is one process driving several devices:

* ``StationMesh`` is a frozen tuple of ``torch.device`` s and the axis
  name; ``station_mesh`` is the capability probe (``None`` where sharding
  cannot help) and ``padded_pool_width`` the row count a pool carries so
  that its station axis divides the mesh;
* ``split_rows`` is ``pool_sharding``'s counterpart: a stacked pool
  (or any dataclass of tensors with a leading station axis) cut into
  contiguous row blocks, shard k holding rows k·S/d … (k+1)·S/d − 1 —
  the layout of ``P('stations')`` — each an owned copy on its device;
* ``replicate`` is ``replicated_sharding``'s: one copy of a tensor a
  distinct mesh device, made once (the hash mappings, when the pool is
  built), not on every step;
* ``put_rows`` places a host (S, ...) input straight onto its shards'
  devices;
* ``on_device`` makes a shard's device current while its step launches,
  so a CUDA kernel goes to that device's stream.

A mesh may name one device more than once (``[cpu] * k`` in the tests,
``[cuda:0] * k`` on a one-card machine: the shards then serialise on that
device); the probe itself only returns distinct devices. The LM half of
``repro.dist`` (sharding rules, layouts, data parallelism) is not here.
"""
from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

# mesh axis name of the station-pool shard (stream/fused.py): the leading
# S axis of the stacked FusedState is split over it
STATION_AXIS = "stations"


@dataclasses.dataclass(frozen=True)
class StationMesh:
    """A 1-axis device mesh: ``devices`` in shard order, ``axis`` its
    name (the reference's ``Mesh(devices, ('stations',))``)."""

    devices: tuple[torch.device, ...]
    axis: str = STATION_AXIS

    @property
    def shape(self) -> dict[str, int]:
        return {self.axis: len(self.devices)}

    @property
    def size(self) -> int:
        return len(self.devices)


def _device(d) -> torch.device:
    dev = torch.device(d)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def station_mesh(n_stations: int | None = None, *, devices=None,
                 axis: str = STATION_AXIS) -> StationMesh | None:
    """The capability probe of the sharded station pool: a 1-axis
    ``stations`` mesh when splitting the pool can help, else ``None``
    (callers then keep the one-device pool):

    * fewer than two devices → ``None``;
    * fewer than two stations → ``None`` (nothing to split);
    * more devices than stations → the mesh is trimmed to ``n_stations``,
      so no device holds an empty shard.

    ``devices`` defaults to every visible card, ``cuda:0`` …
    ``cuda:{device_count - 1}`` (none without CUDA)."""
    if devices is None:
        devices = (range(torch.cuda.device_count())
                   if torch.cuda.is_available() else ())
        devices = [torch.device("cuda", i) for i in devices]
    devs = [_device(d) for d in devices]
    nd = len(devs)
    if n_stations is not None:
        nd = min(nd, int(n_stations))
    if nd < 2 or (n_stations is not None and n_stations < 2):
        return None
    return StationMesh(tuple(devs[:nd]), axis)


def padded_pool_width(n_stations: int, mesh: StationMesh | None) -> int:
    """Station rows the stacked pool must carry so that its leading axis
    divides the mesh: ``n_stations`` rounded up to a multiple of the
    ``stations`` axis size (``n_stations`` unchanged without a mesh). The
    pad rows are throwaway station clones: they step like real stations
    (the math is row-independent) and their output is never read."""
    if mesh is None:
        return int(n_stations)
    return -(-int(n_stations) // mesh.size) * mesh.size


def map_tensors(fn, tree):
    """``fn`` on every tensor of a dataclass tree (``FusedState``,
    ``IndexState``, ``Pairs``) or on a tensor; ``None`` leaves stay."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if dataclasses.is_dataclass(tree):
        return type(tree)(**{f.name: map_tensors(fn, getattr(tree, f.name))
                             for f in dataclasses.fields(tree)})
    raise TypeError(f"not a tensor tree: {type(tree).__name__}")


def _rows(tree) -> int:
    leaves = []
    map_tensors(leaves.append, tree)
    return int(leaves[0].shape[0])


def split_rows(tree, mesh: StationMesh) -> list:
    """``pool_sharding``'s counterpart: a station-stacked tree cut into
    ``mesh.size`` contiguous row blocks, shard k on ``mesh.devices[k]``.
    Every shard owns its storage (a copy, also on the tree's own device),
    so stepping a shard in place never writes into the source."""
    s, d = _rows(tree), mesh.size
    if s % d:
        raise ValueError(f"{s} station rows do not divide a {d}-wide mesh; "
                         f"pad the pool to padded_pool_width rows")
    r = s // d
    return [map_tensors(lambda x, k=k, dev=dev: x[k * r:(k + 1) * r].to(
        dev, copy=True), tree) for k, dev in enumerate(mesh.devices)]


def replicate(x: torch.Tensor, mesh: StationMesh) -> tuple:
    """``replicated_sharding``'s counterpart: ``x`` on every mesh device,
    aligned with ``mesh.devices``, copied once a distinct device (a
    device that already holds ``x`` uses it as it is)."""
    copies: dict[torch.device, torch.Tensor] = {}
    for dev in mesh.devices:
        if dev not in copies:
            copies[dev] = x if _device(x.device) == dev else x.to(dev)
    return tuple(copies[dev] for dev in mesh.devices)


def put_rows(x: np.ndarray, mesh: StationMesh) -> list[torch.Tensor]:
    """A host (S, ...) array's contiguous row blocks, each placed straight
    onto its shard's device (no detour through one device)."""
    x = np.asarray(x)
    r = x.shape[0] // mesh.size
    if r * mesh.size != x.shape[0]:
        raise ValueError(f"{x.shape[0]} rows do not divide a "
                         f"{mesh.size}-wide mesh")
    return [torch.as_tensor(np.ascontiguousarray(x[k * r:(k + 1) * r]),
                            device=dev)
            for k, dev in enumerate(mesh.devices)]


def on_device(device) -> contextlib.AbstractContextManager:
    """Makes a CUDA ``device`` current (its stream is the one a kernel
    launches on); a no-op for the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()
