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
device); the probe itself only returns distinct devices.

The LM half (below the station half) runs one process a rank over
``torch.distributed``: gloo on the CPU, NCCL with one rank a card.

* ``LMMesh`` names the axes of a ``DeviceMesh`` (``init_device_mesh``)
  and holds a process group for every set of its axes; ranks are
  row-major over the axes, so block k of a dim split over an axis sits
  on coordinate k, as under ``P(...)``. ``with mesh:`` installs it and
  ``current_mesh()`` reads it back.
* ``layout`` / ``current_layout``, ``manual_axes`` / ``in_manual_region``,
  ``allow_uneven_sharding``, ``axis_size``, ``batch_axes``, ``dp_size``
  and ``sanitize_spec`` are the reference's, name for name;
  ``replicated_rows`` marks batch axes whose ranks hold the same rows
  (serving under fsdp), which ``live_batch_axes`` leaves out.
* ``shard`` / ``shard_batch`` are placement: this rank's block of a
  global tensor under the sanitized spec (``x`` itself without a mesh);
  ``gather`` is the inverse. The reference's constraints only pin XLA's
  layout, so layer code has no counterpart of them.
* ``gather_param`` gathers a stored block at use inside autograd: its
  backward sums over the axes whose ranks saw different data (the live
  batch axes) with a ``reduce_scatter`` and takes the local slice over
  the others. ``plan`` decides which entries are gathered: under the
  fsdp layout every split entry (the model axis is a batch axis there);
  under the tp layout only the data and pod ones, since the layers
  compute on their ``model`` blocks. ``sum_forward`` (Megatron's "g":
  all_reduce forward, identity backward), ``sum_backward`` ("f":
  identity forward, all_reduce backward) and ``mean_forward`` (the aux
  loss's ``pmean``) are the other collectives the model code runs.
* ``tensor_parallel()`` is the ``model`` axis as compute: under the tp
  layout a ``TensorParallel`` of the rank's coordinate and the axis
  size, whose methods the layers call (its block of a head, channel or
  vocab dim, "f" and "g", the vocab-parallel cross-entropy, the
  flash-decode combine); without a mesh, under fsdp or inside a region
  where ``model`` is manual, a size-1 one that runs no collective.
* ``COLLECTIVES`` counts the calls that reach the process group, by
  operation and axes (``reset_collectives`` zeroes it), so a run can show
  which collectives its path issued; ``TRACE``, while a step analyzer
  sets it, also takes each call's bytes.
"""
from __future__ import annotations

import collections
import contextlib
import contextvars
import dataclasses
import itertools
import math
import socket
from typing import Sequence

import numpy as np
import torch
import torch.distributed as tdist

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


# ---------------------------------------------------------------------------
# the LM half: named-axis meshes over torch.distributed
# ---------------------------------------------------------------------------

_MESH: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_mesh", default=None)

_MANUAL: contextvars.ContextVar[frozenset] = contextvars.ContextVar(
    "repro_torch_manual_axes", default=frozenset())

_UNEVEN: contextvars.ContextVar[bool] = contextvars.ContextVar(
    "repro_torch_allow_uneven", default=False)

# batch axes whose ranks hold the same rows (``replicated_rows``)
_REPLICATED: contextvars.ContextVar[frozenset] = contextvars.ContextVar(
    "repro_torch_replicated_rows", default=frozenset())

# "tp" (default: tensor-parallel rules over 'model') or "fsdp" (pure data
# parallelism over pod×data×model, parameters fully sharded)
_LAYOUT: contextvars.ContextVar[str] = contextvars.ContextVar(
    "repro_torch_layout", default="tp")


def free_port() -> int:
    """A TCP port on 127.0.0.1 that the OS reports free."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def init_ranks(backend: str, rank: int = 0, world_size: int = 1,
               init_method: str | None = None) -> None:
    """``init_process_group`` with an explicit rendezvous (nothing on the
    machine names a cluster): ``init_method`` (``file://`` or
    ``tcp://``), by default a free local port, which only a one-rank
    group can find. NCCL takes card ``rank``."""
    if init_method is None:
        if world_size != 1:
            raise ValueError("several ranks need a shared init_method")
        init_method = f"tcp://127.0.0.1:{free_port()}"
    if backend == "nccl":
        torch.cuda.set_device(rank)
    tdist.init_process_group(backend, init_method=init_method, rank=rank,
                             world_size=world_size)


class LMMesh:
    """Named mesh axes over the ranks of the default process group
    (``jax.make_mesh``'s counterpart): ``shape`` maps each axis name to
    its size, ``coords`` this rank's coordinate on each axis. The
    single-axis groups are the ``DeviceMesh``'s; a group of several axes
    is made with ``new_subgroups_by_enumeration`` (every rank takes part
    in making every group, in one order). Raises ``ValueError`` naming the
    shape when the world size differs from its product."""

    def __init__(self, shape: Sequence[int], axes: Sequence[str]):
        from torch.distributed.device_mesh import init_device_mesh
        shape, axes = tuple(int(n) for n in shape), tuple(axes)
        if len(shape) != len(axes):
            raise ValueError(f"mesh shape {shape} names {len(axes)} axes "
                             f"{axes}")
        world = tdist.get_world_size() if tdist.is_initialized() else 1
        if world != math.prod(shape):
            raise ValueError(f"a mesh of shape {shape} over {axes} needs "
                             f"{math.prod(shape)} ranks, the process group "
                             f"has {world}")
        if not tdist.is_initialized():
            raise RuntimeError("no process group: call dist.init_ranks "
                               "(or torch.distributed.init_process_group) "
                               "first")
        device_type = "cuda" if tdist.get_backend() == "nccl" else "cpu"
        self.axis_names = axes
        self.shape = dict(zip(axes, shape))
        self.rank = tdist.get_rank()
        self.coords = dict(zip(axes, (int(c) for c in np.unravel_index(
            self.rank, shape))))
        self.device_mesh = init_device_mesh(device_type, shape,
                                            mesh_dim_names=axes)
        self._groups = {(a,): self.device_mesh.get_group(a) for a in axes}
        ranks = np.arange(world).reshape(shape)
        for k in range(2, len(axes) + 1):
            for sub in itertools.combinations(axes, k):
                if k == len(axes):
                    self._groups[sub] = tdist.group.WORLD
                    continue
                keep = [axes.index(a) for a in sub]
                rest = [i for i in range(len(axes)) if i not in keep]
                blocks = ranks.transpose(rest + keep).reshape(
                    -1, math.prod(shape[i] for i in keep))
                mine, _ = tdist.new_subgroups_by_enumeration(
                    [sorted(int(r) for r in b) for b in blocks])
                self._groups[sub] = mine

    def _key(self, axes) -> tuple[str, ...]:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        return tuple(a for a in self.axis_names if a in axes)

    def group(self, axes):
        """The process group of this rank's fellows over ``axes`` (one
        name or several, in any order), its ranks in mesh order."""
        return self._groups[self._key(axes)]

    def size(self, axes) -> int:
        return math.prod(self.shape[a] for a in self._key(axes))

    def coord(self, axes) -> int:
        """This rank's block index along a dim split over ``axes``, the
        first axis the slowest (``P(("pod", "data"))``). The axes must
        come in mesh order, the order of their group's ranks."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        if self._key(axes) != axes:
            raise ValueError(f"axes {axes} are not in mesh order "
                             f"{self.axis_names}")
        k = 0
        for a in axes:
            k = k * self.shape[a] + self.coords[a]
        return k

    def __enter__(self):
        self._tokens = getattr(self, "_tokens", []) + [_MESH.set(self)]
        return self

    def __exit__(self, *exc):
        _MESH.reset(self._tokens.pop())


@contextlib.contextmanager
def layout(mode: str):
    assert mode in ("tp", "fsdp"), mode
    tok = _LAYOUT.set(mode)
    try:
        yield
    finally:
        _LAYOUT.reset(tok)


def current_layout() -> str:
    return _LAYOUT.get()


@contextlib.contextmanager
def manual_axes(axes):
    tok = _MANUAL.set(_MANUAL.get() | frozenset(axes))
    try:
        yield
    finally:
        _MANUAL.reset(tok)


def in_manual_region() -> bool:
    """True inside ``manual_axes`` (the pod-compressed gradient's region)."""
    return bool(_MANUAL.get())


@contextlib.contextmanager
def replicated_rows(axes):
    """Inside, the ranks along ``axes`` hold the same rows of the batch,
    so ``live_batch_axes`` leaves them out: serving under the fsdp layout,
    whose decode cache splits its batch over pod×data only (a bare
    ``model`` entry of its rules drops), so that a ``model`` group's
    ranks step the same rows. No axes: nothing changes."""
    tok = _REPLICATED.set(_REPLICATED.get() | frozenset(axes))
    try:
        yield
    finally:
        _REPLICATED.reset(tok)


@contextlib.contextmanager
def allow_uneven_sharding():
    """Let a dim that the axes do not divide (but ≥ their size) shard:
    blocks of ⌈dim / n⌉, the last ones short or empty (XLA pads)."""
    tok = _UNEVEN.set(True)
    try:
        yield
    finally:
        _UNEVEN.reset(tok)


def bind_context(fn):
    """``fn`` run in a copy of the caller's context (mesh, layout, manual
    axes): a checkpointed body recomputes in the backward, which on the
    card runs on autograd's device thread, where the caller's context
    variables are not set. Without a mesh, ``fn`` itself."""
    if current_mesh() is None:
        return fn
    ctx = contextvars.copy_context()
    return lambda *a, **k: ctx.copy().run(fn, *a, **k)


def current_mesh() -> LMMesh | None:
    """The mesh installed by a ``with mesh:`` block, or None."""
    return _MESH.get()


def axis_size(name: str) -> int:
    mesh = current_mesh()
    if mesh is None or name not in mesh.shape:
        return 1
    return mesh.shape[name]


def batch_axes() -> tuple[str, ...]:
    """Mesh axes of data parallelism: pod × data under the tp layout, pod
    × data × model under fsdp (the model axis joins the batch)."""
    mesh = current_mesh()
    if mesh is None:
        return ()
    names = (("pod", "data", "model") if _LAYOUT.get() == "fsdp"
             else ("pod", "data"))
    return tuple(a for a in names if a in mesh.shape)


def live_batch_axes() -> tuple[str, ...]:
    """``batch_axes()`` without the manual and the replicated ones: the
    axes whose ranks hold other rows of the batch in this region (inside
    the pod-compressed region a pod's ranks reduce among themselves only;
    serving under fsdp splits the rows over pod×data only)."""
    out = _MANUAL.get() | _REPLICATED.get()
    return tuple(a for a in batch_axes() if a not in out)


def dp_size() -> int:
    out = 1
    for a in batch_axes():
        out *= axis_size(a)
    return out


def _entry_size(entry) -> int:
    if entry is None:
        return 1
    if isinstance(entry, str):
        return axis_size(entry)
    out = 1
    for a in entry:
        out *= axis_size(a)
    return out


def sanitize_spec(shape: Sequence[int], spec: Sequence) -> tuple | None:
    """The spec entries that exist on the mesh and divide their dim (None
    without a mesh), padded with None to ``len(shape)``: "vocab" is the
    model axis; a bare "model" drops under fsdp; axes missing from the
    mesh and manual axes drop; an entry that does not divide drops unless
    ``allow_uneven_sharding`` is on and the dim is at least its size."""
    mesh = current_mesh()
    if mesh is None:
        return None
    uneven = _UNEVEN.get()
    out = []
    for dim, entry in zip(shape, spec):
        if entry is None:
            out.append(None)
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        if _LAYOUT.get() == "fsdp":
            axes = tuple("model" if a == "vocab" else a for a in axes
                         if a != "model")
        else:
            axes = tuple("model" if a == "vocab" else a for a in axes)
        manual = _MANUAL.get()
        axes = tuple(a for a in axes if a in mesh.shape and a not in manual)
        if not axes:
            out.append(None)
            continue
        if dim % _entry_size(axes) != 0 and not (
                uneven and dim >= _entry_size(axes)):
            out.append(None)
            continue
        out.append(axes[0] if len(axes) == 1 else axes)
    out += [None] * (len(shape) - len(out))
    return tuple(out)


def spec_axes(spec) -> tuple[str, ...]:
    """Every axis a (sanitized) spec splits over, in mesh-entry order."""
    out = []
    for e in spec or ():
        if e is not None:
            out += [e] if isinstance(e, str) else list(e)
    return tuple(out)


def block_range(dim: int, n: int, k: int) -> tuple[int, int]:
    """[lo, hi) of block k of a dim cut in n blocks of ⌈dim / n⌉."""
    b = -(-dim // n)
    lo = min(k * b, dim)
    return lo, min(lo + b, dim)


def block_shape(shape: Sequence[int], spec) -> tuple[int, ...]:
    """The shape of this rank's block of a global ``shape`` under a
    sanitized ``spec`` (``shape`` without one)."""
    mesh = current_mesh()
    out = []
    for d, n in enumerate(shape):
        e = spec[d] if spec is not None else None
        if e is None:
            out.append(int(n))
        else:
            lo, hi = block_range(n, mesh.size(e), mesh.coord(e))
            out.append(hi - lo)
    return tuple(out)


def local_block(x: torch.Tensor, spec, mesh: LMMesh | None = None
                ) -> torch.Tensor:
    """This rank's block of a global ``x`` under a sanitized ``spec``, an
    owned copy (a view would keep the whole tensor alive)."""
    mesh = mesh or current_mesh()
    for d, e in enumerate(spec or ()):
        if e is not None:
            lo, hi = block_range(x.shape[d], mesh.size(e), mesh.coord(e))
            x = x.narrow(d, lo, hi - lo)
    return x.clone(memory_format=torch.contiguous_format)


def shard(x: torch.Tensor, *spec) -> torch.Tensor:
    """This rank's block of the global ``x`` under ``sanitize_spec``;
    ``x`` itself without a mesh."""
    mesh = current_mesh()
    if mesh is None:
        return x
    return local_block(x, sanitize_spec(x.shape, spec), mesh)


def shard_batch(x: torch.Tensor, *rest) -> torch.Tensor:
    """This rank's rows of the global batch: the leading dim over
    ``batch_axes()``, the rest as given."""
    ba = batch_axes()
    if not ba:
        return x
    return shard(x, ba, *rest)


# the names of torch 2.13 (whose older ones warn that they are deprecated),
# else those of earlier releases
_all_gather = getattr(tdist, "all_gather_single", None) or \
    tdist.all_gather_into_tensor
_reduce_scatter = getattr(tdist, "reduce_scatter_single", None) or \
    tdist.reduce_scatter_tensor

# calls that reached the process group: "<op>:<axis>+<axis>" → count;
# a parameter's gather at use counts under "param_all_gather" besides
COLLECTIVES: collections.Counter = collections.Counter()


# while not None, receives (op, mesh, axes, bytes) for every call that
# reaches the process group, its bytes the larger of its input and output
# (set by ``launch.hlo_stats.analyze_step``; a plain list, not a context
# variable, so that a backward running on another thread records too)
TRACE: list | None = None


def reset_collectives() -> None:
    COLLECTIVES.clear()


def _count(op: str, mesh: LMMesh, axes, nbytes: int = 0) -> None:
    key = mesh._key(axes)
    COLLECTIVES[op + ":" + "+".join(key)] += 1
    if TRACE is not None and nbytes:
        TRACE.append((op, mesh, key, nbytes))


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def all_gather_dim(x: torch.Tensor, dim: int, axes, full: int,
                   mesh: LMMesh | None = None) -> torch.Tensor:
    """The blocks of ``axes``'s ranks joined along ``dim`` into a dim of
    ``full`` (short last blocks padded on the wire, then cut)."""
    mesh = mesh or current_mesh()
    n = mesh.size(axes)
    b = -(-full // n)
    xt = x.movedim(dim, 0)
    if xt.shape[0] < b:
        xt = torch.cat([xt, xt.new_zeros((b - xt.shape[0], *xt.shape[1:]))])
    xt = xt.contiguous()
    out = xt.new_empty((n * b, *xt.shape[1:]))
    _count("all_gather", mesh, axes, _nbytes(out))
    _all_gather(out, xt, group=mesh.group(axes))
    return out[:full].movedim(0, dim).contiguous()


def reduce_scatter_dim(x: torch.Tensor, dim: int, axes,
                       mesh: LMMesh | None = None) -> torch.Tensor:
    """Σ of ``x`` over ``axes``'s ranks, of which this rank keeps its
    block along ``dim`` (``all_gather_dim``'s transpose)."""
    mesh = mesh or current_mesh()
    n, full = mesh.size(axes), x.shape[dim]
    b = -(-full // n)
    xt = x.movedim(dim, 0)
    if full < n * b:
        xt = torch.cat([xt, xt.new_zeros((n * b - full, *xt.shape[1:]))])
    xt = xt.contiguous()
    out = xt.new_empty((b, *xt.shape[1:]))
    _count("reduce_scatter", mesh, axes, _nbytes(xt))
    _reduce_scatter(out, xt, op=tdist.ReduceOp.SUM, group=mesh.group(axes))
    lo, hi = block_range(full, n, mesh.coord(axes))
    return out[: hi - lo].movedim(0, dim).contiguous()


def all_reduce(x: torch.Tensor, axes, op=tdist.ReduceOp.SUM,
               mesh: LMMesh | None = None) -> torch.Tensor:
    """``x`` reduced over ``axes``'s ranks, in place; no axes: ``x``."""
    mesh = mesh or current_mesh()
    if mesh is not None and axes:
        _count("all_reduce", mesh, axes, _nbytes(x))
        tdist.all_reduce(x, op=op, group=mesh.group(axes))
    return x


def gather(x: torch.Tensor, spec, shape: Sequence[int] | None = None
           ) -> torch.Tensor:
    """``shard``'s inverse: the global tensor from every rank's block
    under a sanitized ``spec``. ``shape`` is the global shape (needed
    only for uneven blocks). ``x`` itself without a mesh."""
    mesh = current_mesh()
    if mesh is None or spec is None:
        return x
    for d, e in enumerate(spec):
        if e is not None:
            full = shape[d] if shape is not None else \
                x.shape[d] * mesh.size(e)
            x = all_gather_dim(x, d, e, full, mesh)
    return x


@dataclasses.dataclass(frozen=True)
class Plan:
    """How a stored block becomes the whole tensor at use, fixed when the
    forward runs (so the backward, on another thread on the card, needs
    no context): the global ``shape``, the sanitized ``spec`` and the
    axes whose ranks saw different data (``summed``)."""

    mesh: LMMesh
    shape: tuple
    spec: tuple
    summed: frozenset

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        for d, e in enumerate(self.spec):
            if e is not None:
                _count("param_all_gather", self.mesh, e)
                x = all_gather_dim(x, d, e, self.shape[d], self.mesh)
        return x

    def scatter_grad(self, g: torch.Tensor) -> torch.Tensor:
        for d, e in enumerate(self.spec):
            if e is None:
                continue
            axes = (e,) if isinstance(e, str) else tuple(e)
            if all(a in self.summed for a in axes):
                g = reduce_scatter_dim(g, d, e, self.mesh)
            else:       # the rules split no dim over both kinds of axis
                assert not any(a in self.summed for a in axes), e
                lo, hi = block_range(g.shape[d], self.mesh.size(e),
                                     self.mesh.coord(e))
                g = g.narrow(d, lo, hi - lo).contiguous()
        return g


def plan(shape: Sequence[int], rule: Sequence, *,
         blocks: bool) -> Plan | None:
    """The ``Plan`` of a parameter of global ``shape`` stored under
    ``rule`` on the current mesh; None without a mesh or when nothing is
    gathered. ``blocks``: the compute uses the parameter's ``model``
    blocks as they are (the tp layout), so only its other entries (pod,
    data) are gathered."""
    mesh = current_mesh()
    if mesh is None:
        return None
    spec = sanitize_spec(shape, rule)
    if blocks:
        spec = tuple(None if e == "model" else e for e in spec)
    if not spec_axes(spec):
        return None
    return Plan(mesh, tuple(shape), spec, frozenset(live_batch_axes()))


class _GatherParam(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, p):
        ctx.plan = p
        return p.gather(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.plan.scatter_grad(g.contiguous()), None


def gather_param(x: torch.Tensor, p: Plan | None) -> torch.Tensor:
    """The whole parameter from its stored block (``x`` when ``p`` is
    None), differentiable as ``Plan.scatter_grad`` says."""
    return x if p is None else _GatherParam.apply(x, p)


def gather_tree(tree: dict, plans: dict | None) -> dict:
    """``gather_param`` on every leaf of a nested dict by a matching tree
    of plans (None: the leaf as it is)."""
    if plans is None:
        return tree
    return {k: gather_tree(v, plans.get(k)) if isinstance(v, dict)
            else gather_param(v, plans.get(k)) for k, v in tree.items()}


class _SumForward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        return all_reduce(x.clone(), axes, mesh=mesh)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _SumBackward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.clone(), ctx.axes, mesh=ctx.mesh), None, None


class _ReduceScatterRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes, ctx.full = mesh, axes, x.shape[0]
        return reduce_scatter_dim(x, 0, axes, mesh)

    @staticmethod
    def backward(ctx, g):
        return all_gather_dim(g.contiguous(), 0, ctx.axes, ctx.full,
                              ctx.mesh), None, None


class _MeanForward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.n = mesh.size(axes)
        return all_reduce(x.clone(), axes, tdist.ReduceOp.SUM, mesh) / ctx.n

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None, None


def sum_forward(x: torch.Tensor, axes) -> torch.Tensor:
    """Σ over ``axes``'s ranks forward, identity backward (each rank
    back-propagates its own part; the gradient reduction sums them)."""
    mesh = current_mesh()
    return x if mesh is None or not axes else _SumForward.apply(x, mesh,
                                                               tuple(axes))


def sum_backward(x: torch.Tensor, axes) -> torch.Tensor:
    """Identity forward, Σ of the gradient over ``axes``'s ranks backward:
    an input replicated over ``axes`` whose ranks each use a part of it."""
    mesh = current_mesh()
    return x if mesh is None or not axes else _SumBackward.apply(x, mesh,
                                                                tuple(axes))


def reduce_scatter_rows(x: torch.Tensor, axes) -> torch.Tensor:
    """Σ over ``axes``'s ranks of which this rank keeps its block of rows
    (dim 0); the backward all_gathers the rows' gradients (every rank's
    rows took a part from this rank's ``x``)."""
    mesh = current_mesh()
    return _ReduceScatterRows.apply(x, mesh, tuple(axes))


def mean_forward(x: torch.Tensor, axes) -> torch.Tensor:
    """The mean over ``axes``'s ranks forward (``pmean``), the gradient
    ÷ their count backward: each rank's share of a mean whose gradients
    are summed over the same ranks."""
    mesh = current_mesh()
    return x if mesh is None or not axes else _MeanForward.apply(
        x, mesh, tuple(axes))


class _GatherSumGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, full, mesh, axes):
        ctx.dim, ctx.mesh, ctx.axes = dim, mesh, axes
        return all_gather_dim(x, dim, axes, full, mesh)

    @staticmethod
    def backward(ctx, g):
        return (reduce_scatter_dim(g.contiguous(), ctx.dim, ctx.axes,
                                   ctx.mesh), None, None, None, None)


class _VocabParallelCE(torch.autograd.Function):
    """Per-token −log softmax(logits)[label] from this rank's vocab block
    (B, S, V/M) fp32 of logits whose block starts at ``lo``: the max by
    an all_reduce(MAX), Σ exp by an all_reduce(SUM), the picked logit
    from the rank whose block holds the label by an all_reduce(SUM). The
    backward is local: softmax minus one-hot on the block, times the
    incoming gradient. The arithmetic is ``torch.logsumexp``'s and its
    backward's, so on one rank the bits are those of the unsplit loss."""

    @staticmethod
    def forward(ctx, logits, labels, lo, tp):
        n = logits.shape[-1]
        m = tp.reduce(logits.amax(-1, keepdim=True), tdist.ReduceOp.MAX)
        se = tp.reduce((logits - m).exp_().sum(-1))
        lse = se.log_().add_(m[..., 0])
        local = labels.long() - lo
        inside = (local >= 0) & (local < n)
        local = local.clamp(0, n - 1)
        picked = logits.gather(-1, local[..., None])[..., 0]
        picked = tp.reduce(torch.where(inside, picked, 0.0))
        ctx.save_for_backward(logits, lse, local, inside)
        return lse - picked

    @staticmethod
    def backward(ctx, g):
        logits, lse, local, inside = ctx.saved_tensors
        d = g[..., None] * (logits - lse[..., None]).exp()
        d.scatter_add_(-1, local[..., None],
                       torch.where(inside, -g, 0.0)[..., None])
        return d, None, None, None


@dataclasses.dataclass(frozen=True)
class TensorParallel:
    """The ``model`` axis as compute (Megatron's tensor parallelism): this
    rank is ``rank`` of ``size``; a head, channel or vocab dim of n is
    cut in blocks of ⌈n / size⌉ (``block_range``), the last ones short or
    empty. ``mesh`` is the mesh whose ``model`` group the collectives
    run over; None runs none: one rank (``size`` 1), or ranks played in
    turn in one process, whose caller sums their partial outputs."""

    size: int = 1
    rank: int = 0
    mesh: LMMesh | None = None

    @property
    def axes(self) -> tuple[str, ...]:
        return ("model",) if self.mesh is not None else ()

    def block(self, n: int) -> tuple[int, int]:
        """[lo, hi) of this rank's block of a dim of n."""
        return block_range(n, self.size, self.rank)

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """"g": the block's partial output summed over the ranks."""
        return x if self.mesh is None else _SumForward.apply(
            x, self.mesh, self.axes)

    def sum_grad(self, x: torch.Tensor) -> torch.Tensor:
        """"f": a replicated input of which each rank uses a part; its
        gradient is summed over the ranks."""
        return x if self.mesh is None else _SumBackward.apply(
            x, self.mesh, self.axes)

    def reduce(self, x: torch.Tensor, op=tdist.ReduceOp.SUM
               ) -> torch.Tensor:
        """``x`` reduced over the ranks in place, outside autograd."""
        return all_reduce(x, self.axes, op, self.mesh)

    def gather(self, x: torch.Tensor, dim: int, full: int) -> torch.Tensor:
        """The ranks' blocks joined along ``dim`` into a dim of ``full``,
        outside autograd (serving)."""
        if self.mesh is None:
            if x.shape[dim] != full:
                raise ValueError("ranks played in one process cannot "
                                 "gather their blocks")
            return x
        return all_gather_dim(x, dim, self.axes, full, self.mesh)

    def gather_sum_grad(self, x: torch.Tensor, dim: int,
                        full: int) -> torch.Tensor:
        """An activation's blocks gathered whole, each rank to use a part
        of it: the backward reduce_scatters the gradient to the blocks."""
        if self.mesh is None:
            return self.gather(x, dim, full)
        return _GatherSumGrad.apply(x, dim, full, self.mesh, self.axes)

    def part(self, w: torch.Tensor, dim: int, n: int) -> torch.Tensor:
        """This rank's block along ``dim`` (of n) of a parameter stored
        either as that block (the rules split the dim) or whole (they do
        not: a dim the axis does not divide). A whole one is cut here, so
        its gradient on each rank is that of the rank's part, which the
        train step sums over the ranks (``decoder.partial_grad_leaves``):
        a sum in the backward would be a collective that a rank with an
        empty part never reaches."""
        if self.size == 1:
            return w
        lo, hi = self.block(n)
        if w.shape[dim] == n:
            return w.narrow(dim, lo, hi - lo)
        if w.shape[dim] != hi - lo:
            raise ValueError(f"a block of {w.shape[dim]} along dim {dim} "
                             f"is not rank {self.rank}'s of {n}")
        return w

    def cross_entropy(self, logits: torch.Tensor, labels: torch.Tensor,
                      lo: int) -> torch.Tensor:
        """Per-token NLL from this rank's vocab block of fp32 logits
        starting at ``lo`` (the vocab-parallel cross-entropy)."""
        return _VocabParallelCE.apply(logits, labels, lo, self)


def tensor_parallel() -> TensorParallel:
    """The current mesh's ``model`` axis as compute: under the tp layout
    on a mesh with a ``model`` axis (not manual), this rank's coordinate
    on it; else a size-1 ``TensorParallel`` without collectives (no mesh,
    or fsdp, whose model axis is a batch axis)."""
    mesh = current_mesh()
    if (mesh is None or "model" not in mesh.shape or _LAYOUT.get() != "tp"
            or "model" in _MANUAL.get()):
        return TensorParallel()
    return TensorParallel(mesh.shape["model"], mesh.coords["model"], mesh)
