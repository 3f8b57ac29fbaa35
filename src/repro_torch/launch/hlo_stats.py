"""Static cost of one rank's step → roofline terms (the counterpart of
``repro.launch.hlo_stats``).

No HLO exists here. The reference lowers a step with XLA and walks the
optimized HLO text; the port runs the step eagerly on ``meta`` tensors
(shapes and dtypes, no storage, nothing computed) under a
``TorchDispatchMode`` that sees every aten op it issues — the forward,
the recompute of checkpointed bodies and the backward — and counts each.
Reference names and their counterparts:

  ``analyze_hlo(text, pod_boundary)`` → ``analyze_step(fn, *args,
  node_size=8, pod_boundary=None)``;
  ``HloStats`` → ``StepStats``, the same fields, ``link_bytes_ici`` /
  ``link_bytes_dcn`` named ``link_bytes_nvlink`` / ``link_bytes_network``,
  and besides ``dot_flops``, ``kernels``, ``ops`` and ``memory``;
  ``extract_memory(compiled)`` → ``extract_memory(stats)``, from the trace;
  ``extract_cost(compiled)`` → ``extract_cost(prof)``, a ``torch.profiler``
  run of the step on the card;
  ``roofline_terms`` → ``roofline_terms``, the reference's keys with
  ``collective_bytes_nvlink`` / ``collective_bytes_network`` for
  ``collective_bytes_ici`` / ``collective_bytes_dcn``;
  ``PEAK_FLOPS``, ``HBM_BW``, ``ICI_BW``, ``DCN_BW`` → ``PEAK_FLOPS``,
  ``HBM_BW``, ``NVLINK_BW``, ``NETWORK_BW``; the HLO type table
  (``_DTYPE_BYTES``) has no counterpart: a torch dtype knows its size.

Cost model (per aten op, the reference's):
  dot            2 · |result| · K (mm, bmm, addmm, baddbmm, mv, dot:
                 what einsum, matmul and linear lower to), + |result|
                 for the bias of addmm / baddbmm; also in ``dot_flops``
  convolution    2 · |result| · |weight| / out_channels
  elementwise    |result|
  reduction      |operand| (softmax and its backward as the reductions
                 and elementwise ops XLA lowers them to)
  transcendental the reference's list (exp, log, tanh, logistic, rsqrt,
                 sqrt, power, sine, cosine) and the activations made of
                 them (silu, softplus, gelu, erf, exp2, expm1, log1p, …)
  sort / topk    0 flops; |operand| into ``sort_elems``
  bytes          the reference models TPU fusion and charges HBM only at
                 fusion boundaries. Eager PyTorch on the H100 writes each
                 op's result to HBM, so every op that is not a view
                 charges its operands plus its result (a broadcast operand
                 its distinct elements); an in-place update of a slice
                 (copy_, index_put_, scatter_, index_copy_, index_add_)
                 2 · |update| and its indices; a gather (embedding,
                 index_select, gather, index) 2 · |result| and its
                 indices; a fill its result; an allocation nothing.
  kernels        the hand-written kernels run through ctypes, which no
                 dispatch mode sees. On ``meta`` tensors each wrapper of
                 ``kernels/ops.py`` records the work ``kernels/cost.py``
                 gives it (``cost.RECORDER``); it is added as it is.
  collectives    counted where ``dist`` issues them (``dist.TRACE``), each
                 with the larger of its input and output bytes (size):
                 an all_reduce moves 2 · size over its link, the others
                 1 · size. A group whose ranks all lie in one NVLink node
                 of ``node_size`` cards (rank // node_size) is NVLink; any
                 other group (and one that crosses ``pod_boundary``, where
                 given) the network; a group of one rank moves nothing.
  no trip multipliers: an eager trace runs every layer and microbatch.

Memory: the arguments' bytes (distinct storages), the outputs', the
outputs that are arguments updated in place (alias), and the temporaries'
peak: the most bytes of live storages made by the step at once, read from
C++ weak references to the storages, so a tensor that autograd saves for
the backward counts until the graph frees it.

Hardware model: the H100 SXM datasheet's peaks (NVIDIA H100 80GB HBM3 at
700 W), not measurements: 989 TFLOP/s dense bf16, 3.35 TB/s HBM3,
450 GB/s NVLink a direction, 50 GB/s network a card (400 Gb/s).
"""
from __future__ import annotations

import collections
import dataclasses
import math

import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import dist
from repro_torch.kernels import cost

PEAK_FLOPS = 989e12
HBM_BW = 3.35e12
NVLINK_BW = 450e9
NETWORK_BW = 50e9

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute", "ragged-all-to-all")
# dist's operation names → the reference's
_DIST_OPS = {"all_gather": "all-gather", "all_reduce": "all-reduce",
             "reduce_scatter": "reduce-scatter"}

_DOTS = {"mm", "bmm", "addmm", "baddbmm", "mv", "addmv", "dot", "vdot"}
_TRANSCENDENTAL = {
    "exp", "exp2", "expm1", "log", "log2", "log10", "log1p", "tanh",
    "sigmoid", "rsqrt", "sqrt", "pow", "sin", "cos", "silu", "softplus",
    "gelu", "erf", "silu_backward", "softplus_backward", "gelu_backward",
    "tanh_backward"}
_ELEMENTWISE = _TRANSCENDENTAL | {
    "add", "sub", "rsub", "mul", "div", "neg", "abs", "maximum", "minimum",
    "clamp", "clamp_min", "clamp_max", "where", "eq", "ne", "lt", "le",
    "gt", "ge", "logical_and", "logical_or", "logical_not", "logical_xor",
    "bitwise_and", "bitwise_or", "bitwise_xor", "bitwise_not",
    "bitwise_left_shift", "bitwise_right_shift", "__and__", "__or__",
    "__xor__", "__lshift__", "__rshift__", "remainder", "fmod", "floor",
    "ceil", "round", "trunc", "sign", "reciprocal", "relu", "isfinite",
    "isnan", "isinf", "masked_fill", "lerp", "addcmul", "addcdiv", "atan2",
    "floor_divide", "sigmoid_backward", "threshold_backward", "square"}
_REDUCTIONS = {"sum", "mean", "amax", "amin", "max", "min", "prod", "var",
               "var_mean", "std", "std_mean", "norm", "linalg_vector_norm",
               "argmax", "argmin", "any", "all", "cumsum", "cumprod",
               "count_nonzero", "nansum", "logsumexp", "logcumsumexp"}
# (flops, transcendentals) a softmax-family op does an operand element
_SOFTMAX = {"_softmax": (5, 1), "_log_softmax": (5, 1),
            "_softmax_backward_data": (3, 0),
            "_log_softmax_backward_data": (3, 1)}
_SORTS = {"sort", "topk", "msort", "kthvalue", "median", "unique"}
# in place: (operand holding the update, operands that are indices)
_SLICE_UPDATES = {"copy": (1, ()), "index_put": (2, (1,)),
                  "index_copy": (3, (2,)), "index_add": (3, (2,)),
                  "scatter": (3, (2,)), "scatter_add": (3, (2,)),
                  "scatter_reduce": (3, (2,)), "masked_scatter": (2, (1,))}
# the result's rows read from the operand: (index operands)
_GATHERS = {"embedding": (1,), "index_select": (2,), "gather": (2,),
            "index": (1,)}
_WRITE_ONLY = {"fill", "zero", "zeros", "zeros_like", "ones", "ones_like",
               "full", "full_like", "arange", "scalar_tensor", "new_zeros",
               "new_ones", "new_full"}
# no flops, no bytes: allocation, metadata, a reshape without a copy
_FREE = {"empty", "empty_like", "empty_strided", "new_empty",
         "new_empty_strided", "_unsafe_view", "lift_fresh", "set_",
         "resize_", "_local_scalar_dense", "is_same_size",
         "_has_compatible_shallow_copy_type", "detach", "alias"}


@dataclasses.dataclass
class StepStats:
    flops: float = 0.0
    bytes: float = 0.0
    transcendentals: float = 0.0
    coll_counts: dict = dataclasses.field(
        default_factory=lambda: {k: 0 for k in _COLLECTIVES})
    coll_bytes: dict = dataclasses.field(
        default_factory=lambda: {k: 0.0 for k in _COLLECTIVES})
    link_bytes_nvlink: float = 0.0
    link_bytes_network: float = 0.0
    unknown_trip_whiles: int = 0        # always 0: no loop is folded
    sort_elems: float = 0.0
    dot_flops: float = 0.0
    # kernel name → {"calls", "flops", "bytes", "transcendentals",
    # "bound_ms": the sum of its calls' least times}
    kernels: dict = dataclasses.field(default_factory=dict)
    # aten op name → [calls, flops, bytes]
    ops: dict = dataclasses.field(
        default_factory=lambda: collections.defaultdict(
            lambda: [0, 0.0, 0.0]))
    memory: dict = dataclasses.field(default_factory=dict)

    def add_kernel(self, name: str, w: cost.Work) -> None:
        self.flops += w.flops
        self.bytes += w.bytes
        self.transcendentals += w.transcendentals
        k = self.kernels.setdefault(name, {"calls": 0, "flops": 0.0,
                                           "bytes": 0.0,
                                           "transcendentals": 0.0,
                                           "bound_ms": 0.0})
        k["calls"] += 1
        k["flops"] += w.flops
        k["bytes"] += w.bytes
        k["transcendentals"] += w.transcendentals
        k["bound_ms"] += cost.bound_ms(w)[0]


def _tensors(tree, out: list | None = None) -> list[torch.Tensor]:
    """The tensors of a nest of dicts, lists, tuples and dataclasses (no
    nested function: a recursive closure is a reference cycle, which
    would keep the tensors alive until the garbage collector runs)."""
    out = [] if out is None else out
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, dict):
        for v in tree.values():
            _tensors(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _tensors(v, out)
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            _tensors(getattr(tree, f.name), out)
    return out


def _bytes(t: torch.Tensor) -> int:
    """The distinct elements' bytes of ``t`` (a broadcast dim once)."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride:
            n *= size
    return n * t.element_size()


def _key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def _storage_bytes(tensors) -> tuple[int, set]:
    keys: dict = {}
    for t in tensors:
        keys.setdefault(_key(t), t.untyped_storage().nbytes())
    return sum(keys.values()), set(keys)


class _Live:
    """The bytes of the live storages a step made: each new storage is
    held by a weak reference, and the expired ones are swept whenever the
    count would pass its peak, so the peak is exact at every op."""

    def __init__(self, arg_keys: set):
        self.args = arg_keys
        self.held: dict = {}
        self.live = 0
        self.peak = 0

    def add(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self.args:
            return
        old = self.held.get(key)
        if old is not None:
            if not old[0].expired():
                return
            self.live -= old[1]
        n = st.nbytes()
        self.held[key] = (StorageWeakRef(st), n)
        self.live += n
        if self.live > self.peak:
            self._sweep()
            self.peak = max(self.peak, self.live)

    def _sweep(self) -> None:
        for key in [k for k, (ref, _) in self.held.items() if ref.expired()]:
            self.live -= self.held.pop(key)[1]


class _CostMode(TorchDispatchMode):
    def __init__(self, stats: StepStats, live: _Live):
        super().__init__()
        self.stats, self.live = stats, live

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.namespace == "aten":
            self._charge(func, args, kwargs, out)
        for t in _tensors(out):
            self.live.add(t)
        return out

    def _charge(self, func, args, kwargs, out) -> None:
        name = func.overloadpacket.__name__
        if func.is_view or name in _FREE:
            return
        mutable = func._schema.is_mutable
        base = name[:-1] if mutable and name.endswith("_") else name
        ins = _tensors(args) + _tensors(kwargs)
        outs = _tensors(out)
        res = outs[0].numel() if outs else 0
        st = self.stats
        flops = trans = 0.0
        if base in _DOTS:
            bias = base in ("addmm", "baddbmm", "addmv")
            k = args[0].numel() if base in ("dot", "vdot") \
                else args[int(bias)].shape[-1]
            dots = 2.0 * res * k
            st.dot_flops += dots
            flops = dots + (res if bias else 0)
        elif base == "convolution":
            w = args[1]
            flops = 2.0 * res * w.numel() / max(w.shape[0], 1)
            st.dot_flops += flops
        elif base in _ELEMENTWISE:
            flops = float(res)
            if base in _TRANSCENDENTAL:
                trans = float(res)
        elif base in _REDUCTIONS:
            flops = float(ins[0].numel()) if ins else 0.0
            if base in ("logsumexp", "logcumsumexp"):
                trans = flops
        elif base in _SOFTMAX:
            f, t = _SOFTMAX[base]
            flops, trans = f * float(ins[0].numel()), t * float(
                ins[0].numel())
        elif base in _SORTS:
            st.sort_elems += float(ins[0].numel()) if ins else 0.0
        if mutable and base in _SLICE_UPDATES:
            upd, idx = _SLICE_UPDATES[base]
            update = _tensors(args[upd]) if upd < len(args) else []
            n = sum(_bytes(t) for t in update)
            if base == "copy":
                n += _bytes(args[0])
            else:
                n *= 2
            n += sum(_bytes(t) for i in idx if i < len(args)
                     for t in _tensors(args[i]))
        elif base in _GATHERS:
            n = 2 * sum(_bytes(t) for t in outs) + sum(
                _bytes(t) for i in _GATHERS[base] if i < len(args)
                for t in _tensors(args[i]))
        elif base in _WRITE_ONLY:
            n = sum(_bytes(t) for t in outs)
        else:
            n = sum(_bytes(t) for t in ins) + sum(_bytes(t) for t in outs)
        st.flops += flops
        st.transcendentals += trans
        st.bytes += n
        rec = st.ops[name]
        rec[0] += 1
        rec[1] += flops
        rec[2] += n


def _link(ranks: list[int], node_size: int,
          pod_boundary: int | None) -> str | None:
    if len(ranks) == 1:
        return None             # a one-rank group moves nothing
    if pod_boundary is not None and min(ranks) < pod_boundary <= max(ranks):
        return "network"
    return "nvlink" if len({r // node_size for r in ranks}) == 1 \
        else "network"


def analyze_step(fn, *args, node_size: int = 8,
                 pod_boundary: int | None = None, **kwargs) -> StepStats:
    """Run ``fn(*args, **kwargs)`` once under the cost model (the module's
    docstring) and return its ``StepStats``, ``memory`` filled. Meant for
    ``meta`` arguments (nothing is computed and no kernel launches; the
    kernels count their own work); on CPU tensors it runs for real and
    the kernels' plain versions are counted as the aten ops they are."""
    import torch.distributed as tdist
    stats = StepStats()
    arg_tensors = _tensors((args, kwargs))
    arg_bytes, arg_keys = _storage_bytes(arg_tensors)
    live = _Live(arg_keys)
    kernels: list = []
    trace: list = []
    prev = cost.RECORDER, dist.TRACE
    cost.RECORDER, dist.TRACE = kernels, trace
    try:
        with _CostMode(stats, live):
            out = fn(*args, **kwargs)
    finally:
        cost.RECORDER, dist.TRACE = prev
    for name, w in kernels:
        stats.add_kernel(name, w)
    links: dict = {}
    for op, mesh, axes, size in trace:
        kind = _DIST_OPS[op]
        stats.coll_counts[kind] += 1
        stats.coll_bytes[kind] += size
        key = (id(mesh), axes)
        if key not in links:
            ranks = tdist.get_process_group_ranks(mesh.group(axes))
            links[key] = _link(ranks, node_size, pod_boundary)
        traffic = 2 * size if kind == "all-reduce" else size
        if links[key] == "nvlink":
            stats.link_bytes_nvlink += traffic
        elif links[key] == "network":
            stats.link_bytes_network += traffic
    out_tensors = _tensors(out)
    out_bytes, out_keys = _storage_bytes(out_tensors)
    alias, _ = _storage_bytes([t for t in out_tensors
                               if _key(t) in arg_keys])
    stats.memory = {"argument_size_in_bytes": arg_bytes,
                    "output_size_in_bytes": out_bytes,
                    "temp_size_in_bytes": live.peak,
                    "alias_size_in_bytes": alias}
    stats.ops = {k: list(v) for k, v in sorted(
        stats.ops.items(), key=lambda kv: -kv[1][2])}
    return stats


# ---------------------------------------------------------------------------
# extraction
# ---------------------------------------------------------------------------


def extract_memory(stats: StepStats) -> dict:
    """The reference's ``memory_analysis()`` fields from a traced step:
    argument, output, temp (peak of the step's own live storages) and
    alias bytes. No code is generated, so that field is absent."""
    return dict(stats.memory)


_TOP = 15        # the longest CUDA functions ``extract_cost`` lists


def extract_cost(prof, max_memory_allocated: int | None = None) -> dict:
    """A ``torch.profiler`` run of the step on the card: its device time
    (the union of its kernels' spans), the device time of the ``_TOP``
    longest CUDA function names, that of each of the port's kernels
    (``cost.kernel_of``), and ``max_memory_allocated`` where given."""
    spans, by_name, calls, port = [], {}, {}, {}
    # the profiler's raw events: building its event tree for a step of
    # ~10^5 kernels takes minutes
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        name, start, us = e.name(), e.start_ns() * 1e-3, \
            e.duration_ns() * 1e-3
        spans.append((start, start + us))
        by_name[name] = by_name.get(name, 0.0) + us
        calls[name] = calls.get(name, 0) + 1
        k = cost.kernel_of(name)
        if k is not None:
            port[k] = port.get(k, 0.0) + us
    spans.sort()
    busy, end = 0.0, -math.inf
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])
    out = {"device_time_s": busy * 1e-6, "device_ops": len(spans),
           "device_us_by_kernel": {k[:80]: v for k, v in ranked[:_TOP]},
           "calls_by_kernel": {k[:80]: calls[k] for k, _ in ranked[:_TOP]},
           "port_kernel_ms": {k: v * 1e-3 for k, v in port.items()}}
    if max_memory_allocated is not None:
        out["max_memory_allocated"] = int(max_memory_allocated)
    return out


def roofline_terms(stats: StepStats, n_devices: int, model_flops: float,
                   peak_flops: float = PEAK_FLOPS, hbm_bw: float = HBM_BW,
                   nvlink_bw: float = NVLINK_BW,
                   network_bw: float = NETWORK_BW) -> dict:
    """The three roofline terms (seconds per step, per device), at the
    H100's datasheet peaks unless others are given."""
    t_compute = stats.flops / peak_flops
    t_memory = stats.bytes / hbm_bw
    t_coll = (stats.link_bytes_nvlink / nvlink_bw
              + stats.link_bytes_network / network_bw)
    terms = {"compute_s": t_compute, "memory_s": t_memory,
             "collective_s": t_coll}
    dominant = max(terms, key=terms.get)
    bound = max(terms.values())
    flops_global = stats.flops * n_devices
    return {
        **terms,
        "dominant": dominant,
        "hlo_flops_per_device": stats.flops,
        "hlo_bytes_per_device": stats.bytes,
        "hlo_flops_global": flops_global,
        "collective_bytes_nvlink": stats.link_bytes_nvlink,
        "collective_bytes_network": stats.link_bytes_network,
        "model_flops": model_flops,
        "useful_flops_ratio": (model_flops / flops_global
                               if flops_global else 0.0),
        "roofline_fraction": (t_compute / bound if bound > 0 else 0.0),
        "step_time_lower_bound_s": bound,
        "unknown_trip_whiles": stats.unknown_trip_whiles,
        "sort_elems_per_device": stats.sort_elems,
    }
