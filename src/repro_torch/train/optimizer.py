"""AdamW with mixed precision, on one device.

The counterpart of ``repro.train.optimizer``: parameters live in
``param_dtype`` (bf16 in production); the optimizer state carries an fp32
master copy and fp32 moments. The math is the reference's, in fp32 on the
parameters' device, with the step count held as a device tensor so that no
step reads a value back to the host. The update runs leaf by leaf and in
place, in slices of ``UPDATE_SLICE`` elements, so its transient memory is
a few slices and not a copy of the tree (qwen2.5-14b's head alone is 786 M
parameters).

Under a mesh (``repro_torch.dist``) the state is ZeRO-sharded as the
reference lays it out: the parameters by the decoder's rules, the fp32
master and moments by ``opt_state_sharding_rules`` (the rules with the
``data`` axis added on the largest unsplit dim, kept where it divides),
each rank holding its block. ``apply_updates`` then updates its own
blocks in place and gathers the new parameters back to their layout.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch import dist
from repro_torch.utils import (tree_get, tree_leaves, tree_map,
                               tree_map_with_path)

# elements of a leaf updated together: 64 MB of fp32 a temporary
UPDATE_SLICE = 1 << 24


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    accum_dtype: str = "bfloat16"   # gradient-accumulation dtype


def schedule(cfg: OptimizerConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup → cosine decay to min_lr_frac·lr (fp32, on step's
    device)."""
    step = step.float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos)


def init_opt_state(params: dict) -> dict:
    """fp32 master (a copy, also of fp32 parameters), zero fp32 moments and
    a 0-d int32 step, on the parameters' device."""
    with torch.no_grad():
        master = tree_map(lambda x: x.detach().to(torch.float32, copy=True),
                          params)
        zeros = lambda: tree_map(  # noqa: E731
            lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                  device=x.device), params)
        device = next(tree_leaves(params))[1].device
        return {"master": master, "m": zeros(), "v": zeros(),
                "step": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree: dict, axes: dict | None = None) -> torch.Tensor:
    """√(Σ leaf²) over the leaves in fp32, summed leaf by leaf in the
    reference's order. Under a mesh ``axes`` gives, leaf for leaf, the
    axes its block is split over: each leaf's local sum of squares is
    summed over exactly those ranks (one all_reduce a distinct set of
    axes), so a leaf whole on every rank counts once."""
    sqs = [torch.linalg.vector_norm(x, dtype=torch.float32).square()
           for _, x in tree_leaves(tree)]
    if axes is not None:
        split = [dist.current_mesh()._key(a) for _, a in tree_leaves(axes)]
        stacked = torch.stack(sqs)
        for key in dict.fromkeys(k for k in split if k):
            idx = torch.tensor([i for i, k in enumerate(split) if k == key],
                               device=stacked.device)
            stacked[idx] = dist.all_reduce(stacked[idx].clone(), key)
        sqs = stacked.unbind(0)
    total = None
    for sq in sqs:
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def apply_updates(params: dict, grads: dict, opt_state: dict,
                  cfg: OptimizerConfig, layouts: dict | None = None
                  ) -> tuple[dict, dict, dict]:
    """One AdamW step; grads in any dtype, math in fp32. Updates the
    parameters, master copy and moments in place (the reference returns
    new trees) and returns (params, state with step + 1, {"lr",
    "grad_norm"} as 0-d device tensors).

    Under a mesh ``layouts`` (``state_layouts``) gives each leaf's
    layouts: the gradients come in the optimizer's (ZeRO) blocks or in
    the parameters' (then cut to the optimizer's), each rank updates its
    blocks of master / m / v, and a parameter split over fewer axes than
    its state is all_gathered back from the new bf16 blocks."""
    with torch.no_grad():
        step = opt_state["step"] + 1
        lr = schedule(cfg, step)
        norm_axes = None
        if layouts is not None:
            grads = _to_opt_blocks(grads, layouts)
            norm_axes = tree_map(lambda lay: dist.spec_axes(lay.opt),
                                 layouts)
        gnorm = global_norm(grads, norm_axes)
        scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
        b1, b2 = cfg.beta1, cfg.beta2
        stepf = step.float()
        c1 = 1 - torch.pow(b1, stepf)
        c2 = 1 - torch.pow(b2, stepf)
        state = zip(*(tree_leaves(t) for t in (
            grads, opt_state["m"], opt_state["v"], opt_state["master"],
            params)))
        for (path, g), (_, m), (_, v), (_, master), (_, p) in state:
            lay = None if layouts is None else tree_get(layouts, path)
            split = lay is not None and lay.param != lay.opt
            out = torch.empty_like(master, dtype=p.dtype) if split else p
            flat = [g.reshape(-1)] + [t.view(-1)
                                      for t in (m, v, master, out)]
            for lo in range(0, g.numel(), UPDATE_SLICE):
                gs, ms, vs, ws, ps = (t[lo: lo + UPDATE_SLICE] for t in flat)
                gf = gs.float() * scale
                m_new = b1 * ms + (1 - b1) * gf
                v_new = b2 * vs + (1 - b2) * gf * gf
                delta = (m_new / c1) / (torch.sqrt(v_new / c2) + cfg.eps) \
                    + cfg.weight_decay * ws
                w_new = ws - lr * delta
                ms.copy_(m_new)
                vs.copy_(v_new)
                ws.copy_(w_new)
                ps.copy_(w_new)
            if split:
                p.copy_(_opt_to_param(out, lay))
        new_state = dict(opt_state, step=step)
        return params, new_state, {"lr": lr, "grad_norm": gnorm}


# ---------------------------------------------------------------------------
# ZeRO sharding
# ---------------------------------------------------------------------------


def zero_sharding_entry(param_spec: tuple, shape: tuple[int, ...],
                        data_axes: tuple[str, ...] = ("data",)) -> tuple:
    """A parameter's spec extended with ZeRO sharding over ``data``: the
    largest dim not already split gets the data axes; unchanged when the
    spec already uses them or no dim is free. As in the reference, the
    size is not checked against the axes: ``dist.sanitize_spec`` drops an
    entry that does not divide, so such a leaf stays whole."""
    spec = list(param_spec) + [None] * (len(shape) - len(param_spec))
    used = {a for e in spec if e is not None
            for a in ((e,) if isinstance(e, str) else e)}
    if any(a in used for a in data_axes):
        return tuple(spec)
    order = sorted(range(len(shape)), key=lambda i: -shape[i])
    for i in order:
        if spec[i] is None:
            spec[i] = data_axes[0] if len(data_axes) == 1 else tuple(data_axes)
            return tuple(spec)
    return tuple(param_spec)


def opt_state_sharding_rules(param_rules: dict, param_shapes_tree: dict
                             ) -> dict:
    """Rules of ``init_opt_state``'s tree from the parameters' rules."""
    def extend(rule, shp):
        if isinstance(rule, dict):
            return {k: extend(rule[k], shp[k]) for k in rule}
        return zero_sharding_entry(tuple(rule), tuple(shp))

    extended = extend(param_rules, param_shapes_tree)
    return {"master": extended, "m": extended, "v": extended, "step": ()}


@dataclasses.dataclass(frozen=True)
class LeafLayout:
    """Where a leaf's blocks lie under the current mesh: its global
    ``shape``, the parameter's sanitized spec and the optimizer state's."""

    shape: tuple
    param: tuple
    opt: tuple


def state_layouts(param_rules: dict, param_shapes_tree: dict) -> dict:
    """Each leaf's ``LeafLayout`` under the current mesh and layout: the
    state's effective placement, ``sanitize_spec(shape, rule)`` and
    ``sanitize_spec(shape, zero_sharding_entry(rule, shape))``."""
    opt = opt_state_sharding_rules(param_rules, param_shapes_tree)["master"]

    def walk(rule, z, shp):
        if isinstance(rule, dict):
            return {k: walk(rule[k], z[k], shp[k]) for k in rule}
        return LeafLayout(tuple(shp), dist.sanitize_spec(shp, rule),
                          dist.sanitize_spec(shp, z))

    return walk(param_rules, opt, param_shapes_tree)


def _extra_dims(lay: LeafLayout):
    """(dim, axes) where the optimizer's spec splits a dim that the
    parameter's leaves whole (ZeRO's added ``data``)."""
    return [(d, o) for d, (p, o) in enumerate(zip(lay.param, lay.opt))
            if p != o]


def param_to_opt_block(g: torch.Tensor, lay: LeafLayout) -> torch.Tensor:
    """A parameter-layout block cut to this rank's optimizer block."""
    mesh = dist.current_mesh()
    for d, axes in _extra_dims(lay):
        lo, hi = dist.block_range(g.shape[d], mesh.size(axes),
                                  mesh.coord(axes))
        g = g.narrow(d, lo, hi - lo)
    return g.contiguous()


def _opt_to_param(x: torch.Tensor, lay: LeafLayout) -> torch.Tensor:
    for d, axes in _extra_dims(lay):
        x = dist.all_gather_dim(x, d, axes, lay.shape[d])
    return x


def _to_opt_blocks(grads: dict, layouts: dict) -> dict:
    """Gradients in the optimizer's blocks: those still in a parameter's
    layout (``shard_grads_like_opt`` off) are cut to them."""
    def one(path, g):
        lay = tree_get(layouts, path)
        if tuple(g.shape) == dist.block_shape(lay.shape, lay.opt):
            return g
        return param_to_opt_block(g, lay)

    return tree_map_with_path(one, grads)
