"""Train step: microbatched gradient accumulation + AdamW.

The counterpart of ``repro.train.loop``: ``make_train_step`` builds
step(state, batch) → (state, metrics): batch (B, S) → microbatch split
(B laid out as [dp, n_mb, local]) → gradients per microbatch accumulated
in ``accum_dtype``, or one backward of the mean loss → global-norm clip
→ AdamW (in place) → new state. The metrics (``loss``, ``lr``,
``grad_norm``) are 0-d device tensors: nothing in a step reads back to
the host.

Under a mesh (``repro_torch.dist``, one process a rank) the state is
this rank's blocks (``shard_train_state``) and the step takes the global
batch, of which each rank keeps its rows along the batch axes. The loss
is the reference's global one (``lm_loss``); each rank back-propagates
its part and the gradients are summed over exactly the ranks that
contributed different parts: inside the backward over the axes a
parameter is split on (``dist.gather_param``), then over the remaining
batch axes — reduce_scattered into the optimizer's ZeRO blocks with
``shard_grads_like_opt``, all_reduced without.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch
import torch.utils.checkpoint as ckpt

from repro_torch import dist
from repro_torch.models import ModelConfig, init_params, lm_loss
from repro_torch.models.config import dtype
from repro_torch.models.decoder import (gather_params, param_shapes,
                                        param_sharding_rules,
                                        partial_grad_leaves, place_params)
from repro_torch.train.optimizer import (OptimizerConfig, apply_updates,
                                         init_opt_state, state_layouts)
from repro_torch.utils import (tree_get, tree_leaves, tree_map_with_path,
                               tree_unflatten)


@dataclasses.dataclass
class TrainState:
    params: Any
    opt: dict
    step: torch.Tensor


def init_train_state(cfg: ModelConfig, seed: int = 0,
                     device=None) -> TrainState:
    """Parameters from ``init_params(cfg, seed, device)`` (cuda unless
    named), their optimizer state and step 0."""
    params = init_params(cfg, seed, device)
    dev = next(tree_leaves(params))[1].device
    return TrainState(params=params, opt=init_opt_state(params),
                      step=torch.zeros((), dtype=torch.int32, device=dev))


def layouts(cfg: ModelConfig) -> dict | None:
    """Each parameter's ``LeafLayout`` (parameter and optimizer-state
    specs) under the current mesh and layout; None without a mesh."""
    if dist.current_mesh() is None:
        return None
    return state_layouts(param_sharding_rules(cfg), param_shapes(cfg))


def shard_train_state(state: TrainState, cfg: ModelConfig) -> TrainState:
    """A whole (one-device) ``TrainState`` → this rank's blocks under the
    current mesh: the parameters by ``param_sharding_rules``, master / m /
    v by ``opt_state_sharding_rules``, each sanitized; the step counts
    as they are."""
    lay = layouts(cfg)
    if lay is None:
        return state

    def opt(tree):
        return tree_map_with_path(lambda path, x: dist.local_block(
            x, tree_get(lay, path).opt), tree)

    return TrainState(
        params=place_params(state.params, cfg),
        opt={**{k: opt(state.opt[k]) for k in ("master", "m", "v")},
             "step": state.opt["step"]}, step=state.step)


def gather_train_state(state: TrainState, cfg: ModelConfig) -> TrainState:
    """``shard_train_state``'s inverse: whole tensors on every rank."""
    lay = layouts(cfg)
    if lay is None:
        return state

    def opt(tree):
        return tree_map_with_path(lambda path, x: dist.gather(
            x, tree_get(lay, path).opt, tree_get(lay, path).shape), tree)

    return TrainState(
        params=gather_params(state.params, cfg),
        opt={**{k: opt(state.opt[k]) for k in ("master", "m", "v")},
             "step": state.opt["step"]}, step=state.step)


def reduce_gradients(grads: dict, cfg: ModelConfig,
                     like_opt: bool = False) -> dict:
    """Finish the data-parallel sum of the gradients of this rank's
    parameter blocks (as ``torch.autograd.grad`` gives them under a
    mesh): over the live batch axes a parameter is not split on (the
    backward summed the others), and over ``model`` for the leaves the
    tensor-parallel layers use a part of on each rank though they are
    stored whole (``decoder.partial_grad_leaves``); a leaf split over
    ``model`` comes from autograd as this rank's block, a replicated one
    (norms, the router, Mamba2's fused projections) equal on every model
    rank through the "f" operators. ``like_opt``: reduce_scatter over the
    axes ZeRO adds, into the optimizer's blocks (the reference's
    ``_shard_like_opt``), else all_reduce into the parameters' blocks.
    Each leaf of ``grads`` is replaced in place (the tree is returned), so
    a leaf's old buffer goes as its reduced one comes. The tree itself
    without a mesh."""
    lay = layouts(cfg)
    if lay is None:
        return grads
    live = dist.live_batch_axes()
    partial = partial_grad_leaves(cfg)

    def one(path, g):
        leaf = tree_get(lay, path)
        rest = [a for a in live if a not in dist.spec_axes(leaf.param)]
        if partial is not None and tree_get(partial, path):
            rest.append("model")
        if like_opt:
            for d, (p, o) in enumerate(zip(leaf.param, leaf.opt)):
                if p != o:
                    g = dist.reduce_scatter_dim(g, d, o)
                    rest = [a for a in rest if a not in dist.spec_axes((o,))]
        return dist.all_reduce(g.contiguous(), tuple(rest))

    for path, _ in list(tree_leaves(grads)):
        node = tree_get(grads, path[:-1])
        node[path[-1]] = one(path, node[path[-1]])
    return grads


def microbatch_split(batch: dict, n_mb: int, dp: int = 1) -> dict:
    """(B, ...) → (n_mb, B/n_mb, ...), B laid out as [dp, n_mb, local] as
    in the reference (microbatch i takes rows i·local … of each of the dp
    shards). Requires B % (dp · n_mb) == 0."""
    def split(x):
        b = x.shape[0]
        assert b % (dp * n_mb) == 0, (b, dp, n_mb)
        local = b // (dp * n_mb)
        y = x.reshape(dp, n_mb, local, *x.shape[1:]).transpose(0, 1)
        return y.reshape(n_mb, dp * local, *x.shape[1:])

    return {k: split(v) for k, v in batch.items()}


def make_train_step(cfg: ModelConfig, opt_cfg: OptimizerConfig,
                    n_microbatches: int = 1, attn_impl: str = "masked",
                    grad_reducer: Callable | None = None,
                    accum_mode: str = "scan_grads",
                    shard_grads_like_opt: bool = False):
    """Returns step(state, batch) → (state, metrics).

    ``accum_mode``:
      * "scan_grads": a backward per microbatch, the gradients summed in
        ``opt_cfg.accum_dtype`` (each add rounded to it, as the reference
        rounds), then × 1/n_mb in fp32; under a mesh each microbatch's
        gradients are reduced over the ranks before they are added (as
        XLA reduces once a microbatch), so with ZeRO the accumulators are
        the optimizer's blocks;
      * "grad_of_scan": one backward of the mean loss over the
        microbatches, each microbatch's loss checkpointed; under a mesh
        the gradients are reduced once a step.
    On one device both give the same gradients within fp32 rounding.
    ``shard_grads_like_opt``: under a mesh the gradients are
    reduce_scattered into the optimizer's ZeRO blocks (half the ring
    traffic of an all_reduce) and the update runs on them; off, they are
    all_reduced over the batch axes. Either way the update gathers the
    new parameters back to their layout. ``grad_reducer``: an optional
    hook on the reduced gradient tree before the update. The step updates
    the state's tensors in place and returns a new ``TrainState`` holding
    them."""
    if accum_mode not in ("scan_grads", "grad_of_scan"):
        raise ValueError(f"unknown accum_mode {accum_mode!r}")
    accum_dt = dtype(opt_cfg.accum_dtype)

    def loss_fn(params, mb):
        return lm_loss(params, mb, cfg, impl=attn_impl)[0]

    def grad(loss, tensors):
        # leaves the loss does not reach (the parallel block's MLP norm, a
        # patch projection without patch inputs) get zeros, as in JAX
        return torch.autograd.grad(loss, tensors, allow_unused=True,
                                   materialize_grads=True)

    def step(state: TrainState, batch: dict):
        n_mb = n_microbatches
        params = state.params
        paths, tensors = zip(*tree_leaves(params))
        for t in tensors:
            t.requires_grad_(True)
        dp = dist.dp_size()
        mbs = microbatch_split(batch, n_mb, dp) if n_mb > 1 else \
            {k: v[None] for k, v in batch.items()}
        mesh = dist.current_mesh() is not None
        rows = dist.live_batch_axes()
        if rows:        # this rank's rows of every microbatch
            mbs = {k: dist.shard(v, None, rows) for k, v in mbs.items()}
        mb = lambda i: {k: v[i] for k, v in mbs.items()}  # noqa: E731

        if accum_mode == "grad_of_scan":
            total = torch.zeros((), dtype=torch.float32,
                                device=tensors[0].device)
            for i in range(n_mb):
                total = total + ckpt.checkpoint(
                    dist.bind_context(loss_fn), params, mb(i),
                    use_reentrant=False)
            loss_mean = total / n_mb
            flat = list(grad(loss_mean, tensors))
            loss_sum = loss_mean.detach() * n_mb
        else:
            flat, loss_sum = None, torch.zeros(
                (), dtype=torch.float32, device=tensors[0].device)
            for i in range(n_mb):
                loss = loss_fn(params, mb(i))
                grads = grad(loss, tensors)
                loss_sum = loss_sum + loss.detach()
                if mesh:    # summed over the ranks a microbatch
                    grads = tree_unflatten(paths, grads)
                    grads = [g for _, g in tree_leaves(reduce_gradients(
                        grads, cfg, shard_grads_like_opt))]
                if flat is None:       # 0 + g in accum_dtype: g rounded
                    flat = [g.to(accum_dt).contiguous() for g in grads]
                else:
                    for a, g in zip(flat, grads):
                        a.add_(g.to(accum_dt))
                del grads
            flat = [a.float().mul_(1.0 / n_mb) if a.dtype != torch.float32
                    else a.mul_(1.0 / n_mb) for a in flat]
        for t in tensors:
            t.requires_grad_(False)
        grads = tree_unflatten(paths, flat)
        del flat
        if mesh and accum_mode == "grad_of_scan":
            grads = reduce_gradients(grads, cfg, shard_grads_like_opt)
        if grad_reducer is not None:
            grads = grad_reducer(grads)
        params, opt, opt_metrics = apply_updates(params, grads, state.opt,
                                                 opt_cfg, layouts(cfg))
        del grads
        metrics = {"loss": loss_sum / n_mb, **opt_metrics}
        return TrainState(params=params, opt=opt, step=state.step + 1), \
            metrics

    return step
