"""Train step: microbatched gradient accumulation + AdamW, on one device.

The counterpart of ``repro.train.loop``: ``make_train_step`` builds
step(state, batch) → (state, metrics): batch (B, S) → microbatch split
(B laid out as [dp, n_mb, local], dp = 1 here) → gradients per
microbatch accumulated in ``accum_dtype``, or one backward of the mean
loss → global-norm clip → AdamW (in place) → new state. The metrics
(``loss``, ``lr``, ``grad_norm``) are 0-d device tensors: nothing in a
step reads back to the host. The multi-device parts (the data-parallel
reduction, ``shard_grads_like_opt``) wait for ROADMAP queue 1 item 3.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch
import torch.utils.checkpoint as ckpt

from repro_torch.models import ModelConfig, init_params, lm_loss
from repro_torch.models.config import dtype
from repro_torch.train.optimizer import (OptimizerConfig, apply_updates,
                                         init_opt_state)
from repro_torch.utils import tree_leaves


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
        rounds), then × 1/n_mb in fp32;
      * "grad_of_scan": one backward of the mean loss over the
        microbatches, each microbatch's loss checkpointed.
    On one device both give the same gradients within fp32 rounding.
    ``grad_reducer``: an optional hook on the gradient tree before the
    update. The step updates the state's tensors in place and returns a
    new ``TrainState`` holding them."""
    if shard_grads_like_opt:
        raise NotImplementedError(
            "shard_grads_like_opt (ZeRO-sharded gradients) is multi-device: "
            "ROADMAP queue 1 item 3")
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
        mbs = microbatch_split(batch, n_mb) if n_mb > 1 else \
            {k: v[None] for k, v in batch.items()}
        mb = lambda i: {k: v[i] for k, v in mbs.items()}  # noqa: E731

        if accum_mode == "grad_of_scan":
            total = torch.zeros((), dtype=torch.float32,
                                device=tensors[0].device)
            for i in range(n_mb):
                total = total + ckpt.checkpoint(loss_fn, params, mb(i),
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
        grads = _unflatten(paths, flat)
        if grad_reducer is not None:
            grads = grad_reducer(grads)
        params, opt, opt_metrics = apply_updates(params, grads, state.opt,
                                                 opt_cfg)
        del grads, flat
        metrics = {"loss": loss_sum / n_mb, **opt_metrics}
        return TrainState(params=params, opt=opt, step=state.step + 1), \
            metrics

    return step


def _unflatten(paths, values) -> dict:
    out: dict = {}
    for path, v in zip(paths, values):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return out

