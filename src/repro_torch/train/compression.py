"""Cross-pod gradient compression (the counterpart of
``repro.train.compression``).

The pod axis is the slow link between hosts: an fp32 ring all-reduce of
the gradients costs 2 × 4 bytes a parameter across it. Here the pod
exchange is an int8 ``all_gather`` plus a local dequantize-and-mean,
(P − 1)/P × 1 byte a parameter: the data and model axes reduce exactly
(fp32) inside each pod, the pod axis in int8. Quantization is per-tensor
absmax int8, rounded half to even (``torch.round`` and ``jnp.round``
agree on that); integer and 0-d leaves take the exact mean instead.
"""
from __future__ import annotations

import torch

from repro_torch import dist
from repro_torch.train.loop import layouts, reduce_gradients
from repro_torch.utils import (tree_get, tree_leaves, tree_map,
                               tree_map_with_path, tree_unflatten)

POD = "pod"


def _quantize(g: torch.Tensor, amax: torch.Tensor | None = None):
    """Per-tensor absmax int8 with a leading pod-stack axis: → (q (1,
    *shape) int8, scale (1,) fp32), scale = max|g| / 127 + 1e-12.
    ``amax``: the tensor's max |g| when ``g`` is only a block of it."""
    gf = g.float()
    if amax is None:
        amax = gf.abs().max()
    scale = amax / 127.0 + 1e-12
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    return q[None], scale.reshape(1)


def _exempt(g: torch.Tensor) -> bool:
    """Integer and 0-d leaves take the exact mean (absmax int8 of an
    integer or a lone scalar would be lossy for nothing)."""
    return not g.is_floating_point() or g.ndim == 0


def _pod_mean_exact(g: torch.Tensor) -> torch.Tensor:
    n = dist.axis_size(POD)
    total = dist.all_reduce(g.clone(), (POD,))
    if not g.is_floating_point():       # XLA's integer division truncates
        return torch.div(total, n, rounding_mode="trunc")
    return total / n


def _dequant_mean(q: torch.Tensor, scale: torch.Tensor,
                  like: torch.Tensor) -> torch.Tensor:
    """Every pod rank's (q, scale) — q (1, *shape) int8, scale (1,) fp32,
    its 4 bytes sent as int8 behind q's — through one int8
    ``all_gather`` over the pod group, dequantized and averaged."""
    n = dist.axis_size(POD)
    payload = torch.cat([q.reshape(-1), scale.view(torch.int8)])
    got = dist.all_gather_dim(payload, 0, POD, n * payload.numel())
    got = got.reshape(n, -1)
    qs = got[:, :-4].reshape((n, *like.shape))
    ss = got[:, -4:].contiguous().view(torch.float32)       # (n, 1)
    deq = qs.float() * ss.reshape((-1,) + (1,) * like.ndim)
    return deq.mean(dim=0).to(like.dtype)


def compressed_pod_mean(tree: dict) -> dict:
    """The mean of a gradient tree over the ``pod`` axis, float leaves as
    int8 plus an fp32 scale through an ``all_gather`` over the pod group,
    integer and 0-d leaves exactly. Each leaf is a whole tensor on this
    rank (its absmax is local)."""
    def one(g):
        if _exempt(g):
            return _pod_mean_exact(g)
        return _dequant_mean(*_quantize(g), g)

    return tree_map(one, tree)


def pod_compressed_value_and_grad(loss_fn, mesh, cfg):
    """``loss_fn(params, batch) → scalar`` (the mean loss over its batch)
    as f(params, batch) → (loss, grads) whose cross-pod exchange is int8.

    ``batch`` is the global batch; each rank keeps its rows along the
    batch axes, pod first (the reference's ``P(("pod", "data"))``).
    Inside ``manual_axes({"pod"})`` the loss is pod-local — ``lm_loss``
    averages over the pod's own tokens — and the gradients are summed
    exactly over the pod's other batch axes. Each float gradient is then
    quantized with its whole tensor's absmax (a max over the axes its
    block is split on), all_gathered as int8 over ``pod`` and dequantized
    to the mean; the loss is averaged exactly over ``pod``.

    ``cfg``: the model whose rules lay out ``params`` (``place_params``
    under ``manual_axes({"pod"})``: replicated over ``pod``)."""
    def wrapped(params: dict, batch: dict):
        with mesh:
            local = {k: dist.shard_batch(v) for k, v in batch.items()}
            with dist.manual_axes({POD}):
                paths, tensors = zip(*tree_leaves(params))
                for t in tensors:
                    t.requires_grad_(True)
                try:
                    loss = loss_fn(params, local)
                    flat = torch.autograd.grad(
                        loss, tensors, allow_unused=True,
                        materialize_grads=True)
                finally:
                    for t in tensors:
                        t.requires_grad_(False)
                grads = reduce_gradients(tree_unflatten(paths, flat), cfg)
                split = tree_map(lambda lay: dist.spec_axes(lay.param),
                                 layouts(cfg))

            def one(path, g):
                if _exempt(g):
                    return _pod_mean_exact(g)
                amax = g.float().abs().max()
                dist.all_reduce(amax, tree_get(split, path),
                                torch.distributed.ReduceOp.MAX)
                return _dequant_mean(*_quantize(g, amax), g)

            return (_pod_mean_exact(loss.detach()),
                    tree_map_with_path(one, grads))

    return wrapped
