"""The decoder: parameters, training forward and loss, decode cache,
prefill, decode step, for every LM family of the registry.

The counterpart of ``repro.models.decoder``: the dense GQA transformer
(``block_kind="attn"``, with the parallel attention + MLP block or MoE in
place of the MLP), Mamba1 (``"mamba1"``), Mamba2 (``"mamba2"``), the
Zamba2 hybrid (``shared_attn_every``: groups of Mamba2 layers, each
followed by one shared attention + MLP block, then the tail) and the
patch frontend. Parameters are a nested dict of tensors with the
reference's keys and layouts, the layers stacked along a leading L dim; a
Python loop over layers stands in for ``lax.scan``. Prefill and the
training forward run the ``flash_attention`` kernel once per attention
layer (the hybrid's: once per shared block) or ``mamba_scan`` once per
Mamba1 layer, and the training backward their backward kernels. The
vocabulary is padded to a multiple of 2048, as in the reference.

Under a mesh (``repro_torch.dist``) the parameters are this rank's
blocks by ``param_sharding_rules``. Under the tp layout the layers
compute on their ``model`` blocks (``dist.TensorParallel``): the vocab
rows of the embedding, the heads, ``d_ff`` and ``d_inner`` channels of
the blocks, and the loss's logits by vocab with the vocab-parallel
cross-entropy; nothing is gathered over ``model``. Under the fsdp layout
(the model axis a batch axis) each layer gathers its blocks at use.
Serving under a mesh takes the global batch, each rank its rows over
pod×data, and keeps the decode cache as ``cache_sharding_rules`` lays it
out: under tp the KV caches' sequence split over ``model``
(flash-decode), the SSM states' channels too; under fsdp, where a bare
``model`` entry drops, the cache whole but for its rows, which a model
group's ranks compute alike. Both entries return whole logits.
"""
from __future__ import annotations

import dataclasses
import functools
import math

import torch
import torch.utils.checkpoint as ckpt

from repro_torch import dist, utils
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models.config import ModelConfig, dtype

VOCAB_PAD = L.VOCAB_PAD


def padded_vocab(cfg: ModelConfig) -> int:
    return utils.round_up(cfg.vocab_size, VOCAB_PAD)


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------


def _attn_shapes(cfg: ModelConfig) -> dict:
    d, hd, hq, hkv = cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv_heads
    return {"ln": (d,), "wq": (d, hq, hd), "wk": (d, hkv, hd),
            "wv": (d, hkv, hd), "wo": (hq, hd, d)}


def _mlp_shapes(d: int, f: int) -> dict:
    return {"ln": (d,), "wg": (d, f), "wu": (d, f), "wd": (f, d)}


def _layer_param_shapes(cfg: ModelConfig) -> dict:
    """Per-layer parameter shapes (without the leading L stack dim)."""
    d, hd, hq, hkv = cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv_heads
    if cfg.block_kind == "attn":
        attn = _attn_shapes(cfg)
        if cfg.qkv_bias:
            attn.update({"bq": (hq, hd), "bk": (hkv, hd), "bv": (hkv, hd)})
        if not cfg.is_moe:
            return {"attn": attn, "mlp": _mlp_shapes(d, cfg.d_ff)}
        e, f = cfg.n_experts, cfg.expert_ff
        moe = {"ln": (d,), "router": (d, e), "wg": (e, d, f),
               "wu": (e, d, f), "wd": (e, f, d)}
        if cfg.n_shared_experts:
            sf = cfg.n_shared_experts * f
            moe.update({"swg": (d, sf), "swu": (d, sf), "swd": (sf, d)})
        return {"attn": attn, "moe": moe}
    di, n = cfg.d_inner, cfg.ssm_state
    if cfg.block_kind == "mamba1":
        r = cfg.dt_rank
        return {"ssm": {"ln": (d,), "in_proj": (d, 2 * di),
                        "conv_w": (cfg.ssm_conv, di), "conv_b": (di,),
                        "x_proj": (di, r + 2 * n), "dt_w": (r, di),
                        "dt_bias": (di,), "a_log": (di, n), "d_skip": (di,),
                        "out_proj": (di, d)}}
    if cfg.block_kind == "mamba2":
        hh, conv_dim = cfg.ssm_heads, di + 2 * n
        return {"ssm": {"ln": (d,), "in_proj": (d, 2 * di + 2 * n + hh),
                        "conv_w": (cfg.ssm_conv, conv_dim),
                        "conv_b": (conv_dim,), "dt_bias": (hh,),
                        "a_log": (hh,), "d_skip": (hh,), "out_ln": (di,),
                        "out_proj": (di, d)}}
    raise ValueError(cfg.block_kind)


def param_shapes(cfg: ModelConfig) -> dict:
    """Full parameter tree as shape tuples (stacked layer dim first); the
    hybrid adds ``shared_attn`` (and ``shared_mlp`` where d_ff > 0), the
    patch frontend ``patch_proj`` (d, d)."""
    v, d = padded_vocab(cfg), cfg.d_model
    layers = {blk: {k: (cfg.n_layers, *shp) for k, shp in leaves.items()}
              for blk, leaves in _layer_param_shapes(cfg).items()}
    tree = {"embed": (v, d), "final_ln": (d,), "lm_head": (d, v),
            "layers": layers}
    if cfg.shared_attn_every:
        tree["shared_attn"] = _attn_shapes(cfg)
        if cfg.d_ff:
            tree["shared_mlp"] = _mlp_shapes(d, cfg.d_ff)
    if cfg.frontend == "patch":
        tree["patch_proj"] = (d, d)
    return tree


def init_params(cfg: ModelConfig, seed: int = 0, device=None) -> dict:
    """Random parameters made on ``device`` (cuda unless named) from a
    seeded ``torch.Generator``, with the reference's distributions: each
    leaf N(0, 1) · min(1/√shape[-2], 0.02) (0.02 for vectors) in
    ``cfg.param_dtype``, drawn leaf by leaf in the reference's order; then
    ``a_log`` = log(1..N) per channel, ``dt_bias`` = −4.6 (softplus⁻¹ of
    0.01) and every norm weight 1. The values differ from the reference's
    (another generator); tests hand both packages the same parameters
    through ``convert.lm_params``."""
    device = utils.resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    params: dict = {}
    for path, shp in utils.tree_leaves(param_shapes(cfg)):
        name = path[-1]
        if name == "a_log":
            vals = torch.log(torch.arange(1, shp[-1] + 1, dtype=torch.float32,
                                          device=device))
            leaf = vals.expand(shp).to(cfg.pdtype)
        elif name == "dt_bias":
            leaf = torch.full(shp, -4.6, dtype=cfg.pdtype, device=device)
        elif name in ("ln", "out_ln", "final_ln"):
            leaf = torch.ones(shp, dtype=cfg.pdtype, device=device)
        else:
            scale = min(1.0 / math.sqrt(shp[-2]) if len(shp) >= 2 else 0.02,
                        0.02)
            leaf = (torch.randn(shp, generator=gen, dtype=torch.float32,
                                device=device) * scale).to(cfg.pdtype)
        node = params
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[name] = leaf.contiguous()
    return params


def param_sharding_rules(cfg: ModelConfig) -> dict:
    """Spec entries per parameter, the same tree as ``param_shapes`` (the
    reference's, entry for entry). Mamba2 keeps its fused in_proj / conv
    replicated (the fused output dim mixes z | x | B | C | dt, whose
    boundaries do not align with the shards); Mamba1's clean 2·d_inner
    split stays tensor-parallel. Under the fsdp layout every
    non-embedding parameter splits its largest dim over pod×data×model;
    the embeddings stay vocab-sharded (the "vocab" alias survives)."""
    m2 = cfg.block_kind == "mamba2"
    fsdp = dist.current_layout() == "fsdp"

    def spec_for(path_names: tuple[str, ...], shp: tuple[int, ...]):
        name = path_names[-1]
        stacked = path_names[0] == "layers"
        lead = (None,) if stacked else ()
        if fsdp and name not in ("embed", "lm_head"):
            dims = shp[1:] if stacked else shp
            if not dims:
                return lead
            big = max(range(len(dims)), key=lambda i: dims[i])
            return lead + tuple(("pod", "data", "model") if i == big
                                else None for i in range(len(dims)))
        nd = len(shp) - len(lead)
        if name == "embed":
            body = ("vocab", ("pod", "data")) if fsdp else ("vocab", None)
        elif name == "lm_head":
            body = (("pod", "data"), "vocab") if fsdp else (None, "vocab")
        elif name in ("wq", "wk", "wv"):
            body = (None, "model", None)
        elif name == "wo":
            body = ("model", None, None)
        elif name in ("bq", "bk", "bv"):
            body = ("model", None)
        elif name in ("wg", "wu"):
            body = ("model", None, None) if nd == 3 else (None, "model")
        elif name == "wd":
            body = ("model", None, None) if nd == 3 else ("model", None)
        elif name in ("swg", "swu"):
            body = (None, "model")
        elif name == "swd":
            body = ("model", None)
        elif name in ("in_proj", "conv_w"):
            body = (None, None) if m2 else (None, "model")
        elif name == "out_proj":
            body = ("model", None)
        elif name in ("conv_b", "d_skip", "dt_bias"):
            body = (None,) if m2 else ("model",)
        elif name == "x_proj":
            body = ("model", None)
        elif name == "dt_w":
            body = (None, "model")
        elif name == "a_log":
            body = ("model", None) if nd == 2 else (None,)
        else:
            body = (None,) * nd
        full = lead + body
        full = full + (None,) * (len(shp) - len(full))
        return full[: len(shp)]

    def walk(path, node):
        if isinstance(node, tuple):
            return spec_for(path, node)
        return {k: walk(path + (k,), v) for k, v in node.items()}

    return walk((), param_shapes(cfg))


def param_plans(cfg: ModelConfig) -> dict | None:
    """Under a mesh, each parameter's ``dist.Plan``: what is gathered of
    its stored block at use (None for a leaf nothing of which is
    gathered). Under the tp layout the layers compute on the ``model``
    blocks, so a leaf split only over ``model`` is not gathered, and the
    routed experts under expert parallelism stay local; the routed
    experts without it are gathered whole (each rank routes to every
    expert), and so is every leaf under fsdp. None without a mesh."""
    if dist.current_mesh() is None:
        return None
    tp = dist.tensor_parallel().mesh is not None
    keep = tp and L.expert_parallel(cfg)

    def walk(path, shapes, rules):
        if isinstance(shapes, tuple):
            routed = path[-2:-1] == ("moe",) and path[-1] in (
                "wg", "wu", "wd")
            if keep and routed:
                return None
            return dist.plan(shapes, rules, blocks=tp and not routed)
        return {k: walk(path + (k,), shapes[k], rules[k]) for k in shapes}

    return walk((), param_shapes(cfg), param_sharding_rules(cfg))


def partial_grad_leaves(cfg: ModelConfig) -> dict | None:
    """Under the tp layout with ``model`` > 1, True for each parameter
    stored whole though its rule splits a dim over ``model`` (a dim the
    axis does not divide, as 5 heads on 4 ranks): the layers cut it to
    the rank's part (``TensorParallel.part``), so the backward gives each
    rank the gradient of its part only, and the train step sums it over
    ``model`` (``train.loop.reduce_gradients``). The routed experts
    without expert parallelism are used whole by every rank (False).
    None without tensor parallelism."""
    if dist.tensor_parallel().size == 1:
        return None

    def walk(path, shapes, rules):
        if isinstance(shapes, tuple):
            routed = path[-2:-1] == ("moe",) and path[-1] in (
                "wg", "wu", "wd")
            named = {"model", "vocab"} & set(dist.spec_axes(rules))
            return bool(named) and not routed and "model" not in \
                dist.spec_axes(dist.sanitize_spec(shapes, rules))
        return {k: walk(path + (k,), shapes[k], rules[k]) for k in shapes}

    return walk((), param_shapes(cfg), param_sharding_rules(cfg))


def _layer_plans(plans: dict) -> dict:
    """The stacked layers' plans for one layer: the leading L entry
    (never split) dropped."""
    return {k: _layer_plans(v) if isinstance(v, dict) else None if v is None
            else dataclasses.replace(v, shape=v.shape[1:], spec=v.spec[1:])
            for k, v in plans.items()}


def place_params(params: dict, cfg: ModelConfig) -> dict:
    """This rank's blocks of a whole parameter tree under the current
    mesh, by ``param_sharding_rules`` (sanitized): the layout ``forward``
    reads. The tree itself without a mesh."""
    if dist.current_mesh() is None:
        return params
    rules = param_sharding_rules(cfg)
    return utils.tree_map_with_path(
        lambda path, x: dist.shard(x, *utils.tree_get(rules, path)), params)


def gather_params(params: dict, cfg: ModelConfig) -> dict:
    """``place_params``'s inverse: whole tensors on every rank."""
    if dist.current_mesh() is None:
        return params
    rules, shapes = param_sharding_rules(cfg), param_shapes(cfg)

    def one(path, x):
        shape = utils.tree_get(shapes, path)
        spec = dist.sanitize_spec(shape, utils.tree_get(rules, path))
        return dist.gather(x, spec, shape)

    return utils.tree_map_with_path(one, params)


def _layer(tree: dict, i: int) -> dict:
    """Layer ``i``'s parameters: every stacked leaf indexed at i (views)."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


# ---------------------------------------------------------------------------
# forward (training / scoring)
# ---------------------------------------------------------------------------

# the products "block_dots" keeps (the reference's
# dots_with_no_batch_dims_saveable: the matmuls of the projections)
_DOT_OPS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
            torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return (ckpt.CheckpointPolicy.MUST_SAVE if op in _DOT_OPS
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def _groups(cfg: ModelConfig) -> list[tuple[int, int, bool]]:
    """The stack as (first layer, end, shared block after it) runs: one
    run of every layer, or for the hybrid ``n_layers // k`` groups of k
    layers, each followed by the shared attention + MLP block, then the
    tail of ``n_layers % k`` layers without one."""
    k = cfg.shared_attn_every
    if not k:
        return [(0, cfg.n_layers, False)]
    n_groups = cfg.n_layers // k
    runs = [(g * k, (g + 1) * k, True) for g in range(n_groups)]
    if cfg.n_layers % k:
        runs.append((n_groups * k, cfg.n_layers, False))
    return runs


def _ffn(lp: dict, x: torch.Tensor, cfg: ModelConfig):
    """The block after an attention layer's attention: MoE → (x, aux) or
    the SwiGLU MLP → (x, None)."""
    if cfg.is_moe:
        return L.moe_block(lp["moe"], x, cfg)
    return L.mlp_block(lp["mlp"], x, cfg), None


def _parallel(cfg: ModelConfig) -> bool:
    return cfg.parallel_block and not cfg.is_moe


def _block_body(cfg: ModelConfig, plans: dict | None = None):
    """One layer as a function of (x, layer params) → (x, MoE aux or
    None), wrapped as ``cfg.remat`` asks: "block" recomputes the whole
    layer in backward (``torch.utils.checkpoint``, non-reentrant),
    "block_dots" recomputes it but keeps the matmul outputs (selective
    checkpointing), "none" keeps every activation. The three give the
    same loss and gradients. With ``plans`` (under a mesh) the body
    gathers what the plans gather of the layer's blocks first; the
    checkpointed body runs in the caller's context
    (``dist.bind_context``) also when it recomputes, and so does every
    collective inside it, on every rank in the same order."""
    def body(x, lp):
        lp = dist.gather_tree(lp, plans)
        pos = torch.arange(x.shape[1], device=x.device)
        if cfg.block_kind == "mamba1":
            return S.mamba1_block(lp["ssm"], x, cfg), None
        if cfg.block_kind == "mamba2":
            return S.mamba2_block(lp["ssm"], x, cfg), None
        if _parallel(cfg):
            return L.parallel_attn_mlp_block(lp["attn"], lp["mlp"], x, cfg,
                                             pos), None
        return _ffn(lp, L.attention_block(lp["attn"], x, cfg, pos), cfg)

    if cfg.remat == "none":
        return body
    kw = {} if cfg.remat == "block" else {
        "context_fn": functools.partial(
            ckpt.create_selective_checkpoint_contexts, _dots_policy)}
    return lambda x, lp: ckpt.checkpoint(dist.bind_context(body), x, lp,
                                         use_reentrant=False, **kw)


def _unstack(tree: dict, n: int) -> list[dict]:
    """The stacked layer tree as n per-layer trees of views. One
    ``unbind`` per leaf, so the backward stacks each leaf's layer
    gradients once (indexing each layer would scatter a full-size zero
    gradient per layer)."""
    out = [dict() for _ in range(n)]
    for k, v in tree.items():
        parts = _unstack(v, n) if isinstance(v, dict) else v.unbind(0)
        for i in range(n):
            out[i][k] = parts[i]
    return out


def _embed_inputs(params: dict, batch: dict,
                  cfg: ModelConfig) -> torch.Tensor:
    """Token embeddings; with the patch frontend and ``patch_embeds`` (B,
    P, D) in the batch, their projection takes the first P positions and
    the last P token embeddings fall off the end, as in the reference."""
    x = L.embed_tokens(params["embed"], batch["tokens"], cfg)
    if cfg.frontend == "patch" and "patch_embeds" in batch:
        pe = torch.einsum("bpd,de->bpe", batch["patch_embeds"].to(cfg.cdtype),
                          params["patch_proj"].to(cfg.cdtype))
        x = torch.cat([pe, x[:, : x.shape[1] - pe.shape[1]]], dim=1)
    return x


def _shared_block(params: dict, x: torch.Tensor, cfg: ModelConfig,
                  pos: torch.Tensor, return_kv: bool = False):
    """The hybrid's shared attention (+ MLP) block, prefill / training →
    x, or with ``return_kv`` (prefill) (x, (k, v))."""
    x = L.attention_block(params["shared_attn"], x, cfg, pos,
                          return_kv=return_kv)
    if return_kv:
        x, kv = x
    if "shared_mlp" in params:
        x = L.mlp_block(params["shared_mlp"], x, cfg)
    return (x, kv) if return_kv else x


def forward(params: dict, batch: dict, cfg: ModelConfig,
            impl: str = "masked") -> tuple[torch.Tensor, torch.Tensor]:
    """→ (final hidden states (B, S, D), MoE aux loss 0-d fp32: the sum of
    every MoE layer's, 0 for the other families). ``batch`` holds
    ``tokens`` and, for the patch frontend, optionally ``patch_embeds``.
    ``impl`` ("masked" / "triangular", the reference's attention variants)
    is accepted and changes nothing: the ``flash_attention`` kernel
    computes the same function for both. Runs where the parameters lie;
    differentiable (the kernels' backward kernels on the card, autograd
    through the plain versions on the CPU).

    Under a mesh the parameters are this rank's blocks, stored by
    ``param_sharding_rules`` (``place_params``), and ``batch`` is this
    rank's rows. Under the tp layout each layer computes on its blocks
    (its heads, ``d_ff`` or ``d_inner`` channels, the embedding's vocab
    rows); under fsdp each layer gathers its blocks inside its
    checkpointed body (so remat gathers again in the backward), the
    other leaves at use. The MoE experts stay local under expert
    parallelism."""
    plans = param_plans(cfg)
    params = _gather_top(params, plans, skip=("layers", "lm_head"))
    x = _embed_inputs(params, batch, cfg)
    body = _block_body(cfg, None if plans is None else
                       _layer_plans(plans["layers"]))
    layers = _unstack(params["layers"], cfg.n_layers)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for lo, hi, shared in _groups(cfg):
        for lp in layers[lo:hi]:
            x, a = body(x, lp)
            if a is not None:
                aux = aux + a
        if shared:
            x = _shared_block(params, x, cfg,
                              torch.arange(x.shape[1], device=x.device))
    x = L.rms_norm(x, params["final_ln"], cfg.rms_eps)
    return x, aux


def _gather_top(params: dict, plans: dict | None,
                skip=("layers",)) -> dict:
    """The leaves outside the layer stack (and ``skip``) as the plans
    gather them (the layers gather inside their bodies)."""
    if plans is None:
        return params
    top = {k: v for k, v in params.items() if k not in skip}
    return dict(params, **dist.gather_tree(top, plans))


def _chunk_loss(h: torch.Tensor, y: torch.Tensor, m: torch.Tensor,
                w_out: torch.Tensor, tp: dist.TensorParallel,
                lo: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Masked next-token NLL of one sequence chunk: (sum, mask sum). The
    (B, sc, V) logits are fp32; in bf16 the product is rounded to bf16
    before the cast (as ``_logits`` does in serving), where the reference
    accumulates to fp32 output. Under the tp layout ``w_out`` is this
    rank's vocab block from ``lo``, and the NLL the vocab-parallel
    cross-entropy of the (B, sc, V/M) block of logits; at one rank it is
    ``torch.logsumexp``'s arithmetic, bit for bit."""
    logits = torch.matmul(h, w_out).float()
    nll = tp.cross_entropy(logits, y, lo) * m
    return nll.sum(), m.sum()


def lm_loss(params: dict, batch: dict, cfg: ModelConfig,
            impl: str = "masked") -> tuple[torch.Tensor, dict]:
    """Next-token CE in sequence chunks of ``cfg.loss_seq_chunk``, each
    checkpointed so its logits are recomputed in backward and the full
    (B, S, V) logits never exist. As in the reference, the tokens past the
    last whole chunk (S mod chunk) do not count. The loss adds
    ``router_aux_coef`` × the MoE aux loss (0 for the other families). →
    (loss, {"ce", "aux", "tokens"}).

    Under a mesh (this rank's rows, parameters stored by the rules) the
    loss is the reference's global one: the masked sum over every rank's
    tokens over their global count (one scalar all_reduce of the count
    over the live batch axes), the same value on every rank. Its backward
    gives this rank's own part of the gradient (``dist.sum_forward``),
    which the train step sums over the batch axes. Under the tp layout
    each chunk's logits are this rank's (B, sc, V/M) vocab block, from
    its block of ``lm_head``, and the cross-entropy combines the ranks'
    blocks (``TensorParallel.cross_entropy``); under fsdp ``lm_head`` is
    gathered whole."""
    hidden, aux = forward(params, batch, cfg, impl=impl)
    s = hidden.shape[1]
    labels = batch["labels"]
    mask = batch.get("loss_mask")
    if mask is None:
        mask = torch.ones(labels.shape, dtype=torch.float32,
                          device=labels.device)
    plans = param_plans(cfg)
    tp = dist.tensor_parallel()
    v = padded_vocab(cfg)
    w_out = dist.gather_param(params["lm_head"], plans and plans["lm_head"])
    if tp.mesh is not None:
        hidden = tp.sum_grad(hidden)
        w_out = tp.part(w_out, 1, v)
    w_out = w_out.to(cfg.cdtype)
    chunk = dist.bind_context(functools.partial(_chunk_loss, tp=tp,
                                                lo=tp.block(v)[0]))
    sc = min(cfg.loss_seq_chunk, s)
    totals = torch.zeros((), dtype=torch.float32, device=hidden.device)
    counts = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(s // sc):
        cut = slice(i * sc, (i + 1) * sc)
        t, c = ckpt.checkpoint(chunk, hidden[:, cut], labels[:, cut],
                               mask[:, cut], w_out, use_reentrant=False)
        totals, counts = totals + t, counts + c
    if plans is not None:
        axes = dist.live_batch_axes()
        counts = dist.all_reduce(counts.detach().clone(), axes)
        loss = dist.sum_forward(totals / torch.clamp(counts, min=1.0), axes)
    else:
        loss = totals / torch.clamp(counts, min=1.0)
    total = loss + cfg.router_aux_coef * aux
    return total, {"ce": loss, "aux": aux, "tokens": counts}


# ---------------------------------------------------------------------------
# serving: prefill + decode
# ---------------------------------------------------------------------------


# the caches with a sequence dim (dim 2): (L or groups, B, S, Hkv, hd)
SEQ_CACHES = ("k", "v", "sa_k", "sa_v")


def _cache_shapes(cfg: ModelConfig, batch_size: int, max_len: int
                  ) -> dict:
    """Each decode-cache leaf's global (shape, dtype)."""
    kvdt = dtype(cfg.cache_dtype)
    ldim, b = cfg.n_layers, batch_size
    out = {"pos": ((b,), torch.int32)}
    kv = ((ldim, b, max_len, cfg.n_kv_heads, cfg.hd), kvdt)
    di, n = cfg.d_inner, cfg.ssm_state
    if cfg.block_kind == "attn":
        out["k"] = out["v"] = kv
    elif cfg.block_kind == "mamba1":
        out["conv"] = ((ldim, b, cfg.ssm_conv - 1, di), kvdt)
        out["ssm"] = ((ldim, b, di, n), torch.float32)
    else:
        out["conv"] = ((ldim, b, cfg.ssm_conv - 1, di + 2 * n), kvdt)
        out["ssm"] = ((ldim, b, cfg.ssm_heads, cfg.ssm_head_dim, n),
                      torch.float32)
    if cfg.shared_attn_every:
        groups = cfg.n_layers // cfg.shared_attn_every
        out["sa_k"] = out["sa_v"] = ((groups, *kv[0][1:]), kvdt)
    return out


def cache_specs(cfg: ModelConfig, batch_size: int, max_len: int
                ) -> dict | None:
    """Each cache leaf's sanitized ``cache_sharding_rules`` spec on the
    current mesh (None without one), as ``sanitize_spec`` takes the
    layout and ``allow_uneven_sharding``: under fsdp the bare ``model``
    entries drop (the sequence and the SSM channels stay whole); with
    the flag a dim the axes do not divide (but at least their size) is
    split too, rank k's block ``dist.block_range``'s k-th of ⌈dim /
    ranks⌉, the last ones short or empty."""
    if dist.current_mesh() is None:
        return None
    rules = cache_sharding_rules(cfg)
    return {k: dist.sanitize_spec(shp, rules[k])
            for k, (shp, _) in _cache_shapes(cfg, batch_size,
                                             max_len).items()}


def init_cache(cfg: ModelConfig, batch_size: int, max_len: int,
               device=None) -> dict:
    """Decode cache: ``pos`` (B,) int32; attention: k / v (L, B, S, Hkv,
    hd); Mamba1: conv (L, B, d_conv − 1, Di) in the cache dtype and ssm
    (L, B, Di, N) fp32; Mamba2: conv (L, B, d_conv − 1, Di + 2N) and ssm
    (L, B, H, P, N) fp32; the hybrid also sa_k / sa_v (n_layers //
    shared_attn_every, B, S, Hkv, hd). Zeros, on ``device`` (cuda unless
    named). Under a mesh this rank's blocks of them (``cache_specs``);
    ``pos`` stays whole, as its rule says."""
    device = utils.resolve_device(device)
    specs = cache_specs(cfg, batch_size, max_len)
    cache = {k: torch.zeros(shp if specs is None else
                            dist.block_shape(shp, specs[k]), dtype=dt,
                            device=device)
             for k, (shp, dt) in _cache_shapes(cfg, batch_size,
                                               max_len).items()}
    return cache if specs is None else _record_len(cache, max_len)


def place_cache(cache: dict, cfg: ModelConfig) -> dict:
    """This rank's blocks of a whole decode cache under the current mesh
    (``cache_specs``); the cache itself without a mesh."""
    if dist.current_mesh() is None:
        return cache
    seq = [cache[k].shape[2] for k in SEQ_CACHES if k in cache]
    max_len = seq[0] if seq else 0
    specs = cache_specs(cfg, cache["pos"].shape[0], max_len)
    return _record_len({k: dist.local_block(x, specs[k])
                        for k, x in cache.items()}, max_len)


def gather_cache(cache: dict, cfg: ModelConfig) -> dict:
    """``place_cache``'s inverse: whole tensors on every rank."""
    if dist.current_mesh() is None:
        return cache
    b = cache["pos"].shape[0]
    max_len = _cache_len(cache)
    specs = cache_specs(cfg, b, max_len)
    shapes = _cache_shapes(cfg, b, max_len)
    return {k: dist.gather(x, specs[k], shapes[k][0])
            for k, x in cache.items()}


def cache_sharding_rules(cfg: ModelConfig) -> dict:
    """Spec entries of the decode cache (the reference's): batch over
    pod×data, the KV caches' sequence dim over model (flash-decode), the
    SSM states' channel dim over model."""
    rules: dict = {"pos": (None,)}
    if cfg.block_kind == "attn":
        rules["k"] = (None, ("pod", "data"), "model", None, None)
        rules["v"] = (None, ("pod", "data"), "model", None, None)
    elif cfg.block_kind == "mamba1":
        rules["conv"] = (None, ("pod", "data"), None, "model")
        rules["ssm"] = (None, ("pod", "data"), "model", None)
    else:
        rules["conv"] = (None, ("pod", "data"), None, "model")
        rules["ssm"] = (None, ("pod", "data"), "model", None, None)
    if cfg.shared_attn_every:
        rules["sa_k"] = (None, ("pod", "data"), "model", None, None)
        rules["sa_v"] = (None, ("pod", "data"), "model", None, None)
    return rules


def _logits(x: torch.Tensor, lm_head: torch.Tensor,
            cfg: ModelConfig) -> torch.Tensor:
    """fp32 logits. In bf16 the product is rounded to bf16 before the
    cast, where the reference asks for fp32 output: converting the (d, V)
    head to fp32 on every step would cost more than the step. Under the
    tp layout the rank's vocab block of them, gathered whole."""
    tp = dist.tensor_parallel()
    v = padded_vocab(cfg)
    out = torch.matmul(x, tp.part(lm_head, 1, v).to(cfg.cdtype)).float()
    return tp.gather(out, -1, v) if tp.mesh is not None else out


class _Serving:
    """One serving call's layout under a mesh: the rows of the global
    batch this rank takes (the cache rules' pod×data entry), the cache's
    specs, the plans of the parameters it gathers, the model axis.

    Under the tp layout the model axis is compute: the layers work on
    the rank's heads and channels, the KV caches' sequence and the SSM
    states' channels are the rank's blocks. Under the fsdp layout the
    reference's serving computes the same function with the model axis
    a batch axis: every parameter is gathered whole at use by
    ``param_plans`` (each layer's blocks as the layer runs; ``lm_head``
    whole too, so each rank computes whole logits for its rows where the
    reference splits them by vocab: the same values), and the cache
    rules' bare ``model`` entries drop, so the cache's rows go over
    pod×data and its sequence and SSM channels stay whole. The ranks of
    one model group then hold the same rows, and each computes them:
    the group's work is redundant but for the routed experts under
    expert parallelism (a model axis that divides ``n_experts``), which
    the group's ranks divide and sum with one all_reduce. A call runs
    inside ``dist.replicated_rows(("model",))`` there (``rows_ctx``).

    Under ``allow_uneven_sharding`` the rows and the cache take the
    flag as ``sanitize_spec`` does: blocks of ⌈dim / ranks⌉ from
    ``dist.block_range``, the last ones short or empty."""

    def __init__(self, cfg: ModelConfig, b: int, max_len: int):
        self.mesh = dist.current_mesh()
        self.b = b
        self.max_len = max_len
        self.uniform = cfg.uniform_decode_pos
        self.specs = cache_specs(cfg, b, max_len)
        self.plans = param_plans(cfg)
        self.tp = dist.tensor_parallel()
        rows = dist.sanitize_spec((b,), (("pod", "data"),))
        self.rows = rows[0] if rows else None

    def rows_ctx(self):
        """The context a call runs in: under fsdp the model ranks hold
        the same rows (``dist.replicated_rows``)."""
        fsdp = self.mesh is not None and dist.current_layout() == "fsdp"
        return dist.replicated_rows(("model",) if fsdp else ())

    def take(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a global (B, ...) input."""
        if self.rows is None:
            return x
        lo, hi = dist.block_range(self.b, self.mesh.size(self.rows),
                                  self.mesh.coord(self.rows))
        return x[lo:hi]

    def join(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's rows of a (B_rank, ...) output, whole."""
        if self.rows is None:
            return x
        return dist.all_gather_dim(x, 0, self.rows, self.b)

    def layer(self, params: dict, i: int) -> dict:
        lp = _layer(params["layers"], i)
        if self.plans is None:
            return lp
        return dist.gather_tree(lp, _layer_plans(self.plans["layers"]))

    def write_pos(self, cache: dict, pos: torch.Tensor) -> torch.Tensor:
        """The positions ``write_kv`` takes: in the uniform mode the
        global batch's (every row writes at its first), else the rank's
        rows'."""
        return cache["pos"] if self.uniform else pos

    def seq_range(self, name: str) -> tuple[int, int] | None:
        """(first position, the sequence's length) of this rank's block
        of the cache leaf's sequence dim; None where it is whole."""
        e = None if self.specs is None else self.specs[name][2]
        if e is None:
            return None
        lo, _ = dist.block_range(self.max_len, self.mesh.size(e),
                                 self.mesh.coord(e))
        return lo, self.max_len

    def seq_block(self, name: str, kv: torch.Tensor) -> torch.Tensor:
        """This rank's block of the sequence of a (B, S, ...) prefill
        k / v, by the cache leaf's spec."""
        e = None if self.specs is None else self.specs[name][2]
        if e is None:
            return kv
        lo, hi = dist.block_range(kv.shape[1], self.mesh.size(e),
                                  self.mesh.coord(e))
        return kv[:, lo:hi]

    def state_in(self, name: str, c: torch.Tensor, dim: int, n: int,
                 whole: bool) -> torch.Tensor:
        """A layer's SSM state as the block computes on it: whole
        (``whole``: Mamba2) or the rank's channels (Mamba1), from the
        cache leaf's layout."""
        split = self.specs is not None and \
            self.specs[name][dim + 1] is not None
        if whole:
            return self.tp.gather(c, dim, n) if split else c
        if split or self.tp.size == 1:
            return c
        lo, hi = self.tp.block(n)
        return c.narrow(dim, lo, hi - lo)

    def state_out(self, name: str, c: torch.Tensor, dim: int, n: int,
                  whole: bool) -> torch.Tensor:
        """``state_in``'s inverse: the block's new state in the cache
        leaf's layout."""
        split = self.specs is not None and \
            self.specs[name][dim + 1] is not None
        if whole:
            if not split:
                return c
            lo, hi = self.tp.block(n)
            return c.narrow(dim, lo, hi - lo)
        if split or self.tp.size == 1:
            return c
        return self.tp.gather(c, dim, n)


# the dim of each SSM state (per layer: (B, ...)) that the model axis
# splits, and its size
def _state_dims(cfg: ModelConfig) -> dict:
    if cfg.block_kind == "mamba1":
        return {"conv": (2, cfg.d_inner), "ssm": (1, cfg.d_inner)}
    return {"conv": (2, cfg.d_inner + 2 * cfg.ssm_state),
            "ssm": (1, cfg.ssm_heads)}


def _prefill_layer(lp: dict, x: torch.Tensor, cfg: ModelConfig,
                   pos: torch.Tensor, cache: dict, i: int,
                   sv: _Serving) -> torch.Tensor:
    """Layer ``i`` of the prefill; writes its cache entries (under a
    mesh, this rank's blocks of them)."""
    if cfg.block_kind == "attn":
        if _parallel(cfg):
            x, (k, v) = L.parallel_attn_mlp_block(lp["attn"], lp["mlp"], x,
                                                  cfg, pos, return_kv=True)
        else:
            x, (k, v) = L.attention_block(lp["attn"], x, cfg, pos,
                                          return_kv=True)
            x, _ = _ffn(lp, x, cfg)       # decode drops the MoE aux
        cache["k"][i] = sv.seq_block("k", k)
        cache["v"][i] = sv.seq_block("v", v)
        return x
    block = S.mamba1_block if cfg.block_kind == "mamba1" else S.mamba2_block
    x, st = block(lp["ssm"], x, cfg, return_state=True)
    for name, (dim, n) in _state_dims(cfg).items():
        cache[name][i] = sv.state_out(name, st[name], dim, n,
                                      cfg.block_kind == "mamba2")
    return x


def prefill(params: dict, batch: dict, cfg: ModelConfig
            ) -> tuple[torch.Tensor, dict]:
    """Prefill: forward pass over ``batch["tokens"]`` (B, S) (and the
    patch frontend's ``patch_embeds`` where given) that also builds the
    decode cache → (last-position logits (B, V) fp32, cache with pos =
    S). Runs where the parameters lie.

    Under a mesh ``batch`` is the global batch and the parameters this
    rank's blocks: the rank prefills its rows; its cache is its blocks by
    ``cache_specs`` and the logits are whole (B, V) on every rank. Under
    the tp layout the rank computes its heads and channels, and its cache
    holds the prompt's k / v of every kv head over its block of the
    sequence; under fsdp it gathers each layer whole and its cache holds
    its rows whole (``_Serving``)."""
    tokens = batch["tokens"]
    sv = _Serving(cfg, *tokens.shape)
    with sv.rows_ctx():
        return _prefill(params, batch, cfg, sv)


def _prefill(params: dict, batch: dict, cfg: ModelConfig,
             sv: _Serving) -> tuple[torch.Tensor, dict]:
    tokens = batch["tokens"]
    b, s = tokens.shape
    params = _gather_top(params, sv.plans)
    local = {k: sv.take(v) for k, v in batch.items()}
    x = _embed_inputs(params, local, cfg)
    pos = torch.arange(s, device=tokens.device)
    cache = init_cache(cfg, b, s, tokens.device)
    g = 0
    for lo, hi, shared in _groups(cfg):
        for i in range(lo, hi):
            x = _prefill_layer(sv.layer(params, i), x, cfg, pos, cache, i,
                               sv)
        if shared:
            x, (k, v) = _shared_block(params, x, cfg, pos, return_kv=True)
            cache["sa_k"][g] = sv.seq_block("sa_k", k)
            cache["sa_v"][g] = sv.seq_block("sa_v", v)
            g += 1
    x = L.rms_norm(x, params["final_ln"], cfg.rms_eps)
    cache["pos"].fill_(s)
    return sv.join(_logits(x[:, -1], params["lm_head"], cfg)), cache


def _decode_layer(lp: dict, x: torch.Tensor, cfg: ModelConfig,
                  pos: torch.Tensor, cache: dict, i: int,
                  sv: _Serving) -> torch.Tensor:
    """Layer ``i`` of a decode step; updates its cache entries in place.
    ``pos``: the rank's rows' positions; the uniform mode writes at the
    global batch's first one (``cache["pos"]``)."""
    if cfg.block_kind == "attn":
        kv = {"k": cache["k"][i], "v": cache["v"][i]}
        seq = sv.seq_range("k")
        if _parallel(cfg):
            x, _ = L.parallel_attn_mlp_block(lp["attn"], lp["mlp"], x, cfg,
                                             None, cache=kv, pos=pos,
                                             seq=seq,
                                             write_pos=sv.write_pos(cache,
                                                                    pos))
            return x
        x, _ = L.attention_block_decode(lp["attn"], x, kv, pos, cfg, seq,
                                        sv.write_pos(cache, pos))
        return _ffn(lp, x, cfg)[0]       # the MoE aux is dropped
    step = S.mamba1_decode if cfg.block_kind == "mamba1" else S.mamba2_decode
    whole = cfg.block_kind == "mamba2"
    dims = _state_dims(cfg)
    x, new = step(lp["ssm"], x, {
        name: sv.state_in(name, cache[name][i], dim, n, whole)
        for name, (dim, n) in dims.items()}, cfg)
    for name, (dim, n) in dims.items():
        cache[name][i] = sv.state_out(name, new[name], dim, n, whole)
    return x


def decode_step(params: dict, cache: dict, tokens: torch.Tensor,
                cfg: ModelConfig) -> tuple[torch.Tensor, dict]:
    """One decode step. tokens: (B, 1) → (logits (B, V) fp32, cache with
    pos + 1). The cache's tensors are updated in place (the reference
    returns new arrays): the returned dict shares them.

    Under a mesh ``tokens`` and ``pos`` are the global batch's, the
    cache this rank's blocks (``init_cache`` / ``place_cache``): the
    rank steps its rows, and the logits are whole (B, V) on every rank.
    Under the tp layout attention is the flash-decode over the rank's
    block of the sequence with every q head; under fsdp each layer is
    gathered whole and attends over the rank's rows' whole cache."""
    sv = _Serving(cfg, tokens.shape[0], _cache_len(cache))
    with sv.rows_ctx():
        return _decode_step(params, cache, tokens, cfg, sv)


def _decode_step(params: dict, cache: dict, tokens: torch.Tensor,
                 cfg: ModelConfig, sv: _Serving
                 ) -> tuple[torch.Tensor, dict]:
    params = _gather_top(params, sv.plans)
    pos = sv.take(cache["pos"])
    x = L.embed_tokens(params["embed"], sv.take(tokens), cfg)
    g = 0
    for lo, hi, shared in _groups(cfg):
        for i in range(lo, hi):
            x = _decode_layer(sv.layer(params, i), x, cfg, pos, cache, i,
                              sv)
        if shared:
            x, _ = L.attention_block_decode(
                params["shared_attn"], x,
                {"k": cache["sa_k"][g], "v": cache["sa_v"][g]}, pos, cfg,
                sv.seq_range("sa_k"), sv.write_pos(cache, pos))
            if "shared_mlp" in params:
                x = L.mlp_block(params["shared_mlp"], x, cfg)
            g += 1
    x = L.rms_norm(x, params["final_ln"], cfg.rms_eps)
    logits = sv.join(_logits(x[:, 0], params["lm_head"], cfg))
    return logits, dict(cache, pos=cache["pos"] + 1)


def _cache_len(cache: dict) -> int:
    """The KV caches' global sequence length: their own without a mesh;
    under one, the length ``init_cache`` / ``place_cache`` / ``prefill``
    recorded on them (a block's length alone does not tell a sequence
    split over the model axis from a whole one it does not divide). 0
    without a KV cache."""
    name = next((k for k in SEQ_CACHES if k in cache), None)
    if name is None:
        return 0
    if dist.current_mesh() is None:
        return cache[name].shape[2]
    n = getattr(cache[name], "seq_len", None)
    if n is None:
        raise ValueError("under a mesh the decode cache comes from "
                         "init_cache, place_cache or prefill (its KV "
                         "caches record their global sequence length)")
    return n


def _record_len(cache: dict, max_len: int) -> dict:
    """Records the KV caches' global sequence length on them."""
    for k in SEQ_CACHES:
        if k in cache:
            cache[k].seq_len = max_len
    return cache
