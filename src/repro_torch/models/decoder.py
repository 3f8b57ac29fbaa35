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

VOCAB_PAD = 2048


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
    """Under a mesh, each parameter's ``dist.Plan`` (its global shape and
    sanitized rule; None for a leaf nothing splits, and for the routed
    experts under expert parallelism with the tp layout, which stay
    local); None without a mesh."""
    if dist.current_mesh() is None:
        return None
    keep = L.expert_parallel(cfg) and "model" not in dist.live_batch_axes()

    def walk(path, shapes, rules):
        if isinstance(shapes, tuple):
            if keep and path[-2:-1] == ("moe",) and path[-1] in (
                    "wg", "wu", "wd"):
                return None
            return dist.plan(shapes, rules)
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


def _no_mesh(what: str) -> None:
    if dist.current_mesh() is not None:
        raise NotImplementedError(
            f"{what} under a mesh (the sequence-sharded decode cache of "
            "cache_sharding_rules) is ROADMAP queue 1 item 3, slice B3")


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
    gathers the layer's blocks first; the checkpointed body runs in the
    caller's context (``dist.bind_context``) also when it recomputes."""
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
                  pos: torch.Tensor):
    """The hybrid's shared attention (+ MLP) block, prefill / training →
    (x, (k, v))."""
    x, kv = L.attention_block(params["shared_attn"], x, cfg, pos,
                              return_kv=True)
    if "shared_mlp" in params:
        x = L.mlp_block(params["shared_mlp"], x, cfg)
    return x, kv


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
    rank's rows: each layer gathers its blocks inside its checkpointed
    body (so remat gathers again in the backward), the other leaves at
    use; the MoE experts stay local under expert parallelism."""
    plans = param_plans(cfg)
    if plans is not None:
        top = {k: v for k, v in params.items()
               if k not in ("layers", "lm_head")}
        params = dict(params, **dist.gather_tree(top, plans))
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
            x, _ = _shared_block(params, x, cfg,
                                 torch.arange(x.shape[1], device=x.device))
    x = L.rms_norm(x, params["final_ln"], cfg.rms_eps)
    return x, aux


def _chunk_loss(h: torch.Tensor, y: torch.Tensor, m: torch.Tensor,
                w_out: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Masked next-token NLL of one sequence chunk: (sum, mask sum). The
    (B, sc, V) logits are fp32; in bf16 the product is rounded to bf16
    before the cast (as ``_logits`` does in serving), where the reference
    accumulates to fp32 output."""
    logits = torch.matmul(h, w_out).float()
    lse = torch.logsumexp(logits, dim=-1)
    picked = logits.gather(-1, y[..., None].long())[..., 0]
    nll = (lse - picked) * m
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
    which the train step sums over the batch axes."""
    hidden, aux = forward(params, batch, cfg, impl=impl)
    s = hidden.shape[1]
    labels = batch["labels"]
    mask = batch.get("loss_mask")
    if mask is None:
        mask = torch.ones(labels.shape, dtype=torch.float32,
                          device=labels.device)
    plans = param_plans(cfg)
    w_out = dist.gather_param(params["lm_head"], plans and plans["lm_head"])
    w_out = w_out.to(cfg.cdtype)
    sc = min(cfg.loss_seq_chunk, s)
    totals = torch.zeros((), dtype=torch.float32, device=hidden.device)
    counts = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(s // sc):
        cut = slice(i * sc, (i + 1) * sc)
        t, c = ckpt.checkpoint(_chunk_loss, hidden[:, cut], labels[:, cut],
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


def init_cache(cfg: ModelConfig, batch_size: int, max_len: int,
               device=None) -> dict:
    """Decode cache: ``pos`` (B,) int32; attention: k / v (L, B, S, Hkv,
    hd); Mamba1: conv (L, B, d_conv − 1, Di) in the cache dtype and ssm
    (L, B, Di, N) fp32; Mamba2: conv (L, B, d_conv − 1, Di + 2N) and ssm
    (L, B, H, P, N) fp32; the hybrid also sa_k / sa_v (n_layers //
    shared_attn_every, B, S, Hkv, hd). Zeros, on ``device`` (cuda unless
    named)."""
    device = utils.resolve_device(device)
    kvdt = dtype(cfg.cache_dtype)
    ldim, b = cfg.n_layers, batch_size
    cache = {"pos": torch.zeros((b,), dtype=torch.int32, device=device)}
    kv = (max_len, cfg.n_kv_heads, cfg.hd)
    di, n = cfg.d_inner, cfg.ssm_state
    if cfg.block_kind == "attn":
        cache["k"] = torch.zeros((ldim, b, *kv), dtype=kvdt, device=device)
        cache["v"] = torch.zeros((ldim, b, *kv), dtype=kvdt, device=device)
    elif cfg.block_kind == "mamba1":
        cache["conv"] = torch.zeros((ldim, b, cfg.ssm_conv - 1, di),
                                    dtype=kvdt, device=device)
        cache["ssm"] = torch.zeros((ldim, b, di, n), dtype=torch.float32,
                                   device=device)
    else:
        cache["conv"] = torch.zeros((ldim, b, cfg.ssm_conv - 1, di + 2 * n),
                                    dtype=kvdt, device=device)
        cache["ssm"] = torch.zeros((ldim, b, cfg.ssm_heads,
                                    cfg.ssm_head_dim, n),
                                   dtype=torch.float32, device=device)
    if cfg.shared_attn_every:
        groups = cfg.n_layers // cfg.shared_attn_every
        cache["sa_k"] = torch.zeros((groups, b, *kv), dtype=kvdt,
                                    device=device)
        cache["sa_v"] = torch.zeros((groups, b, *kv), dtype=kvdt,
                                    device=device)
    return cache


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
    head to fp32 on every step would cost more than the step."""
    return torch.matmul(x, lm_head.to(cfg.cdtype)).float()


def _prefill_layer(lp: dict, x: torch.Tensor, cfg: ModelConfig,
                   pos: torch.Tensor, cache: dict, i: int) -> torch.Tensor:
    """Layer ``i`` of the prefill; writes its cache entries."""
    if cfg.block_kind == "attn":
        if _parallel(cfg):
            x, (k, v) = L.parallel_attn_mlp_block(lp["attn"], lp["mlp"], x,
                                                  cfg, pos, return_kv=True)
        else:
            x, (k, v) = L.attention_block(lp["attn"], x, cfg, pos,
                                          return_kv=True)
            x, _ = _ffn(lp, x, cfg)       # decode drops the MoE aux
        cache["k"][i] = k
        cache["v"][i] = v
        return x
    block = S.mamba1_block if cfg.block_kind == "mamba1" else S.mamba2_block
    x, st = block(lp["ssm"], x, cfg, return_state=True)
    cache["conv"][i] = st["conv"]
    cache["ssm"][i] = st["ssm"]
    return x


def prefill(params: dict, batch: dict, cfg: ModelConfig
            ) -> tuple[torch.Tensor, dict]:
    """Prefill: forward pass over ``batch["tokens"]`` (B, S) (and the
    patch frontend's ``patch_embeds`` where given) that also builds the
    decode cache → (last-position logits (B, V) fp32, cache with pos =
    S). Runs where the parameters lie; not under a mesh (the sharded
    decode cache is ROADMAP queue 1 item 3, slice B3)."""
    _no_mesh("prefill")
    tokens = batch["tokens"]
    b, s = tokens.shape
    x = _embed_inputs(params, batch, cfg)
    pos = torch.arange(s, device=tokens.device)
    cache = init_cache(cfg, b, s, tokens.device)
    g = 0
    for lo, hi, shared in _groups(cfg):
        for i in range(lo, hi):
            x = _prefill_layer(_layer(params["layers"], i), x, cfg, pos,
                               cache, i)
        if shared:
            x, (k, v) = _shared_block(params, x, cfg, pos)
            cache["sa_k"][g] = k
            cache["sa_v"][g] = v
            g += 1
    x = L.rms_norm(x, params["final_ln"], cfg.rms_eps)
    cache["pos"].fill_(s)
    return _logits(x[:, -1], params["lm_head"], cfg), cache


def _decode_layer(lp: dict, x: torch.Tensor, cfg: ModelConfig,
                  pos: torch.Tensor, cache: dict, i: int) -> torch.Tensor:
    """Layer ``i`` of a decode step; updates its cache entries in place."""
    if cfg.block_kind == "attn":
        kv = {"k": cache["k"][i], "v": cache["v"][i]}
        if _parallel(cfg):
            x, _ = L.parallel_attn_mlp_block(lp["attn"], lp["mlp"], x, cfg,
                                             None, cache=kv, pos=pos)
            return x
        x, _ = L.attention_block_decode(lp["attn"], x, kv, pos, cfg)
        return _ffn(lp, x, cfg)[0]       # the MoE aux is dropped
    step = S.mamba1_decode if cfg.block_kind == "mamba1" else S.mamba2_decode
    x, new = step(lp["ssm"], x, {"conv": cache["conv"][i],
                                 "ssm": cache["ssm"][i]}, cfg)
    cache["conv"][i] = new["conv"]
    cache["ssm"][i] = new["ssm"]
    return x


def decode_step(params: dict, cache: dict, tokens: torch.Tensor,
                cfg: ModelConfig) -> tuple[torch.Tensor, dict]:
    """One decode step. tokens: (B, 1) → (logits (B, V) fp32, cache with
    pos + 1). The cache's tensors are updated in place (the reference
    returns new arrays): the returned dict shares them. Not under a mesh
    (ROADMAP queue 1 item 3, slice B3)."""
    _no_mesh("decode_step")
    pos = cache["pos"]
    x = L.embed_tokens(params["embed"], tokens, cfg)
    g = 0
    for lo, hi, shared in _groups(cfg):
        for i in range(lo, hi):
            x = _decode_layer(_layer(params["layers"], i), x, cfg, pos,
                              cache, i)
        if shared:
            x, _ = L.attention_block_decode(
                params["shared_attn"], x,
                {"k": cache["sa_k"][g], "v": cache["sa_v"][g]}, pos, cfg)
            if "shared_mlp" in params:
                x = L.mlp_block(params["shared_mlp"], x, cfg)
            g += 1
    x = L.rms_norm(x, params["final_ln"], cfg.rms_eps)
    return _logits(x[:, 0], params["lm_head"], cfg), dict(cache, pos=pos + 1)
