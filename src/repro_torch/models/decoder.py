"""The decoder for serving: parameters, decode cache, prefill, decode step.

The counterpart of ``repro.models.decoder`` for the dense GQA transformer
(``block_kind="attn"``) and Mamba1 (``"mamba1"``). Parameters are a nested
dict of tensors with the reference's keys and layouts, the layers stacked
along a leading L dim; a Python loop over layers stands in for
``lax.scan``. Prefill runs the ``flash_attention`` (attention) or
``mamba_scan`` (Mamba1) kernel once per layer. The vocabulary is padded to
a multiple of 2048, as in the reference. MoE, the parallel attention + MLP
block, Mamba2, the shared-attention hybrid and the patch frontend raise
``NotImplementedError`` (ROADMAP queue 1 item 6), and ``forward`` /
``lm_loss`` belong to the training slice (item 5).
"""
from __future__ import annotations

import math

import torch

from repro_torch import utils
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models.config import ModelConfig, dtype

VOCAB_PAD = 2048


def padded_vocab(cfg: ModelConfig) -> int:
    return utils.round_up(cfg.vocab_size, VOCAB_PAD)


def _check_ported(cfg: ModelConfig) -> None:
    missing = [what for what, on in (
        ("MoE", cfg.is_moe), ("the parallel attention + MLP block",
                              cfg.parallel_block),
        ("mamba2", cfg.block_kind == "mamba2"),
        ("the shared-attention hybrid", cfg.shared_attn_every > 0),
        ("the patch frontend", cfg.frontend == "patch")) if on]
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(missing)} not ported yet (ROADMAP "
            f"queue 1 item 6)")


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------


def _layer_param_shapes(cfg: ModelConfig) -> dict:
    """Per-layer parameter shapes (without the leading L stack dim)."""
    d, hd, hq, hkv = cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv_heads
    if cfg.block_kind == "attn":
        attn = {"ln": (d,), "wq": (d, hq, hd), "wk": (d, hkv, hd),
                "wv": (d, hkv, hd), "wo": (hq, hd, d)}
        if cfg.qkv_bias:
            attn.update({"bq": (hq, hd), "bk": (hkv, hd), "bv": (hkv, hd)})
        return {"attn": attn, "mlp": {"ln": (d,), "wg": (d, cfg.d_ff),
                                      "wu": (d, cfg.d_ff),
                                      "wd": (cfg.d_ff, d)}}
    di, n, r = cfg.d_inner, cfg.ssm_state, cfg.dt_rank
    return {"ssm": {"ln": (d,), "in_proj": (d, 2 * di),
                    "conv_w": (cfg.ssm_conv, di), "conv_b": (di,),
                    "x_proj": (di, r + 2 * n), "dt_w": (r, di),
                    "dt_bias": (di,), "a_log": (di, n), "d_skip": (di,),
                    "out_proj": (di, d)}}


def param_shapes(cfg: ModelConfig) -> dict:
    """Full parameter tree as shape tuples (stacked layer dim first)."""
    _check_ported(cfg)
    v, d = padded_vocab(cfg), cfg.d_model
    layers = {blk: {k: (cfg.n_layers, *shp) for k, shp in leaves.items()}
              for blk, leaves in _layer_param_shapes(cfg).items()}
    return {"embed": (v, d), "final_ln": (d,), "lm_head": (d, v),
            "layers": layers}


def _leaves(tree: dict, prefix: tuple = ()):
    """(path, leaf) pairs in the reference's flatten order (sorted keys)."""
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _leaves(tree[k], prefix + (k,))
        else:
            yield prefix + (k,), tree[k]


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
    for path, shp in _leaves(param_shapes(cfg)):
        name = path[-1]
        if name == "a_log":
            vals = torch.log(torch.arange(1, shp[-1] + 1, dtype=torch.float32,
                                          device=device))
            leaf = vals.expand(shp).to(cfg.pdtype)
        elif name == "dt_bias":
            leaf = torch.full(shp, -4.6, dtype=cfg.pdtype, device=device)
        elif name in ("ln", "final_ln"):
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


def _layer(tree: dict, i: int) -> dict:
    """Layer ``i``'s parameters: every stacked leaf indexed at i (views)."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


# ---------------------------------------------------------------------------
# serving: prefill + decode
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch_size: int, max_len: int,
               device=None) -> dict:
    """Decode cache: ``pos`` (B,) int32; attention: k / v (L, B, S, Hkv,
    hd); Mamba1: conv (L, B, d_conv − 1, Di) in the cache dtype and ssm
    (L, B, Di, N) fp32. Zeros, on ``device`` (cuda unless named)."""
    _check_ported(cfg)
    device = utils.resolve_device(device)
    kvdt = dtype(cfg.cache_dtype)
    ldim = cfg.n_layers
    cache = {"pos": torch.zeros((batch_size,), dtype=torch.int32,
                                device=device)}
    if cfg.block_kind == "attn":
        shp = (ldim, batch_size, max_len, cfg.n_kv_heads, cfg.hd)
        cache["k"] = torch.zeros(shp, dtype=kvdt, device=device)
        cache["v"] = torch.zeros(shp, dtype=kvdt, device=device)
    else:
        di, n = cfg.d_inner, cfg.ssm_state
        cache["conv"] = torch.zeros((ldim, batch_size, cfg.ssm_conv - 1, di),
                                    dtype=kvdt, device=device)
        cache["ssm"] = torch.zeros((ldim, batch_size, di, n),
                                   dtype=torch.float32, device=device)
    return cache


def _logits(x: torch.Tensor, lm_head: torch.Tensor,
            cfg: ModelConfig) -> torch.Tensor:
    """fp32 logits. In bf16 the product is rounded to bf16 before the
    cast, where the reference asks for fp32 output: converting the (d, V)
    head to fp32 on every step would cost more than the step."""
    return torch.matmul(x, lm_head.to(cfg.cdtype)).float()


def prefill(params: dict, batch: dict, cfg: ModelConfig
            ) -> tuple[torch.Tensor, dict]:
    """Prefill: forward pass over ``batch["tokens"]`` (B, S) that also
    builds the decode cache → (last-position logits (B, V) fp32, cache
    with pos = S). Runs where the parameters lie."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    x = L.embed_tokens(params["embed"], tokens, cfg)
    pos = torch.arange(s, device=tokens.device)
    cache = init_cache(cfg, b, s, tokens.device)
    kvdt = dtype(cfg.cache_dtype)
    for i in range(cfg.n_layers):
        lp = _layer(params["layers"], i)
        if cfg.block_kind == "attn":
            x, (k, v) = L.attention_block(lp["attn"], x, cfg, pos,
                                          return_kv=True)
            x = L.mlp_block(lp["mlp"], x, cfg)
            cache["k"][i] = k.to(kvdt)
            cache["v"][i] = v.to(kvdt)
        else:
            x, st = S.mamba1_block(lp["ssm"], x, cfg, return_state=True)
            cache["conv"][i] = st["conv"]
            cache["ssm"][i] = st["ssm"]
    x = L.rms_norm(x, params["final_ln"], cfg.rms_eps)
    cache["pos"].fill_(s)
    return _logits(x[:, -1], params["lm_head"], cfg), cache


def decode_step(params: dict, cache: dict, tokens: torch.Tensor,
                cfg: ModelConfig) -> tuple[torch.Tensor, dict]:
    """One decode step. tokens: (B, 1) → (logits (B, V) fp32, cache with
    pos + 1). The cache's tensors are updated in place (the reference
    returns new arrays): the returned dict shares them."""
    pos = cache["pos"]
    x = L.embed_tokens(params["embed"], tokens, cfg)
    for i in range(cfg.n_layers):
        lp = _layer(params["layers"], i)
        if cfg.block_kind == "attn":
            x, _ = L.attention_block_decode(
                lp["attn"], x, {"k": cache["k"][i], "v": cache["v"][i]}, pos,
                cfg)
            x = L.mlp_block(lp["mlp"], x, cfg)
        else:
            x, new = S.mamba1_decode(
                lp["ssm"], x, {"conv": cache["conv"][i],
                               "ssm": cache["ssm"][i]}, cfg)
            cache["conv"][i] = new["conv"]
            cache["ssm"][i] = new["ssm"]
    x = L.rms_norm(x, params["final_ln"], cfg.rms_eps)
    return _logits(x[:, 0], params["lm_head"], cfg), dict(cache, pos=pos + 1)
