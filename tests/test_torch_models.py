"""The port's LM stack against the JAX package on the CPU: the arch
registry and config, layers and blocks, one block at each model's full
width, the decoder's prefill + decode and training forward for every LM
arch, ``init_params`` and ``convert.lm_params``.

Inputs and parameters come from numpy seeds (or from the reference's own
``init_params``, converted) and go through both packages. Tolerances:
fp32 atol 1e-4 · max|reference| (summation order and the port's kernels'
fp32 arithmetic); bf16 decoder 2e-2 · max|logit|, wider because the
reference rounds attention probabilities to bf16 before P·V and the port
keeps them in fp32, as the Pallas kernel does.
"""
import _torch_threads  # noqa: F401  (one torch thread a process)
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch.train import default_smoke_model as j_default_smoke_model
from repro.models import decoder as JD
from repro.models import layers as JL
from repro.models import ssm as JS
from repro_torch import configs, convert
from repro_torch.launch.serve import default_smoke_model
from repro_torch.models import config as model_config
from repro_torch.models import decoder as D
from repro_torch.models import layers as L
from repro_torch.models import ssm as S

FP32_TOL = 1e-4
BF16_TOL = 2e-2
SMOKE_ARCHS = ("smoke", *jconfigs.LM_ARCHS)


def _port_cfg(jcfg, **kw):
    return model_config.ModelConfig(**dict(dataclasses.asdict(jcfg), **kw))


def _f32(cfg):
    return dataclasses.replace(cfg, param_dtype="float32",
                               compute_dtype="float32",
                               cache_dtype="float32")


def _smoke(arch):
    return (j_default_smoke_model() if arch == "smoke"
            else jconfigs.get_smoke_config(arch))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, tol=FP32_TOL):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(float(np.abs(want).max()),
                                              1e-30))


def _params(jcfg, seed=0):
    """The reference's parameters and the same values as the port's."""
    jp = JD.init_params(jax.random.PRNGKey(seed), jcfg)
    return jp, convert.lm_params(jax.device_get(jp), device="cpu")


def _layer0(tree):
    if isinstance(tree, dict):
        return {k: _layer0(v) for k, v in tree.items()}
    return tree[0]


# ---------------------------------------------------------------------------
# registry and config
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", jconfigs.LM_ARCHS)
def test_registry_configs_equal_the_reference(arch):
    for get in ("get_config", "get_smoke_config"):
        jcfg = getattr(jconfigs, get)(arch)
        cfg = getattr(configs, get)(arch)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        assert cfg.param_count() == jcfg.param_count()
        assert (cfg.hd, cfg.d_inner, cfg.dt_rank) == (jcfg.hd, jcfg.d_inner,
                                                      jcfg.dt_rank)
        assert cfg.cdtype == torch.bfloat16 and cfg.pdtype == torch.bfloat16
    assert configs.LM_ARCHS == jconfigs.LM_ARCHS
    assert dataclasses.asdict(default_smoke_model()) == dataclasses.asdict(
        j_default_smoke_model())


def test_registry_names_unported_archs():
    """Every LM architecture loads (none is left unported), its parameter
    tree has the reference's shapes, and an unknown name raises."""
    for arch in configs.LM_ARCHS:
        for get in ("get_config", "get_smoke_config"):
            cfg = getattr(configs, get)(arch)
            jcfg = getattr(jconfigs, get)(arch)
            assert dict(_flat(D.param_shapes(cfg))) == dict(
                _flat(JD.param_shapes(jcfg)))
    with pytest.raises(KeyError):
        configs.get_smoke_config("gpt-2")


# ---------------------------------------------------------------------------
# layers and blocks, fp32
# ---------------------------------------------------------------------------


def test_rms_norm_and_rope(rng):
    x = rng.standard_normal((2, 7, 3, 32)).astype(np.float32)
    w = rng.standard_normal(32).astype(np.float32)
    _close(L.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5),
           JL.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5))
    for positions in (np.arange(7), rng.integers(0, 500, (2, 7))):
        cos, sin = L.rope_tables(torch.from_numpy(positions), 32, 10000.0)
        jcos, jsin = JL.rope_tables(jnp.asarray(positions), 32, 10000.0)
        _close(cos, jcos)
        _close(sin, jsin)
        _close(L.apply_rope(torch.from_numpy(x), cos, sin),
               JL.apply_rope(jnp.asarray(x), jcos, jsin))


@pytest.mark.parametrize("arch", ["smoke", "qwen2.5-14b"])
def test_attention_and_mlp_blocks(rng, arch):
    jcfg = _f32(_smoke(arch))
    cfg = _port_cfg(jcfg)
    jp, tp = _params(jcfg)
    jl, tl = _layer0(jp["layers"]), _layer0(tp["layers"])
    x = rng.standard_normal((2, 32, jcfg.d_model)).astype(np.float32)
    out, (k, v) = L.attention_block(tl["attn"], torch.from_numpy(x), cfg,
                                    torch.arange(32), return_kv=True)
    jout, (jk, jv) = JL.attention_block(jl["attn"], jnp.asarray(x), jcfg,
                                        jnp.arange(32), return_kv=True)
    for got, want in ((out, jout), (k, jk), (v, jv)):
        _close(got, want)
    _close(L.mlp_block(tl["mlp"], torch.from_numpy(x), cfg),
           JL.mlp_block(jl["mlp"], jnp.asarray(x), jcfg))


@pytest.mark.parametrize("uniform", [True, False])
def test_attention_block_decode(rng, uniform):
    jcfg = dataclasses.replace(_f32(_smoke("qwen2.5-14b")),
                               uniform_decode_pos=uniform)
    cfg = _port_cfg(jcfg)
    jp, tp = _params(jcfg)
    jl, tl = _layer0(jp["layers"]), _layer0(tp["layers"])
    shp = (3, 24, jcfg.n_kv_heads, jcfg.hd)
    kc, vc = (rng.standard_normal(shp).astype(np.float32) for _ in range(2))
    # per-slot positions, one past the cache (its write is dropped)
    pos = np.array([9, 9, 9] if uniform else [5, 23, 24], np.int32)
    x = rng.standard_normal((3, 1, jcfg.d_model)).astype(np.float32)
    out, cache = L.attention_block_decode(
        tl["attn"], torch.from_numpy(x), {"k": torch.from_numpy(kc.copy()),
                                          "v": torch.from_numpy(vc.copy())},
        torch.from_numpy(pos), cfg)
    jout, jcache = JL.attention_block_decode(
        jl["attn"], jnp.asarray(x), {"k": jnp.asarray(kc),
                                     "v": jnp.asarray(vc)},
        jnp.asarray(pos), jcfg)
    _close(out, jout)
    _close(cache["k"], jcache["k"])
    _close(cache["v"], jcache["v"])


def test_mamba1_block_and_decode(rng):
    jcfg = _f32(_smoke("falcon-mamba-7b"))
    cfg = _port_cfg(jcfg)
    jp, tp = _params(jcfg)
    jl, tl = _layer0(jp["layers"])["ssm"], _layer0(tp["layers"])["ssm"]
    x = rng.standard_normal((2, 32, jcfg.d_model)).astype(np.float32)
    out, st = S.mamba1_block(tl, torch.from_numpy(x), cfg, return_state=True)
    jout, jst = JS.mamba1_block(jl, jnp.asarray(x), jcfg, return_state=True)
    _close(out, jout)
    _close(st["conv"], jst["conv"])
    _close(st["ssm"], jst["ssm"])
    x1 = rng.standard_normal((2, 1, jcfg.d_model)).astype(np.float32)
    out1, st1 = S.mamba1_decode(tl, torch.from_numpy(x1), st, cfg)
    jout1, jst1 = JS.mamba1_decode(jl, jnp.asarray(x1), jst, jcfg)
    _close(out1, jout1)
    _close(st1["conv"], jst1["conv"])
    _close(st1["ssm"], jst1["ssm"])


def test_causal_depthwise_conv(rng):
    x = rng.standard_normal((2, 9, 6)).astype(np.float32)
    w = rng.standard_normal((4, 6)).astype(np.float32)
    b = rng.standard_normal(6).astype(np.float32)
    _close(S.causal_depthwise_conv(*map(torch.from_numpy, (x, w, b))),
           JS.causal_depthwise_conv(*map(jnp.asarray, (x, w, b))))


# ---------------------------------------------------------------------------
# one block at each model's full width (fp32, S = 64)
# ---------------------------------------------------------------------------


def _numpy_leaves(rng, shapes: dict) -> dict:
    out = {}
    for name, shp in shapes.items():
        if name == "a_log":
            out[name] = np.broadcast_to(
                np.log(np.arange(1, shp[-1] + 1, dtype=np.float32)),
                shp).copy()
        elif name == "dt_bias":
            out[name] = np.full(shp, -4.6, np.float32)
        elif name == "ln":
            out[name] = np.ones(shp, np.float32)
        else:
            out[name] = rng.standard_normal(shp, dtype=np.float32) * 0.02
    return out


def test_qwen25_14b_attention_block_at_full_width(rng):
    jcfg = _f32(jconfigs.get_config("qwen2.5-14b"))
    cfg = _port_cfg(jcfg)
    assert (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
            cfg.qkv_bias) == (5120, 40, 8, 128, True)
    leaves = _numpy_leaves(rng, D._layer_param_shapes(cfg)["attn"])
    x = rng.standard_normal((1, 64, cfg.d_model), dtype=np.float32)
    out = L.attention_block({k: torch.from_numpy(v) for k, v in
                             leaves.items()}, torch.from_numpy(x), cfg,
                            torch.arange(64))
    jout = JL.attention_block({k: jnp.asarray(v) for k, v in leaves.items()},
                              jnp.asarray(x), jcfg, jnp.arange(64))
    _close(out, jout)


def test_falcon_mamba_7b_mamba1_block_at_full_width(rng):
    jcfg = _f32(jconfigs.get_config("falcon-mamba-7b"))
    cfg = _port_cfg(jcfg)
    assert (cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_conv,
            cfg.dt_rank) == (4096, 8192, 16, 4, 256)
    leaves = _numpy_leaves(rng, D._layer_param_shapes(cfg)["ssm"])
    x = rng.standard_normal((1, 64, cfg.d_model), dtype=np.float32)
    out, st = S.mamba1_block({k: torch.from_numpy(v) for k, v in
                              leaves.items()}, torch.from_numpy(x), cfg,
                             return_state=True)
    jout, jst = JS.mamba1_block({k: jnp.asarray(v) for k, v in
                                 leaves.items()}, jnp.asarray(x), jcfg,
                                return_state=True)
    _close(out, jout)
    _close(st["ssm"], jst["ssm"])


# ---------------------------------------------------------------------------
# the decoder: prefill, then 4 decode steps
# ---------------------------------------------------------------------------


def _pad_seq(a, extra):
    """(L, B, S, ...) cache leaf with ``extra`` zero positions appended."""
    if isinstance(a, torch.Tensor):
        return torch.cat([a, a.new_zeros((a.shape[0], a.shape[1], extra,
                                           *a.shape[3:]))], dim=2)
    return jnp.pad(a, [(0, 0), (0, 0), (0, extra)] + [(0, 0)] * (a.ndim - 3))


def _decoder_run(jcfg, tol, rng):
    cfg = _port_cfg(jcfg)
    jp, tp = _params(jcfg)
    b, s, steps = 2, 32, 4
    toks = rng.integers(1, jcfg.vocab_size, (b, s)).astype(np.int32)
    nxt = rng.integers(1, jcfg.vocab_size, (steps, b, 1)).astype(np.int32)
    jlogits, jcache = jax.jit(functools.partial(JD.prefill, cfg=jcfg))(
        jp, {"tokens": jnp.asarray(toks)})
    logits, cache = D.prefill(tp, {"tokens": torch.from_numpy(toks)}, cfg)
    _close(logits, jlogits, tol)
    assert logits.shape == (b, D.padded_vocab(cfg))
    for k in D.SEQ_CACHES:                  # room for the decode steps
        if k in cache:
            jcache[k] = _pad_seq(jcache[k], steps)
            cache[k] = _pad_seq(cache[k], steps)
    jstep = jax.jit(functools.partial(JD.decode_step, cfg=jcfg))
    for t in range(steps):
        jlogits, jcache = jstep(jp, jcache, jnp.asarray(nxt[t]))
        logits, cache = D.decode_step(tp, cache, torch.from_numpy(nxt[t]),
                                      cfg)
        _close(logits, jlogits, tol)
    assert sorted(cache) == sorted(jcache)
    for k in cache:
        assert cache[k].dtype == getattr(torch, np.asarray(jcache[k])
                                         .dtype.name)
        _close(cache[k], jcache[k], tol)


@pytest.mark.parametrize("arch", SMOKE_ARCHS)
def test_decoder_prefill_and_decode_fp32(rng, arch):
    _decoder_run(_f32(_smoke(arch)), FP32_TOL, rng)


@pytest.mark.parametrize("arch", SMOKE_ARCHS)
def test_forward_hidden_states_and_aux_fp32(rng, arch):
    """The training forward: final hidden states and the MoE aux loss (0
    for the other families)."""
    jcfg = _f32(_smoke(arch))
    jp, tp = _params(jcfg)
    toks = rng.integers(1, jcfg.vocab_size, (2, 64)).astype(np.int32)
    h, aux = D.forward(tp, {"tokens": torch.from_numpy(toks)},
                       _port_cfg(jcfg))
    jh, jaux = JD.forward(jp, {"tokens": jnp.asarray(toks)}, jcfg)
    _close(h, jh)
    assert aux.dtype == torch.float32 and aux.shape == ()
    assert abs(float(aux) - float(jaux)) <= 1e-6 * abs(float(jaux))
    assert (float(jaux) > 0) == jcfg.is_moe


def test_decoder_prefill_and_decode_qwen_bf16(rng):
    # bf16: the reference rounds p to bf16 before P·V, the port does not
    _decoder_run(jconfigs.get_smoke_config("qwen2.5-14b"), BF16_TOL, rng)


# ---------------------------------------------------------------------------
# init_params and convert
# ---------------------------------------------------------------------------


def _flat(tree, prefix=()):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _flat(tree[k], prefix + (k,))
        else:
            yield prefix + (k,), tree[k]


@pytest.mark.parametrize("arch", jconfigs.LM_ARCHS)
def test_init_params_matches_reference_distributions(arch):
    # vocab 4000 → padded 4096 rows: the embedding's scale is 1/√4096,
    # below the 0.02 cap, so both scale rules are exercised
    jcfg = dataclasses.replace(jconfigs.get_smoke_config(arch),
                               vocab_size=4000)
    cfg = _port_cfg(jcfg)
    jp = jax.device_get(JD.init_params(jax.random.PRNGKey(0), jcfg))
    tp = D.init_params(cfg, seed=0, device="cpu")
    jleaves, tleaves = dict(_flat(jp)), dict(_flat(tp))
    assert sorted(jleaves) == sorted(tleaves)
    shapes = dict(_flat(D.param_shapes(cfg)))
    checked = 0
    for path, j in jleaves.items():
        t = tleaves[path]
        assert tuple(t.shape) == j.shape == shapes[path], path
        assert t.dtype == torch.bfloat16 and j.dtype.name == "bfloat16"
        tf, jf = t.float().numpy(), np.asarray(j, np.float32)
        if path[-1] in ("a_log", "dt_bias", "ln", "out_ln", "final_ln"):
            np.testing.assert_array_equal(tf, jf, err_msg=str(path))
        elif jf.size >= 10_000:
            assert abs(tf.std() / jf.std() - 1) < 0.05, path
            assert abs(tf.mean()) < 0.05 * jf.std(), path
            checked += 1
    assert checked >= 4


def test_lm_params_round_trips_bf16_bit_for_bit():
    jcfg = jconfigs.get_smoke_config("qwen2.5-14b")       # bf16 leaves
    jp = jax.device_get(JD.init_params(jax.random.PRNGKey(3), jcfg))
    tp = convert.lm_params(jp, device="cpu")
    shapes = dict(_flat(D.param_shapes(_port_cfg(jcfg))))
    for path, j in _flat(jp):
        t = dict(_flat(tp))[path]
        assert tuple(t.shape) == shapes[path] and t.dtype == torch.bfloat16
        np.testing.assert_array_equal(
            t.view(torch.int16).numpy().view(np.uint16),
            np.asarray(j).view(np.uint16))
    cache = JD.init_cache(jcfg, 2, 8)
    got = convert.lm_cache(jax.device_get(cache), device="cpu")
    assert got["pos"].dtype == torch.int32
    assert got["k"].dtype == torch.bfloat16 and got["k"].shape == (2, 2, 8,
                                                                   1, 32)
