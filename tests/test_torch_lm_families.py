"""The port's MoE, parallel attention + MLP block, Mamba2 (SSD), patch
frontend and their parameter conversion, unit by unit against the JAX
package on the CPU.

Inputs come from numpy seeds (or the reference's own ``init_params``,
converted by ``convert.lm_params``) and go through both packages.
Integer outputs are held exactly: capacities, expert ids, arrival ranks
and the set of (token, slot) pairs that capacity drops. Float outputs
are fp32 and held to 1e-4 · max|reference| (``FP32_TOL``: summation
order; the port contracts the reference's three-operand SSD einsums as
two products each), the router's weights and aux loss to 1e-6 (one fp32
product and a softmax). SSD is also held to the plain recurrence at
lengths the reference cannot run (not a multiple of its chunk).
"""
import _torch_threads  # noqa: F401  (one torch thread a process)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import decoder as JD
from repro.models import layers as JL
from repro.models import ssm as JS
from repro_torch import configs, convert
from repro_torch.launch import serve
from repro_torch.launch import train
from repro_torch.models import config as model_config
from repro_torch.models import decoder as D
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.utils import tree_leaves as _flat

FP32_TOL = 1e-4
ROUTE_TOL = 1e-6
MOE_ARCHS = ("deepseek-moe-16b", "moonshot-v1-16b-a3b")


def _port_cfg(jcfg, **kw):
    return model_config.ModelConfig(**dict(dataclasses.asdict(jcfg), **kw))


def _f32(cfg, **kw):
    return dataclasses.replace(cfg, param_dtype="float32",
                               compute_dtype="float32",
                               cache_dtype="float32", **kw)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, tol=FP32_TOL):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(float(np.abs(want).max()),
                                              1e-30))


def _params(jcfg, seed=0):
    jp = JD.init_params(jax.random.PRNGKey(seed), jcfg)
    return jp, convert.lm_params(jax.device_get(jp), device="cpu")


def _layer0(tree):
    if isinstance(tree, dict):
        return {k: _layer0(v) for k, v in tree.items()}
    return tree[0]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_capacity_matches_reference(arch):
    for get in ("get_config", "get_smoke_config"):
        jcfg = getattr(jconfigs, get)(arch)
        cfg = getattr(configs, get)(arch)
        for n in (1, 4, 7, 12, 100, 512, 1000, 2048, 8192):
            assert L._capacity(n, cfg) == JL._capacity(n, jcfg), (get, n)
    # a decode step's few tokens take the floor of 8
    assert L._capacity(4, configs.get_config(arch)) == 8


def _route_both(h2, router, jcfg):
    cfg = _port_cfg(jcfg)
    te, tw, ta = L._route(_t(h2), _t(router), cfg)
    je, jw, ja = JL._route(jnp.asarray(h2), jnp.asarray(router), jcfg)
    return (te, tw, ta), (np.asarray(je), jw, ja)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_route_matches_reference(rng, arch):
    jcfg = jconfigs.get_config(arch)              # 64 experts, top-6
    h2 = rng.standard_normal((257, 256), dtype=np.float32)
    router = rng.standard_normal((256, jcfg.n_experts), dtype=np.float32)
    (te, tw, ta), (je, jw, ja) = _route_both(h2, router, jcfg)
    assert te.shape == je.shape == (257, jcfg.moe_top_k)
    np.testing.assert_array_equal(te.numpy(), je)
    _close(tw, jw, ROUTE_TOL)
    assert abs(float(ta) - float(ja)) <= ROUTE_TOL * abs(float(ja))
    assert tw.dtype == torch.float32


def test_route_orders_ties_as_the_reference():
    """Equal probabilities (duplicated router columns, zero tokens): the
    lower expert id comes first, as ``jax.lax.top_k`` orders them."""
    jcfg = jconfigs.get_smoke_config("deepseek-moe-16b")   # 8 experts, top-2
    rng = np.random.default_rng(3)
    col = rng.standard_normal((128, 1), dtype=np.float32)
    router = rng.standard_normal((128, 8), dtype=np.float32)
    router[:, [1, 4, 6]] = col * 3.0            # three tied leaders
    h2 = np.abs(rng.standard_normal((16, 128), dtype=np.float32))
    h2 *= np.sign(col.T)                        # col·h > 0: the tie wins
    h2[5] = 0.0                                 # every expert tied
    (te, tw, ta), (je, jw, ja) = _route_both(h2, router, jcfg)
    np.testing.assert_array_equal(te.numpy(), je)
    assert (je[:, :2] == [1, 4]).all(axis=1)[np.arange(16) != 5].all()
    assert list(je[5]) == [0, 1]
    _close(tw, jw, ROUTE_TOL)


def test_route_bf16_same_inputs_route_identically(rng):
    """bf16 hidden states: the port's fp32 router logits give the
    reference's expert ids exactly on the same inputs."""
    jcfg = jconfigs.get_smoke_config("deepseek-moe-16b")
    h2 = rng.standard_normal((128, 128), dtype=np.float32)
    router = (rng.standard_normal((128, 8), dtype=np.float32)
              / np.sqrt(128)).astype(np.float32)
    te, _, _ = L._route(_t(h2).to(torch.bfloat16),
                        _t(router).to(torch.bfloat16), _port_cfg(jcfg))
    je, _, _ = JL._route(jnp.asarray(h2, jnp.bfloat16),
                         jnp.asarray(router, jnp.bfloat16), jcfg)
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))


@pytest.mark.parametrize("n_experts", [8, 13, 64])
def test_rank_within_expert_is_exact(rng, n_experts):
    flat = rng.integers(0, n_experts, 1000).astype(np.int32)
    got = L._rank_within_expert(_t(flat), n_experts)
    want = JL._rank_within_expert(jnp.asarray(flat), n_experts)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # token-major arrival order: ranks count up within each expert
    for e in range(n_experts):
        np.testing.assert_array_equal(got.numpy()[flat == e],
                                      np.arange((flat == e).sum()))


def _overflow_case(rng, t=96):
    """A smoke MoE layer with a skewed router: most tokens' first choice
    is expert 2, far past its capacity. The skew keeps every probability
    above fp32's normal range: XLA on the CPU flushes subnormal ones to
    zero, which ties them, where torch keeps them apart."""
    jcfg = _f32(jconfigs.get_smoke_config("deepseek-moe-16b"))
    jp, tp = _params(jcfg)
    jl, tl = _layer0(jp["layers"])["moe"], _layer0(tp["layers"])["moe"]
    h2 = rng.standard_normal((t, jcfg.d_model), dtype=np.float32)
    router = np.array(jl["router"])
    router[:, 2] = h2.mean(0) * 4.0
    return jcfg, jl, tl, h2, router


@pytest.mark.parametrize("e_base,e_loc", [(0, 8), (2, 4)])
def test_moe_local_under_overflow(rng, e_base, e_loc):
    jcfg, jl, tl, h2, router = _overflow_case(rng)
    cfg = _port_cfg(jcfg)
    assert jcfg.moe_top_k == 2
    (te, tw, _), (je, jw, _) = _route_both(h2, router, jcfg)
    np.testing.assert_array_equal(te.numpy(), je)
    flat = je.reshape(-1)
    cap = L._capacity(h2.shape[0], cfg)
    assert cap == JL._capacity(h2.shape[0], jcfg)
    rank = L._rank_within_expert(te.reshape(-1), cfg.n_experts).numpy()
    dropped = rank >= cap
    np.testing.assert_array_equal(
        dropped, np.asarray(JL._rank_within_expert(jnp.asarray(flat),
                                                   jcfg.n_experts)) >= cap)
    assert 10 < dropped.sum() < flat.size      # capacity really drops
    sl = slice(e_base, e_base + e_loc)
    ws = [np.ascontiguousarray(np.asarray(jl[k])[sl])
          for k in ("wg", "wu", "wd")]
    got = L._moe_local(_t(h2), te, tw, *map(_t, ws), e_base, cfg)
    want = JL._moe_local(jnp.asarray(h2), jnp.asarray(je), jw,
                         *map(jnp.asarray, ws), jnp.int32(e_base), jcfg)
    _close(got, want)
    # the (token, slot) pairs that count — local experts, within capacity —
    # each through its expert alone, weighted
    kept = ~dropped & (flat >= e_base) & (flat < e_base + e_loc)
    expect = np.zeros_like(h2)
    w = np.asarray(jw).reshape(-1)
    for i in np.nonzero(kept)[0]:
        wg, wu, wd = (m[flat[i] - e_base] for m in ws)
        g, u = h2[i // 2] @ wg, h2[i // 2] @ wu
        expect[i // 2] += w[i] * ((g / (1 + np.exp(-g)) * u) @ wd)
    _close(got, expect)
    none_kept = ~kept.reshape(je.shape).any(axis=1)
    assert none_kept.any() == (e_loc < jcfg.n_experts)
    assert (got.numpy()[none_kept] == 0).all()


@pytest.mark.parametrize("shared", [2, 0])
def test_moe_block_matches_reference(rng, shared):
    jcfg = _f32(jconfigs.get_smoke_config("deepseek-moe-16b"))
    jcfg = dataclasses.replace(jcfg, n_shared_experts=shared)
    jp, tp = _params(jcfg)
    jl, tl = _layer0(jp["layers"])["moe"], _layer0(tp["layers"])["moe"]
    assert ("swg" in tl) == bool(shared)
    for b, s in ((2, 40), (4, 1)):               # a prefill, a decode step
        x = rng.standard_normal((b, s, jcfg.d_model), dtype=np.float32)
        y, aux = L.moe_block(tl, _t(x), _port_cfg(jcfg))
        jy, jaux = JL.moe_block(jl, jnp.asarray(x), jcfg)
        _close(y, jy)
        assert abs(float(aux) - float(jaux)) <= ROUTE_TOL * float(jaux)


# ---------------------------------------------------------------------------
# the parallel attention + MLP block (command-r)
# ---------------------------------------------------------------------------


def _parallel_case(**kw):
    jcfg = _f32(jconfigs.get_smoke_config("command-r-35b"), **kw)
    jp, tp = _params(jcfg)
    jl, tl = _layer0(jp["layers"]), _layer0(tp["layers"])
    return jcfg, _port_cfg(jcfg), jl, tl


def test_parallel_block_prefill(rng):
    jcfg, cfg, jl, tl = _parallel_case()
    x = rng.standard_normal((2, 32, jcfg.d_model), dtype=np.float32)
    y, (k, v) = L.parallel_attn_mlp_block(tl["attn"], tl["mlp"], _t(x), cfg,
                                          torch.arange(32), return_kv=True)
    jy, (jk, jv) = JL.parallel_attn_mlp_block(
        jl["attn"], jl["mlp"], jnp.asarray(x), jcfg, jnp.arange(32),
        return_kv=True)
    for got, want in ((y, jy), (k, jk), (v, jv)):
        _close(got, want)
    _close(L.parallel_attn_mlp_block(tl["attn"], tl["mlp"], _t(x), cfg,
                                     torch.arange(32)), jy)


@pytest.mark.parametrize("uniform", [True, False])
def test_parallel_block_decode(rng, uniform):
    jcfg, cfg, jl, tl = _parallel_case(uniform_decode_pos=uniform)
    shp = (3, 24, jcfg.n_kv_heads, jcfg.hd)
    kc, vc = (rng.standard_normal(shp).astype(np.float32) for _ in range(2))
    # per-slot positions, one past the cache (its write is dropped)
    pos = np.array([9, 9, 9] if uniform else [5, 23, 24], np.int32)
    x = rng.standard_normal((3, 1, jcfg.d_model)).astype(np.float32)
    y, cache = L.parallel_attn_mlp_block(
        tl["attn"], tl["mlp"], _t(x), cfg, None,
        cache={"k": _t(kc.copy()), "v": _t(vc.copy())}, pos=_t(pos))
    jy, jcache = JL.parallel_attn_mlp_block(
        jl["attn"], jl["mlp"], jnp.asarray(x), jcfg, None,
        cache={"k": jnp.asarray(kc), "v": jnp.asarray(vc)},
        pos=jnp.asarray(pos))
    _close(y, jy)
    _close(cache["k"], jcache["k"])
    _close(cache["v"], jcache["v"])


# ---------------------------------------------------------------------------
# Mamba2 (SSD)
# ---------------------------------------------------------------------------


def test_segsum_matches_reference(rng):
    a = -np.abs(rng.standard_normal((2, 3, 16), dtype=np.float32))
    got, want = S._segsum(_t(a)).numpy(), np.asarray(JS._segsum(a))
    finite = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), finite)
    np.testing.assert_allclose(got[finite], want[finite], rtol=0,
                               atol=FP32_TOL * np.abs(want[finite]).max())


def _ssd_inputs(rng, b=2, s=64, h=3, p=4, n=5):
    xdt = rng.standard_normal((b, s, h, p), dtype=np.float32)
    a = -np.abs(rng.standard_normal((b, s, h), dtype=np.float32)) * 0.3
    bm = rng.standard_normal((b, s, n), dtype=np.float32)
    cm = rng.standard_normal((b, s, n), dtype=np.float32)
    h0 = rng.standard_normal((b, h, p, n), dtype=np.float32)
    return xdt, a, bm, cm, h0


def _recurrence(xdt, a, bm, cm, h0):
    """h_t = exp(a_t) h_{t-1} + xdt_t ⊗ b_t; y_t = h_t · c_t (float64)."""
    h = h0.astype(np.float64)
    ys = []
    for t in range(xdt.shape[1]):
        h = (np.exp(a[:, t])[:, :, None, None] * h
             + xdt[:, t, :, :, None] * bm[:, t, None, None, :])
        ys.append(np.einsum("bhpn,bn->bhp", h, cm[:, t]))
    return np.stack(ys, 1), h


@pytest.mark.parametrize("s,chunk", [(64, 16), (64, 64), (12, 12)])
def test_ssd_matches_reference(rng, s, chunk):
    args = _ssd_inputs(rng, s=s)
    y, h = S.ssd(*map(_t, args), chunk)
    jy, jh = JS.ssd(*map(jnp.asarray, args), chunk)
    _close(y, jy)
    _close(h, jh)


@pytest.mark.parametrize("s,chunk", [(37, 16), (70, 64), (5, 16)])
def test_ssd_takes_any_length(rng, s, chunk):
    """A ragged tail (padded inside) against the recurrence, at lengths the
    reference's reshape refuses."""
    args = _ssd_inputs(rng, s=s)
    y, h = S.ssd(*map(_t, args), min(chunk, s))
    wy, wh = _recurrence(*args)
    assert y.shape == wy.shape
    _close(y, wy)
    _close(h, wh)


def _mamba2_case(jcfg, rng, s):
    cfg = _port_cfg(jcfg)
    jp, tp = _params(jcfg)
    jl, tl = _layer0(jp["layers"])["ssm"], _layer0(tp["layers"])["ssm"]
    x = rng.standard_normal((2, s, jcfg.d_model), dtype=np.float32)
    return cfg, jl, tl, x


def test_mamba2_block_and_decode(rng):
    jcfg = _f32(jconfigs.get_smoke_config("zamba2-1.2b"))
    cfg, jl, tl, x = _mamba2_case(jcfg, rng, 32)
    out, st = S.mamba2_block(tl, _t(x), cfg, return_state=True)
    jout, jst = JS.mamba2_block(jl, jnp.asarray(x), jcfg, return_state=True)
    _close(out, jout)
    _close(st["conv"], jst["conv"])
    _close(st["ssm"], jst["ssm"])
    _close(S.mamba2_block(tl, _t(x), cfg), jout)
    for _ in range(3):
        x1 = rng.standard_normal((2, 1, jcfg.d_model)).astype(np.float32)
        out1, st = S.mamba2_decode(tl, _t(x1), st, cfg)
        jout1, jst = JS.mamba2_decode(jl, jnp.asarray(x1), jst, jcfg)
        _close(out1, jout1)
        _close(st["conv"], jst["conv"])
        _close(st["ssm"], jst["ssm"])


def test_mamba2_block_ragged_prompt_continues_as_decode(rng):
    """Prefill of a length the reference cannot chunk (21 with chunk 16),
    then one decode step, against 22 decode steps of the same tokens."""
    jcfg = _f32(jconfigs.get_smoke_config("zamba2-1.2b"))
    cfg, _, tl, x = _mamba2_case(jcfg, rng, 22)
    full = S.mamba2_block(tl, _t(x), cfg)
    _, st = S.mamba2_block(tl, _t(x[:, :21]), cfg, return_state=True)
    last, _ = S.mamba2_decode(tl, _t(x[:, 21:]), st, cfg)
    _close(last, full[:, 21:])
    di = jcfg.d_inner + 2 * jcfg.ssm_state
    st = {"conv": torch.zeros((2, jcfg.ssm_conv - 1, di)),
          "ssm": torch.zeros((2, cfg.ssm_heads, jcfg.ssm_head_dim,
                              jcfg.ssm_state))}
    outs = []
    for t in range(22):
        o, st = S.mamba2_decode(tl, _t(x[:, t:t + 1]), st, cfg)
        outs.append(o)
    _close(torch.cat(outs, 1), full)


def test_zamba2_mamba2_block_at_full_width(rng):
    jcfg = _f32(jconfigs.get_config("zamba2-1.2b"))
    cfg = _port_cfg(jcfg)
    assert (cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads,
            cfg.ssm_head_dim, cfg.ssm_chunk) == (2048, 4096, 64, 64, 64, 64)
    shapes = D._layer_param_shapes(cfg)["ssm"]
    leaves = {}
    for name, shp in shapes.items():
        if name == "a_log":
            leaves[name] = np.log(np.arange(1, shp[-1] + 1,
                                            dtype=np.float32))
        elif name == "dt_bias":
            leaves[name] = np.full(shp, -4.6, np.float32)
        elif name in ("ln", "out_ln"):
            leaves[name] = np.ones(shp, np.float32)
        else:
            leaves[name] = rng.standard_normal(shp, dtype=np.float32) * 0.02
    x = rng.standard_normal((1, 128, cfg.d_model), dtype=np.float32)
    out, st = S.mamba2_block({k: _t(v) for k, v in leaves.items()}, _t(x),
                             cfg, return_state=True)
    jout, jst = JS.mamba2_block({k: jnp.asarray(v) for k, v in
                                 leaves.items()}, jnp.asarray(x), jcfg,
                                return_state=True)
    _close(out, jout)
    _close(st["ssm"], jst["ssm"])


# ---------------------------------------------------------------------------
# the patch frontend (internvl2)
# ---------------------------------------------------------------------------


def test_patch_frontend_forward_and_prefill(rng):
    jcfg = _f32(jconfigs.get_smoke_config("internvl2-1b"))
    cfg = _port_cfg(jcfg)
    jp, tp = _params(jcfg)
    assert tuple(tp["patch_proj"].shape) == (jcfg.d_model, jcfg.d_model)
    toks = rng.integers(1, jcfg.vocab_size, (2, 32)).astype(np.int32)
    pe = rng.standard_normal((2, jcfg.n_patches, jcfg.d_model),
                             dtype=np.float32)
    batch = {"tokens": toks, "patch_embeds": pe}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: _t(v) for k, v in batch.items()}
    h, aux = D.forward(tp, tb, cfg)
    jh, jaux = JD.forward(jp, jb, jcfg)
    _close(h, jh)
    assert float(aux) == float(jaux) == 0.0
    logits, cache = D.prefill(tp, tb, cfg)
    jlogits, jcache = JD.prefill(jp, jb, jcfg)
    _close(logits, jlogits)
    _close(cache["k"], jcache["k"])
    # the patches take the first positions: the tokens alone differ
    plain, _ = D.forward(tp, {"tokens": tb["tokens"]}, cfg)
    assert not torch.allclose(plain[:, :jcfg.n_patches],
                              h[:, :jcfg.n_patches])


# ---------------------------------------------------------------------------
# conversion of the new trees, and the launchers' --arch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "zamba2-1.2b",
                                  "internvl2-1b"])
def test_lm_params_round_trip_new_trees(arch):
    """The reference's bf16 parameters and decode cache → the port (bit
    for bit, the port's shapes) → numpy → the reference's values."""
    jcfg = jconfigs.get_smoke_config(arch)
    jp = jax.device_get(JD.init_params(jax.random.PRNGKey(5), jcfg))
    tp = convert.lm_params(jp, device="cpu")
    shapes = dict(_flat(D.param_shapes(_port_cfg(jcfg))))
    tflat = dict(_flat(tp))
    assert sorted(tflat) == sorted(shapes) == sorted(dict(_flat(jp)))
    back = dict(_flat(convert._lm_tree_to_numpy(tp)))
    for path, j in _flat(jp):
        t = tflat[path]
        assert tuple(t.shape) == shapes[path] and t.dtype == torch.bfloat16
        np.testing.assert_array_equal(
            t.view(torch.int16).numpy().view(np.uint16),
            np.asarray(j).view(np.uint16), err_msg=str(path))
        np.testing.assert_array_equal(back[path],
                                      np.asarray(j, np.float32))
    jcache = jax.device_get(JD.init_cache(jcfg, 2, 8))
    cache = convert.lm_cache(jcache, device="cpu")
    want = D.init_cache(_port_cfg(jcfg), 2, 8, device="cpu")
    assert sorted(cache) == sorted(want)
    for k, v in want.items():
        assert cache[k].shape == v.shape and cache[k].dtype == v.dtype, k


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "zamba2-1.2b",
                                  "command-r-35b"])
def test_launchers_take_the_new_archs(arch, capsys):
    stats = serve.main(["--arch", arch, "--requests", "3", "--slots", "2",
                        "--max-new", "3", "--device", "cpu"])
    assert stats["requests"] == 3 and stats["generated"] == 9
    res = train.main(["--arch", arch, "--smoke", "--steps", "2", "--seq",
                      "32", "--batch", "2", "--no-dedup", "--device",
                      "cpu"])
    assert res["steps_run"] == 2 and np.isfinite(res["final_loss"])
    assert "RESULT " in capsys.readouterr().out
