"""The port's training gradients against the JAX package on the CPU:
``lm_loss`` (with the MoE aux loss) and its gradients against
``jax.value_and_grad`` of the reference's ``lm_loss`` on every LM arch's
smoke config (fp32 with the three remat settings; bf16), and the
backward formulas of the two LM kernels (``plain_bwd``) against
``jax.vjp`` of ``repro.kernels.ref``.

Parameters come from the reference's ``init_params`` (converted), inputs
from numpy seeds. Tolerances: fp32 1e-5 relative to max|reference| for
the loss and 2e-5 for the gradients (summation order, with the
reference's blocked attention and chunked scan against the port's plain
versions); bf16 2⁻⁷ relative (the reference rounds attention
probabilities and its chunked scan's pairs at other places than the
port); the backward formulas 2e-5 relative in fp32.
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
from repro.kernels import ref as jref
from repro.launch.train import default_smoke_model as j_default_smoke_model
from repro.models import init_params as j_init_params
from repro.models import lm_loss as j_lm_loss
from repro_torch import convert
from repro_torch.kernels import flash_attention as fa_k
from repro_torch.kernels import mamba_scan as ms_k
from repro_torch.models import config as model_config
from repro_torch.models import forward, lm_loss
from repro_torch.utils import tree_leaves as leaves

SMOKE_ARCHS = tuple(jconfigs.LM_ARCHS)
# bf16 leaves out the MoE archs: the two packages round attention at other
# places in bf16 (see BF16_TOL), and that noise sends 2 of the smoke
# batch's 128 tokens to another expert at the first MoE layer, a
# discontinuity no tolerance on the gradients covers; the same bf16
# inputs route identically (tests/test_torch_lm_families.py), and fp32
# holds the MoE archs above
BF16_ARCHS = tuple(a for a in SMOKE_ARCHS
                   if not jconfigs.get_smoke_config(a).is_moe)
LOSS_TOL = 1e-5
GRAD_TOL = 2e-5
BF16_TOL = 2.0 ** -7
BF16_GRAD_TOL = 2.0 ** -5
SEQ = 64


def _jcfg(arch, dt, remat="none"):
    base = (j_default_smoke_model() if arch == "smoke"
            else jconfigs.get_smoke_config(arch))
    return dataclasses.replace(base, param_dtype=dt, compute_dtype=dt,
                               cache_dtype=dt, remat=remat)


def _port_cfg(jcfg, **kw):
    return model_config.ModelConfig(**dict(dataclasses.asdict(jcfg), **kw))


def _batch(vocab, b=2, s=SEQ, seed=0):
    rng = np.random.default_rng(seed)
    tok = rng.integers(1, vocab, (b, s)).astype(np.int32)
    labels = np.concatenate([tok[:, 1:], np.zeros((b, 1), np.int32)], 1)
    mask = np.ones((b, s), np.float32)
    mask[:, -1] = 0.0
    mask[0, : s // 4] = 0.0
    return {"tokens": tok, "labels": labels, "loss_mask": mask}


@functools.lru_cache(maxsize=None)
def _reference_of(arch, dt):
    """The reference's parameters, loss and gradients for one smoke config
    (shared by the three remat settings)."""
    jcfg = _jcfg(arch, dt)
    return _reference(jcfg, _batch(jcfg.vocab_size))


def _reference(jcfg, batch, seed=0):
    params = j_init_params(jax.random.PRNGKey(seed), jcfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (loss, metrics), grads = jax.value_and_grad(
        lambda p: j_lm_loss(p, jb, jcfg), has_aux=True)(params)
    return params, float(loss), metrics, jax.device_get(grads)


def _port(cfg, jparams, batch):
    params = convert.lm_params(jax.device_get(jparams), "cpu")
    tensors = [t for _, t in leaves(params)]
    for t in tensors:
        t.requires_grad_(True)
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    loss, metrics = lm_loss(params, tb, cfg)
    # leaves the loss does not reach (the parallel block's MLP norm, the
    # patch projection without patch inputs) get zeros, as in JAX
    grads = torch.autograd.grad(loss, tensors, allow_unused=True,
                                materialize_grads=True)
    return float(loss), metrics, [p for p, _ in leaves(params)], grads


def _jleaf(tree, path):
    for k in path:
        tree = tree[k]
    return np.asarray(jnp.asarray(tree, jnp.float32))


def _check(arch, dt, remat, loss_tol, grad_tol):
    jcfg = _jcfg(arch, dt)
    batch = _batch(jcfg.vocab_size)
    jparams, jloss, jmet, jgrads = _reference_of(arch, dt)
    loss, met, paths, grads = _port(_port_cfg(jcfg, remat=remat), jparams,
                                    batch)
    assert abs(loss - jloss) <= loss_tol * abs(jloss)
    assert float(met["tokens"]) == float(jmet["tokens"])
    assert abs(float(met["aux"]) - float(jmet["aux"])) <= loss_tol * abs(
        float(jmet["aux"]))
    for path, g in zip(paths, grads):
        want = _jleaf(jgrads, path)
        got = g.float().numpy()
        scale = float(np.abs(want).max())
        err = float(np.abs(got - want).max())
        assert err <= grad_tol * scale, (path, err, scale)


@pytest.mark.parametrize("remat", ["none", "block", "block_dots"])
@pytest.mark.parametrize("arch", SMOKE_ARCHS)
def test_lm_loss_and_grads_match_reference_fp32(arch, remat):
    _check(arch, "float32", remat, LOSS_TOL, GRAD_TOL)


@pytest.mark.parametrize("arch", BF16_ARCHS)
def test_lm_loss_and_grads_match_reference_bf16(arch):
    _check(arch, "bfloat16", "block", BF16_TOL, BF16_GRAD_TOL)


def test_remat_settings_give_the_same_loss_and_grads():
    """"none", "block" and "block_dots" recompute the same arithmetic:
    equal loss and gradients, bit for bit, on the CPU."""
    jcfg = _jcfg("qwen2.5-14b", "float32")
    batch = _batch(jcfg.vocab_size, seed=1)
    jparams = j_init_params(jax.random.PRNGKey(1), jcfg)
    runs = [_port(_port_cfg(jcfg, remat=r), jparams, batch)
            for r in ("none", "block", "block_dots")]
    for loss, _, _, grads in runs[1:]:
        assert loss == runs[0][0]
        for a, b in zip(grads, runs[0][3]):
            assert torch.equal(a, b)


def test_lm_loss_drops_the_tokens_past_the_last_whole_chunk():
    """The reference's quirk: S = 40 with 32-token chunks scores only the
    first 32 positions."""
    jcfg = _jcfg("qwen2.5-14b", "float32")
    cfg = _port_cfg(jcfg)
    batch = {k: torch.as_tensor(v) for k, v in
             _batch(jcfg.vocab_size, b=1, s=40).items()}
    params = convert.lm_params(jax.device_get(
        j_init_params(jax.random.PRNGKey(0), jcfg)), "cpu")
    loss, met = lm_loss(params, batch, cfg)
    assert float(met["tokens"]) == float(batch["loss_mask"][:, :32].sum())
    hidden, aux = forward(params, batch, cfg)
    assert hidden.shape == (1, 40, cfg.d_model) and float(aux) == 0.0


# ---------------------------------------------------------------------------
# the kernels' backward formulas against jax.vjp of the reference functions
# ---------------------------------------------------------------------------


def _rel_close(got, want, tol=GRAD_TOL):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-6)
    assert float(np.abs(got - want).max()) <= tol * scale


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hq,hkv,s", [(2, 2, 33), (4, 2, 64), (5, 1, 47)])
def test_flash_attention_plain_bwd_matches_jax_vjp(hq, hkv, s, causal):
    rng = np.random.default_rng(hq * 100 + s)
    b, d = 2, 16
    q, do = (rng.standard_normal((b, hq, s, d)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.standard_normal((b, hkv, s, d)).astype(np.float32)
            for _ in range(2))
    out, vjp = jax.vjp(lambda q_, k_, v_: jref.flash_attention(
        q_, k_, v_, causal=causal), q, k, v)
    want = vjp(jnp.asarray(do))
    tq, tk, tv, tdo = (torch.as_tensor(x) for x in (q, k, v, do))
    o, lse = fa_k.plain_with_lse(tq, tk, tv, causal)
    _rel_close(o, out, 1e-5)
    got = fa_k.plain_bwd(tq, tk, tv, o, lse, tdo, causal)
    for g, w in zip(got, want):
        _rel_close(g, w)


@pytest.mark.parametrize("b,s,di,n", [(2, 33, 8, 4), (1, 47, 12, 16),
                                      (2, 20, 6, 32), (1, 64, 5, 1)])
def test_mamba_scan_plain_bwd_matches_jax_vjp(b, s, di, n):
    rng = np.random.default_rng(s * 10 + n)
    xdt = rng.standard_normal((b, s, di)).astype(np.float32)
    dt = (np.abs(rng.standard_normal((b, s, di))) * 0.2).astype(np.float32)
    a = -np.abs(rng.standard_normal((di, n))).astype(np.float32)
    bm, cm = (rng.standard_normal((b, s, n)).astype(np.float32)
              for _ in range(2))
    dy = rng.standard_normal((b, s, di)).astype(np.float32)
    dh = rng.standard_normal((b, di, n)).astype(np.float32)
    _, vjp = jax.vjp(jref.mamba_scan, xdt, dt, a, bm, cm)
    want = vjp((jnp.asarray(dy), jnp.asarray(dh)))
    got = ms_k.plain_bwd(*(torch.as_tensor(x) for x in
                           (xdt, dt, a, bm, cm, dy, dh)))
    for g, w in zip(got, want):
        _rel_close(g, w)
    # h_final's gradient None (unused in training) is zero
    _, vjp0 = jax.vjp(jref.mamba_scan, xdt, dt, a, bm, cm)
    want0 = vjp0((jnp.asarray(dy), jnp.zeros((b, di, n), jnp.float32)))
    got0 = ms_k.plain_bwd(*(torch.as_tensor(x) for x in
                            (xdt, dt, a, bm, cm, dy)))
    for g, w in zip(got0, want0):
        _rel_close(g, w)
