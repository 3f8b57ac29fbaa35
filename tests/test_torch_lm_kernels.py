"""The plain versions of the port's LM kernels against the JAX package's
Pallas kernels (interpret mode on the CPU, as tests/test_kernels.py runs
them) and its references, plus the dispatch rules of the two wrappers.

Shapes are tests/test_kernels.py's cases, with ragged ones (Sq, Sk not
multiples of a block) held against ``repro.kernels.ref`` only: the JAX
``ops.flash_attention`` falls back to the reference there. fp32, atol
5e-5 (only the fp32 summation order differs).
"""
import _torch_threads  # noqa: F401  (one torch thread a process)
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models.ssm import mamba1_scan
from repro_torch.kernels import ops
from repro_torch.kernels import ref

ATOL = 5e-5


def _qkv(rng, b, hq, hkv, sq, sk, d):
    return (rng.standard_normal((b, hq, sq, d)).astype(np.float32),
            rng.standard_normal((b, hkv, sk, d)).astype(np.float32),
            rng.standard_normal((b, hkv, sk, d)).astype(np.float32))


@pytest.mark.parametrize("b,hq,hkv,sq,sk,d", [
    (2, 4, 2, 128, 128, 64),
    (1, 8, 1, 64, 64, 32),
    (2, 4, 4, 8, 128, 64),     # decode-ish: short q against long cache
    (2, 8, 2, 128, 128, 16),   # command-r-35b-smoke's head dim
])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_plain_matches_pallas(rng, b, hq, hkv, sq, sk, d,
                                              causal):
    q, k, v = _qkv(rng, b, hq, hkv, sq, sk, d)
    got = ref.flash_attention(*map(torch.from_numpy, (q, k, v)), causal)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    want_k = jops.flash_attention(jq, jk, jv, causal=causal,
                                  bq=min(64, sq), bk=64)
    want_r = jref.flash_attention(jq, jk, jv, causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_k), atol=ATOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_r), atol=ATOL)


@pytest.mark.parametrize("b,hq,hkv,sq,sk,d", [
    (1, 5, 1, 100, 100, 32),   # ragged self-attention
    (2, 6, 2, 37, 101, 16),    # ragged, Sq < Sk
    (1, 2, 2, 1, 70, 64),      # one query row
])
def test_flash_attention_plain_matches_ref_ragged(rng, b, hq, hkv, sq, sk,
                                                  d):
    q, k, v = _qkv(rng, b, hq, hkv, sq, sk, d)
    got = ops.flash_attention(*map(torch.from_numpy, (q, k, v)))
    want = jref.flash_attention(*map(jnp.asarray, (q, k, v)), causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def _emulate_kernel(q, k, v, causal, round_p, bk=64):
    """The CUDA kernels' numerics in PyTorch: 64-key tiles in order, an
    online softmax with exp2 and scale·log2(e) folded into one multiply,
    fp32 m, l and O, and P rounded to bf16 before P·V where ``round_p``
    (the bf16 tensor-core kernel; the fp32 kernel keeps P fp32)."""
    b, hq, sq, d = q.shape
    sk = k.shape[2]
    group = hq // k.shape[1]
    qf = q.float()
    kf = k.repeat_interleave(group, 1).float()
    vf = v.repeat_interleave(group, 1).float()
    c = torch.tensor(1.4426950408889634 / np.sqrt(d), dtype=torch.float32)
    m = torch.full((b, hq, sq, 1), -np.inf)
    l = torch.zeros((b, hq, sq, 1))
    o = torch.zeros((b, hq, sq, d))
    qi = torch.arange(sq)[:, None] + (sk - sq)
    for k0 in range(0, sk, bk):
        s = qf @ kf[:, :, k0:k0 + bk].transpose(-1, -2)
        if causal:
            kj = torch.arange(k0, min(k0 + bk, sk))[None, :]
            s = s.masked_fill(kj > qi, -np.inf)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True) * c)
        m_use = torch.where(m_new == -np.inf, 0.0, m_new)
        alpha = torch.exp2(m - m_use)
        p = torch.exp2(s * c - m_use)
        l = l * alpha + p.sum(-1, keepdim=True)
        if round_p:
            p = p.bfloat16().float()
        o = o * alpha + p @ vf[:, :, k0:k0 + bk]
        m = m_new
    return (o / l.clamp_min(1e-20)).to(q.dtype)


# share of max|plain| that chip_smoke.py and tests/test_torch_cuda.py allow
_KERNEL_TOL = {torch.float32: 5e-5, torch.bfloat16: 2.0 ** -7}


@pytest.mark.parametrize("b,hq,hkv,sq,sk,d,dtype,causal", [
    # chip_smoke.py's four cases with the heads cut 40/8 → 5/1 and the
    # lengths 8x: 2048², 512 × 2048, the ragged 1000², fp32 2048²
    (1, 5, 1, 256, 256, 128, torch.bfloat16, True),
    (1, 5, 1, 64, 256, 128, torch.bfloat16, True),
    (1, 5, 1, 125, 125, 128, torch.bfloat16, True),
    (1, 5, 1, 256, 256, 128, torch.float32, True),
    # the card test's non-causal case: small max|plain| against max|v|
    (2, 6, 3, 77, 77, 128, torch.bfloat16, False),
    # head dim 16 (command-r-35b-smoke's heads at chip_smoke's 2048 / 8)
    (1, 8, 2, 256, 256, 16, torch.bfloat16, True),
    (1, 8, 2, 256, 256, 16, torch.float32, True)])
def test_kernel_numerics_stay_within_the_card_tolerance(
        b, hq, hkv, sq, sk, d, dtype, causal):
    """The bf16 kernel rounds P to bf16 before P·V; by design that stays
    inside the card's unchanged 2⁻⁷·max|plain| (and the fp32 kernel's
    arithmetic inside 5e-5·max|plain|) on chip_smoke's inputs, standard
    normal q, k, v."""
    g = torch.Generator().manual_seed(11)
    q, k, v = (torch.randn(shape, generator=g).to(dtype) for shape in (
        (b, hq, sq, d), (b, hkv, sk, d), (b, hkv, sk, d)))
    want = ref.flash_attention(q, k, v, causal)
    got = _emulate_kernel(q, k, v, causal, round_p=dtype == torch.bfloat16)
    err = float((got.float() - want.float()).abs().max())
    assert err <= _KERNEL_TOL[dtype] * float(want.float().abs().max()), err


def _emulate_bwd(q, k, v, do, causal):
    """The bf16 backward kernels' numerics in PyTorch, on the emulated
    forward's bf16 output and its fp32 log-sum-exp: fp32 products of the
    bf16 inputs, P = exp2(S·scale·log2(e) − L·log2(e)), Dv = rowsum(dO ∘
    O) in fp32, P rounded to bf16 before dV = Pᵀ dO, dS = P ∘ (dP − Dv)
    rounded to bf16 before dQ = dS K and dK = dSᵀ Q, the group's q heads
    summed in fp32, each gradient rounded to bf16 once."""
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    group = hq // hkv
    scale = 1.0 / np.sqrt(d)
    log2e = 1.4426950408889634
    o = _emulate_kernel(q, k, v, causal, round_p=True)
    qf, dof, of = q.float(), do.float(), o.float()
    kx = k.repeat_interleave(group, 1).float()
    vx = v.repeat_interleave(group, 1).float()
    s = qf @ kx.transpose(-1, -2)
    keep = torch.ones((sq, sk), dtype=torch.bool)
    if causal:
        keep = torch.arange(sk)[None, :] <= torch.arange(sq)[:, None] + sk - sq
    lse = torch.logsumexp(torch.where(keep, s * scale, -np.inf), -1)
    l2 = torch.where(torch.isfinite(lse), lse * log2e, np.inf)
    p = torch.where(keep, torch.exp2(s * (scale * log2e) - l2[..., None]),
                    0.0)
    dvec = (dof * of).sum(-1, keepdim=True)
    dv = p.bfloat16().float().transpose(-1, -2) @ dof
    ds = (p * (dof @ vx.transpose(-1, -2) - dvec)).bfloat16().float()
    dq = ds @ kx * scale
    dk = ds.transpose(-1, -2) @ qf * scale
    dk = dk.reshape(b, hkv, group, sk, d).sum(2)
    dv = dv.reshape(b, hkv, group, sk, d).sum(2)
    return tuple(t.bfloat16() for t in (dq, dk, dv))


@pytest.mark.parametrize("b,hq,hkv,sq,sk,d,causal", [
    # chip_smoke.py's backward case with the heads cut 40/8 → 5/1 and the
    # lengths 2048 → 256, causal; Sq < Sk; the non-causal card case
    (1, 5, 1, 256, 256, 128, True),
    (1, 5, 1, 129, 256, 64, True),
    (2, 6, 3, 77, 77, 128, False),
    (1, 8, 2, 256, 256, 16, True)])        # head dim 16
def test_bwd_kernel_numerics_stay_within_the_card_tolerance(
        b, hq, hkv, sq, sk, d, causal):
    """The bf16 backward rounds P and dS to bf16 before their products and
    each gradient once; on chip_smoke's inputs (standard normal q, k, v,
    dO, made with numpy) that stays inside the card's 2⁻⁷·max of the
    JAX package's vjp of its reference attention, for each gradient."""
    import jax
    rng = np.random.default_rng(21)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).bfloat16() for shape in (
        (b, hq, sq, d), (b, hkv, sk, d), (b, hkv, sk, d), (b, hq, sq, d)))
    got = _emulate_bwd(q, k, v, do, causal)
    x = [jnp.asarray(t.float().numpy()) for t in (q, k, v)]
    _, vjp = jax.vjp(lambda *a: jref.flash_attention(*a, causal=causal), *x)
    want = vjp(jnp.asarray(do.float().numpy()))
    for g, w in zip(got, want):
        w = np.asarray(w)
        err = float(np.abs(g.float().numpy() - w).max())
        assert err <= _KERNEL_TOL[torch.bfloat16] * float(np.abs(w).max()), err


def _scan_inputs(rng, b, s, di, n):
    xdt = rng.standard_normal((b, s, di)).astype(np.float32)
    dt = np.abs(rng.standard_normal((b, s, di))).astype(np.float32) * 0.1
    a = -np.abs(rng.standard_normal((di, n))).astype(np.float32)
    bm = rng.standard_normal((b, s, n)).astype(np.float32)
    cm = rng.standard_normal((b, s, n)).astype(np.float32)
    return xdt, dt, a, bm, cm


@pytest.mark.parametrize("b,s,di,n,bd", [(2, 16, 8, 4, 8), (1, 33, 24, 5, 8),
                                         (3, 8, 128, 16, 128)])
def test_mamba_scan_plain_matches_pallas(rng, b, s, di, n, bd):
    args = _scan_inputs(rng, b, s, di, n)
    y, h = ops.mamba_scan(*map(torch.from_numpy, args))
    jargs = [jnp.asarray(x) for x in args]
    for want_y, want_h in (jops.mamba_scan(*jargs, bd=bd),
                           jref.mamba_scan(*jargs)):
        np.testing.assert_allclose(y.numpy(), np.asarray(want_y), atol=ATOL)
        np.testing.assert_allclose(h.numpy(), np.asarray(want_h), atol=ATOL)


def test_mamba_scan_plain_matches_model_scan(rng):
    """The kernel's function is the model's chunked associative scan."""
    b, s, di, n = 2, 32, 8, 4
    xdt, dt, a, bm, cm = _scan_inputs(rng, b, s, di, n)
    y, h = ref.mamba_scan(*map(torch.from_numpy, (xdt, dt, a, bm, cm)))
    y2, h2 = mamba1_scan(jnp.asarray(xdt), jnp.asarray(dt[..., None] * a),
                         jnp.asarray(bm), jnp.asarray(cm),
                         jnp.zeros((b, di, n)), chunk=8)
    np.testing.assert_allclose(y.numpy(), np.asarray(y2), atol=1e-4)
    np.testing.assert_allclose(h.numpy(), np.asarray(h2), atol=1e-4)


def _emulate_scan(xdt, dt, a, b, c, spt=4):
    """The CUDA scan's numerics in PyTorch: per state g = exp(dt·a) and h =
    fma(g, h, xdt·b) (the fma from one float64 rounding of the exact
    product plus xdt·b, all else fp32); y summed as the kernel sums it, the
    thread's ``spt`` states p = h·c left to right, then the halving tree
    over the channel's N / spt lanes: at N = 16, (P0 + P2) + (P1 + P3)."""
    bsz, s, di = xdt.shape
    n = a.shape[1]
    lanes = n // spt
    h = torch.zeros((bsz, di, n))
    ys = []
    for t in range(s):
        g = torch.exp(dt[:, t, :, None] * a[None])
        xb = xdt[:, t, :, None] * b[:, t, None, :]
        h = (g.double() * h.double() + xb.double()).float()
        p = h * c[:, t, None, :]
        parts = []
        for k in range(lanes):
            acc = p[..., k * spt]
            for j in range(1, spt):
                acc = acc + p[..., k * spt + j]
            parts.append(acc)
        while len(parts) > 1:
            half = len(parts) // 2
            parts = [parts[k] + parts[k + half] for k in range(half)]
        ys.append(parts[0])
    return torch.stack(ys, dim=1), h


def test_scan_kernel_y_order_stays_within_the_card_tolerance():
    """The CUDA scan sums y over the states in another order than the
    plain version (partials a lane, then a shuffle tree across lanes); on
    chip_smoke.py's inputs (A = -(1..N), a softplus-sized dt) at S = 2048
    and N = 16 that order stays inside the card's unchanged 5e-5·max|plain|
    for fp32."""
    rng = np.random.default_rng(15)
    b, s, di, n = 1, 2048, 64, 16
    xdt = torch.from_numpy(rng.standard_normal((b, s, di)).astype(np.float32))
    dt = torch.nn.functional.softplus(torch.from_numpy(
        rng.standard_normal((b, s, di)).astype(np.float32)) - 4.6)
    a = -torch.arange(1, n + 1, dtype=torch.float32).expand(di, n)
    bm, cm = (torch.from_numpy(rng.standard_normal((b, s, n))
                               .astype(np.float32)) for _ in range(2))
    want_y, want_h = ref.mamba_scan(xdt, dt, a, bm, cm)
    got_y, got_h = _emulate_scan(xdt, dt, a, bm, cm)
    err = float((got_y - want_y).abs().max())
    assert err <= _KERNEL_TOL[torch.float32] * float(want_y.abs().max()), err
    np.testing.assert_allclose(got_h.numpy(), want_h.numpy(), atol=ATOL)


def _fma(x, y, z):
    """fp32 fma: one rounding of the exact x·y + z (float64 holds it)."""
    return (x.double() * y.double() + z.double()).float()


def _lane_tree(x):
    """The backward's butterfly over the 8 lanes of a channel (the last
    axis, one value a lane): ((x0 + x4) + (x2 + x6)) + ((x1 + x5) + (x3 +
    x7))."""
    x = x[..., :4] + x[..., 4:]
    x = x[..., :2] + x[..., 2:]
    return x[..., 0] + x[..., 1]


def _channel_sum(v, warps=16, per_warp=4):
    """dB / dC's order over the channels (axis 1): a warp's 4 channels in
    its butterfly, (v0 + v2) + (v1 + v3); the 64-channel CTA's 16 warps in
    order; then the CTAs' partials in order from 0, as the sum kernel adds
    them."""
    bsz, di, n = v.shape
    w = v.reshape(bsz, di // (warps * per_warp), warps, per_warp, n)
    w = (w[:, :, :, 0] + w[:, :, :, 2]) + (w[:, :, :, 1] + w[:, :, :, 3])
    acc = w[:, :, 0]
    for i in range(1, warps):
        acc = acc + w[:, :, i]
    total = torch.zeros((bsz, n))
    for i in range(acc.shape[1]):
        total = total + acc[:, i]
    return total


def _emulate_scan_bwd(xdt, dt, a, b, c, dy):
    """The backward kernel's numerics at N = 16 in PyTorch: the forward's
    states, the adjoint's fmas and products as the kernel rounds them, a
    thread's 2 states summed by an fma chain and the channel's 8 lanes by
    ``_lane_tree`` (dxdt, ddt), dB / dC in ``_channel_sum``'s order, da an
    fma chain over time a batch row, then the rows in order."""
    bsz, s, di = xdt.shape
    h = torch.zeros((bsz, di, a.shape[1]))
    hs = []
    for t in range(s):
        g = torch.exp(dt[:, t, :, None] * a)
        h = _fma(g, h, xdt[:, t, :, None] * b[:, t, None, :])
        hs.append(h)
    lam = torch.zeros_like(h)
    dak = torch.zeros_like(h)
    dx, ddt = torch.zeros_like(xdt), torch.zeros_like(xdt)
    db, dc = torch.zeros_like(b), torch.zeros_like(c)
    zero = torch.zeros((bsz, di, 8))
    for t in reversed(range(s)):
        lam = _fma(dy[:, t, :, None], c[:, t, None, :], lam)
        hprev = hs[t - 1] if t else torch.zeros_like(h)
        g = torch.exp(dt[:, t, :, None] * a)
        dg = (lam * hprev) * g
        bt = b[:, t, None, :].expand_as(lam)
        sx = _fma(lam[..., 1::2], bt[..., 1::2],
                  _fma(lam[..., 0::2], bt[..., 0::2], zero))
        st = _fma(dg[..., 1::2], a[None, :, 1::2].expand_as(sx),
                  _fma(dg[..., 0::2], a[None, :, 0::2].expand_as(sx), zero))
        dx[:, t], ddt[:, t] = _lane_tree(sx), _lane_tree(st)
        dak = _fma(dg, dt[:, t, :, None].expand_as(dg), dak)
        db[:, t] = _channel_sum(lam * xdt[:, t, :, None])
        dc[:, t] = _channel_sum(dy[:, t, :, None] * hs[t])
        lam = g * lam
    da = torch.zeros_like(a)
    for i in range(bsz):
        da = da + dak[i]
    return dx, ddt, da, db, dc


def test_scan_bwd_summation_order_stays_within_the_card_tolerance():
    """The backward kernel sums dxdt / ddt over a channel's lanes, dB / dC
    over the channels (a warp's butterfly, the CTA's warps, the CTAs) and
    da over time and the batch in other orders than ``plain_bwd``; on
    chip_smoke.py's inputs (A = −(1..N), a softplus-sized dt, made with
    numpy) at the training microbatch's B = 2 and N = 16, four CTAs of 64
    channels and 256 steps, every gradient stays inside the card's
    5e-5·max|plain|."""
    rng = np.random.default_rng(22)
    b, s, di, n = 2, 256, 256, 16
    xdt, dy = (torch.from_numpy(rng.standard_normal((b, s, di)).astype(
        np.float32)) for _ in range(2))
    dt = torch.nn.functional.softplus(torch.from_numpy(
        rng.standard_normal((b, s, di)).astype(np.float32)) - 4.6)
    a = -torch.arange(1, n + 1, dtype=torch.float32).expand(di, n)
    bm, cm = (torch.from_numpy(rng.standard_normal((b, s, n)).astype(
        np.float32)) for _ in range(2))
    got = _emulate_scan_bwd(xdt, dt, a, bm, cm, dy)
    want = ref.mamba_scan_bwd(xdt, dt, a, bm, cm, dy)
    for g, w, name in zip(got, want, ("dxdt", "ddt", "da", "db", "dc")):
        err = float((g - w).abs().max())
        assert err <= _KERNEL_TOL[torch.float32] * float(w.abs().max()), \
            (name, err)


def test_bf16_inputs_keep_their_dtype_on_the_plain_path(rng):
    q, k, v = (torch.from_numpy(x).bfloat16()
               for x in _qkv(rng, 1, 4, 2, 9, 9, 32))
    assert ops.flash_attention(q, k, v).dtype == torch.bfloat16
    xdt, dt, a, bm, cm = map(torch.from_numpy, _scan_inputs(rng, 1, 5, 8, 4))
    y, h = ops.mamba_scan(xdt.bfloat16(), dt.bfloat16(), a, bm.bfloat16(),
                          cm.bfloat16())
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32


@pytest.mark.parametrize("case", ["dtypes", "heads", "last_dim", "scan_a",
                                  "scan_bc", "scan_dtypes"])
def test_lm_wrappers_reject_bad_inputs(rng, case):
    q = torch.zeros((1, 4, 8, 32))
    kv = torch.zeros((1, 2, 8, 32))
    xdt = torch.zeros((1, 5, 8))
    a = torch.zeros((8, 4))
    bc = torch.zeros((1, 5, 4))
    with pytest.raises(ValueError):
        if case == "dtypes":
            ops.flash_attention(q, kv.bfloat16(), kv.bfloat16())
        elif case == "heads":
            ops.flash_attention(q, torch.zeros((1, 3, 8, 32)),
                                torch.zeros((1, 3, 8, 32)))
        elif case == "last_dim":
            ops.flash_attention(q.transpose(2, 3), kv, kv)
        elif case == "scan_a":
            ops.mamba_scan(xdt, xdt, a.double(), bc, bc)
        elif case == "scan_bc":
            ops.mamba_scan(xdt, xdt, a, bc, torch.zeros((1, 5, 3)))
        else:
            ops.mamba_scan(xdt, xdt.bfloat16(), a, bc, bc)
