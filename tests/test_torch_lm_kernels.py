"""The plain versions of the port's LM kernels against the JAX package's
Pallas kernels (interpret mode on the CPU, as tests/test_kernels.py runs
them) and its references, plus the dispatch rules of the two wrappers.

Shapes are tests/test_kernels.py's cases, with ragged ones (Sq, Sk not
multiples of a block) held against ``repro.kernels.ref`` only: the JAX
``ops.flash_attention`` falls back to the reference there. fp32, atol
5e-5 (only the fp32 summation order differs).
"""
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
    (2, 6, 3, 77, 77, 128, torch.bfloat16, False)])
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
