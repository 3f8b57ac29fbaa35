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
