"""``ops.jaccard_popcount`` with its callers' valid mask and ring modulo
folded in, on the CPU (its plain version), bit-exact:

- against the chain it replaces (mask the ids, reduce them modulo the
  ring, score every slot, mask the scores);
- through ``stream.index.verify_pairs`` and ``core.lsh.verify_jaccard``
  against the JAX package's functions of the same name, on seeded rings
  with empty unions, ids not reduced (negative ones too) and garbage ids
  in invalid slots, for every valid pattern;
- its plan (16-byte or 4-byte loads, lanes a pair, loads a lane) against
  what ``csrc/jaccard_popcount.cu`` instantiates, and its input checks.
"""
import _torch_threads  # noqa: F401  (one torch thread a process)
import re
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import lsh as jlsh
from repro.stream import index as jidx
from repro_torch import utils as tu
from repro_torch.core import lsh as tlsh
from repro_torch.kernels import _build
from repro_torch.kernels import jaccard_popcount as jac_k
from repro_torch.kernels import ops
from repro_torch.stream import index as tidx

WIDTHS = (1, 3, 32, 33, 256)
SLOTS = (0, 1, 33, 4096)
PATTERNS = ("all", "none", "prefix", "scattered")
RING = 50


def _ring(rng, s: int, ring: int, w: int) -> np.ndarray:
    """(s, ring, w) uint32 words, sparse enough that unions vary, with
    the last two rows of each station empty."""
    pk = (rng.integers(0, 2**32, (s, ring, w), dtype=np.uint32)
          & rng.integers(0, 2**32, (s, ring, w), dtype=np.uint32))
    pk[:, -2:] = 0
    return pk


def _slots(rng, s: int, m: int, ring: int, pattern: str):
    """(s, m) ids and valid flags: valid ids anywhere in [-2P, 5P) (not
    reduced, negative ones too), some pairs on the empty rows and some of
    a row with itself; invalid slots hold ids far out of range."""
    i1 = rng.integers(-2 * ring, 5 * ring, (s, m)).astype(np.int32)
    i2 = rng.integers(-2 * ring, 5 * ring, (s, m)).astype(np.int32)
    if m:
        i1[:, 0], i2[:, 0] = ring - 1, 2 * ring - 2      # empty union
        i1[:, m // 2], i2[:, m // 2] = 7 + ring, 7 - 2 * ring  # row 7 twice
    if pattern == "all":
        valid = np.ones((s, m), bool)
    elif pattern == "none":
        valid = np.zeros((s, m), bool)
    elif pattern == "prefix":
        valid = np.arange(m)[None, :] < np.array([[m // 3], [m - 1]])[:s]
    else:
        valid = rng.random((s, m)) < 0.4
    junk = rng.integers(-2**31, 2**31 - 1, (2, s, m)).astype(np.int32)
    i1 = np.where(valid, i1, junk[0])
    i2 = np.where(valid, i2, junk[1])
    return i1, i2, valid


def _old_chain(pk: torch.Tensor, i1: torch.Tensor, i2: torch.Tensor,
               valid: torch.Tensor) -> torch.Tensor:
    """What ``verify_pairs`` did around the kernel before the kernel took
    the mask and the modulo: ids masked and reduced, every slot scored as
    the earlier plain version scored it, scores masked."""
    ring = pk.shape[1]
    zero = torch.zeros_like(i1)
    a = torch.where(valid, i1, zero) % ring
    b = torch.where(valid, i2, zero) % ring
    s = torch.arange(pk.shape[0])[:, None]
    ra, rb = pk[s, a.long()], pk[s, b.long()]
    inter = tu.popcount(ra & rb).sum(dim=-1)
    union = tu.popcount(ra | rb).sum(dim=-1)
    jac = inter.to(torch.float32) / union.clamp(min=1).to(torch.float32)
    jac = torch.where(union > 0, jac, torch.zeros_like(jac))
    return torch.where(valid, jac, torch.zeros_like(jac))


def _torch(pk: np.ndarray, *arrays):
    return (torch.from_numpy(np.ascontiguousarray(pk).view(np.int32)),
            *(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays))


@pytest.mark.parametrize("pattern", PATTERNS)
@pytest.mark.parametrize("w", WIDTHS)
def test_plain_equals_the_chain_it_replaces(w, pattern):
    rng = np.random.default_rng(w)
    pk, i1, i2, valid = _torch(_ring(rng, 2, RING, w),
                               *_slots(rng, 2, 4096, RING, pattern))
    got = ops.jaccard_popcount(pk, i1, i2, valid)
    assert got.dtype == torch.float32 and got.shape == (2, 4096)
    assert torch.equal(got, _old_chain(pk, i1, i2, valid))
    if pattern == "all":
        assert torch.equal(ops.jaccard_popcount(pk, i1, i2), got)
        assert float(got[0, 0]) == 0.0 and float(got[0, 2048]) == 1.0
    assert not bool(got[~valid].any())


@pytest.mark.parametrize("pattern", PATTERNS)
@pytest.mark.parametrize("m", SLOTS)
@pytest.mark.parametrize("w", WIDTHS)
def test_verify_pairs_equals_reference(w, m, pattern):
    """Two stations through the port's station axis against the JAX
    ``verify_pairs`` of each station's ring."""
    rng = np.random.default_rng(1000 * w + m)
    pk = _ring(rng, 2, RING, w)
    i1, i2, valid = _slots(rng, 2, m, RING, pattern)
    sim = rng.integers(0, 9, (2, m)).astype(np.int32)
    tpk, ti1, ti2, tvalid, tsim = _torch(pk, i1, i2, valid, sim)
    got = tidx.verify_pairs(types.SimpleNamespace(pk=tpk),
                            tlsh.Pairs(ti1, ti2, tsim, tvalid))
    for st in range(2):
        want = jidx.verify_pairs(
            types.SimpleNamespace(pk=jnp.asarray(pk[st])),
            jlsh.Pairs(*(jnp.asarray(a[st]) for a in (i1, i2, sim, valid))))
        np.testing.assert_array_equal(got[st].numpy(), np.asarray(want))
    assert ops.LAUNCHES["jaccard_popcount"] == 0


@pytest.mark.parametrize("pattern", PATTERNS)
@pytest.mark.parametrize("m", SLOTS)
@pytest.mark.parametrize("w", WIDTHS)
def test_verify_jaccard_equals_reference(w, m, pattern):
    """The offline verify: ids of valid pairs in [0, N) (the reference
    takes no modulo there), garbage ids elsewhere."""
    rng = np.random.default_rng(2000 * w + m)
    n = RING
    packed = _ring(rng, 1, n, w)[0]
    i1, i2, valid = _slots(rng, 1, m, n, pattern)
    i1 = np.where(valid, np.mod(i1, n), i1)[0]
    i2 = np.where(valid, np.mod(i2, n), i2)[0]
    valid, sim = valid[0], np.zeros(m, np.int32)
    tpk, ti1, ti2, tvalid, tsim = _torch(packed, i1, i2, valid, sim)
    got = tlsh.verify_jaccard(tpk, tlsh.Pairs(ti1, ti2, tsim, tvalid))
    want = jlsh.verify_jaccard(
        jnp.asarray(packed),
        jlsh.Pairs(*(jnp.asarray(a) for a in (i1, i2, sim, valid))))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _instantiated() -> tuple[set, set]:
    """The lanes and loads that csrc/jaccard_popcount.cu's dispatch
    instantiates (its `case` labels)."""
    text = (_build.SRC_DIR / "jaccard_popcount.cu").read_text()
    body = {fn: text[text.index(f"int {fn}("):] for fn in
            ("launch_lanes", "launch_nv")}
    cases = {fn: {int(c) for c in re.findall(
        r"case (\d+):", b[:b.index("default")])} for fn, b in body.items()}
    return cases["launch_lanes"], cases["launch_nv"]


@pytest.mark.parametrize("aligned", [True, False])
def test_plan_stays_within_the_kernels_instantiations(aligned):
    lanes_ok, loads_ok = _instantiated()
    for w in range(0, 1100):
        p = jac_k.plan(w, 4096 if aligned else 4100)
        assert p.vector == (aligned and w % 4 == 0)
        assert p.lanes in lanes_ok and p.loads in loads_ok
        elems = w // 4 if p.vector else w
        assert p.lanes <= (jac_k.VECTOR_LANES if p.vector
                           else jac_k.SCALAR_LANES)
        # one round covers the row unless it needs more than MAX_LOADS
        if elems > p.lanes * p.loads:
            assert p.loads == jac_k.MAX_LOADS


@pytest.mark.parametrize("w,addr,want", [
    (256, 0, (True, 16, 4)),       # the paper's rows: 64 vectors, 16 lanes
    (32, 256, (True, 8, 1)),       # the smoke config's rows
    (256, 4, (False, 32, 8)),      # a view off 16 bytes: 4-byte words
    (33, 0, (False, 32, 2)), (257, 0, (False, 32, 8)),
    (3, 0, (False, 4, 1)), (1, 0, (False, 4, 1)), (512, 0, (True, 16, 8))])
def test_plan_at_the_paths_widths(w, addr, want):
    p = jac_k.plan(w, addr)
    assert (p.vector, p.lanes, p.loads) == want


@pytest.mark.parametrize("case", ["int64_ids", "valid_dtype", "valid_shape",
                                  "ids_shape", "empty_ring"])
def test_jaccard_popcount_rejects_bad_inputs(case):
    pk = torch.zeros((2, 5, 4), dtype=torch.int32)
    i1 = torch.zeros((2, 3), dtype=torch.int32)
    valid = torch.ones((2, 3), dtype=torch.bool)
    args = {"int64_ids": (pk, i1.long(), i1, valid),
            "valid_dtype": (pk, i1, i1, valid.to(torch.uint8)),
            "valid_shape": (pk, i1, i1, valid[:, :2].contiguous()),
            "ids_shape": (pk, i1[:1].contiguous(), i1[:1].contiguous(),
                          None),
            "empty_ring": (pk[:, :0].contiguous(), i1, i1, None)}[case]
    with pytest.raises(ValueError):
        ops.jaccard_popcount(*args)
