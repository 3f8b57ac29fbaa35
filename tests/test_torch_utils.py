"""repro_torch.utils against repro.utils: bit-exact on random inputs and on
the uint32 edges 0 and 2**32 - 1; the tree sizes on every arch's smoke
parameters."""
import _torch_threads  # noqa: F401  (one torch thread a process)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import utils as ju
from repro.models import decoder as jdecoder
from repro_torch import configs as tconfigs
from repro_torch import utils as tu
from repro_torch.models import decoder as tdecoder

EDGES = np.array([0, 1, 2**31 - 1, 2**31, 2**32 - 2, 2**32 - 1], np.uint32)


def _u32(rng, n=4096):
    return np.concatenate([EDGES, rng.integers(0, 2**32, n, dtype=np.uint32)])


def _same(port: torch.Tensor, ref) -> None:
    np.testing.assert_array_equal(port.numpy().astype(np.int64),
                                  np.asarray(ref).astype(np.int64))


def test_mix32_bit_exact(rng):
    x = _u32(rng)
    _same(tu.mix32(torch.from_numpy(x.astype(np.int64))),
          ju.mix32(jnp.asarray(x)))


@pytest.mark.parametrize("seed", [0, 1234, 1234 ^ 0xABCD, 2**32 - 1])
def test_hash_u32_bit_exact(rng, seed):
    x = _u32(rng)
    _same(tu.hash_u32(torch.from_numpy(x.astype(np.int64)), seed),
          ju.hash_u32(jnp.asarray(x), seed))


def test_hash_combine_bit_exact(rng):
    a, b = _u32(rng), _u32(rng)[::-1].copy()
    _same(tu.hash_combine(torch.from_numpy(a.astype(np.int64)),
                          torch.from_numpy(b.astype(np.int64))),
          ju.hash_combine(jnp.asarray(a), jnp.asarray(b)))


@pytest.mark.parametrize("axis", [0, 1, -1])
def test_fold_hashes_bit_exact(rng, axis):
    h = rng.integers(0, 2**32, (7, 5, 4), dtype=np.uint32)
    h[0, 0] = EDGES[:4]
    _same(tu.fold_hashes(torch.from_numpy(h.astype(np.int64)), dim=axis),
          ju.fold_hashes(jnp.asarray(h), axis=axis))


def test_int32_views_round_trip(rng):
    x = _u32(rng)
    bits = tu.to_i32_bits(torch.from_numpy(x.astype(np.int64)))
    np.testing.assert_array_equal(bits.numpy().view(np.uint32), x)
    _same(tu.to_u32(bits), x)


@pytest.mark.parametrize("d", [32, 96, 1024])
def test_pack_unpack_bit_exact(rng, d):
    bits = rng.random((5, d)) < 0.3
    bits[0] = True
    bits[1] = False
    packed = tu.pack_bits(torch.from_numpy(bits))
    ref = np.asarray(ju.pack_bits(jnp.asarray(bits)))
    np.testing.assert_array_equal(packed.numpy().view(np.uint32), ref)
    np.testing.assert_array_equal(tu.unpack_bits(packed, d).numpy(),
                                  np.asarray(ju.unpack_bits(jnp.asarray(ref),
                                                            d)))


def test_popcount_bit_exact(rng):
    x = _u32(rng)
    _same(tu.popcount(torch.from_numpy(x.view(np.int32))),
          ju.popcount(jnp.asarray(x)))


@pytest.mark.parametrize("name", ["segment_starts", "run_lengths",
                                  "rank_in_run", "segment_ids"])
def test_segment_helpers_bit_exact(rng, name):
    keys = np.sort(rng.integers(0, 40, 300)).astype(np.int32)
    kt, kj = torch.from_numpy(keys), jnp.asarray(keys)
    if name == "segment_starts":
        got, want = [tu.segment_starts(kt)], [ju.segment_starts(kj)]
    elif name == "segment_ids":
        got = [tu.segment_ids_from_starts(tu.segment_starts(kt))]
        want = [ju.segment_ids_from_starts(ju.segment_starts(kj))]
    elif name == "run_lengths":
        got, want = tu.run_lengths(kt), ju.run_lengths(kj)
    else:
        got, want = [tu.rank_in_run(kt)], [jax.jit(ju.rank_in_run)(kj)]
    for g, w in zip(got, want):
        _same(g, w)


def test_segment_helpers_batch_over_leading_axis(rng):
    keys = np.sort(rng.integers(0, 9, (3, 50)), axis=-1).astype(np.int32)
    kt = torch.from_numpy(keys)
    rank, (seg, lens) = tu.rank_in_run(kt), tu.run_lengths(kt)
    for r in range(3):
        assert torch.equal(rank[r], tu.rank_in_run(kt[r]))
        assert torch.equal(seg[r], tu.run_lengths(kt[r])[0])
        assert torch.equal(lens[r], tu.run_lengths(kt[r])[1])


def test_lex_key_sorts_like_lax_sort(rng):
    inv = np.int32(2**31 - 1)
    k1 = rng.integers(-5, 5, 500).astype(np.int32)
    k2 = rng.integers(-2**31, 2**31 - 1, 500).astype(np.int32)
    k1[::7] = inv
    k2[::11] = inv
    k2[::13] = -2**31
    order = torch.sort(tu.lex_key(torch.from_numpy(k1), torch.from_numpy(k2)),
                       stable=True).indices.numpy()
    s1, s2 = jax.lax.sort((jnp.asarray(k1), jnp.asarray(k2)), num_keys=2)
    np.testing.assert_array_equal(k1[order], np.asarray(s1))
    np.testing.assert_array_equal(k2[order], np.asarray(s2))


@pytest.mark.parametrize("a,b", [(0, 8), (1, 8), (8, 8), (9, 8), (255, 128)])
def test_cdiv_round_up(a, b):
    assert tu.cdiv(a, b) == ju.cdiv(a, b)
    assert tu.round_up(a, b) == ju.round_up(a, b)


def test_tree_bytes_reference_case():
    """The reference's ``tests/test_utils_props.py`` case, in tensors."""
    tree = {"a": torch.zeros((4, 4), dtype=torch.float32),
            "b": torch.zeros(3, dtype=torch.int8)}
    assert tu.tree_bytes(tree) == ju.tree_bytes(
        {"a": np.zeros((4, 4), np.float32), "b": np.zeros(3, np.int8)})
    assert tu.tree_bytes(tree) == 64 + 3
    assert tu.tree_param_count(tree) == 19


@pytest.mark.parametrize("arch", tconfigs.LM_ARCHS)
def test_tree_bytes_and_param_count_of_every_smoke_model(arch):
    """Equal to the reference's on each arch's smoke ``init_params``: the
    port's tensors, their meta copies and the reference's shapes."""
    shapes = jax.eval_shape(
        lambda k: jdecoder.init_params(k, jconfigs.get_smoke_config(arch)),
        jax.random.PRNGKey(0))
    params = tdecoder.init_params(tconfigs.get_smoke_config(arch), 0, "cpu")
    meta = tu.tree_map(lambda t: t.to("meta"), params)
    for tree in (params, meta):
        assert tu.tree_bytes(tree) == ju.tree_bytes(shapes)
        assert tu.tree_param_count(tree) == ju.tree_param_count(shapes)
