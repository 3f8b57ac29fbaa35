"""repro_torch's corpus deduplication against the JAX package on the CPU:
shingle fingerprints bit-exact, and ``find_duplicates`` (shingles → the
port's offline search → exact Jaccard verify) with the same keep mask and
the same stats on the inputs of tests/test_data.py.
"""
import _torch_threads  # noqa: F401  (one torch thread a process)
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import dedup as jdedup
from repro_torch.core.lsh import LSHConfig
from repro_torch.data import dedup as tdedup
from repro_torch.kernels import ops


def _cfgs(**kw):
    jc = jdedup.DedupConfig(**kw)
    tc = tdedup.DedupConfig(**{
        **kw, "lsh": LSHConfig(**dataclasses.asdict(jc.lsh))})
    return jc, tc


def _injected(rng):
    """tests/test_data.py: an exact and a near duplicate among 24 docs."""
    n, s = 24, 128
    docs = rng.integers(1, 1000, (n, s)).astype(np.int32)
    docs[20] = docs[3]
    docs[21] = docs[5].copy()
    docs[21, ::37] = 7
    return docs


def _distinct(rng):
    return rng.integers(1, 10_000, (16, 128)).astype(np.int32)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("kw", [{}, dict(shingle=3, feature_dim=256)])
def test_shingle_fingerprints_bit_exact(seed, kw):
    rng = np.random.default_rng(seed)
    docs = rng.integers(0, 2**31 - 1, (5, 64)).astype(np.int32)
    jc, tc = _cfgs(**kw)
    np.testing.assert_array_equal(
        tdedup.shingle_fingerprints(torch.from_numpy(docs), tc).numpy(),
        np.asarray(jdedup.shingle_fingerprints(jnp.asarray(docs), jc)))


@pytest.mark.parametrize("make", [_injected, _distinct])
def test_find_duplicates_equals_reference(rng, make):
    docs = make(rng)
    ops.reset_launches()
    keep, stats = tdedup.find_duplicates(docs, device="cpu")
    assert sum(ops.LAUNCHES.values()) == 0
    want_keep, want_stats = jdedup.find_duplicates(docs)
    np.testing.assert_array_equal(keep, want_keep)
    assert stats == want_stats
    if make is _injected:
        assert not keep[20] and not keep[21] and keep[3] and keep[5]


def test_find_duplicates_with_a_looser_threshold(rng):
    docs = _injected(rng)
    docs[10] = docs[2]
    docs[10, ::5] = 9                     # Jaccard well under 0.5
    jc, tc = _cfgs(jaccard_threshold=0.2)
    keep, stats = tdedup.find_duplicates(torch.from_numpy(docs), tc)
    want_keep, want_stats = jdedup.find_duplicates(docs, jc)
    np.testing.assert_array_equal(keep, want_keep)
    assert stats == want_stats


def test_find_duplicates_defaults_to_cuda(monkeypatch, rng):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdedup.find_duplicates(_distinct(rng))


def test_dedup_config_matches_reference():
    jc, tc = jdedup.DedupConfig(), tdedup.DedupConfig()
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
