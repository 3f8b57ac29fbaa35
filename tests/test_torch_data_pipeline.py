"""The port's ``data.pipeline`` against the JAX package's on the CPU:
``TokenPipeline`` batches bit-equal to the reference's with dedup on and
off (the same kept sequences, the same dedup counts), an
``IteratorState`` resume that continues the stream exactly, and the
prefetching iterator yielding the same batches. Tolerance: none, the
arrays are equal.
"""
import _torch_threads  # noqa: F401  (one torch thread a process)
import itertools

import numpy as np
import pytest

from repro.data import pipeline as jpipe
from repro_torch.data.pipeline import DataConfig, IteratorState, TokenPipeline

KEYS = ("tokens", "labels", "loss_mask")


def _take(it, n):
    return list(itertools.islice(it, n))


def _cfg(dedup, seed=0):
    return dict(vocab_size=256, seq_len=48, global_batch=8, seed=seed,
                dedup=dedup, dedup_buffer=16)


@pytest.mark.parametrize("dedup", [True, False])
def test_batches_equal_the_reference(dedup):
    ref = jpipe.TokenPipeline(jpipe.DataConfig(**_cfg(dedup)))
    port = TokenPipeline(DataConfig(**_cfg(dedup)), device="cpu")
    for a, b in zip(_take(ref.batches(), 3), _take(port.batches(), 3)):
        for k in KEYS:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
            np.testing.assert_array_equal(a[k], b[k])
    assert port.state.to_dict() == ref.state.to_dict()
    assert port.dedup_stats == ref.dedup_stats
    if dedup:
        assert port.dedup_stats["dropped"] > 0


def test_resume_from_iterator_state_continues_exactly():
    cfg = DataConfig(**_cfg(True, seed=4))
    full = _take(TokenPipeline(cfg, device="cpu").batches(), 4)
    first = TokenPipeline(cfg, device="cpu")
    _take(first.batches(), 2)
    saved = IteratorState.from_dict(first.state.to_dict())
    resumed = _take(TokenPipeline(cfg, state=saved, device="cpu").batches(),
                    2)
    for a, b in zip(full[2:], resumed):
        for k in KEYS:
            np.testing.assert_array_equal(a[k], b[k])


def test_prefetched_yields_the_batches():
    cfg = DataConfig(**_cfg(False, seed=2))
    want = _take(TokenPipeline(cfg, device="cpu").batches(), 3)
    got = _take(TokenPipeline(cfg, device="cpu").prefetched(), 3)
    for a, b in zip(want, got):
        for k in KEYS:
            np.testing.assert_array_equal(a[k], b[k])


def test_labels_shift_and_mask_the_last_position():
    b = next(TokenPipeline(DataConfig(**_cfg(False)), device="cpu")
             .batches())
    np.testing.assert_array_equal(b["labels"][:, :-1], b["tokens"][:, 1:])
    assert (b["labels"][:, -1] == 0).all()
    assert (b["loss_mask"][:, -1] == 0).all() and \
        (b["loss_mask"][:, :-1] == 1).all()
