"""The plain PyTorch versions of the port's kernels against the JAX
package's Pallas kernels (run in interpret mode on the CPU, as
tests/test_kernels.py runs them), plus the dispatch rules of
repro_torch.kernels.ops: a CPU tensor takes the plain version and leaves
the launch counter alone; bad inputs raise; a missing nvcc raises.

Float kernels: rtol 1e-5 and atol 1e-5 * max|x| (only the fp32 summation
order differs). Integer kernels: bit-exact.
"""
import _torch_threads  # noqa: F401  (one torch thread a process)
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.core.fingerprint import frame
from repro.core.lsh import bucket_salts as j_bucket_salts
from repro.kernels import ops as jops
from repro.kernels.ref import dft_matrices
from repro.utils import pack_bits as j_pack_bits
from repro_torch import utils as tu
from repro_torch.kernels import _build
from repro_torch.kernels import ops
from repro_torch.kernels import ref


def _close(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()))


@pytest.mark.parametrize("rows,n,frame_len,hop,lo,hi", [
    (2, 1200, 64, 16, 3, 15),      # block-multiple frames
    (3, 777, 50, 7, 1, 10),        # ragged: frames not a multiple of 8
])
def test_stft_mag_plain_matches_pallas(rng, rows, n, frame_len, hop, lo, hi):
    wave = rng.standard_normal((rows, n)).astype(np.float32)
    window = np.hanning(frame_len).astype(np.float32)
    dr, di = dft_matrices(frame_len, frame_len // 2 + 1)
    dr, di = np.ascontiguousarray(dr[:, lo:hi]), np.ascontiguousarray(
        di[:, lo:hi])
    got = ref.stft_mag(torch.from_numpy(wave), torch.from_numpy(window),
                       torch.from_numpy(dr), torch.from_numpy(di), hop)
    for r in range(rows):
        want = jops.stft_mag(frame(jnp.asarray(wave[r]), frame_len, hop),
                             jnp.asarray(window), jnp.asarray(dr),
                             jnp.asarray(di), use_pallas=True)
        _close(got[r], want)


@pytest.mark.parametrize("n,h,w", [(8, 16, 32), (5, 8, 8)])
def test_haar2d_plain_matches_pallas(rng, n, h, w):
    imgs = rng.standard_normal((n, h, w)).astype(np.float32)
    th, tw, _ = ops.haar_mats(h, w, "cpu")
    _close(ref.haar2d(torch.from_numpy(imgs), th, tw),
           jops.haar2d(jnp.asarray(imgs), use_pallas=True))


@pytest.mark.parametrize("n,d,t,f,use_minmax,n_buckets", [
    (16, 256, 8, 2, True, 64),
    (13, 320, 12, 3, True, 128),   # ragged rows, dims and tables
    (9, 128, 5, 2, False, 32),     # baseline MinHash fold
])
def test_minmax_sig_buckets_plain_matches_pallas(rng, n, d, t, f,
                                                 use_minmax, n_buckets):
    bits = rng.random((n, d)) < 0.1
    bits[0] = False                         # empty row: min 2^31-1, max 0
    bits[1] = True
    mappings = rng.integers(0, 2**31 - 1, (d, t * f), dtype=np.int32)
    salts = np.array(j_bucket_salts(t, 77))
    want_sig, want_bkt = jops.minmax_sig_buckets(
        jnp.asarray(bits), jnp.asarray(mappings), jnp.asarray(salts),
        use_minmax=use_minmax, n_buckets=n_buckets)
    sig, bkt = ref.minmax_sig_buckets(
        tu.pack_bits(torch.from_numpy(bits)), torch.from_numpy(mappings),
        torch.from_numpy(salts.view(np.int32)), f, use_minmax, n_buckets)
    np.testing.assert_array_equal(sig.numpy().view(np.uint32),
                                  np.asarray(want_sig))
    np.testing.assert_array_equal(bkt.numpy(), np.asarray(want_bkt))


def test_minmax_planes_match_reference(rng):
    from repro.kernels import ref as jref
    bits = rng.random((11, 192)) < 0.2
    bits[3] = False
    mappings = rng.integers(0, 2**31 - 1, (192, 40), dtype=np.int32)
    mins, maxs = ref.minmax_hash(torch.from_numpy(bits),
                                 torch.from_numpy(mappings))
    jmins, jmaxs = jref.minmax_hash(jnp.asarray(bits), jnp.asarray(mappings))
    np.testing.assert_array_equal(mins.numpy(), np.asarray(jmins))
    np.testing.assert_array_equal(maxs.numpy(), np.asarray(jmaxs))


@pytest.mark.parametrize("ring,words,m", [(40, 8, 64), (17, 3, 29)])
def test_jaccard_popcount_plain_matches_pallas(rng, ring, words, m):
    pk = rng.integers(0, 2**32, (ring, words), dtype=np.uint32)
    pk[-1] = 0
    pk[-2] = 0
    i1 = rng.integers(0, ring, m)
    i2 = rng.integers(0, ring, m)
    i1[:3], i2[:3] = ring - 1, ring - 2      # empty unions score 0
    i2[3] = i1[3]                            # identical rows score 1
    want = jops.jaccard_popcount(jnp.asarray(pk[i1]), jnp.asarray(pk[i2]),
                                 use_pallas=True)
    got = ref.jaccard_popcount(torch.from_numpy(pk.view(np.int32))[None],
                               torch.from_numpy(i1)[None],
                               torch.from_numpy(i2)[None])
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want))
    assert float(got[0, 0]) == 0.0 and float(got[0, 3]) == 1.0


def _wrapper_inputs(rng):
    wave = torch.from_numpy(rng.standard_normal((2, 400)).astype(np.float32))
    window = torch.from_numpy(np.hanning(40).astype(np.float32))
    dr, di = (torch.from_numpy(np.ascontiguousarray(m[:, 2:9]))
              for m in dft_matrices(40, 21))
    imgs = torch.from_numpy(rng.standard_normal((3, 8, 16))
                            .astype(np.float32))
    bits = torch.from_numpy(rng.random((6, 64)) < 0.2)
    mappings = torch.from_numpy(rng.integers(0, 2**31 - 1, (64, 8),
                                             dtype=np.int32))
    salts = torch.from_numpy(np.array(j_bucket_salts(4, 3)).view(np.int32))
    pk = tu.pack_bits(bits)[None]
    idx = torch.from_numpy(rng.integers(0, 6, (1, 10)).astype(np.int32))
    q = torch.from_numpy(rng.standard_normal((1, 4, 9, 32))
                         .astype(np.float32))
    kv = torch.from_numpy(rng.standard_normal((1, 2, 9, 32))
                          .astype(np.float32))
    scan = [torch.from_numpy(rng.standard_normal(shp).astype(np.float32))
            for shp in ((1, 6, 8), (1, 6, 8), (8, 4), (1, 6, 4), (1, 6, 4))]
    o, lse = ref.flash_attention_with_lse(q, kv, kv)
    return {
        "stft_mag": (lambda: ops.stft_mag(wave, window, dr, di, 5),
                     lambda: ref.stft_mag(wave, window, dr, di, 5)),
        "haar2d": (lambda: ops.haar2d(imgs), lambda: ref.haar2d(
            imgs, *ops.haar_mats(8, 16, "cpu")[:2])),
        "minmax_hash": (
            lambda: ops.minmax_hash(tu.pack_bits(bits), mappings),
            lambda: ref.minmax_hash(bits, mappings)),
        "minmax_sig_buckets": (
            lambda: ops.minmax_sig_buckets(tu.pack_bits(bits), mappings,
                                           salts, use_minmax=True,
                                           n_buckets=16),
            lambda: ref.minmax_sig_buckets(tu.pack_bits(bits), mappings,
                                           salts, 2, True, 16)),
        "jaccard_popcount": (lambda: ops.jaccard_popcount(pk, idx, idx.flip(1)),
                             lambda: ref.jaccard_popcount(pk, idx,
                                                          idx.flip(1))),
        "flash_attention": (lambda: ops.flash_attention(q, kv, kv),
                            lambda: ref.flash_attention(q, kv, kv)),
        "mamba_scan": (lambda: ops.mamba_scan(*scan),
                       lambda: ref.mamba_scan(*scan)),
        "flash_attention_bwd": (
            lambda: ops.flash_attention_bwd(q, kv, kv, o, lse, q),
            lambda: ref.flash_attention_bwd(q, kv, kv, o, lse, q)),
        "mamba_scan_bwd": (lambda: ops.mamba_scan_bwd(*scan, scan[0]),
                           lambda: ref.mamba_scan_bwd(*scan, scan[0])),
    }


@pytest.mark.parametrize("name", sorted(ops.LAUNCHES))
def test_cpu_tensor_takes_plain_version_without_counting(rng, name):
    call, plain = _wrapper_inputs(rng)[name]
    ops.reset_launches()
    got, want = call(), plain()
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert torch.equal(g, w)
    assert ops.LAUNCHES[name] == 0


@pytest.mark.parametrize("case", ["dtype", "ndim", "contiguity", "buckets",
                                  "devices", "mapping_rows"])
def test_wrappers_reject_bad_inputs(rng, case):
    imgs = torch.zeros((2, 4, 8))
    with pytest.raises(ValueError):
        if case == "dtype":
            ops.haar2d(imgs.double())
        elif case == "ndim":
            ops.haar2d(imgs[0])
        elif case == "contiguity":
            ops.haar2d(imgs.transpose(1, 2))
        elif case == "buckets":
            ops.minmax_sig_buckets(torch.zeros((2, 1), dtype=torch.int32),
                                   torch.zeros((32, 4), dtype=torch.int32),
                                   torch.zeros(2, dtype=torch.int32),
                                   use_minmax=True, n_buckets=12)
        elif case == "mapping_rows":
            ops.minmax_hash(torch.zeros((2, 2), dtype=torch.int32),
                            torch.zeros((32, 4), dtype=torch.int32))
        else:
            ops.stft_mag(torch.zeros((1, 64)), torch.zeros(8),
                         torch.zeros((8, 2)), torch.zeros((8, 2),
                                                          device="meta"), 2)


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build.shutil, "which", lambda _: None)
    monkeypatch.setattr(_build.os.path, "isfile", lambda _: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc()


def test_library_names_track_sources():
    paths = {name: _build.lib_path(name) for name in _build.NAMES}
    assert len(set(paths.values())) == len(_build.NAMES)
    for name, p in paths.items():
        assert p.parent == _build.BUILD_DIR and p.name.startswith(name + "-")
        assert (_build.SRC_DIR / f"{name}.cu").exists()
        assert _build.lib_path(name) == p


def test_kernel_sources_never_use_fast_math():
    assert not any("fast_math" in f or "fast-math" in f for f in _build.FLAGS)
    assert "arch=compute_90a,code=sm_90a" in _build.FLAGS
    for name in _build.NAMES:
        assert "fast_math" not in (_build.SRC_DIR / f"{name}.cu").read_text()


def test_pack_bits_feeds_reference_layout(rng):
    bits = rng.random((4, 96)) < 0.5
    np.testing.assert_array_equal(
        tu.pack_bits(torch.from_numpy(bits)).numpy().view(np.uint32),
        np.asarray(j_pack_bits(jnp.asarray(bits))))
