"""The CUDA kernels against their plain versions on the card, at small,
ragged and large-shared-memory shapes; the batch golden, the offline
golden and the offline search's card-equals-CPU parity on the card; the
streaming driver on the card (advance route equal to the block route,
one launch of each kernel a pooled block, the stream golden, the
detector's default device); detection serving on the card (one launch of
``stft_mag``, ``haar2d`` and ``minmax_hash`` a dispatched tick, none on an
idle tick, match lists equal to the CPU's; ``pool_serving_state`` copies
that survive a push) and a detector snapshot taken on the card restoring
on the card and the CPU to the CPU's uninterrupted run; the location tier
on the card (``locate_groups`` within the finest cell of the CPU's with
``n_used`` and ``consistent`` equal, and the located stream's alerts and
detections equal to the CPU's); the LM serving engine's tokens on the
card equal to its CPU path's; one NCCL rank's ZeRO step, expert
parallelism and serving (``prefill`` / ``decode_step``) equal to the
same without a mesh.

Needs a CUDA card and ``nvcc``: every test takes the ``cuda`` fixture,
which skips with a reason where there is none (as on a CPU-only machine).
Imports nothing of JAX, so it runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py
"""
import _torch_threads  # noqa: F401  (one torch thread a process)
import contextlib
import json
import pathlib

import numpy as np
import pytest
import torch

from repro_torch import utils as tu
from repro_torch.kernels import minmax_hash as mm_k
from repro_torch.kernels import ops
from repro_torch.kernels import ref

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want):
    assert torch.allclose(got, want, rtol=1e-5,
                          atol=1e-5 * float(want.abs().max()))


@pytest.mark.parametrize("rows,n,frame_len,hop,k", [
    (3, 777, 50, 7, 9), (4, 54375, 200, 25, 35), (1, 4000, 1024, 100, 40),
    # frame counts off the 32-frame tile, bins off the 4-bin tile
    (2, 1000, 64, 8, 9), (3, 6000, 200, 25, 35), (2, 9000, 1024, 64, 40),
    (2, 5000, 1024, 100, 35),            # DFT staged in 5 chunks of t
    (1, 3000, 1024, 256, 511)])          # 128 bin groups: 4 rounds a CTA
def test_stft_mag_kernel(cuda, rows, n, frame_len, hop, k):
    g = torch.Generator().manual_seed(0)
    wave = torch.randn((rows, n), generator=g).to(cuda)
    window = torch.hann_window(frame_len).to(cuda)
    dr, di = (torch.as_tensor(np.ascontiguousarray(m[:, 1:1 + k]), device=cuda)
              for m in ref.dft_matrices(frame_len, frame_len // 2 + 1))
    ops.reset_launches()
    got = ops.stft_mag(wave, window, dr, di, hop)
    assert ops.LAUNCHES["stft_mag"] == 1
    _close(got, ref.stft_mag(wave, window, dr, di, hop))


@pytest.mark.parametrize("n,h,w", [
    (5, 8, 8), (1024, 32, 128),
    (3, 64, 256),                 # T_W^T (256 KB) staged in chunks of c
    # image counts off the persistent grid's share a CTA, the smoke shape
    (1, 32, 128), (7, 32, 128), (1023, 32, 128), (64, 16, 32),
    (4, 2, 16), (3, 16, 2)])      # sides below the 4 x 4 thread tile
def test_haar2d_kernel(cuda, n, h, w):
    imgs = torch.randn((n, h, w), generator=torch.Generator().manual_seed(1))
    imgs = imgs.to(cuda)
    th, tw, _ = ops.haar_mats(h, w, cuda)
    _close(ops.haar2d(imgs), ref.haar2d(imgs, th, tw))


def test_haar2d_kernel_takes_unaligned_images(cuda):
    """Images that do not start on a 16-byte boundary take the 1 x 1 tile
    path and give the tiled path's result bit for bit."""
    n, h, w = 9, 32, 128
    g = torch.Generator().manual_seed(2)
    flat = torch.randn(n * h * w + 1, generator=g).to(cuda)
    imgs = flat[1:].view(n, h, w)
    assert imgs.data_ptr() % 16 != 0
    got = ops.haar2d(imgs)
    assert torch.equal(got, ops.haar2d(imgs.clone()))
    th, tw, _ = ops.haar_mats(h, w, cuda)
    _close(got, ref.haar2d(imgs, th, tw))


@pytest.mark.parametrize("n,d,t,f,use_minmax", [
    (13, 320, 12, 3, True), (256, 8192, 100, 4, True),
    (7, 32768, 300, 4, True),                # 1200 columns, 135 KB smem
    (9, 128, 5, 2, False)])
def test_minmax_sig_buckets_kernel(cuda, n, d, t, f, use_minmax):
    rng = np.random.default_rng(2)
    bits = torch.from_numpy(rng.random((n, d)) < 0.05)
    bits[0] = False
    packed = tu.pack_bits(bits).to(cuda)
    mappings = torch.from_numpy(rng.integers(0, 2**31 - 1, (d, t * f),
                                             dtype=np.int32)).to(cuda)
    salts = torch.from_numpy(rng.integers(-2**31, 2**31 - 1, t,
                                          dtype=np.int32)).to(cuda)
    sig, bkt = ops.minmax_sig_buckets(packed, mappings, salts,
                                      use_minmax=use_minmax, n_buckets=4096)
    want = ref.minmax_sig_buckets(packed, mappings, salts, f, use_minmax,
                                  4096)
    assert torch.equal(sig, want[0]) and torch.equal(bkt, want[1])


@pytest.mark.parametrize("n,d,h", [
    (13, 320, 100), (256, 8192, 400),
    (9, 8192, 800),                          # MinHash baseline: 2 columns a thread
    (24, 1024, 64),                          # dedup widths
    (5, 16384, 400)])                        # 64 KB set-bit list: > 48 KB smem
def test_minmax_hash_kernel(cuda, n, d, h):
    rng = np.random.default_rng(4)
    bits = torch.from_numpy(rng.random((n, d)) < 0.05)
    bits[0] = False                          # empty row
    bits[-1] = True                          # every dimension set
    packed = tu.pack_bits(bits).to(cuda)
    mappings = torch.from_numpy(rng.integers(0, 2**31 - 1, (d, h),
                                             dtype=np.int32)).to(cuda)
    ops.reset_launches()
    mins, maxs = ops.minmax_hash(packed, mappings)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["minmax_hash"] == 1
    want = mm_k.plain_raw(packed, mappings)
    assert torch.equal(mins, want[0]) and torch.equal(maxs, want[1])
    assert (mins[0] == 2**31 - 1).all() and (maxs[0] == 0).all()


def _edge_bits(n, d, seed):
    """5% random bits; every 7th row empty, row 1 (inside the first row
    tile of sparse rows) full, and rows 128..255 all zero (a whole tile
    when there are that many)."""
    bits = torch.from_numpy(np.random.default_rng(seed).random((n, d))
                            < 0.05)
    bits[::7] = False
    if n > 1:
        bits[1] = True
    bits[128:256] = False
    return bits


@pytest.mark.parametrize("n,d,h", [
    (129, 8192, 400),        # one tile and a row; H = 400 (16-column slice)
    (5, 8192, 400),          # fewer rows than a tile
    (1000, 8224, 400),       # 64 chunks and a 32-dimension one
    (300, 4096, 800),        # the fewest dimensions tiled; H = 800
    (24, 8192, 64),          # 64 columns: groups of 16 lanes
    (1024, 8192, 1200),
    (2000, 8192, 40)])       # 40 columns: 10 quads in groups of 16
def test_minmax_hash_tiled_edges(cuda, monkeypatch, n, d, h):
    """The tiled kernel's tile, chunk, slice and cluster edges, bit for
    bit against the plain version; an all-zero tile gives 2**31 - 1 / 0.
    Every plane takes the tiled kernel here (a station-day's last tile
    holds 48 rows)."""
    monkeypatch.setattr(mm_k, "MIN_TILED_PLANE", 0)
    assert mm_k.plan(n, d // 32, h).tiled
    rng = np.random.default_rng(6)
    bits = _edge_bits(n, d, 7)
    packed = tu.pack_bits(bits).to(cuda)
    mappings = torch.from_numpy(rng.integers(0, 2**31 - 1, (d, h),
                                             dtype=np.int32)).to(cuda)
    ops.reset_launches()
    mins, maxs = ops.minmax_hash(packed, mappings)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["minmax_hash"] == 1
    want = mm_k.plain_raw(packed, mappings)
    assert torch.equal(mins, want[0]) and torch.equal(maxs, want[1])
    assert (mins[128:256] == 2**31 - 1).all() and (maxs[128:256] == 0).all()
    assert (mins[0] == 2**31 - 1).all() and (maxs[0] == 0).all()


@pytest.mark.parametrize("n,d,t,f,use_minmax", [
    (129, 8192, 100, 4, True), (5, 8192, 100, 4, True),
    (1000, 8224, 100, 4, True), (1024, 8192, 100, 4, False),
    (2000, 8192, 20, 2, True),           # the smoke config's H = 40
    (300, 4128, 400, 2, True), (77, 8192, 300, 4, True),
    (40, 8192, 40, 1, False),
    (50, 8192, 13, 3, True),             # f = 3: the row kernel
    (1000, 1024, 20, 2, True)])          # D = 1024: the row kernel
def test_minmax_sig_buckets_tiled_edges(cuda, monkeypatch, n, d, t, f,
                                       use_minmax):
    monkeypatch.setattr(mm_k, "MIN_TILED_PLANE", 0)
    assert mm_k.plan(n, d // 32, t * f, f).tiled == (f != 3 and d >= 4096)
    rng = np.random.default_rng(8)
    packed = tu.pack_bits(_edge_bits(n, d, 9)).to(cuda)
    mappings = torch.from_numpy(rng.integers(0, 2**31 - 1, (d, t * f),
                                             dtype=np.int32)).to(cuda)
    salts = torch.from_numpy(rng.integers(-2**31, 2**31 - 1, t,
                                          dtype=np.int32)).to(cuda)
    ops.reset_launches()
    sig, bkt = ops.minmax_sig_buckets(packed, mappings, salts,
                                      use_minmax=use_minmax, n_buckets=4096)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["minmax_sig_buckets"] == 1
    want = mm_k.plain(packed, mappings, salts, f, use_minmax, 4096)
    assert torch.equal(sig, want[0]) and torch.equal(bkt, want[1])


def test_minmax_unaligned_mappings_take_the_row_kernel(cuda, monkeypatch):
    """A mapping table that does not start on 16 bytes runs the row
    kernel and gives the tiled kernel's planes and signatures."""
    monkeypatch.setattr(mm_k, "MIN_TILED_PLANE", 0)
    n, d, t, f = 200, 8192, 100, 4
    rng = np.random.default_rng(10)
    packed = tu.pack_bits(_edge_bits(n, d, 11)).to(cuda)
    flat = torch.from_numpy(rng.integers(0, 2**31 - 1, d * t * f + 1,
                                         dtype=np.int32)).to(cuda)
    loose = flat[1:].view(d, t * f)
    assert loose.data_ptr() % 16 != 0
    assert not mm_k.plan(n, d // 32, t * f, f, aligned=False).tiled
    salts = torch.from_numpy(rng.integers(-2**31, 2**31 - 1, t,
                                          dtype=np.int32)).to(cuda)
    for call in (lambda m: ops.minmax_hash(packed, m),
                 lambda m: ops.minmax_sig_buckets(packed, m, salts,
                                                  use_minmax=True,
                                                  n_buckets=4096)):
        got, want = call(loose), call(loose.clone())
        assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("n", [256, 320])
def test_minmax_few_rows_take_the_row_kernel(cuda, monkeypatch, n):
    """One station's replay block (256 rows at the paper widths) runs the
    row kernel; its planes and signatures equal the plain version's and,
    bit for bit, the tiled kernel's on the same input."""
    d, t, f = 8192, 100, 4
    assert not mm_k.plan(n, d // 32, t * f, f).tiled
    rng = np.random.default_rng(12)
    packed = tu.pack_bits(_edge_bits(n, d, 13)).to(cuda)
    mappings = torch.from_numpy(rng.integers(0, 2**31 - 1, (d, t * f),
                                             dtype=np.int32)).to(cuda)
    salts = torch.from_numpy(rng.integers(-2**31, 2**31 - 1, t,
                                          dtype=np.int32)).to(cuda)
    calls = (lambda: ops.minmax_hash(packed, mappings),
             lambda: ops.minmax_sig_buckets(packed, mappings, salts,
                                            use_minmax=True, n_buckets=4096))
    row = [call() for call in calls]
    assert all(torch.equal(a, b) for a, b in zip(
        row[0], mm_k.plain_raw(packed, mappings)))
    assert all(torch.equal(a, b) for a, b in zip(
        row[1], mm_k.plain(packed, mappings, salts, f, True, 4096)))
    monkeypatch.setattr(mm_k, "MIN_TILED_PLANE", 0)
    assert mm_k.plan(n, d // 32, t * f, f).tiled
    for got, call in zip(row, calls):
        assert all(torch.equal(a, b) for a, b in zip(got, call()))


@pytest.mark.parametrize("min_plane", [0, None])
def test_minmax_no_rows(cuda, monkeypatch, min_plane):
    """No rows at the paper widths give empty outputs and launch nothing,
    also where the plan would tile them; the launch functions take an
    empty input on either plan."""
    if min_plane is not None:
        monkeypatch.setattr(mm_k, "MIN_TILED_PLANE", min_plane)
    d, t, f = 8192, 100, 4
    packed = torch.zeros((0, d // 32), dtype=torch.int32, device=cuda)
    mappings = torch.randint(0, 2**31 - 1, (d, t * f), dtype=torch.int32,
                             device=cuda)
    salts = torch.zeros(t, dtype=torch.int32, device=cuda)
    ops.reset_launches()
    mins, maxs = ops.minmax_hash(packed, mappings)
    sig, bkt = ops.minmax_sig_buckets(packed, mappings, salts,
                                      use_minmax=True, n_buckets=4096)
    torch.cuda.synchronize()
    assert mins.shape == maxs.shape == (0, t * f)
    assert sig.shape == bkt.shape == (0, t)
    assert ops.LAUNCHES["minmax_hash"] == ops.LAUNCHES[
        "minmax_sig_buckets"] == 0
    mm_k.launch_raw(packed, mappings, mins, maxs)
    mm_k.launch(packed, mappings, salts, f, True, 4096, sig, bkt)
    torch.cuda.synchronize()


JAC_WIDTHS = (1, 3, 4, 32, 33, 255, 256, 257, 512)
JAC_PATTERNS = ("all", "none", "prefix", "scattered")


def _jaccard_inputs(w: int, m: int, pattern: str, s: int = 2,
                    ring: int = 300):
    """A seeded (s, ring, w) ring (the last two rows of each station empty)
    and (s, m) slots: valid ids not reduced modulo the ring (negative ones
    too), an empty union and a row with itself among them, and garbage
    ids in the invalid slots."""
    rng = np.random.default_rng(7 * w + m)
    pk = (rng.integers(0, 2**32, (s, ring, w), dtype=np.uint32)
          & rng.integers(0, 2**32, (s, ring, w), dtype=np.uint32))
    pk[:, -2:] = 0
    i1 = rng.integers(-2 * ring, 5 * ring, (s, m)).astype(np.int32)
    i2 = rng.integers(-2 * ring, 5 * ring, (s, m)).astype(np.int32)
    if m:
        i1[:, 0], i2[:, 0] = ring - 1, 2 * ring - 2
        i1[:, m // 2], i2[:, m // 2] = 7 + ring, 7 - 2 * ring
    valid = {"all": np.ones((s, m), bool), "none": np.zeros((s, m), bool),
             "prefix": np.arange(m)[None, :] < (m * np.arange(1, s + 1)
                                                 // (s + 1))[:, None],
             "scattered": rng.random((s, m)) < 0.4}[pattern]
    junk = rng.integers(-2**31, 2**31 - 1, (2, s, m)).astype(np.int32)
    i1, i2 = np.where(valid, i1, junk[0]), np.where(valid, i2, junk[1])
    return (torch.from_numpy(pk.view(np.int32)),
            *(torch.from_numpy(np.ascontiguousarray(a))
              for a in (i1, i2, valid)))


@pytest.mark.parametrize("pattern", JAC_PATTERNS)
@pytest.mark.parametrize("m", [0, 1, 33, 4096, 20000])
@pytest.mark.parametrize("w", JAC_WIDTHS)
def test_jaccard_popcount_kernel(cuda, w, m, pattern):
    """Both plans (16-byte loads where W % 4 == 0, else 4-byte words)
    against the plain version, bit for bit; one launch where there are
    slots, none where there are not."""
    pk, i1, i2, valid = (t.to(cuda) for t in _jaccard_inputs(w, m, pattern))
    ops.reset_launches()
    got = ops.jaccard_popcount(pk, i1, i2, valid)
    assert ops.LAUNCHES["jaccard_popcount"] == (1 if m else 0)
    want = ref.jaccard_popcount(pk, i1, i2, valid)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    if m > 1 and pattern == "all":
        assert float(got[0, 0]) == 0.0 and float(got[0, m // 2]) == 1.0
        assert torch.equal(ops.jaccard_popcount(pk, i1, i2), got)


# one station-day of the offline search: t · cap · N = 100 · 4 · 43,184
SEARCH_SLOTS, SEARCH_FP = 100 * 4 * 43_184, 43_184


def _occurrence_inputs(m: int, n_fp: int, share: float, hub: int, dev,
                       offset: int = 0):
    """An (m,) pair stream over n_fp fingerprints, a ``share`` of its
    slots valid and the rest INVALID ids; the first ``hub`` slots pair
    fingerprint 11 with as many partners, side by side as in the sorted
    search stream. ``offset`` slots are cut off the front, so the views
    start off the kernel's vector alignment when it is not a multiple of
    4."""
    g = torch.Generator(device=dev).manual_seed(5)
    n = m + offset
    i1 = torch.randint(0, n_fp - 1, (n,), generator=g, device=dev,
                       dtype=torch.int32)
    i2 = torch.minimum(i1 + torch.randint(1, 64, (n,), generator=g,
                                          device=dev, dtype=torch.int32),
                       torch.tensor(n_fp - 1, device=dev, dtype=torch.int32))
    valid = torch.rand(n, generator=g, device=dev) < share
    if hub:
        i1[offset:offset + hub] = 11
        i2[offset:offset + hub] = 12 + torch.arange(hub, device=dev) % (
            n_fp - 12)
        valid[offset:offset + hub] = True
    sim = torch.randint(2, 101, (n,), generator=g, device=dev,
                        dtype=torch.int32)
    inv = torch.tensor(2**31 - 1, device=dev, dtype=torch.int32)
    i1, i2 = torch.where(valid, i1, inv), torch.where(valid, i2, inv)
    sim = torch.where(valid, sim, 0)
    return tuple(t[offset:] for t in (i1, i2, sim, valid))


@pytest.mark.parametrize("m,n_fp,share,hub,offset", [
    (SEARCH_SLOTS, SEARCH_FP, 0.005, 1000, 0),   # the search's stream
    (SEARCH_SLOTS, SEARCH_FP, 0.005, 0, 0),
    (0, 50, 0.0, 0, 0), (1, 10, 1.0, 0, 0), (7, 10, 1.0, 0, 0),
    (4097, 300, 0.5, 50, 0),                     # a ragged tail tile
    (4096, 2000, 1.0, 0, 0),                     # the host tail's streams
    (10001, 500, 0.3, 40, 1), (10001, 500, 0.3, 40, 3),   # unaligned views
    (4 * 4096 + 5, 30, 1.0, 0, 0)])              # every id excluded
def test_occurrence_filter_kernel(cuda, m, n_fp, share, hub, offset):
    """The kernel against the plain version on the same card tensors,
    bit for bit, twice (the same bits run to run): one launch a call."""
    idx1, idx2, sim, valid = _occurrence_inputs(m, n_fp, share, hub, cuda,
                                                offset)
    cap = max(1, int(0.01 * n_fp))
    ops.reset_launches()
    got = ops.occurrence_filter(idx1, idx2, sim, valid, n_fp, cap)
    again = ops.occurrence_filter(idx1, idx2, sim, valid, n_fp, cap)
    assert ops.LAUNCHES["occurrence_filter"] == 2
    want = ref.occurrence_filter(idx1, idx2, sim, valid, n_fp, cap)
    torch.cuda.synchronize()
    for g, a, w in zip(got, again, want):
        assert g.is_cuda and torch.equal(g, w) and torch.equal(a, w)
    if hub:
        assert bool(got[2][11]) and not bool(got[0][:hub].any())


@pytest.mark.parametrize("w", [4, 32, 255, 256, 257, 512])
def test_jaccard_popcount_unaligned_ring_takes_scalar_plan(cuda, w):
    """A ring view off 16 bytes takes the 4-byte plan and gives the
    16-byte plan's (or the plain version's) result bit for bit."""
    from repro_torch.kernels import jaccard_popcount as jac_k
    pk, i1, i2, valid = (t.to(cuda) for t in _jaccard_inputs(
        w, 4096, "scattered"))
    flat = torch.empty(pk.numel() + 1, dtype=torch.int32, device=cuda)
    view = flat[1:].view(pk.shape)
    view.copy_(pk)
    assert view.data_ptr() % 16 != 0 and not jac_k.plan(
        w, view.data_ptr()).vector
    got = ops.jaccard_popcount(view, i1, i2, valid)
    torch.cuda.synchronize()
    assert torch.equal(got, ops.jaccard_popcount(pk, i1, i2, valid))
    assert torch.equal(got, ref.jaccard_popcount(pk, i1, i2, valid))


@pytest.mark.parametrize("w", [33, 256])
def test_jaccard_popcount_several_passes(cuda, w):
    """300,000 slots take more than one pass of the persistent grid: a
    warp takes at most 32 slots a pass, and the H100 holds at most
    132 x 64 warps (8,448 x 32 < 300,000)."""
    pk, i1, i2, valid = (t.to(cuda) for t in _jaccard_inputs(
        w, 300_000, "scattered", s=1))
    got = ops.jaccard_popcount(pk, i1, i2, valid)
    torch.cuda.synchronize()
    assert torch.equal(got, ref.jaccard_popcount(pk, i1, i2, valid))


@pytest.mark.parametrize("caller", ["verify_pairs", "verify_jaccard"])
def test_verify_is_one_launch_without_host_sync(cuda, caller):
    """The stream verify and the offline verify each run one kernel on
    the card (the profiler's device events) and never make the host wait
    (sync debug mode "error" raises on any synchronising call)."""
    import types

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import lsh
    from repro_torch.stream import index as tidx
    pk, i1, i2, valid = (t.to(cuda) for t in _jaccard_inputs(
        256, 4096, "prefix", s=4 if caller == "verify_pairs" else 1))
    if caller == "verify_pairs":
        state = types.SimpleNamespace(pk=pk)
        pairs = lsh.Pairs(i1, i2, torch.zeros_like(i1), valid)

        def call():
            return tidx.verify_pairs(state, pairs)
    else:
        packed = pk[0]
        pairs = lsh.Pairs(torch.where(valid[0], i1[0] % pk.shape[1], i1[0]),
                          i2[0] % pk.shape[1], torch.zeros_like(i1[0]),
                          valid[0])

        def call():
            return lsh.verify_jaccard(packed, pairs)
    want = call()                                 # builds and loads the kernel
    torch.cuda.synchronize()
    ops.reset_launches()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = call()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
    assert ops.LAUNCHES["jaccard_popcount"] == 1
    kernels = [e.name for e in prof.events()
               if e.device_type == DeviceType.CUDA]
    assert len(kernels) == 1 and "jaccard_popcount" in kernels[0], kernels
    assert torch.equal(got, want)


def test_batch_golden_on_the_card(cuda):
    from repro_torch.core import (AlignConfig, DetectConfig,
                                  FingerprintConfig, LSHConfig, SynthConfig,
                                  make_dataset)
    from repro_torch.core.detect import detect_events, recall_against_truth
    gold = json.loads((ROOT / "tests" / "golden" / "batch_detect.json")
                      .read_text())
    syn = dict(gold["synth"])
    syn["repeating_noise_stations"] = tuple(syn["repeating_noise_stations"])
    ds = make_dataset(SynthConfig(**syn))
    fcfg = FingerprintConfig(img_time=32, img_hop=4, top_k=200,
                             mad_sample_rate=1.0)
    cfg = DetectConfig(
        fingerprint=fcfg,
        lsh=LSHConfig(n_tables=100, n_funcs=4, n_matches=2, bucket_cap=8,
                      min_dt=fcfg.overlap_fingerprints,
                      occurrence_frac=0.05),
        align=AlignConfig(channel_threshold=3, min_cluster_sim=4,
                          min_cluster_size=1, min_stations=2,
                          onset_tol=int(10 * fcfg.fs / fcfg.lag_samples)))
    ops.reset_launches()
    det, events, _, stats = detect_events(ds.waveforms, cfg, device=cuda)
    # the default replay has verify off: jaccard_popcount is not on it
    assert all(ops.LAUNCHES[k] > 0
               for k in ("stft_mag", "haar2d", "minmax_sig_buckets"))
    stats = {k: v for k, v in stats.items()
             if k != "drops" and not k.endswith("_qc")}
    assert stats == gold["stats"]
    assert recall_against_truth(det, events, ds, fcfg) == gold["recall"]


def test_offline_search_card_equals_cpu(cuda):
    from repro_torch.core import lsh
    rng = np.random.default_rng(5)
    bits = rng.random((96, 512)) < 0.08
    bits[40:56] = bits[40]                   # a bucket larger than the window
    for i in range(0, 16, 2):
        bits[95 - i] = bits[i] ^ (rng.random(512) < 0.01)
    packed = tu.pack_bits(torch.from_numpy(bits))
    cfg = lsh.LSHConfig(n_tables=50, n_funcs=4, bucket_cap=4, min_dt=1,
                        occurrence_frac=0.1)
    ops.reset_launches()
    got, gstats = lsh.search(packed.to(cuda), cfg)
    gjac = lsh.verify_jaccard(packed.to(cuda), got)
    assert ops.LAUNCHES["minmax_hash"] == 1
    assert ops.LAUNCHES["jaccard_popcount"] == 1
    want, wstats = lsh.search(packed, cfg)
    for f in ("idx1", "idx2", "sim", "valid"):
        assert torch.equal(getattr(got, f).cpu(), getattr(want, f))
    assert {k: v.item() for k, v in gstats.items()} == \
        {k: v.item() for k, v in wstats.items()}
    assert torch.equal(gjac.cpu(), lsh.verify_jaccard(packed, want))
    blocks, _ = lsh.partitioned_search(packed.to(cuda), cfg, 4)
    for g, w in zip(blocks, lsh.partitioned_search(packed, cfg, 4)[0]):
        assert torch.equal(g.idx1.cpu(), w.idx1)
        assert torch.equal(g.valid.cpu(), w.valid)


def test_offline_golden_and_dedup_on_the_card(cuda):
    from repro_torch.configs import fast_seismic
    from repro_torch.core import SynthConfig, make_dataset
    from repro_torch.core import fingerprint, lsh
    from repro_torch.data import dedup
    gold = json.loads((ROOT / "tests" / "golden" / "stream_pairs.json")
                      .read_text())
    cfg = fast_seismic.smoke_config()
    ds = make_dataset(SynthConfig(**gold["synth"]))
    _, packed = fingerprint.fingerprints_from_waveform(
        torch.from_numpy(ds.waveforms[0]).to(cuda), cfg.fingerprint)
    pairs, _ = lsh.search(packed, cfg.lsh)
    v = pairs.valid.cpu().numpy()
    got = sorted(zip(pairs.idx1.cpu().numpy()[v].tolist(),
                     pairs.idx2.cpu().numpy()[v].tolist()))
    assert [list(p) for p in got] == gold["offline_pairs"]
    rng = np.random.default_rng(0)
    docs = rng.integers(1, 1000, (24, 128)).astype(np.int32)
    docs[20] = docs[3]
    ops.reset_launches()
    keep, stats = dedup.find_duplicates(docs)
    assert ops.LAUNCHES["minmax_hash"] == 1
    want_keep, want_stats = dedup.find_duplicates(docs, device="cpu")
    assert (keep == want_keep).all() and stats == want_stats
    assert not keep[20]


def _paper_stream(cuda, n_stations, n_blocks):
    """The paper widths, ``stream_config``'s index, a pool state frozen
    with each station's statistics, and the waveforms of ``n_blocks``
    consecutive blocks."""
    from repro_torch.configs import fast_seismic
    from repro_torch.core import SynthConfig, fingerprint, lsh, make_dataset
    from repro_torch.stream import fused, index
    cfg, scfg = fast_seismic.config(), fast_seismic.stream_config()
    fcfg, b = cfg.fingerprint, scfg.block_fingerprints
    n = fcfg.block_samples(b) + (n_blocks - 1) * b * fcfg.lag_samples
    ds = make_dataset(SynthConfig(duration_s=n / fcfg.fs + 1.0,
                                  n_stations=n_stations, n_sources=2,
                                  events_per_source=4, event_snr=6.0,
                                  seed=4))
    wave = torch.from_numpy(ds.waveforms[:, :n]).to(cuda)
    coeffs = fingerprint.coeffs_from_waveform(wave, fcfg)
    stats = [fingerprint.mad_stats(c, 1.0) for c in coeffs]
    icfg = scfg.effective_index(fcfg.fp_dim)

    def state():
        return fused.init_pool_state(
            [index.init_index(cfg.lsh, icfg, n_stations, cuda)],
            fcfg.halo_samples, [m for m, _ in stats], [d for _, d in stats])
    knobs = dict(window=scfg.window_fingerprints,
                 saturation=scfg.saturation_limit, occ_limit=scfg.occ_limit,
                 counters=1, max_pairs=scfg.max_pairs_per_block,
                 verify=scfg.verify_code)
    return (cfg, scfg, wave, state, lsh.hash_mappings(fcfg.fp_dim, cfg.lsh,
                                                       cuda), knobs)


def test_pool_step_advance_equals_block_on_the_card(cuda):
    """Five consecutive paper-width blocks of 4 stations: the advance
    route (halo + new samples) and the block route give the same pairs,
    qc, halo and index, bit for bit."""
    from repro_torch.stream import fused
    cfg, scfg, wave, state, mappings, knobs = _paper_stream(cuda, 4, 5)
    fcfg, b = cfg.fingerprint, scfg.block_fingerprints
    bs, adv_n = fcfg.block_samples(b), b * fcfg.lag_samples
    valid = torch.ones((4, b), dtype=torch.bool, device=cuda)
    adv, blk = state(), state()
    emitted = 0
    for k in range(5):
        block = wave[:, k * adv_n:k * adv_n + bs].contiguous()
        blk, bp, bq = fused.pool_step_block(blk, block, mappings, k * b,
                                            valid, fcfg, cfg.lsh, **knobs)
        if k == 0:
            adv, ap, aq = fused.pool_step_block(adv, block, mappings, 0,
                                                valid, fcfg, cfg.lsh,
                                                **knobs)
        else:
            adv, ap, aq = fused.pool_step_advance(
                adv, block[:, -adv_n:].contiguous(), mappings, k * b, fcfg,
                cfg.lsh, **knobs)
        assert torch.equal(aq, bq)
        for f in ("idx1", "idx2", "sim", "valid", "jac"):
            assert torch.equal(getattr(ap, f), getattr(bp, f)), f
        assert torch.equal(adv.halo, blk.halo)
        for f in ("sig", "ids", "cursor", "traffic", "occ", "pk"):
            assert torch.equal(getattr(adv.index, f),
                               getattr(blk.index, f)), f
        emitted += int(aq[:, 3].sum())
    assert emitted > 0


def test_pooled_paper_block_launches_each_kernel_once(cuda):
    """One pooled advance step at the paper widths (4 stations × 256
    fingerprints, verify on) launches stft_mag, haar2d, minmax_sig_buckets
    and jaccard_popcount once each: the wrappers' counts and the
    profiler's device kernels agree."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.stream import fused
    cfg, scfg, wave, state, mappings, knobs = _paper_stream(cuda, 4, 2)
    fcfg, b = cfg.fingerprint, scfg.block_fingerprints
    adv_n = b * fcfg.lag_samples
    st = state()
    valid = torch.ones((4, b), dtype=torch.bool, device=cuda)
    st, _, _ = fused.pool_step_block(st, wave[:, :fcfg.block_samples(b)]
                                     .contiguous(), mappings, 0, valid,
                                     fcfg, cfg.lsh, **knobs)
    new = wave[:, -adv_n:].contiguous()
    torch.cuda.synchronize()
    ops.reset_launches()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        st, pairs, qc = fused.pool_step_advance(st, new, mappings, b, fcfg,
                                                cfg.lsh, **knobs)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == DeviceType.CUDA]
    want = {"stft_mag": ("stft_mag",), "haar2d": ("haar2d",),
            "minmax_sig_buckets": ("minmax_sig_buckets", "tiled_kernel"),
            "jaccard_popcount": ("jaccard_popcount",)}
    for name, keys in want.items():
        assert ops.LAUNCHES[name] == 1, (name, ops.LAUNCHES)
        hits = [n for n in names if any(k in n for k in keys)]
        assert len(hits) == 1, (name, hits)


def test_stream_golden_on_the_card(cuda):
    """The two-pass and compact + verify runs of the stream golden, and a
    bounded 3-station stream whose alerts and detections equal the
    port's CPU path."""
    from repro_torch.configs import fast_seismic
    from repro_torch.core import SynthConfig, fingerprint, make_dataset
    from repro_torch.stream import StreamingDetector
    gold = json.loads((ROOT / "tests" / "golden" / "stream_pairs.json")
                      .read_text())
    cfg = fast_seismic.smoke_config()
    wf = make_dataset(SynthConfig(**gold["synth"])).waveforms[0]
    med_mad = fingerprint.mad_stats(fingerprint.coeffs_from_waveform(
        torch.from_numpy(wf), cfg.fingerprint), 1.0)
    want = {tuple(p) for p in gold["stream_two_pass_pairs"]}
    for scfg in (fast_seismic.stream_smoke_config(),
                 fast_seismic.stream_compact_smoke_config()):
        ops.reset_launches()
        det = StreamingDetector(cfg, scfg, med_mad=med_mad, device=cuda)
        for chunk in np.array_split(wf, gold["n_chunks"]):
            det.push(chunk)
        _, pairs, _ = det.stations[0].finalize()
        v = pairs.valid.cpu().numpy()
        assert set(zip(pairs.idx1.cpu().numpy()[v].tolist(),
                       pairs.idx2.cpu().numpy()[v].tolist())) == want
        assert ops.LAUNCHES["stft_mag"] > 0
        assert (ops.LAUNCHES["jaccard_popcount"] > 0) == scfg.verify_jaccard
    ds = make_dataset(SynthConfig(duration_s=600.0, n_stations=3,
                                  n_sources=2, events_per_source=5,
                                  event_snr=3.0, seed=11))
    runs = []
    for dev in (cuda, "cpu"):
        det = StreamingDetector(cfg, fast_seismic.stream_bounded_smoke_config(),
                                n_stations=3, device=dev)
        for a in range(0, ds.waveforms.shape[1], 6000):
            det.push(ds.waveforms[:, a:a + 6000])
        dets, _, stats = det.finalize()
        runs.append(([x.tolist() for x in det.alerts],
                     {k: v.cpu().tolist() for k, v in dets.items()},
                     stats["detections"]))
    assert runs[0] == runs[1]
    assert runs[0][2] >= 1


def test_detector_defaults_to_the_card(cuda):
    from repro_torch.configs import fast_seismic
    from repro_torch.stream import StreamingDetector
    cfg = fast_seismic.smoke_config()
    det = StreamingDetector(cfg, fast_seismic.stream_smoke_config())
    assert det.stations[0].state.sig.is_cuda
    med = np.zeros(cfg.fingerprint.n_coeff, np.float32)
    pool = StreamingDetector(cfg, fast_seismic.stream_smoke_config(),
                             n_stations=2, med_mad=(med, med + 1))
    assert pool.pooled and pool.pstate.index.sig.is_cuda
    assert pool.stations[1].state.ids.is_cuda


def _bounded_stream(dev, n_pushes=None):
    """The bounded 3-station smoke stream (600 s, 6,000-sample pushes) on
    ``dev``; returns the detector, the trace and the push bounds."""
    from repro_torch.configs import fast_seismic
    from repro_torch.core import SynthConfig, make_dataset
    from repro_torch.stream import StreamingDetector
    ds = make_dataset(SynthConfig(duration_s=600.0, n_stations=3,
                                  n_sources=2, events_per_source=5,
                                  event_snr=3.0, seed=11))
    wf = ds.waveforms
    bounds = [(a, a + 6000) for a in range(0, wf.shape[1], 6000)]
    det = StreamingDetector(fast_seismic.smoke_config(),
                            fast_seismic.stream_bounded_smoke_config(),
                            n_stations=3, device=dev)
    for a, b in bounds[:n_pushes]:
        det.push(wf[:, a:b])
    return det, wf, bounds


def test_serving_tick_launches_each_kernel_once(cuda):
    """A dispatched serving tick launches stft_mag, haar2d and
    minmax_hash once each; an idle tick launches nothing; the card's
    match lists equal the CPU's on the same serving state."""
    from repro_torch.launch.serve_detect import (QueryRequest,
                                                 ServeDetectEngine)
    det, wf, _ = _bounded_stream(cuda)
    det.flush()
    state, med, mad = det.pool_serving_state()
    reqs = {}
    for dev in (cuda, "cpu"):
        eng = ServeDetectEngine(det.cfg, det.scfg, state, (med, mad),
                                n_slots=4, top_k=32, device=dev)
        reqs[str(dev)] = [QueryRequest(rid=i, window=wf[i % 3, a:a + 3000])
                          for i, a in enumerate(range(0, 42_000, 6000))]
        if dev == "cpu":
            eng.run(reqs["cpu"])
            continue
        for r in reqs[str(cuda)]:
            eng.submit(r)
        while eng.pending():
            ops.reset_launches()
            served = eng.tick()
            torch.cuda.synchronize()
            for name in ("stft_mag", "haar2d", "minmax_hash"):
                assert ops.LAUNCHES[name] == (1 if served else 0), name
        ops.reset_launches()
        assert eng.tick() == 0
        assert sum(ops.LAUNCHES.values()) == 0
    assert [r.matches for r in reqs[str(cuda)]] == \
        [r.matches for r in reqs["cpu"]]
    assert any(r.matches for r in reqs["cpu"])


def test_pool_serving_state_clones_survive_a_push(cuda):
    det, wf, bounds = _bounded_stream(cuda, 6)
    assert det.pstate is not None
    state, med, _ = det.pool_serving_state()
    before = {k: getattr(state, k).clone() for k in ("sig", "ids", "pk")}
    for a, b in bounds[6:]:
        det.push(wf[:, a:b])
    torch.cuda.synchronize()
    for k, v in before.items():
        assert torch.equal(getattr(state, k), v), k
        assert getattr(state, k).data_ptr() != \
            getattr(det.pstate.index, k).data_ptr()
    assert not torch.equal(state.ids, det.pstate.index.ids)
    assert med.device == det.pstate.med.device


def test_snapshot_round_trip_on_the_card_equals_the_cpu(cuda, tmp_path):
    """Snapshot the bounded stream on the card mid-way, restore it on the
    card, finish it: alerts, detections and events equal the CPU's
    uninterrupted run; the card's snapshot restores on the CPU too."""
    from repro_torch.stream import StreamingDetector
    from repro_torch.stream.engine import events_to_rows
    det, wf, bounds = _bounded_stream(cuda, 5)
    det.snapshot(str(tmp_path))
    runs = []
    for dev in (cuda, "cpu"):
        restored, step = StreamingDetector.restore(
            str(tmp_path), det.cfg, det.scfg, device=dev)
        assert step == 5 and restored.pstate.index.sig.device.type == \
            torch.device(dev).type
        for a, b in bounds[5:]:
            restored.push(wf[:, a:b])
        runs.append(restored)
    whole, _, _ = _bounded_stream("cpu")

    def result(d):
        dets, events, stats = d.finalize()
        alerts = np.concatenate(d.alerts) if d.alerts else np.zeros((0, 8))
        return (alerts.tolist(),
                {k: v.cpu().tolist() for k, v in dets.items()},
                [events_to_rows(e).tolist() for e in events],
                stats["detections"], d.quality_summary())

    want = result(whole)
    assert result(runs[0]) == want
    assert result(runs[1]) == want
    assert want[3] >= 1


@pytest.mark.parametrize("groups,stations", [(64, 6), (4096, 16)])
def test_locate_groups_on_the_card(cuda, groups, stations):
    """Onsets from known origins through ``travel_time_lags``, a quarter
    of the stations absent: the card's origins within one finest cell of
    the CPU's (float32 spacing, hence + 1e-4 km), ``n_used`` and
    ``consistent`` equal."""
    from repro_torch.configs import fast_seismic
    from repro_torch.core import locate
    cfg = fast_seismic.locate_config()
    rng = np.random.default_rng(groups)
    xy = torch.as_tensor(rng.uniform(2.5, 47.5, (stations, 2)),
                         dtype=torch.float32)
    src = torch.as_tensor(rng.uniform(0, 50, (groups, 2)),
                          dtype=torch.float32)
    tt = locate.travel_time_lags(src, xy, cfg, np.float32(2.0)).numpy()
    on = np.round(300 + tt + rng.normal(0, 0.5, tt.shape)).astype(np.int32)
    on[rng.random(on.shape) < 0.25] = 2**31 - 1
    w = torch.as_tensor(rng.uniform(0.05, 1, stations), dtype=torch.float32)
    out = {}
    for dev in (cuda, "cpu"):
        got = locate.locate_groups(torch.as_tensor(on, device=dev),
                                   w.to(dev), xy.to(dev), np.float32(2.0),
                                   cfg)
        out[str(dev)] = {k: v.cpu().numpy() for k, v in got.items()}
    card, cpu = out[str(cuda)], out["cpu"]
    assert np.abs(card["xy"] - cpu["xy"]).max() <= cfg.cell_km + 1e-4
    np.testing.assert_array_equal(card["n_used"], cpu["n_used"])
    np.testing.assert_array_equal(card["consistent"], cpu["consistent"])
    assert cpu["consistent"].mean() > 0.5


def test_located_stream_on_the_card(cuda):
    """The located bounded stream (4 stations, 900 s, physical geometry,
    seed 11, 6,000-sample pushes) on the card and on the CPU: alert rows
    equal but for ±1 milli-km in the location columns, finalize's located
    detections equal in the integer columns and within 1e-4 km / 1e-5 in
    the float ones."""
    from repro_torch.configs import fast_seismic
    from repro_torch.core import SynthConfig, make_dataset
    from repro_torch.stream import StreamingDetector
    ds = make_dataset(SynthConfig(duration_s=900.0, n_stations=4,
                                  n_sources=2, events_per_source=6,
                                  event_snr=3.0, seed=11,
                                  physical_geometry=True))
    runs = []
    for dev in (cuda, "cpu"):
        det = StreamingDetector(fast_seismic.located_smoke_config(),
                                fast_seismic.stream_bounded_smoke_config(),
                                n_stations=4, station_xy=ds.station_xy,
                                device=dev)
        for a in range(0, ds.waveforms.shape[1], 6000):
            det.push(ds.waveforms[:, a:a + 6000])
        dets, _, _ = det.finalize()
        runs.append((np.concatenate(det.alerts),
                     {k: (v.cpu().numpy() if torch.is_tensor(v) else v)
                      for k, v in dets.items()}))
    (a, da), (b, db) = runs
    assert a.shape == b.shape and a.shape[0] >= 1
    np.testing.assert_array_equal(np.delete(a, [5, 6], 1),
                                  np.delete(b, [5, 6], 1))
    assert np.abs(a[:, 5:7] - b[:, 5:7]).max() <= 1
    for k in db:
        if db[k].dtype.kind == "f":
            np.testing.assert_allclose(da[k], db[k], rtol=1e-5, atol=1e-4,
                                       equal_nan=True, err_msg=k)
        else:
            np.testing.assert_array_equal(da[k], db[k], err_msg=k)


# fp32: summation order and the online-softmax rescale; bf16 output: one
# rounding of the output to bf16, plus P rounded to bf16 before P·V (at most
# ~2⁻⁹·max|v|; tests/test_torch_lm_kernels.py emulates it on the CPU).
LM_TOL = {torch.float32: 5e-5, torch.bfloat16: 2.0 ** -7}


def _lm_close(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    assert bool(torch.isfinite(got).all())
    err = float((got.float() - want.float()).abs().max())
    assert err <= LM_TOL[want.dtype] * float(want.float().abs().max()), err


@pytest.mark.parametrize("b,hq,hkv,sq,sk,d,dt,causal", [
    (2, 4, 2, 128, 128, 64, torch.float32, True),
    (1, 8, 1, 64, 64, 32, torch.float32, False),
    (2, 4, 4, 8, 128, 64, torch.float32, True),      # short q, long kv
    (1, 5, 1, 1000, 1000, 32, torch.float32, True),  # ragged tiles
    (1, 40, 8, 200, 333, 128, torch.bfloat16, True),  # Sq < Sk, ragged
    (2, 6, 3, 77, 77, 128, torch.bfloat16, False),
    (1, 3, 1, 1, 50, 64, torch.bfloat16, True)])     # one query row
def test_flash_attention_kernel(cuda, b, hq, hkv, sq, sk, d, dt, causal):
    g = torch.Generator().manual_seed(6)
    q = torch.randn((b, hq, sq, d), generator=g).to(cuda, dt)
    k = torch.randn((b, hkv, sk, d), generator=g).to(cuda, dt)
    v = torch.randn((b, hkv, sk, d), generator=g).to(cuda, dt)
    ops.reset_launches()
    got = ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] == 1
    _lm_close(got, ref.flash_attention(q, k, v, causal))


_EDGES = (1, 63, 64, 65, 127, 129)


def _edge_cases():
    """bf16 at the 64-row q tile's and 64-key tile's edges: every (Sq, Sk)
    pair, cycling D 32 / 64 / 128 and groups 1 / 5 / 8, B = 2; causal
    (offset Sk − Sq) where Sq ≤ Sk, except every fourth, and non-causal
    otherwise."""
    cases = []
    for i, (sq, sk) in enumerate((a, b) for a in _EDGES for b in _EDGES):
        d = (32, 64, 128)[i % 3]
        group = (1, 5, 8)[i // 3 % 3]
        hkv = 1 + i % 2
        cases.append((2, group * hkv, hkv, sq, sk, d,
                      sq <= sk and i % 4 != 3))
    return cases


@pytest.mark.parametrize("b,hq,hkv,sq,sk,d,causal", _edge_cases() + [
    (1, 40, 8, 2048, 2048, 128, True)])          # qwen2.5-14b's prefill
def test_flash_attention_bf16_tiles(cuda, b, hq, hkv, sq, sk, d, causal):
    g = torch.Generator().manual_seed(sq * 1000 + sk)
    q = torch.randn((b, hq, sq, d), generator=g).to(cuda, torch.bfloat16)
    k = torch.randn((b, hkv, sk, d), generator=g).to(cuda, torch.bfloat16)
    v = torch.randn((b, hkv, sk, d), generator=g).to(cuda, torch.bfloat16)
    ops.reset_launches()
    got = ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] == 1
    _lm_close(got, ref.flash_attention(q, k, v, causal))


def test_flash_attention_bf16_fused_projection_views(cuda):
    """q, k and v as head-split views of one fused (B, S, (Hq + 2 Hkv) D)
    projection: seq stride (Hq + 2 Hkv) D, offsets of whole heads."""
    b, s, hq, hkv, d = 2, 300, 8, 2, 64
    g = torch.Generator().manual_seed(10)
    qkv = torch.randn((b, s, (hq + 2 * hkv) * d), generator=g).to(
        cuda, torch.bfloat16).view(b, s, hq + 2 * hkv, d)
    q, k, v = (t.transpose(1, 2) for t in qkv.split([hq, hkv, hkv], dim=2))
    got = ops.flash_attention(q, k, v)
    _lm_close(got, ref.flash_attention(q.contiguous(), k.contiguous(),
                                       v.contiguous()))


@pytest.mark.parametrize("width,start", [(129, 1), (136, 1)])
def test_flash_attention_bf16_unaligned_view_raises(cuda, width, start):
    """A seq stride that is not a multiple of 8 elements (width 129) or a
    start off a 16-byte boundary (width 136, one element in) is refused:
    no copy, no plain fallback."""
    base = torch.zeros((1, 4, 64, width), device=cuda, dtype=torch.bfloat16)
    q = base[..., start:start + 128]
    kv = torch.zeros((1, 2, 64, 128), device=cuda, dtype=torch.bfloat16)
    ops.reset_launches()
    with pytest.raises(ValueError, match="16-byte"):
        ops.flash_attention(q, kv, kv)
    with pytest.raises(ValueError, match="16-byte"):
        ops.flash_attention(kv.repeat(1, 2, 1, 1), q[:, :2], kv)
    assert ops.LAUNCHES["flash_attention"] == 0


def test_flash_attention_kernel_takes_model_layout(cuda):
    """(B, S, H, D) activations as transposed views: no copy, the output
    in the same layout."""
    g = torch.Generator().manual_seed(7)
    q, k, v = (torch.randn((2, 90, h, 128), generator=g).to(cuda,
                                                           torch.bfloat16)
               for h in (8, 2, 2))
    got = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2))
    assert got.transpose(1, 2).is_contiguous()
    _lm_close(got, ref.flash_attention(q.transpose(1, 2).contiguous(),
                                       k.transpose(1, 2).contiguous(),
                                       v.transpose(1, 2).contiguous()))


# head dim 16 (command-r-35b-smoke's 128 / 8): a bf16 row is two 16-byte
# chunks; fp32 and bf16, causal and not, GQA groups 1 to 5, ragged tiles,
# Sq < Sk, one query row, and the smoke model's heads at a 2048 prefill
_D16_CASES = [
    (2, 8, 2, 128, 128, 16, torch.float32, True),
    (1, 5, 1, 77, 200, 16, torch.float32, False),
    (1, 5, 1, 1000, 1000, 16, torch.float32, True),
    (2, 8, 2, 128, 128, 16, torch.bfloat16, True),
    (1, 5, 1, 1000, 1000, 16, torch.bfloat16, True),
    (1, 12, 3, 200, 333, 16, torch.bfloat16, True),
    (2, 6, 3, 77, 77, 16, torch.bfloat16, False),
    (1, 4, 1, 1, 50, 16, torch.bfloat16, True),
    (1, 8, 2, 2048, 2048, 16, torch.bfloat16, True)]


@pytest.mark.parametrize("b,hq,hkv,sq,sk,d,dt,causal", _D16_CASES)
def test_flash_attention_head_dim_16(cuda, b, hq, hkv, sq, sk, d, dt,
                                     causal):
    g = torch.Generator().manual_seed(16 + sq)
    q = torch.randn((b, hq, sq, d), generator=g).to(cuda, dt)
    k = torch.randn((b, hkv, sk, d), generator=g).to(cuda, dt)
    v = torch.randn((b, hkv, sk, d), generator=g).to(cuda, dt)
    ops.reset_launches()
    got = ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] == 1
    _lm_close(got, ref.flash_attention(q, k, v, causal))


@pytest.mark.parametrize("b,s,di,n,dt", [
    (2, 16, 8, 4, torch.float32), (1, 33, 24, 5, torch.float32),
    (3, 8, 128, 16, torch.float32), (1, 100, 300, 16, torch.bfloat16),
    (2, 70, 64, 1, torch.float32), (1, 40, 40, 32, torch.float32),
    (1, 2048, 512, 16, torch.float32),
    # Di off the 32 channels a CTA takes at N = 16, S off the 32-step chunk
    (1, 1, 200, 16, torch.float32), (1, 31, 200, 16, torch.bfloat16),
    (2, 33, 200, 16, torch.float32), (1, 33, 72, 16, torch.bfloat16),
    (1, 2049, 200, 16, torch.float32), (1, 2049, 200, 16, torch.bfloat16),
    (1, 31, 100, 8, torch.float32), (1, 2049, 40, 32, torch.bfloat16)])
def test_mamba_scan_kernel(cuda, b, s, di, n, dt):
    g = torch.Generator().manual_seed(8)
    xdt = torch.randn((b, s, di), generator=g).to(cuda, dt)
    dtv = (torch.randn((b, s, di), generator=g).abs() * 0.1).to(cuda, dt)
    a = -torch.randn((di, n), generator=g).abs().to(cuda)
    bm = torch.randn((b, s, n), generator=g).to(cuda, dt)
    cm = torch.randn((b, s, n), generator=g).to(cuda, dt)
    ops.reset_launches()
    y, h = ops.mamba_scan(xdt, dtv, a, bm, cm)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["mamba_scan"] == 1
    y_p, h_p = ref.mamba_scan(xdt, dtv, a, bm, cm)
    _lm_close(y, y_p)
    _lm_close(h, h_p)


@pytest.mark.parametrize("arch", ["smoke", "qwen2.5-14b", "falcon-mamba-7b"])
def test_lm_serve_card_equals_cpu(cuda, arch):
    import dataclasses
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.serve import (Request, ServeEngine,
                                          default_smoke_model)
    from repro_torch.models import init_params, prefill
    cfg = default_smoke_model() if arch == "smoke" else get_smoke_config(arch)
    cfg = dataclasses.replace(cfg, param_dtype="float32",
                              compute_dtype="float32", cache_dtype="float32")
    params = init_params(cfg, 0, "cpu")
    rng = np.random.default_rng(9)
    prompts = [rng.integers(1, cfg.vocab_size, int(rng.integers(4, 40)))
               .astype(np.int32) for _ in range(4)]
    outs = []
    for dev in (cuda, torch.device("cpu")):
        p = _to(params, dev)
        reqs = [Request(i, pr, 8) for i, pr in enumerate(prompts)]
        stats = ServeEngine(cfg, n_slots=2, max_len=64, params=p).run(reqs)
        logits = [prefill(p, {"tokens": torch.as_tensor(pr[None], device=dev)},
                          cfg)[0].cpu() for pr in prompts]
        outs.append(([r.out for r in reqs], stats["ticks"], logits))
    assert outs[0][:2] == outs[1][:2]
    for got, want in zip(outs[0][2], outs[1][2]):
        assert float((got - want).abs().max()) <= 1e-4 * float(
            want.abs().max())


def _to(tree, dev):
    return {k: _to(v, dev) if isinstance(v, dict) else v.to(dev)
            for k, v in tree.items()}


# ---------------------------------------------------------------------------
# the backward kernels of flash_attention and mamba_scan
# ---------------------------------------------------------------------------

_FA_BWD_CASES = [
    (2, 4, 2, 128, 128, 64, torch.float32, True),
    (1, 8, 1, 64, 64, 32, torch.float32, False),
    (2, 4, 4, 8, 128, 64, torch.float32, True),      # short q, long kv
    (1, 5, 1, 1000, 1000, 32, torch.float32, True),  # ragged tiles
    (1, 40, 8, 200, 333, 128, torch.bfloat16, True),  # Sq < Sk, ragged
    (2, 6, 3, 77, 77, 128, torch.bfloat16, False),
    (1, 3, 1, 1, 50, 64, torch.bfloat16, True)]      # one query row


def _grad_close(got, want):
    """``_lm_close`` with a floor of 1e-3 on the scale: a gradient whose
    exact value is 0 (one key: dS = P (dP − rowsum(dO ∘ O)) = 0) is held
    to rounding noise of the O(1) inputs' products, not to 0."""
    assert got.dtype == want.dtype and got.shape == want.shape
    assert bool(torch.isfinite(got).all())
    err = float((got.float() - want.float()).abs().max())
    scale = max(float(want.float().abs().max()), 1e-3)
    assert err <= LM_TOL[want.dtype] * scale, err


def _fa_bwd_inputs(cuda, b, hq, hkv, sq, sk, d, dt, causal, seed):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn((b, hq, sq, d), generator=g).to(cuda, dt)
    k = torch.randn((b, hkv, sk, d), generator=g).to(cuda, dt)
    v = torch.randn((b, hkv, sk, d), generator=g).to(cuda, dt)
    do = torch.randn((b, hq, sq, d), generator=g).to(cuda, dt)
    o, lse = ref.flash_attention_with_lse(q, k, v, causal)
    return q, k, v, o, lse, do


def _fa_bwd_check(cuda, b, hq, hkv, sq, sk, d, dt, causal, seed):
    """The backward kernel against ``plain_bwd`` on the same o and
    log-sum-exp (one launch), bitwise equal on a second launch; the
    forward's log-sum-exp against the plain one."""
    q, k, v, o, lse, do = _fa_bwd_inputs(cuda, b, hq, hkv, sq, sk, d, dt,
                                         causal, seed)
    ops.reset_launches()
    got = ops.flash_attention_bwd(q, k, v, o, lse, do, causal)
    again = ops.flash_attention_bwd(q, k, v, o, lse, do, causal)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention_bwd"] == 2
    want = ref.flash_attention_bwd(q, k, v, o, lse, do, causal)
    for g_, a_, w_ in zip(got, again, want):
        assert torch.equal(g_, a_)
        _grad_close(g_, w_)
    from repro_torch.kernels import flash_attention as fa_k
    out = torch.empty_like(q)
    lse_k = torch.empty(q.shape[:3], dtype=torch.float32, device=cuda)
    fa_k.launch(q, k, v, out, causal, lse_k)
    live = torch.isfinite(lse)
    assert torch.equal(live, torch.isfinite(lse_k))
    assert float((lse_k - lse)[live].abs().max()) <= 1e-3 if live.any() \
        else True


@pytest.mark.parametrize("b,hq,hkv,sq,sk,d,dt,causal", _FA_BWD_CASES)
def test_flash_attention_bwd_kernel(cuda, b, hq, hkv, sq, sk, d, dt, causal):
    _fa_bwd_check(cuda, b, hq, hkv, sq, sk, d, dt, causal, 16)


@pytest.mark.parametrize("b,hq,hkv,sq,sk,d,causal", _edge_cases() + [
    (1, 40, 8, 2048, 2048, 128, True),           # qwen2.5-14b's training
    (1, 14, 2, 2048, 2048, 64, True),            # internvl2-1b's: group 7
    (1, 32, 32, 2048, 2048, 64, True),           # zamba2-1.2b's shared block
    (1, 16, 16, 2048, 2048, 128, True)])         # deepseek-moe-16b's
def test_flash_attention_bwd_bf16_tiles(cuda, b, hq, hkv, sq, sk, d, causal):
    _fa_bwd_check(cuda, b, hq, hkv, sq, sk, d, torch.bfloat16, causal,
                  sq * 1000 + sk)


# bf16 at the edges of the wgmma kernels' tiles: 64-row q tiles and
# 128-key blocks (dK / dV), 128-row blocks and 64-key tiles (dQ), one past
# and one short of each; groups 1, 5 and 8; D 32 (mma.sync), 64 and 128;
# Sq > Sk (non-causal: the plain version's output is NaN on a causal row
# with no key); and a grid of 256 dK / dV CTAs, which is not split
_FA_BWD_TILE_EDGES = [
    (1, 5, 1, 129, 129, 128, True), (1, 8, 1, 127, 127, 64, True),
    (2, 2, 2, 65, 191, 128, True), (1, 5, 1, 63, 257, 64, False),
    (1, 8, 1, 129, 63, 128, False), (1, 5, 1, 127, 129, 32, True),
    (1, 8, 2, 64, 128, 128, True), (2, 16, 16, 1024, 1024, 128, True)]


@pytest.mark.parametrize("b,hq,hkv,sq,sk,d,causal", _FA_BWD_TILE_EDGES)
def test_flash_attention_bwd_wgmma_tile_edges(cuda, b, hq, hkv, sq, sk, d,
                                              causal):
    _fa_bwd_check(cuda, b, hq, hkv, sq, sk, d, torch.bfloat16, causal,
                  sq * 7 + sk)


@pytest.mark.parametrize("b,hq,hkv,sq,sk,d,dt,causal", _D16_CASES)
def test_flash_attention_bwd_head_dim_16(cuda, b, hq, hkv, sq, sk, d, dt,
                                         causal):
    """The backward at D = 16: the Dv pre-pass and the mma.sync (bf16) or
    FMA (fp32) dK / dV and dQ kernels, whose 256-thread tile loads leave
    half the threads idle."""
    _fa_bwd_check(cuda, b, hq, hkv, sq, sk, d, dt, causal, 160 + sq)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_flash_attention_autograd_takes_the_kernels(cuda, dt):
    """The model's transposed (B, S, H, D) views through autograd: one
    forward and one backward launch, the gradients in the views' layout
    and within the tolerance of the plain version's autograd."""
    from repro_torch.models.layers import blocked_attention
    g = torch.Generator().manual_seed(17)
    base = [torch.randn((2, 90, h, 64), generator=g).to(cuda, dt)
            for h in (8, 2, 2)]
    do = torch.randn((2, 90, 8, 64), generator=g).to(cuda, dt)
    ops.reset_launches()
    x = [t.clone().requires_grad_() for t in base]
    blocked_attention(*x).backward(do)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] == 1
    assert ops.LAUNCHES["flash_attention_bwd"] == 1
    y = [t.float().cpu().requires_grad_() for t in base]
    ref.flash_attention(*(t.transpose(1, 2) for t in y)).transpose(
        1, 2).backward(do.float().cpu())
    for a, w in zip(x, y):
        assert a.grad.is_contiguous()
        _lm_close(a.grad.cpu(), w.grad.to(dt))


_MS_CASES = [
    (2, 16, 8, 4, torch.float32), (1, 33, 24, 5, torch.float32),
    (3, 8, 128, 16, torch.float32), (1, 100, 300, 16, torch.bfloat16),
    (2, 70, 64, 1, torch.float32), (1, 40, 40, 32, torch.float32),
    (1, 2048, 512, 16, torch.float32),
    (1, 1, 200, 16, torch.float32), (1, 31, 200, 16, torch.bfloat16),
    (2, 33, 200, 16, torch.float32), (1, 33, 72, 16, torch.bfloat16),
    (1, 2049, 200, 16, torch.float32), (1, 2049, 200, 16, torch.bfloat16),
    (1, 31, 100, 8, torch.float32), (1, 2049, 40, 32, torch.bfloat16),
    # Di off the backward's 64-channel blocks (16 at N = 32), S one past
    # and one short of its 16-step halves and 32-step chunks
    (1, 17, 65, 16, torch.float32), (2, 15, 127, 16, torch.bfloat16),
    (1, 47, 130, 32, torch.float32), (1, 33, 70, 8, torch.bfloat16)]


@pytest.mark.parametrize("b,s,di,n,dt", _MS_CASES)
def test_mamba_scan_bwd_kernel(cuda, b, s, di, n, dt):
    """The backward kernel against ``plain_bwd`` (dh_final given on odd
    batch sizes, None otherwise), bitwise equal on a second launch, and
    the forward instance that stores the chunk states: its y and h_final
    against the plain recurrence's."""
    g = torch.Generator().manual_seed(18)
    xdt = torch.randn((b, s, di), generator=g).to(cuda, dt)
    dtv = (torch.randn((b, s, di), generator=g).abs() * 0.1).to(cuda, dt)
    a = -torch.randn((di, n), generator=g).abs().to(cuda)
    bm = torch.randn((b, s, n), generator=g).to(cuda, dt)
    cm = torch.randn((b, s, n), generator=g).to(cuda, dt)
    dy = torch.randn((b, s, di), generator=g).to(cuda, dt)
    dh = torch.randn((b, di, n), generator=g).to(cuda) if b % 2 else None
    ops.reset_launches()
    y, h, hc = ops.mamba_scan_chunks(xdt, dtv, a, bm, cm)
    got = ops.mamba_scan_bwd(xdt, dtv, a, bm, cm, dy, dh, hc)
    again = ops.mamba_scan_bwd(xdt, dtv, a, bm, cm, dy, dh, hc)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["mamba_scan"] == 1
    assert ops.LAUNCHES["mamba_scan_bwd"] == 2
    y_p, h_p = ref.mamba_scan(xdt, dtv, a, bm, cm)
    _lm_close(y, y_p)
    _lm_close(h, h_p)
    assert float(hc[:, 0].abs().max()) == 0.0
    want = ref.mamba_scan_bwd(xdt, dtv, a, bm, cm, dy, dh)
    for g_, a_, w_ in zip(got, again, want):
        assert torch.equal(g_, a_)
        _grad_close(g_, w_)


def test_mamba_scan_autograd_takes_the_kernels(cuda):
    """Through autograd with h_final unused, as in training: one forward
    and one backward launch, gradients within the tolerance of the plain
    version's autograd."""
    g = torch.Generator().manual_seed(19)
    b, s, di, n = 2, 70, 64, 16
    base = [torch.randn((b, s, di), generator=g),
            torch.randn((b, s, di), generator=g).abs() * 0.1,
            -torch.randn((di, n), generator=g).abs(),
            torch.randn((b, s, n), generator=g),
            torch.randn((b, s, n), generator=g)]
    dy = torch.randn((b, s, di), generator=g)
    ops.reset_launches()
    x = [t.to(cuda).requires_grad_() for t in base]
    ops.mamba_scan(*x)[0].backward(dy.to(cuda))
    torch.cuda.synchronize()
    assert ops.LAUNCHES["mamba_scan"] == 1
    assert ops.LAUNCHES["mamba_scan_bwd"] == 1
    y = [t.clone().requires_grad_() for t in base]
    ref.mamba_scan(*y)[0].backward(dy)
    for a_, w in zip(x, y):
        _lm_close(a_.grad.cpu(), w.grad)


def test_moe_train_steps_repeat_bit_for_bit(cuda):
    """deepseek-moe-16b's bf16 smoke config: a 2-microbatch train step
    from two copies of one state on one batch gives equal parameters and
    optimizer state, leaf for leaf (the dispatch's and the combine's
    indexing backward included)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import init_params
    from repro_torch.train.loop import TrainState, make_train_step
    from repro_torch.train.optimizer import OptimizerConfig, init_opt_state
    cfg = get_smoke_config("deepseek-moe-16b")
    params = init_params(cfg, 0, cuda)
    g = np.random.default_rng(0)
    toks = torch.as_tensor(g.integers(1, cfg.vocab_size, (4, 64)),
                           dtype=torch.int32, device=cuda)
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, 1)}
    step = make_train_step(cfg, OptimizerConfig(warmup_steps=1,
                                                total_steps=10),
                           n_microbatches=2)
    runs = []
    for _ in range(2):
        p = tu.tree_map(torch.clone, params)
        st, m = step(TrainState(p, init_opt_state(p), torch.zeros(
            (), dtype=torch.int32, device=cuda)), batch)
        runs.append([t for _, t in tu.tree_leaves(st.params)]
                    + [t for _, t in tu.tree_leaves(st.opt)] + [m["loss"]])
    assert bool(torch.isfinite(runs[0][-1]))
    assert all(torch.equal(a, b) for a, b in zip(*runs))


@pytest.fixture
def nccl_rank(cuda, tmp_path):
    """One NCCL rank on the card for the test's duration (a ``FileStore``
    rendezvous under the test's temporary directory)."""
    from repro_torch import dist
    dist.init_ranks("nccl", 0, 1, f"file://{tmp_path}/rendezvous")
    try:
        yield cuda
    finally:
        torch.distributed.destroy_process_group()


def test_one_rank_nccl_zero_step_equals_the_step_without_a_mesh(nccl_rank):
    """qwen2.5-14b's bf16 smoke config: two ``shard_grads_like_opt`` steps
    under a (1, 1) NCCL mesh (every collective runs, on one rank) equal
    two steps without a mesh from the same state, leaf for leaf."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.train.loop import (init_train_state, make_train_step,
                                        shard_train_state)
    from repro_torch.train.optimizer import OptimizerConfig
    cfg = get_smoke_config("qwen2.5-14b")
    g = np.random.default_rng(0)
    batches = []
    for _ in range(2):
        toks = torch.as_tensor(g.integers(1, cfg.vocab_size, (4, 64)),
                               dtype=torch.int32, device=nccl_rank)
        batches.append({"tokens": toks, "labels": torch.roll(toks, -1, 1)})
    mesh = make_host_mesh((1, 1))
    runs = []
    for use_mesh in (False, True):
        st = init_train_state(cfg, 0, nccl_rank)
        with mesh if use_mesh else contextlib.nullcontext():
            st = shard_train_state(st, cfg)
            step = make_train_step(cfg, OptimizerConfig(
                warmup_steps=1, total_steps=10), n_microbatches=2,
                shard_grads_like_opt=use_mesh)
            ms = [step(st, b)[1] for b in batches]
        runs.append([t for _, t in tu.tree_leaves(st.params)]
                    + [t for _, t in tu.tree_leaves(st.opt)]
                    + [m[k] for m in ms for k in ("loss", "grad_norm")])
    assert all(torch.equal(a, b) for a, b in zip(*runs))


def test_one_rank_nccl_expert_parallel_moe_equals_dense(nccl_rank):
    """deepseek-moe-16b's smoke config: ``moe_block`` under expert
    parallelism at model = 1 (one all_reduce combines the experts) equals
    the dense block, output and aux."""
    from repro_torch import dist
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import decoder, layers as L
    cfg = get_smoke_config("deepseek-moe-16b")
    lp = decoder._layer(decoder.init_params(cfg, 0, nccl_rank)["layers"],
                        0)["moe"]
    x = torch.randn((2, 64, cfg.d_model), generator=torch.Generator(
        ).manual_seed(0)).to(nccl_rank, cfg.cdtype)
    want = L.moe_block(lp, x, cfg)
    with make_host_mesh((1, 1)):
        assert L.expert_parallel(cfg) and dist.current_mesh() is not None
        got = L.moe_block(lp, x, cfg)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("arch", ["qwen2.5-14b", "falcon-mamba-7b"])
def test_one_rank_nccl_decode_step_equals_the_step_without_a_mesh(
        nccl_rank, arch):
    """The bf16 smoke config's ``prefill`` and three ``decode_step`` s
    under a (1, 1) NCCL mesh (the tensor-parallel path: vocab-split
    embedding and logits, the sequence-split cache and the flash-decode
    combine, every collective on one rank) equal the same without a
    mesh: every logit and the cache, bit for bit."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import decoder
    cfg = get_smoke_config(arch)
    params = decoder.init_params(cfg, 0, nccl_rank)
    g = np.random.default_rng(0)
    toks = torch.as_tensor(g.integers(1, cfg.vocab_size, (2, 64)),
                           dtype=torch.int32, device=nccl_rank)
    steps = [torch.as_tensor(g.integers(1, cfg.vocab_size, (2, 1)),
                             dtype=torch.int32, device=nccl_rank)
             for _ in range(3)]
    mesh = make_host_mesh((1, 1))
    runs = []
    for use_mesh in (False, True):
        with mesh if use_mesh else contextlib.nullcontext():
            logits, cache = decoder.prefill(params, {"tokens": toks}, cfg)
            out = [logits]
            for t in steps:
                logits, cache = decoder.decode_step(params, cache, t, cfg)
                out.append(logits)
        runs.append(out + [cache[k] for k in sorted(cache)])
    assert all(torch.equal(a, b) for a, b in zip(*runs))


def test_detect_step_on_the_card_equals_the_cpu(cuda):
    """``core.detect.detect_step`` on a 12,000-sample chunk at narrow
    widths: every output equal to the CPU's, one launch each of
    ``stft_mag``, ``haar2d`` and ``minmax_sig_buckets``."""
    from repro_torch.core import align, detect, fingerprint, synth
    from repro_torch.core.lsh import LSHConfig
    fcfg = fingerprint.FingerprintConfig(img_time=32, img_hop=8, top_k=64,
                                         mad_sample_rate=1.0, img_freq=16)
    cfg = detect.DetectConfig(
        fingerprint=fcfg,
        lsh=LSHConfig(n_tables=100, n_funcs=4, n_matches=2, bucket_cap=8,
                      min_dt=fcfg.overlap_fingerprints,
                      occurrence_frac=0.05),
        align=align.AlignConfig(channel_threshold=3, min_cluster_sim=4,
                                min_cluster_size=1, min_stations=2))
    ds = synth.make_dataset(synth.SynthConfig(
        duration_s=420.0, n_stations=3, n_sources=2, events_per_source=4,
        repeating_noise_stations=(0,), event_snr=3.0, seed=3))
    x = torch.as_tensor(ds.waveforms[1][:12000])
    med, mad = fingerprint.mad_stats(
        fingerprint.coeffs_from_waveform(x, fcfg), 1.0)
    want = detect.detect_step(x, med, mad, cfg, device="cpu")
    ops.reset_launches()
    got = detect.detect_step(x.to(cuda), med, mad, cfg)
    torch.cuda.synchronize()
    assert {k: ops.LAUNCHES[k] for k in
            ("stft_mag", "haar2d", "minmax_sig_buckets", "minmax_hash",
             "jaccard_popcount")} == {"stft_mag": 1, "haar2d": 1,
                                      "minmax_sig_buckets": 1,
                                      "minmax_hash": 0, "jaccard_popcount": 0}
    assert bool(want["pair_valid"].any())
    for k, v in want.items():
        assert got[k].device.type == "cuda"
        assert torch.equal(got[k].cpu(), v), k


@pytest.mark.parametrize("width", [2, 3])
def test_sharded_stream_on_the_card_equals_the_pooled_run(cuda, width):
    """The bounded 3-station smoke stream on the card under the mesh
    ``[cuda] * width`` (width 2 pads one row): one pool shard a mesh
    entry, each kernel launched on every shard, and alerts, detections
    and every station's pairs equal to the card's one-device pool."""
    from repro_torch.configs import fast_seismic
    from repro_torch.core import SynthConfig, make_dataset
    from repro_torch.stream import StreamingDetector
    ds = make_dataset(SynthConfig(duration_s=600.0, n_stations=3,
                                  n_sources=2, events_per_source=5,
                                  event_snr=3.0, seed=11))
    runs = []
    for devices in (None, [cuda] * width):
        det = StreamingDetector(fast_seismic.smoke_config(),
                                fast_seismic.stream_bounded_smoke_config(),
                                n_stations=3, device=cuda, devices=devices)
        ops.reset_launches()
        for a in range(0, ds.waveforms.shape[1], 6000):
            det.push(ds.waveforms[:, a:a + 6000])
        dets, _, _ = det.finalize()
        torch.cuda.synchronize()
        launches = dict(ops.LAUNCHES)
        blocks = det.stations[0].stats.blocks
        runs.append(([x.tolist() for x in det.alerts],
                     {k: v.cpu().tolist() for k, v in dets.items()},
                     [st.stats.pairs for st in det.stations]))
        shards = 1 if devices is None else width
        assert (det.mesh.size if det.mesh else 1) == shards
        assert launches["minmax_sig_buckets"] == shards * blocks
    assert runs[0] == runs[1]
    assert sum(runs[0][2]) > 0


def test_detect_step_sharded_on_the_card_equals_detect_step(cuda):
    """``detect_step_sharded`` on 4 chunks over ``[cuda] * 2`` in two
    pooled calls of 2 chunks: every output row equals ``detect_step`` on
    that chunk alone on the card, with one launch of each kernel a call."""
    from repro_torch import dist
    from repro_torch.configs import fast_seismic
    from repro_torch.core import SynthConfig, detect, fingerprint
    from repro_torch.core import make_dataset
    cfg = fast_seismic.smoke_config()
    ds = make_dataset(SynthConfig(duration_s=600.0, n_stations=1,
                                  n_sources=2, events_per_source=10,
                                  event_snr=3.0, seed=11,
                                  repeating_noise_stations=(0,)))
    chunks = torch.as_tensor(ds.waveforms[0, :60000]).reshape(4, 15000)
    med, mad = fingerprint.mad_stats(
        fingerprint.coeffs_from_waveform(chunks.reshape(-1),
                                         cfg.fingerprint), 1.0)
    mesh = dist.station_mesh(devices=[cuda] * 2)
    ops.reset_launches()
    got = detect.detect_step_sharded(chunks.to(cuda), med, mad, cfg, mesh)
    torch.cuda.synchronize()
    assert {k: ops.LAUNCHES[k] for k in
            ("stft_mag", "haar2d", "minmax_sig_buckets")} == \
        {"stft_mag": 2, "haar2d": 2, "minmax_sig_buckets": 2}
    for r in range(4):
        one = detect.detect_step(chunks[r].to(cuda), med, mad, cfg)
        for k, v in one.items():
            assert got[k].is_cuda and torch.equal(got[k][r], v), k



def _work_case(name: str, dev):
    """(call, its ``cost.py`` work) of one kernel at a shape of its path,
    the data-dependent counts (set bits, valid pairs, distinct rows) read
    from the inputs; ``call(to)`` runs the wrapper on ``to(*inputs)``."""
    from repro_torch.kernels import cost
    from repro_torch.kernels import flash_attention as fa_k
    g = torch.Generator(device=dev).manual_seed(3)
    i32 = torch.int32
    if name == "stft_mag":
        wave = torch.randn((4, 54375), generator=g, device=dev)
        win = torch.hann_window(200, device=dev)
        dr, di = (torch.as_tensor(np.ascontiguousarray(m[:, 1:36]),
                                  device=dev)
                  for m in ref.dft_matrices(200, 101))
        return (lambda to: ops.stft_mag(*to(wave, win, dr, di), 25),
                cost.stft_mag(4, 54375, 200, 35, 25))
    if name == "haar2d":
        imgs = torch.randn((1024, 32, 128), generator=g, device=dev)
        return (lambda to: ops.haar2d(*to(imgs)),
                cost.haar2d(1024, 32, 128))
    if name in ("minmax_hash", "minmax_sig_buckets"):
        bits = torch.rand((2048, 8192), generator=g, device=dev) < 0.05
        packed = tu.pack_bits(bits).contiguous()
        mp = torch.randint(0, 2**31 - 1, (8192, 400), generator=g,
                           device=dev, dtype=i32)
        nnz, dims = int(bits.sum()), int(bits.any(0).sum())
        if name == "minmax_hash":
            return (lambda to: ops.minmax_hash(*to(packed, mp)),
                    cost.minmax_hash(2048, 256, 400, nnz=nnz, dims=dims))
        salts = torch.randint(0, 2**31 - 1, (100,), generator=g, device=dev,
                              dtype=i32)
        return (lambda to: ops.minmax_sig_buckets(
                    *to(packed, mp, salts), use_minmax=True,
                    n_buckets=16384),
                cost.minmax_sig_buckets(2048, 256, 400, 100, nnz=nnz,
                                        dims=dims))
    if name == "jaccard_popcount":
        pk = torch.randint(-2**31, 2**31 - 1, (4, 4096, 256), generator=g,
                           device=dev, dtype=i32)
        i1, i2 = (torch.randint(0, 4096, (4, 4096), generator=g, device=dev,
                                dtype=i32) for _ in range(2))
        rows = sum(int(torch.unique(torch.cat([i1[s], i2[s]])).numel())
                   for s in range(4))
        return (lambda to: ops.jaccard_popcount(*to(pk, i1, i2)),
                cost.jaccard_popcount(4, 4096, 4096, 256, live=4 * 4096,
                                      rows=rows))
    if name == "occurrence_filter":
        occ = _occurrence_inputs(SEARCH_SLOTS, SEARCH_FP, 0.005, 1000, dev)
        return (lambda to: ops.occurrence_filter(*to(*occ), SEARCH_FP, 431),
                cost.occurrence_filter(SEARCH_SLOTS, SEARCH_FP,
                                       live=int(occ[3].sum())))
    if name.startswith("flash_attention"):
        bf = torch.bfloat16
        q = torch.randn((1, 8, 1024, 128), generator=g, device=dev).to(bf)
        k, v = (torch.randn((1, 2, 1024, 128), generator=g,
                            device=dev).to(bf) for _ in range(2))
        if name == "flash_attention":
            return (lambda to: ops.flash_attention(*to(q, k, v)),
                    cost.flash_attention(1, 8, 2, 1024, 1024, 128, bf))
        o = torch.empty_like(q)
        lse = torch.empty((1, 8, 1024), dtype=torch.float32, device=dev)
        fa_k.launch(q, k, v, o, True, lse)
        return (lambda to: ops.flash_attention_bwd(*to(q, k, v, o, lse, q)),
                cost.flash_attention_bwd(1, 8, 2, 1024, 1024, 128, bf))
    xdt = torch.randn((1, 1024, 2048), generator=g, device=dev)
    dt = torch.rand((1, 1024, 2048), generator=g, device=dev) * 0.1
    a = -torch.arange(1, 17, dtype=torch.float32,
                      device=dev).expand(2048, 16).contiguous()
    b, c = (torch.randn((1, 1024, 16), generator=g, device=dev)
            for _ in range(2))
    if name == "mamba_scan":
        return (lambda to: ops.mamba_scan(*to(xdt, dt, a, b, c)),
                cost.mamba_scan(1, 1024, 2048, 16, torch.float32))
    hc = ops.mamba_scan_chunks(xdt, dt, a, b, c)[2]
    return (lambda to: ops.mamba_scan_bwd(*to(xdt, dt, a, b, c, xdt), None,
                                          *to(hc)),
            cost.mamba_scan_bwd(1, 1024, 2048, 16, torch.float32))


@pytest.mark.parametrize("name", ["stft_mag", "haar2d", "minmax_hash",
                                  "minmax_sig_buckets", "jaccard_popcount",
                                  "occurrence_filter", "flash_attention", "flash_attention_bwd",
                                  "mamba_scan", "mamba_scan_bwd"])
def test_kernel_time_is_at_least_its_cost_bound_and_meta_shapes_match(
        cuda, name):
    """Each kernel at a shape of its path: its CUDA-event time (the mean
    of 20 launches) is at least ``kernels/cost.py``'s bound, and the
    ``meta`` path's outputs have the kernel's shapes and dtypes."""
    from repro_torch.kernels import cost
    call, work = _work_case(name, cuda)
    same = lambda *ts: ts  # noqa: E731
    got = call(same)
    for _ in range(3):
        call(same)
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(20):
        call(same)
    b.record()
    torch.cuda.synchronize()
    ms = a.elapsed_time(b) / 20
    bound, _ = cost.bound_ms(work)
    assert ms >= bound, (ms, bound)
    launches = dict(ops.LAUNCHES)
    meta = call(lambda *ts: tuple(torch.empty_like(t, device="meta")
                                  for t in ts))
    assert ops.LAUNCHES == launches
    got, meta = ((x,) if isinstance(x, torch.Tensor) else x
                 for x in (got, meta))
    assert [(t.shape, t.dtype, t.is_meta) for t in meta] == \
        [(t.shape, t.dtype, True) for t in got]
