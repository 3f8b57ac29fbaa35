#!/usr/bin/env python3
"""Hold one of the port's CUDA kernels against another build of it on the
card: outputs compared element by element, times taken in turns.

    python3 tools/kernel_ab.py stft_mag path/to/other_stft_mag.cu
    python3 tools/kernel_ab.py flash_attention path/to/other.cu
    python3 tools/kernel_ab.py haar2d path/to/other.cu
    python3 tools/kernel_ab.py mamba_scan path/to/other.cu
    python3 tools/kernel_ab.py minmax_sig_buckets path/to/other_minmax_hash.cu
    python3 tools/kernel_ab.py minmax_hash path/to/other_minmax_hash.cu
    python3 tools/kernel_ab.py jaccard_popcount path/to/other.cu

The other source must export the same C entry point as
``src/repro_torch/csrc/<kernel>.cu`` (an earlier commit's file, e.g. from
``git show <rev>:src/repro_torch/csrc/stft_mag.cu``, or a variant of the
tree's). It is built with the port's ``nvcc`` flags into
``build/kernel_ab/`` and swapped in for the tree's library around each
call, so both go through the same wrapper. Times are medians of
CUDA-event timings of the device's work (each call queued behind a ~0.1
ms device busy wait, as in ``chip_smoke.py``), taken other, tree, tree,
other. Shapes: ``stft_mag`` at one paper block (``fast_seismic.config()``,
4 rows × 256 fingerprints) and the card tests' shapes;
``flash_attention`` at ``chip_smoke.py``'s cases; ``haar2d`` at the
paper block (1024 × 32 × 128), image counts off a CTA's share and the
card tests' shapes, its whole output held bit for bit; ``mamba_scan`` at
falcon-mamba-7b's prefill (1 × 2048 × 8192 × 16, fp32 and bf16, with
``chip_smoke.py``'s inputs) and ragged card-test shapes, ``h_final`` held
bit for bit and y's difference printed; ``minmax_sig_buckets`` (both
outputs bit for bit) at the paper block (1024 × 256 words × 400
functions, 4 a table), blocks of 256–768 rows (one to three stations) and
the card tests' shapes, ``minmax_hash`` (both planes bit for bit) at a
station-day (43,184 × 256 × 400), the MinHash baseline's H = 800, 256–768
rows and the card tests' shapes, each on random bits at
top_k / D = 400 / 8192 (5% elsewhere) with every 97th row empty. Both
come from ``csrc/minmax_hash.cu``; a build of it without the tiled
entry points (an earlier commit's) runs its row kernel at every shape.
``jaccard_popcount`` at the paper replay's verify (4 stations × 4096
slots × 256 words over a 43,184-row ring, i2 a row of one 256-row block
and i1 any row before its end): all valid on both plans (the ring on 16
bytes and a copy 4 bytes off), the replay's real valid prefixes, none
valid, 40% scattered, and all valid with both rows anywhere in the ring;
and at W = 32, 33 and 512, M = 1,
33 and 20,000; ids not reduced modulo the ring, garbage ids in invalid
slots; warm and behind a 128 MB L2 flush, the two builds called in
turn within each of 200 iterations (``time_turns``), twice, in both
orders. An other source whose entry
point takes no valid mask (an earlier commit's, ids reduced by its
caller) is called directly with ids masked and reduced before the
timing, its scores masked after; ``other_chain_ms`` times its caller's
whole chain (mask, modulo, kernel, mask: 8 launches) as
``verify_pairs`` ran it.
Prints one JSON line per shape and needs a CUDA card.
"""
from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import hashlib
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def build(src: pathlib.Path) -> ctypes.CDLL:
    from repro_torch.kernels import _build
    out_dir = ROOT / "build" / "kernel_ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    lib = out_dir / f"{src.stem}-{digest}.so"
    if not lib.exists():
        subprocess.run([_build.nvcc(), *_build.FLAGS, "-o", str(lib),
                        str(src)], check=True, capture_output=True)
    return ctypes.CDLL(str(lib))


# The replay's valid prefix a station (4 stations x 4096 slots): its pairs
# emitted over chip_smoke.py's whole paper replay (its `paper` line,
# `pairs_emitted_per_station`), more than any one block holds.
REPLAY_PREFIX = (8, 39, 37, 13)

# the source (and library) each kernel of the command line is built from
SOURCE = {"minmax_sig_buckets": "minmax_hash"}


class _RowLaunch:
    """Stands in for a ``*_tiled_launch`` entry point that a build lacks:
    calls the row entry point with the plan's arguments dropped."""

    def __init__(self, row):
        self.row, self.argtypes, self.restype = row, [], ctypes.c_int

    def __call__(self, *args):
        from repro_torch.kernels import minmax_hash as mm_k
        cut = len(mm_k.PLAN_TYPES) + 1           # the plan, then the stream
        self.row.argtypes = self.argtypes[:-cut] + self.argtypes[-1:]
        self.row.restype = self.restype
        return self.row(*args[:-cut], args[-1])


class RowOnly:
    """A Min-Max build with only the row kernel's entry points (an earlier
    commit's source): the wrapper's tiled launches take its row kernel."""

    def __init__(self, lib: ctypes.CDLL):
        self._lib = lib

    def __getattr__(self, attr: str):
        if attr.endswith("_tiled_launch"):
            return _RowLaunch(getattr(self._lib,
                                      attr.replace("_tiled_", "_")))
        return getattr(self._lib, attr)


@contextlib.contextmanager
def swapped(name: str, lib: ctypes.CDLL):
    """The port's wrappers launch ``lib`` instead of the tree's build."""
    from repro_torch.kernels import _build
    name = SOURCE.get(name, name)
    if name == "minmax_hash" and not hasattr(lib, "minmax_hash_tiled_launch"):
        lib = RowOnly(lib)
    own = _build.load(name)
    _build._LIBS[name] = lib
    try:
        yield
    finally:
        _build._LIBS[name] = own


def time_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(200_000)   # device busy while the host enqueues
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    times = sorted(a.elapsed_time(b) for a, b in pairs)
    return times[len(times) // 2]


def time_turns(fns, iters: int = 200, warmup: int = 5,
               flush=None) -> list[float]:
    """CUDA-event medians of each of ``fns``, called in turn within each
    iteration (each behind its own busy wait, and behind an L2 flush
    with ``flush``), so that a drift of the card's clocks or of its
    neighbours moves every one of them alike."""
    import torch
    for _ in range(warmup):
        for fn in fns:
            fn()
    torch.cuda.synchronize()
    events = [[] for _ in fns]
    for _ in range(iters):
        for fn, ev in zip(fns, events):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            if flush is not None:
                flush.zero_()
            torch.cuda._sleep(200_000)
            a.record()
            fn()
            b.record()
            ev.append((a, b))
    torch.cuda.synchronize()
    out = []
    for ev in events:
        times = sorted(a.elapsed_time(b) for a, b in ev)
        out.append(times[len(times) // 2])
    return out


def compare(name: str, other: ctypes.CDLL, label: str, fn, plain,
            names: tuple = ("out",)) -> dict:
    """``fn()`` (one tensor, or a tuple named by ``names``) through the
    tree's kernel and the other build: bit equality of the first output,
    max abs difference of each output between the builds and to ``plain``,
    times in turns (other, tree, tree, other)."""
    import torch

    def run():
        got = fn()
        return got if isinstance(got, tuple) else (got,)

    tree_out = run()
    with swapped(name, other):
        other_out = run()
    torch.cuda.synchronize()
    plain = plain if isinstance(plain, tuple) else (plain,)
    times = {"other": [], "tree": []}
    for who in ("other", "tree", "tree", "other"):
        if who == "other":
            with swapped(name, other):
                times[who].append(time_ms(fn))
        else:
            times[who].append(time_ms(fn))
    row = {"kernel": name, "case": label}
    for i, nm in enumerate(names):
        pre = "" if i == 0 else f"{nm}_"
        row[f"{pre}bit_equal"] = bool(torch.equal(tree_out[i], other_out[i]))
        t, o, p = (x[i].double() for x in (tree_out, other_out, plain))
        row.update({f"{pre}max_abs_diff": float((t - o).abs().max()),
                    f"{pre}tree_err_to_plain": float((t - p).abs().max()),
                    f"{pre}other_err_to_plain": float((o - p).abs().max()),
                    f"{pre}max_abs_plain": float(p.abs().max())})
    row.update({"tree_ms": times["tree"], "other_ms": times["other"]})
    return row


def stft_cases(dev):
    import numpy as np
    import torch
    from repro_torch.configs import fast_seismic
    from repro_torch.core import fingerprint as fp_mod
    from repro_torch.kernels import ref
    fcfg = fast_seismic.config().fingerprint
    c = fp_mod._consts(fcfg, dev)
    g = torch.Generator().manual_seed(0)
    wave = torch.randn((4, fcfg.block_samples(256)), generator=g).to(dev)
    yield "paper_block", (wave, c["window"], c["dft_r"], c["dft_i"],
                          fcfg.stft_hop)
    for rows, n, frame_len, hop, k in ((3, 777, 50, 7, 9),
                                       (1, 4000, 1024, 100, 40),
                                       (2, 3000, 200, 25, 35)):
        wave = torch.randn((rows, n), generator=g).to(dev)
        dr, di = (torch.as_tensor(np.ascontiguousarray(m[:, 1:1 + k]),
                                  device=dev)
                  for m in ref.dft_matrices(frame_len, frame_len // 2 + 1))
        yield (f"{rows}x{n}_L{frame_len}_hop{hop}_K{k}",
               (wave, torch.hann_window(frame_len).to(dev), dr, di, hop))


def attention_cases(dev):
    import torch
    g = torch.Generator(device=dev).manual_seed(0)
    for b, hq, hkv, sq, sk, d, dt in (
            (1, 40, 8, 2048, 2048, 128, torch.bfloat16),
            (1, 40, 8, 512, 2048, 128, torch.bfloat16),
            (1, 40, 8, 1000, 1000, 128, torch.bfloat16),
            (1, 40, 8, 2048, 2048, 128, torch.float32)):
        q = torch.randn((b, hq, sq, d), generator=g, device=dev).to(dt)
        k = torch.randn((b, hkv, sk, d), generator=g, device=dev).to(dt)
        v = torch.randn((b, hkv, sk, d), generator=g, device=dev).to(dt)
        yield f"{b}x{hq}/{hkv}x{sq}x{sk}x{d}_{str(dt)[6:]}", (q, k, v)


def haar_cases(dev):
    import torch
    g = torch.Generator().manual_seed(1)
    for n, h, w in ((1024, 32, 128), (1, 32, 128), (7, 32, 128),
                    (1023, 32, 128), (5, 8, 8), (64, 16, 32), (3, 64, 256)):
        yield f"{n}x{h}x{w}", torch.randn((n, h, w), generator=g).to(dev)


def scan_cases(dev):
    import torch
    import torch.nn.functional as F
    g = torch.Generator().manual_seed(0)
    for b, s, di, n, dt in ((1, 2048, 8192, 16, torch.float32),
                            (1, 2048, 8192, 16, torch.bfloat16),
                            (1, 2049, 200, 16, torch.float32),
                            (2, 33, 300, 16, torch.bfloat16),
                            (1, 31, 24, 5, torch.float32)):
        # chip_smoke.py's inputs: A = -(1..N), a softplus-sized dt
        xdt = torch.randn((b, s, di), generator=g)
        dtv = F.softplus(torch.randn((b, s, di), generator=g) - 4.6)
        a = -torch.arange(1, n + 1, dtype=torch.float32).expand(di, n)
        bm = torch.randn((b, s, n), generator=g)
        cm = torch.randn((b, s, n), generator=g)
        yield (f"{b}x{s}x{di}x{n}_{str(dt)[6:]}",
               (xdt.to(dev, dt), dtv.to(dev, dt), a.contiguous().to(dev),
                bm.to(dev, dt), cm.to(dev, dt)))


def random_packed(n: int, d: int, density: float, g, dev):
    """(n, d / 32) packed words of random bits, every 97th row empty."""
    import torch
    from repro_torch import utils
    packed = torch.cat([utils.pack_bits(torch.rand(
        (min(4096, n - r), d), generator=g, device=dev) < density)
        for r in range(0, n, 4096)])
    packed[::97] = 0
    return packed


def minmax_sig_cases(dev):
    import torch
    from repro_torch.core import lsh
    g = torch.Generator(device=dev).manual_seed(0)
    for n, d, t, f, use_minmax in ((1024, 8192, 100, 4, True),
                                   (13, 320, 12, 3, True),
                                   (256, 8192, 100, 4, True),
                                   (384, 8192, 100, 4, True),
                                   (512, 8192, 100, 4, True),
                                   (768, 8192, 100, 4, True),
                                   (7, 32768, 300, 4, True),
                                   (9, 128, 5, 2, False),
                                   (1000, 1024, 20, 2, True)):
        density = 400 / 8192 if d == 8192 else 0.05
        mappings = torch.randint(0, 2**31 - 1, (d, t * f), generator=g,
                                 device=dev, dtype=torch.int32)
        yield (f"{n}x{d // 32}x{t * f}_f{f}",
               (random_packed(n, d, density, g, dev), mappings,
                lsh.bucket_salts(t, 3, dev)), f, use_minmax)


def minmax_raw_cases(dev):
    import torch
    g = torch.Generator(device=dev).manual_seed(1)
    for n, d, h in ((43184, 8192, 400), (43184, 8192, 800), (13, 320, 100),
                    (256, 8192, 400), (384, 8192, 400), (512, 8192, 400),
                    (768, 8192, 400), (256, 8192, 800), (9, 8192, 800),
                    (24, 1024, 64), (5, 16384, 400)):
        density = 400 / 8192 if d == 8192 else 0.05
        yield (f"{n}x{d // 32}x{h}",
               (random_packed(n, d, density, g, dev),
                torch.randint(0, 2**31 - 1, (d, h), generator=g, device=dev,
                              dtype=torch.int32)))


def jaccard_cases(dev):
    """(label, pk, i1, i2, valid): the replay's verify shapes and the
    card tests' edges (see the module's docstring)."""
    import torch
    g = torch.Generator(device=dev).manual_seed(0)

    def ring(s, p, w):
        return torch.randint(-2**31, 2**31 - 1, (s, p, w), generator=g,
                             device=dev, dtype=torch.int32)

    def slots(s, m, p, pattern, block=None):
        """Ids not reduced modulo p; with ``block`` (the first id of a
        256-row block), i2 a row of that block and i1 any row before its
        end, as the replay's verify draws them."""
        def ids(lo, hi):
            return (torch.randint(lo, hi, (s, m), generator=g, device=dev)
                    + p * torch.randint(-1, 3, (s, m), generator=g,
                                        device=dev)).to(torch.int32)
        if block is None:
            i1, i2 = ids(0, p), ids(0, p)
        else:
            i1, i2 = ids(0, block + 256), ids(block, block + 256)
        pos = torch.arange(m, device=dev)[None, :]
        if pattern == "all":
            valid = torch.ones((s, m), dtype=torch.bool, device=dev)
        elif pattern == "none":
            valid = torch.zeros((s, m), dtype=torch.bool, device=dev)
        elif pattern == "replay":
            valid = pos < torch.tensor(REPLAY_PREFIX, device=dev)[:s, None]
        else:
            valid = torch.rand((s, m), generator=g, device=dev) < 0.4
        junk = torch.randint(-2**31, 2**31 - 1, (2, s, m), generator=g,
                             device=dev, dtype=torch.int32)
        return (torch.where(valid, i1, junk[0]),
                torch.where(valid, i2, junk[1]), valid)

    paper, block = ring(4, 43184, 256), 21504
    for pattern in ("all", "replay", "none", "scattered"):
        yield (f"4x4096x256_{pattern}", paper,
               *slots(4, 4096, 43184, pattern, block))
    flat = torch.empty(paper.numel() + 1, dtype=torch.int32, device=dev)
    off = flat[1:].view(paper.shape)
    off.copy_(paper)
    yield ("4x4096x256_all_scalar_plan", off,
           *slots(4, 4096, 43184, "all", block))
    yield "4x4096x256_all_random_rows", paper, *slots(4, 4096, 43184, "all")
    del paper, off, flat
    for s, p, w, m, pattern in ((4, 5000, 32, 4096, "all"),
                                (2, 300, 33, 33, "scattered"),
                                (1, 300, 256, 1, "all"),
                                (1, 5000, 256, 20000, "all"),
                                (2, 3000, 512, 4096, "scattered")):
        yield (f"{s}x{m}x{w}_{pattern}", ring(s, p, w),
               *slots(s, m, p, pattern))


def _takes_valid(src: pathlib.Path) -> bool:
    """Whether a jaccard_popcount source's entry point takes the valid
    mask (the tree's interface) or not (an earlier commit's)."""
    text = src.read_text()
    head = text[text.index('extern "C" int jaccard_popcount_launch('):]
    return "valid" in head[:head.index(")")]


def jaccard_compare(other: ctypes.CDLL, new_api: bool, label: str, pk, i1,
                    i2, valid) -> dict:
    """The tree's ``ops.jaccard_popcount`` against the other build: bit
    equality, warm and cold times in turns (other, tree, tree, other)."""
    import torch
    from repro_torch.kernels import jaccard_popcount as jac_k
    from repro_torch.kernels import ops
    s, p, w = pk.shape
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=pk.device)

    def tree():
        return ops.jaccard_popcount(pk, i1, i2, valid)

    if new_api:
        def other_fn():
            with swapped("jaccard_popcount", other):
                return tree()
        chain = None
    else:
        fn = other.jaccard_popcount_launch
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 3 + [
            ctypes.c_void_p] * 2 + [ctypes.c_int] + [ctypes.c_void_p] * 2
        r1 = (torch.where(valid, i1, 0) % p).contiguous()
        r2 = (torch.where(valid, i2, 0) % p).contiguous()
        buf = torch.empty(i1.shape, dtype=torch.float32, device=pk.device)
        stream = torch.cuda.current_stream().cuda_stream

        def launch_old(a, b, out):
            if out.numel():
                rc = fn(pk.data_ptr(), s, p, w, a.data_ptr(), b.data_ptr(),
                        i1.shape[1], out.data_ptr(), stream)
                if rc:
                    raise RuntimeError(f"other build: cudaError {rc}")
            return out

        def other_fn():
            return launch_old(r1, r2, buf)

        def chain():
            zero = torch.zeros_like(i1)
            a = torch.where(valid, i1, zero) % p
            b = torch.where(valid, i2, zero) % p
            jac = launch_old(a, b, torch.empty(i1.shape, dtype=torch.float32,
                                               device=pk.device))
            return torch.where(valid, jac, torch.zeros_like(jac))

    got = tree()
    theirs = other_fn().clone()
    if not new_api:
        theirs = torch.where(valid, theirs, 0.0)
    plain = jac_k.plain(pk, i1, i2, valid)
    torch.cuda.synchronize()
    row = {"kernel": "jaccard_popcount", "case": label,
           "plan": dataclasses.asdict(jac_k.plan(w, pk.data_ptr())),
           "valid_pairs": int(valid.sum()),
           "bit_equal": bool(torch.equal(got, theirs)),
           "equal_plain": bool(torch.equal(got, plain)),
           "max_abs_diff": float((got - theirs).abs().max())
           if got.numel() else 0.0}
    for cold in ("", "_cold"):
        o1, t1 = time_turns((other_fn, tree), flush=flush if cold else None)
        t2, o2 = time_turns((tree, other_fn), flush=flush if cold else None)
        row[f"tree{cold}_ms"], row[f"other{cold}_ms"] = [t1, t2], [o1, o2]
    if chain is not None:
        row["other_chain_ms"] = time_ms(chain)
    return row


def main(argv: list[str]) -> int:
    import torch
    if len(argv) != 2 or argv[0] not in (
            "stft_mag", "flash_attention", "haar2d", "mamba_scan",
            "minmax_sig_buckets", "minmax_hash", "jaccard_popcount"):
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("kernel_ab: CUDA is not available", file=sys.stderr)
        return 2
    from repro_torch.kernels import flash_attention as fa_k
    from repro_torch.kernels import haar2d as haar_k
    from repro_torch.kernels import mamba_scan as ms_k
    from repro_torch.kernels import minmax_hash as mm_k
    from repro_torch.kernels import ops
    from repro_torch.kernels import stft_mag as stft_k
    torch.backends.cuda.matmul.allow_tf32 = False
    name, other = argv[0], build(pathlib.Path(argv[1]).resolve())
    dev = torch.device("cuda", 0)
    if name == "jaccard_popcount":
        new_api = _takes_valid(pathlib.Path(argv[1]))
        for label, *args in jaccard_cases(dev):
            print(json.dumps(jaccard_compare(other, new_api, label, *args)),
                  flush=True)
    elif name == "stft_mag":
        for label, args in stft_cases(dev):
            print(json.dumps(compare(name, other, label,
                                     lambda: ops.stft_mag(*args),
                                     stft_k.plain(*args))), flush=True)
    elif name == "haar2d":
        for label, imgs in haar_cases(dev):
            th, tw, _ = ops.haar_mats(imgs.shape[1], imgs.shape[2], dev)
            print(json.dumps(compare(name, other, label,
                                     lambda: ops.haar2d(imgs),
                                     haar_k.plain(imgs, th, tw))), flush=True)
    elif name == "minmax_sig_buckets":
        for label, args, f, use_minmax in minmax_sig_cases(dev):
            kw = {"use_minmax": use_minmax, "n_buckets": 16384}
            print(json.dumps(compare(
                name, other, label,
                lambda: ops.minmax_sig_buckets(*args, **kw),
                mm_k.plain(*args, f, use_minmax, 16384), ("sig", "bkt"))),
                flush=True)
    elif name == "minmax_hash":
        for label, args in minmax_raw_cases(dev):
            print(json.dumps(compare(name, other, label,
                                     lambda: ops.minmax_hash(*args),
                                     mm_k.plain_raw(*args),
                                     ("mins", "maxs"))), flush=True)
    elif name == "mamba_scan":
        for label, args in scan_cases(dev):
            y, h = ms_k.plain(*args)
            print(json.dumps(compare(name, other, label,
                                     lambda: ops.mamba_scan(*args)[::-1],
                                     (h, y), ("h_final", "y"))), flush=True)
            del y, h
    else:
        for label, (q, k, v) in attention_cases(dev):
            print(json.dumps(compare(name, other, label,
                                     lambda: ops.flash_attention(q, k, v),
                                     fa_k.plain(q, k, v))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
