"""The Min-Max kernels' launch plan on the CPU: which kernel each caller's
shape takes, the tiled kernel's tiling, split and shared memory, the plan's
constants against the CUDA source's, and the two kernels' bound
(``kernels/cost.py``, which ``chip_smoke.py`` reports). Nothing here
needs a card: the plan is plain Python, and the tiled kernel itself is held against the plain version by
``tests/test_torch_cuda.py`` on the card.
"""
import _torch_threads  # noqa: F401  (one torch thread a process)
import importlib.util
import pathlib
import re

import pytest

from repro_torch.configs import fast_seismic
from repro_torch.data.dedup import DedupConfig
from repro_torch.kernels import cost
from repro_torch.kernels import minmax_hash as mm_k

ROOT = pathlib.Path(__file__).resolve().parents[1]
CSRC = (ROOT / "src" / "repro_torch" / "csrc" / "minmax_hash.cu").read_text()


def _lsh_shape(cfg):
    return cfg.n_tables * cfg.funcs_per_table, cfg.funcs_per_table


PAPER = fast_seismic.config()
SMOKE = fast_seismic.smoke_config()
DEDUP = DedupConfig()
H_PAPER, F_PAPER = _lsh_shape(PAPER.lsh)
H_SMOKE, F_SMOKE = _lsh_shape(SMOKE.lsh)
H_DEDUP, _ = _lsh_shape(DEDUP.lsh)
W_PAPER = PAPER.fingerprint.fp_dim // 32
W_SMOKE = SMOKE.fingerprint.fp_dim // 32


# (caller, rows, words, H, f or None for the raw planes) -> the expected
# (tiled, warps, split, grid)
CALLERS = [
    # the batch replay: 4 stations x 256 fingerprints a block; one and two
    # stations
    ("replay_paper", 1024, W_PAPER, H_PAPER, F_PAPER, (True, 16, 4, (32, 4))),
    ("replay_paper_one_station", 256, W_PAPER, H_PAPER, F_PAPER,
     (False, 0, 1, (0, 0))),
    ("replay_paper_two_stations", 512, W_PAPER, H_PAPER, F_PAPER,
     (True, 16, 8, (32, 4))),
    ("replay_smoke", 1024, W_SMOKE, H_SMOKE, F_SMOKE, (False, 0, 1, (0, 0))),
    # the offline search on a station-day, and the MinHash baseline
    ("search_station_day", 43184, W_PAPER, H_PAPER, None,
     (True, 16, 1, (338, 4))),
    ("search_minhash", 43184, W_PAPER, 2 * H_PAPER, None,
     (True, 16, 1, (338, 7))),
    # corpus dedup: the golden's 24 documents
    ("dedup", 24, DEDUP.feature_dim // 32, H_DEDUP, None,
     (False, 0, 1, (0, 0))),
    # an empty input at the paper widths
    ("no_rows", 0, W_PAPER, H_PAPER, None, (False, 0, 1, (0, 0))),
    # the card tests' row-kernel shapes
    ("three_functions_a_table", 13, 10, 36, 3, (False, 0, 1, (0, 0))),
    ("columns_not_quads", 9, 4, 10, 2, (False, 0, 1, (0, 0))),
]


@pytest.mark.parametrize("caller,n,words,h,f,want", CALLERS,
                         ids=[c[0] for c in CALLERS])
def test_each_caller_takes_its_path(caller, n, words, h, f, want):
    p = mm_k.plan(n, words, h, f)
    assert (p.tiled, p.warps, p.split, p.grid) == want


def test_paper_widths_are_the_planned_ones():
    assert (W_PAPER, H_PAPER, F_PAPER) == (256, 400, 4)
    assert (W_SMOKE, H_SMOKE, F_SMOKE) == (32, 40, 2)
    assert (DEDUP.feature_dim, H_DEDUP) == (1024, 64)


@pytest.mark.parametrize("aligned,words,h,f,tiled", [
    (False, 256, 400, 4, False),     # a table off 16 bytes: the row kernel
    (True, 256, 402, None, False),   # columns not in quads
    (True, 256, 12, 3, False),       # a table across two lanes
    (True, 127, 400, 4, False),      # fewer dimensions than 4096
    (True, 128, 400, 4, True),
    (True, 256, 8, 1, True), (True, 256, 16, 2, True),
    (True, 256, 16, 4, True), (True, 1024, 1200, None, True)])
def test_shapes_off_the_tiling_take_the_row_kernel(aligned, words, h, f,
                                                   tiled):
    assert mm_k.plan(43184, words, h, f, aligned=aligned).tiled == tiled
    assert (32 * words >= mm_k.MIN_TILED_DIMS) or not tiled


@pytest.mark.parametrize("n,h,tiled", [
    (0, 400, False), (1, 400, False), (256, 400, False), (327, 400, False),
    (328, 400, True), (384, 400, True), (512, 400, True),
    (163, 800, False), (164, 800, True), (256, 800, True),
    (3276, 40, False), (3277, 40, True)])
def test_small_planes_take_the_row_kernel(n, h, tiled):
    """Below MIN_TILED_PLANE rows × columns the tiled grid fills few SMs
    even split, and the row kernel runs: one station's replay block (256 ×
    400) does, two stations' and 256 rows at H = 800 do not."""
    assert mm_k.MIN_TILED_PLANE == 131_072
    for words, f in ((256, None), (512, None), (256, 4)):
        assert mm_k.plan(n, words, h, f).tiled == tiled


@pytest.mark.parametrize("n", [0, 1, 5, 127, 128, 129, 1000, 1024, 43184,
                               200_000])
@pytest.mark.parametrize("words,h", [(128, 4), (129, 40), (256, 64),
                                     (256, 400), (256, 800), (1024, 1200)])
def test_tiled_plans_fit_the_card(monkeypatch, n, words, h):
    """The tiled plan at every row count (as the card tests force it)."""
    monkeypatch.setattr(mm_k, "MIN_TILED_PLANE", 0)
    p = mm_k.plan(n, words, h)
    assert p.tiled
    rows = p.warps * mm_k.ROWS_PER_WARP
    tiles, slices = -(-n // rows), -(-h // mm_k.SLICE_COLS)
    assert 1 <= p.warps <= mm_k.MAX_WARPS
    assert rows >= min(n, mm_k.MAX_WARPS * mm_k.ROWS_PER_WARP)
    assert p.grid == (tiles * p.split, slices)
    assert p.smem <= mm_k.SMEM_LIMIT
    # a split never exceeds the chunks, nor one wave of CTAs; no rows, no
    # split (nor its scratch)
    assert p.split & (p.split - 1) == 0
    assert p.split <= min(mm_k.MAX_SPLIT, -(-32 * words // mm_k.CHUNK))
    assert p.split == 1 or p.grid[0] * p.grid[1] <= mm_k.H100_SMS
    assert n or (p.split == 1 and p.grid[0] == 0)


def test_split_fills_a_wave_of_the_card():
    """Few rows split their dimensions until the CTAs fill the SMs; a
    station-day already does, and is not split."""
    assert mm_k.plan(1024, 256, 400).grid == (32, 4)
    assert mm_k.plan(1024, 256, 400, n_sms=64).split == 2
    assert mm_k.plan(43184, 256, 400).split == 1


def test_shared_memory_counts_stages_lists_and_alignment():
    p = mm_k.plan(43184, 256, 400)
    stages = mm_k.STAGES * mm_k.CHUNK * mm_k.SLICE_COLS * 4
    lists = 128 * mm_k.LIST_BYTES * (mm_k.CHUNK + 2)
    assert p.smem == stages + lists + 128 == 230_016


@pytest.mark.parametrize("name,value", [
    ("kCols", mm_k.SLICE_COLS), ("kRowsPerWarp", mm_k.ROWS_PER_WARP),
    ("kStages", mm_k.STAGES), ("kChunk", mm_k.CHUNK),
    ("kMaxWarps", mm_k.MAX_WARPS), ("kMaxSplit", mm_k.MAX_SPLIT),
    ("kListBytes", mm_k.LIST_BYTES)])
def test_plan_constants_match_the_cuda_source(name, value):
    m = re.search(rf"constexpr int {name} = (\d+);", CSRC)
    assert m and int(m.group(1)) == value


def test_tiled_entry_points_take_the_plan():
    """The plan crosses to the .cu as its warps, split and the split's
    scratch; the kernel's constants and shared memory stay in the .cu."""
    for entry in ("minmax_hash_tiled_launch",
                  "minmax_sig_buckets_tiled_launch"):
        sig = CSRC[CSRC.index(f'extern "C" int {entry}('):]
        sig = " ".join(sig[:sig.index(")")].split())
        assert ("int warps, int split, void* part, void* counters, "
                "void* stream") in sig
        assert "smem" not in sig and "chunk" not in sig
    assert len(mm_k.PLAN_TYPES) == 4


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_minmax_bound_counts_comparisons_at_the_dpx_rate():
    # 64 IMNMX results a clock an SM, 132 SMs, 1.98 GHz; DPX: 2 a result
    assert cost.INT_OPS_PER_S == pytest.approx(16.7270e12, rel=1e-4)
    assert cost.MINMAX_COMPARES_PER_S == 2 * cost.INT_OPS_PER_S
    # the paper block: 405,200 set bits x 400 functions, min and max
    compares = 2 * 405_200 * 400
    ms, by = cost.bound_ms(cost.Work(ops=compares, bytes=4 * 1024 * 256,
                                     pipe="minmax"))
    assert by == "operations"
    assert ms == pytest.approx(compares / 33.454e12 * 1e3, rel=1e-4)
    assert ms == pytest.approx(0.00969, abs=1e-5)
    # the epilogue's integer operations count at half the comparison rate
    ms_epi, _ = cost.bound_ms(cost.Work(ops=compares, bytes=0, pipe="minmax",
                                        int_ops=1e6))
    assert ms_epi - ms == pytest.approx(1e6 / cost.INT_OPS_PER_S * 1e3)
    # minmax_sig_buckets' work at the paper block: 6 integer operations a
    # column and 13 a table besides the comparisons
    w = cost.minmax_sig_buckets(1024, 256, 400, 100, nnz=405_200, dims=8192)
    assert (w.ops, w.int_ops) == (compares, 6 * 1024 * 400 + 13 * 1024 * 100)
    assert w.bytes == 4 * (1024 * 256 + 8192 * 400 + 100 + 2 * 1024 * 100)


def test_minmax_bound_of_a_station_day():
    n, nnz, h = 43_184, 17_095_200, 400
    ms, by = cost.bound_ms(cost.minmax_hash(n, 256, h, nnz=nnz, dims=8192))
    assert by == "operations"
    assert ms == pytest.approx(0.4088, rel=1e-3)
    # with little to compare, the bytes bound it
    ms_b, by_b = cost.bound_ms(cost.minmax_hash(n, 256, h, nnz=1250,
                                                dims=8192))
    assert by_b == "bytes"
    assert ms_b == pytest.approx(4 * (n * 256 + 8192 * h + 2 * n * h)
                                 / 3.35e12 * 1e3)


@pytest.mark.parametrize("n,words,h,want", [
    # the paper block: 8 tiles of 128 rows (split 4) read the table once
    (1024, 256, 400, ("staged", 8 * 8192 * 400 * 4)),
    # a station-day: 338 tiles
    (43184, 256, 400, ("staged", 338 * 8192 * 400 * 4)),
    # one station's block and dedup: the row kernel gathers per set bit
    (256, 256, 400, ("gather", 1000 * 400 * 4)),
    (24, 32, 64, ("gather", 1000 * 64 * 4))])
def test_minmax_l2_bytes_follow_the_plan(n, words, h, want):
    """chip_smoke.py's L2 bytes of a Min-Max call are those of the plan
    that runs: the tiled kernel's staged table, or the row kernel's
    gathers (nnz · H · 4); never the other design's."""
    cs = _chip_smoke()
    assert cs._minmax_l2(mm_k.plan(n, words, h), 1000, words, h) == want
