"""The dry-run tooling of the port against the reference's: the shapes and
input specs (``configs/shapes``), ``configs.get_module``, the step-cost
analyzer (``launch/hlo_stats``), the kernels' work and ``meta`` path
(``kernels/cost``, ``kernels/ops``) and the dry run itself
(``launch/dryrun``).

The reference's dry run sets ``XLA_FLAGS`` to 512 host devices when it is
imported, so its numbers (cells, microbatches, model flops, cell names)
come from one subprocess. Layout mapping: none — the port's decode cache
has the reference's keys, shapes and dtypes leaf for leaf; the two link
keys of ``roofline_terms`` take the H100's names
(``collective_bytes_nvlink`` / ``_network`` for ``_ici`` / ``_dcn``).

The fake process group (``dryrun.fake_world``) is the process's default
group: each test that makes one destroys it when it ends.
"""
import _torch_threads  # noqa: F401  (one torch thread a process)
import dataclasses
import json
import subprocess
import sys
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as tdist

from repro import configs as jconfigs
from repro.configs import shapes as jshapes
from repro.launch import hlo_stats as jhlo
from repro_torch import configs, dist, utils
from repro_torch.configs import shapes
from repro_torch.kernels import cost, ops
from repro_torch.launch import dryrun, hlo_stats
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh

ROOT = pathlib.Path(__file__).resolve().parents[1]

_REFERENCE = """
import json
from repro.configs import ALL_ARCHS, LM_ARCHS, get_config
from repro.configs.shapes import LM_SHAPES, shapes_for
from repro.launch import dryrun
out = {"cells": [list(c) for c in dryrun.iter_cells(
    ALL_ARCHS, ["all"], ["single", "multi"])], "mb": {}, "flops": {}}
for arch in LM_ARCHS:
    cfg = get_config(arch)
    for name in shapes_for(cfg):
        s = LM_SHAPES[name]
        for dp in (16, 32):
            out["mb"][f"{arch}|{name}|{dp}"] = dryrun.pick_microbatches(
                cfg, s.global_batch, dp)
        out["flops"][f"{arch}|{name}"] = dryrun.model_flops(
            cfg, s.kind, s.global_batch, s.seq_len)
out["names"] = [dryrun._cell_name(r) for r in (
    {"arch": "qwen2.5-14b", "shape": "train_4k", "mesh": "single"},
    {"arch": "zamba2-1.2b", "shape": "long_500k", "mesh": "multi",
     "tag": "a/b"})]
print("REF" + json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference():
    out = subprocess.run([sys.executable, "-c", _REFERENCE], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env={**__import__("os").environ,
                              "PYTHONPATH": str(ROOT / "src")})
    assert out.returncode == 0, out.stderr[-3000:]
    line = next(ln for ln in out.stdout.splitlines() if ln.startswith("REF"))
    return json.loads(line[3:])


@pytest.fixture
def world():
    """``dryrun.fake_world`` made for one test, destroyed after it."""
    yield dryrun.fake_world
    if tdist.is_initialized():
        tdist.destroy_process_group()


# ---------------------------------------------------------------------------
# shapes, input specs, get_module
# ---------------------------------------------------------------------------


def test_lm_shapes_and_shapes_for_are_the_references():
    assert {k: dataclasses.astuple(v) for k, v in shapes.LM_SHAPES.items()} \
        == {k: dataclasses.astuple(v) for k, v in jshapes.LM_SHAPES.items()}
    for arch in configs.LM_ARCHS:
        assert shapes.shapes_for(configs.get_config(arch)) \
            == jshapes.shapes_for(jconfigs.get_config(arch)), arch


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    else:
        yield prefix, tuple(tree.shape), str(tree.dtype).split(".")[-1]


@pytest.mark.parametrize("arch", configs.LM_ARCHS)
def test_input_specs_are_the_references(arch):
    """Every leaf of every applicable shape's specs, shape and dtype, the
    decode cache against ``jax.eval_shape`` of the reference's; the
    port's are ``meta`` tensors."""
    for name in shapes.shapes_for(configs.get_config(arch)):
        got = shapes.input_specs(configs.get_config(arch), name)
        want = jshapes.input_specs(jconfigs.get_config(arch), name)
        assert list(_leaves(got)) == list(_leaves(want)), (arch, name)
        assert all(t.is_meta for _, t in _flat(got))


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def test_get_module_names_the_references_modules():
    for arch in configs.ALL_ARCHS:
        mine, ref = configs.get_module(arch), jconfigs.get_module(arch)
        assert mine.__name__.split(".")[-1] == ref.__name__.split(".")[-1]
        assert mine.ARCH_ID == ref.ARCH_ID == arch
    fs = configs.get_module("fast_seismic")
    assert fs.SHAPES == jconfigs.get_module("fast_seismic").SHAPES
    with pytest.raises(KeyError):
        configs.get_module("no-such-arch")


# ---------------------------------------------------------------------------
# the dry run's arithmetic and cells, against the reference's
# ---------------------------------------------------------------------------


def test_iter_cells_and_the_cli_list_give_the_references_68(reference,
                                                            capsys):
    cells = [list(c) for c in dryrun.iter_cells(
        configs.ALL_ARCHS, ["all"], ["single", "multi"])]
    assert cells == reference["cells"] and len(cells) == 68
    dryrun.main(["--list", "--arch", "all", "--shape", "all", "--mesh",
                 "both"])
    printed = [ln.split() for ln in capsys.readouterr().out.splitlines()]
    assert printed == reference["cells"]


def test_a_list_of_shapes_pairs_each_arch_with_its_kinds_shapes():
    """``--shape prefill_32k,decode_32k,long_500k`` with ``--arch all``:
    each LM arch × the three × both meshes (60 cells), none for the
    detection arch, whose shapes are its own; a detection shape pairs
    with the detection arch only."""
    names = ["prefill_32k", "decode_32k", "long_500k"]
    cells = list(dryrun.iter_cells(configs.ALL_ARCHS, names,
                                   ["single", "multi"]))
    assert cells == [(a, s, m) for a in configs.ALL_ARCHS
                     if a != "fast_seismic" for s in names
                     for m in ("single", "multi")]
    assert len(cells) == 60
    assert list(dryrun.iter_cells(configs.ALL_ARCHS, ["station_month"],
                                  ["single"])) == [
        ("fast_seismic", "station_month", "single")]


def test_pick_microbatches_model_flops_and_cell_names(reference):
    for key, want in reference["mb"].items():
        arch, name, dp = key.split("|")
        s = shapes.LM_SHAPES[name]
        assert dryrun.pick_microbatches(configs.get_config(arch),
                                        s.global_batch, int(dp)) == want
    for key, want in reference["flops"].items():
        arch, name = key.split("|")
        s = shapes.LM_SHAPES[name]
        assert dryrun.model_flops(configs.get_config(arch), s.kind,
                                  s.global_batch, s.seq_len) == want
    assert dryrun.model_flops(configs.get_config("fast_seismic"), "train",
                              1, 1) == 0.0
    assert [dryrun._cell_name(r) for r in (
        {"arch": "qwen2.5-14b", "shape": "train_4k", "mesh": "single"},
        {"arch": "zamba2-1.2b", "shape": "long_500k", "mesh": "multi",
         "tag": "a/b"})] == reference["names"]


# ---------------------------------------------------------------------------
# the analyzer against the reference's HLO walk
# ---------------------------------------------------------------------------


def test_dot_flops_of_a_matmul_chain_equal_the_references():
    x = np.random.default_rng(0).standard_normal((32, 48)).astype(
        np.float32)
    w = np.random.default_rng(1).standard_normal((48, 64)).astype(
        np.float32)
    v = np.random.default_rng(2).standard_normal((64, 16)).astype(
        np.float32)

    def chain(a, b, c):
        return (a @ b) @ c

    want = jhlo.analyze_hlo(jax.jit(chain).lower(x, w, v).compile()
                            .as_text())
    got = hlo_stats.analyze_step(chain, *(torch.empty(t.shape, device="meta")
                                          for t in (x, w, v)))
    assert got.dot_flops == got.flops == want.flops == 2 * 32 * (
        48 * 64 + 64 * 16)


def test_dot_flops_of_the_scan_equal_the_references():
    """tests/test_misc.py's scan of five 32×32 products and a sum: the
    reference multiplies the loop body by its trip count, the port's
    trace runs the five products."""
    def f(x):
        def body(c, _):
            return c @ x, None
        out, _ = jax.lax.scan(body, x, None, length=5)
        return out.sum()

    want = jhlo.analyze_hlo(jax.jit(f).lower(jnp.ones((32, 32))).compile()
                            .as_text())

    def g(x):
        c = x
        for _ in range(5):
            c = c @ x
        return c.sum()

    got = hlo_stats.analyze_step(g, torch.empty((32, 32), device="meta"))
    assert got.dot_flops == 5 * 2 * 32 ** 3
    # the reference's total adds the sum and the loop counter's few ops
    assert got.flops == got.dot_flops + 32 * 32
    assert 0 <= want.flops - got.flops <= 64
    assert got.unknown_trip_whiles == want.unknown_trip_whiles == 0


def test_roofline_terms_with_the_references_peaks_are_the_references():
    ref = jhlo.HloStats(flops=3.0e14, bytes=2.0e12, transcendentals=1e9,
                        link_bytes_ici=4e10, link_bytes_dcn=1e9,
                        sort_elems=5.0)
    mine = hlo_stats.StepStats(flops=3.0e14, bytes=2.0e12,
                               transcendentals=1e9, link_bytes_nvlink=4e10,
                               link_bytes_network=1e9, sort_elems=5.0)
    want = jhlo.roofline_terms(ref, 256, 1.2e16)
    got = hlo_stats.roofline_terms(mine, 256, 1.2e16, jhlo.PEAK_FLOPS,
                                   jhlo.HBM_BW, jhlo.ICI_BW, jhlo.DCN_BW)
    got["collective_bytes_ici"] = got.pop("collective_bytes_nvlink")
    got["collective_bytes_dcn"] = got.pop("collective_bytes_network")
    assert got == want
    # the H100's datasheet peaks by default
    h100 = hlo_stats.roofline_terms(mine, 256, 1.2e16)
    assert h100["compute_s"] == pytest.approx(3.0e14 / 989e12)
    assert h100["memory_s"] == pytest.approx(2.0e12 / 3.35e12)
    assert h100["collective_s"] == pytest.approx(4e10 / 450e9 + 1e9 / 50e9)


def test_bytes_views_inplace_updates_and_memory():
    """A view is free, an op charges operands + result, an in-place slice
    update 2·|update|; the memory's arguments, outputs, alias and the
    temporaries' peak (two live 4 KB results at most)."""
    x = torch.empty(32, 32, device="meta")
    buf = torch.empty(8, 32, 32, device="meta")

    def f(x, buf):
        c = x
        for _ in range(3):
            c = c @ x
        buf[0] = c.t()
        return buf, c.sum()

    st = hlo_stats.analyze_step(f, x, buf)
    assert st.ops["mm"] == [3, 3 * 2 * 32 ** 3, 3 * 3 * 4096]
    assert st.ops["copy_"][2] == 2 * 4096
    assert "t" not in st.ops and "select" not in st.ops
    assert st.memory == {"argument_size_in_bytes": 4096 + 8 * 4096,
                         "output_size_in_bytes": 8 * 4096 + 4,
                         "temp_size_in_bytes": 2 * 4096,
                         "alias_size_in_bytes": 8 * 4096}


def test_collectives_bytes_and_links_on_a_2x16x16_mesh(world):
    """all_reduce 2·size of traffic, all_gather its output, reduce_scatter
    its input; a group inside one node of ``node_size`` cards is NVLink,
    any other (and one across ``pod_boundary``) the network."""
    world(512)
    mesh = make_production_mesh(multi_pod=True)
    x = torch.empty(64, 32, device="meta")

    def f(x):
        dist.all_reduce(x.clone(), "model")
        dist.all_gather_dim(x, 0, "data", 64 * 16)
        dist.reduce_scatter_dim(x, 0, ("pod",))
        return x

    with mesh:
        by8 = hlo_stats.analyze_step(f, x)
        by16 = hlo_stats.analyze_step(f, x, node_size=16)
        pods = hlo_stats.analyze_step(f, x, node_size=512, pod_boundary=256)
    size = 64 * 32 * 4
    for st in (by8, by16, pods):
        assert {k: v for k, v in st.coll_counts.items() if v} == {
            "all-reduce": 1, "all-gather": 1, "reduce-scatter": 1}
        assert st.coll_bytes["all-reduce"] == size
        assert st.coll_bytes["all-gather"] == 16 * size
        assert st.coll_bytes["reduce-scatter"] == size
    # model: 16 consecutive ranks, two nodes of 8; data: ranks 16 apart
    assert (by8.link_bytes_nvlink, by8.link_bytes_network) == (
        0, 2 * size + 16 * size + size)
    assert (by16.link_bytes_nvlink, by16.link_bytes_network) == (
        2 * size, 16 * size + size)
    # one node of 512: only the pod group crosses the pod boundary
    assert (pods.link_bytes_nvlink, pods.link_bytes_network) == (
        2 * size + 16 * size, size)
    assert dist.TRACE is None


# ---------------------------------------------------------------------------
# the kernels' meta path and work
# ---------------------------------------------------------------------------


def _kernel_cases():
    """(name, call) with CPU arguments, each small."""
    g = torch.Generator().manual_seed(0)
    f32, i32 = torch.float32, torch.int32
    wave = torch.randn((3, 700), generator=g)
    win = torch.hann_window(64)
    dr, di = torch.randn((64, 9), generator=g), torch.randn((64, 9),
                                                           generator=g)
    imgs = torch.randn((5, 8, 16), generator=g)
    packed = torch.randint(-2**31, 2**31 - 1, (6, 4), generator=g,
                           dtype=i32)
    mp = torch.randint(0, 2**31 - 1, (128, 12), generator=g, dtype=i32)
    salts = torch.randint(0, 2**31 - 1, (3,), generator=g, dtype=i32)
    pk = torch.randint(-2**31, 2**31 - 1, (2, 10, 4), generator=g,
                       dtype=i32)
    i1 = torch.randint(0, 10, (2, 7), generator=g, dtype=i32)
    valid = torch.rand((2, 7), generator=g) > 0.3
    q = torch.randn((1, 4, 6, 32), generator=g)
    kv = torch.randn((1, 2, 9, 32), generator=g)
    xdt, dt = torch.randn((2, 5, 6), generator=g), torch.rand((2, 5, 6),
                                                              generator=g)
    a = -torch.rand((6, 4), generator=g, dtype=f32)
    bm, cm = torch.randn((2, 5, 4), generator=g), torch.randn((2, 5, 4),
                                                              generator=g)
    lse = torch.randn((1, 4, 6), generator=g)
    return [
        ("stft_mag", lambda t: ops.stft_mag(*t(wave, win, dr, di), 7)),
        ("haar2d", lambda t: ops.haar2d(*t(imgs))),
        ("minmax_hash", lambda t: ops.minmax_hash(*t(packed, mp))),
        ("minmax_sig_buckets", lambda t: ops.minmax_sig_buckets(
            *t(packed, mp, salts), use_minmax=True, n_buckets=64)),
        ("jaccard_popcount", lambda t: ops.jaccard_popcount(
            *t(pk, i1, i1.flip(-1).contiguous(), valid))),
        ("occurrence_filter", lambda t: ops.occurrence_filter(
            *t(i1[0], i1[1], i1[0] + 2, valid[0]), 10, 1)),
        ("flash_attention", lambda t: ops.flash_attention(*t(q, kv, kv))),
        ("flash_attention_bwd", lambda t: ops.flash_attention_bwd(
            *t(q, kv, kv, q, lse, q))),
        ("mamba_scan", lambda t: ops.mamba_scan(*t(xdt, dt, a, bm, cm))),
        ("mamba_scan_bwd", lambda t: ops.mamba_scan_bwd(
            *t(xdt, dt, a, bm, cm, xdt), None, *t(torch.empty(
                (2, 1, 6, 4))))),
    ]


def _on(device):
    return lambda *ts: tuple(x.to(device) for x in ts)


@pytest.mark.parametrize("name,call", _kernel_cases(),
                         ids=[c[0] for c in _kernel_cases()])
def test_meta_path_has_the_plain_versions_shapes_and_records_work(name,
                                                                  call):
    """On ``meta`` each wrapper returns outputs of the plain version's
    shapes and dtypes, launches nothing and records its kernel's work
    for the analyzer."""
    want = call(_on("cpu"))
    ops.reset_launches()
    st = hlo_stats.analyze_step(lambda: call(_on("meta")))
    got = call(_on("meta"))
    flat = lambda o: o if isinstance(o, tuple) else (o,)  # noqa: E731
    assert [(t.shape, t.dtype) for t in flat(got)] == \
        [(t.shape, t.dtype) for t in flat(want)]
    assert all(t.is_meta for t in flat(got))
    assert all(v == 0 for v in ops.LAUNCHES.values())
    assert list(st.kernels) == [name] and st.kernels[name]["calls"] == 1
    assert st.kernels[name]["flops"] > 0 and st.kernels[name]["bytes"] > 0
    assert cost.RECORDER is None


def test_autograd_on_meta_records_the_backward_kernels():
    q = torch.empty((1, 4, 64, 64), device="meta", requires_grad=True)
    kv = torch.empty((1, 2, 64, 64), device="meta", requires_grad=True)
    xdt = torch.empty((2, 64, 8), device="meta", requires_grad=True)
    b = torch.empty((2, 64, 4), device="meta", requires_grad=True)
    a = torch.empty((8, 4), device="meta", requires_grad=True)

    def step():
        out = ops.flash_attention(q, kv, kv).sum() \
            + ops.mamba_scan(xdt, xdt, a, b, b)[0].sum()
        return torch.autograd.grad(out, (q, kv, xdt, a, b))

    st = hlo_stats.analyze_step(step)
    assert {k: v["calls"] for k, v in st.kernels.items()} == {
        "flash_attention": 1, "mamba_scan": 1, "flash_attention_bwd": 1,
        "mamba_scan_bwd": 1}
    w = cost.flash_attention_bwd(1, 4, 2, 64, 64, 64, torch.float32)
    assert st.kernels["flash_attention_bwd"]["flops"] == w.flops
    assert st.kernels["mamba_scan"]["bytes"] == cost.mamba_scan(
        2, 64, 8, 4, torch.float32, chunks=True).bytes


# the bound_ms column of PERF.md's kernel table (chip_smoke.py's kernels
# line and phase 32d, before their arithmetic moved to kernels/cost.py)
# and the work function that reproduces each
_TABLE_BOUNDS = [
    ("stft_mag", lambda f: cost.stft_mag(
        4, f.block_samples(256), f.stft_len, f.band_bins[1]
        - f.band_bins[0], f.stft_hop), 0.00366, "operations"),
    ("haar2d", lambda f: cost.haar2d(1024, f.img_freq, f.img_time),
     0.0200, "operations"),
    ("minmax_hash", lambda f: cost.minmax_hash(43_184, 256, 400,
                                               nnz=17_095_200, dims=8192),
     0.4088, "operations"),
    ("minmax_sig_buckets", lambda f: cost.minmax_sig_buckets(
        1024, 256, 400, 100, nnz=405_200, dims=8192), 0.00992, "operations"),
    ("flash_attention", lambda f: cost.flash_attention(
        1, 40, 8, 2048, 2048, 128, torch.bfloat16), 0.0434, "operations"),
    ("flash_attention_tp4", lambda f: cost.flash_attention(
        1, 10, 2, 2048, 2048, 128, torch.bfloat16), 0.0109, "operations"),
    ("mamba_scan", lambda f: cost.mamba_scan(1, 2048, 8192, 16,
                                             torch.float32), 0.0642, "sfu"),
    ("mamba_scan_tp2", lambda f: cost.mamba_scan(1, 2048, 4096, 16,
                                                 torch.float32), 0.0321,
     "sfu"),
    ("flash_attention_bwd", lambda f: cost.flash_attention_bwd(
        1, 40, 8, 2048, 2048, 128, torch.bfloat16), 0.1086, "operations"),
    # head dim 16 in bf16: the exponentials, one a causal pair, bound it
    ("flash_attention_d16", lambda f: cost.flash_attention(
        1, 8, 2, 2048, 2048, 16, torch.bfloat16), 0.004014, "sfu"),
    ("flash_attention_bwd_d16", lambda f: cost.flash_attention_bwd(
        1, 8, 2, 2048, 2048, 16, torch.bfloat16), 0.004014, "sfu"),
    ("mamba_scan_bwd", lambda f: cost.mamba_scan_bwd(
        2, 2048, 8192, 16, torch.float32), 0.2210, "bytes"),
]


@pytest.mark.parametrize("name,work,ms,by", _TABLE_BOUNDS,
                         ids=[c[0] for c in _TABLE_BOUNDS])
def test_work_functions_reproduce_the_kernel_tables_bounds(name, work, ms,
                                                           by):
    fcfg = configs.get_config("fast_seismic").fingerprint
    got, got_by = cost.bound_ms(work(fcfg))
    assert got_by == by
    assert got == pytest.approx(ms, rel=5e-3)


def test_jaccard_work_counts_the_rows_the_pairs_read():
    w = cost.jaccard_popcount(4, 43_184, 4096, 256, live=16_000,
                              rows=15_430)
    assert (w.ops, w.pipe) == (2 * 16_000 * 256, "popc")
    assert w.bytes == 15_430 * 256 * 4 + 4 * 4096 * 5 + 8 * 16_000
    # by default every slot is valid and reads two rows, at most the ring
    assert cost.jaccard_popcount(2, 3, 5, 1).bytes == 6 * 4 + 50 + 80


def test_causal_pairs_and_the_set_bits_context():
    for sq, sk in ((1, 1), (5, 9), (9, 5), (2048, 2048), (512, 2048)):
        assert cost.causal_pairs(sq, sk) == sum(
            max(0, min(sk, i + sk - sq + 1)) for i in range(sq))
    assert cost.causal_pairs(3, 4, causal=False) == 12
    full = cost.minmax_hash(10, 256, 400)
    with cost.set_bits_per_row(400):
        fp = cost.minmax_hash(10, 256, 400)
    assert (full.ops, fp.ops) == (2 * 10 * 8192 * 400, 2 * 10 * 400 * 400)


def test_kernel_of_names_every_kernels_cuda_functions():
    assert set(cost.DEVICE_NAMES) == set(ops.LAUNCHES)
    for dev_name, want in (
            ("void (anonymous namespace)::stft_mag_kernel(float const*)",
             "stft_mag"),
            ("void (anonymous namespace)::tiled_kernel<(anonymous namespace"
             ")::SigEpilogue, true>(...)", "minmax_sig_buckets"),
            ("void (anonymous namespace)::hop::dkdv_kernel<128>(...)",
             "flash_attention_bwd"),
            ("void (anonymous namespace)::mamba_scan_bwd_kernel<float, 4, "
             "8, 256>(...)", "mamba_scan_bwd"),
            ("void (anonymous namespace)::mamba_scan_kernel<float, 1, 8, "
             "false>(...)", "mamba_scan"),
            ("ampere_bf16_s16816gemm_bf16_128x128", None)):
        assert cost.kernel_of(dev_name) == want


# ---------------------------------------------------------------------------
# traced cells
# ---------------------------------------------------------------------------


def _smoke(monkeypatch):
    """Smoke configs at the cells' kinds, cut to 64-token sequences of a
    global batch of 16 (long_500k 128 tokens)."""
    monkeypatch.setattr(dryrun, "get_config", configs.get_smoke_config)
    for k, v in shapes.LM_SHAPES.items():
        monkeypatch.setitem(shapes.LM_SHAPES, k, dataclasses.replace(
            v, seq_len=128 if k == "long_500k" else 64, global_batch=16))


def _trace(world, n, rank, shape, arch, shape_name, overrides=None,
           layout="tp"):
    world(n, rank)
    mesh = make_host_mesh(shape)
    with dist.layout(layout):
        low, cfg, spec, extra = dryrun.lower_lm_cell(
            arch, shape_name, mesh, "masked", 2, cfg_overrides=overrides)
        return low, low.analyze()


@pytest.mark.parametrize("shape_name", ["train_4k", "prefill_32k",
                                        "decode_32k"])
def test_a_cells_ranks_add_up_to_the_one_rank_cell(world, monkeypatch,
                                                   shape_name):
    """qwen2.5-14b's smoke config (8 heads, 4 kv heads: the model axis
    divides them) at (1, 1) and at each rank of (2, 4): the argument
    bytes are the rank's state plus the batch it takes, and the 8 ranks'
    dot flops and kernel flops add up to the one rank's (the rows split
    over data, heads / d_ff / vocab / the cache's sequence over model;
    the replicated norms and residuals are elementwise work, and the
    collectives' own work is not a dot)."""
    _smoke(monkeypatch)
    over = {"n_heads": 8, "n_kv_heads": 4, "d_model": 256}
    low, one = _trace(world, 1, 0, (1, 1), "qwen2.5-14b", shape_name, over)

    def arg_bytes(args):
        return sum(utils.tree_bytes(a.params) + utils.tree_bytes(
            {k: v for k, v in a.opt.items()})
            + a.step.numel() * a.step.element_size()
            if isinstance(a, dryrun.TrainState) else
            utils.tree_bytes(a) if isinstance(a, dict) else
            a.numel() * a.element_size() for a in args)

    assert one.memory["argument_size_in_bytes"] == arg_bytes(low.args)
    # one rank's groups: the calls are made, no byte crosses a link
    assert one.link_bytes_nvlink == one.link_bytes_network == 0
    dots = kflops = 0.0
    for r in range(8):
        low, st = _trace(world, 8, r, (2, 4), "qwen2.5-14b", shape_name,
                         over)
        assert st.memory["argument_size_in_bytes"] == arg_bytes(low.args)
        # eight ranks, one node of 8: every byte on NVLink
        assert st.link_bytes_nvlink > 0 == st.link_bytes_network
        dots += st.dot_flops
        kflops += sum(k["flops"] for k in st.kernels.values())
    assert dots == one.dot_flops
    assert kflops == sum(k["flops"] for k in one.kernels.values())


@pytest.mark.parametrize("shape_name", ["prefill_32k", "decode_32k"])
def test_fsdp_serving_cells_trace_and_their_ranks_add_up(world, monkeypatch,
                                                        shape_name):
    """The smoke arch's serving cells under the fsdp layout: the (1, 1)
    cell and each rank of (2, 4) trace, and the ranks' dot flops add up
    to the one rank's the way the layout divides the work: the rows over
    data, every parameter gathered whole at use, so the four model ranks
    of a data coordinate compute the same rows (each the same dots) and
    the two data coordinates' dots add up to the (1, 1) cell's; each rank
    gathers its parameters over ``model`` (``param_all_gather``)."""
    _smoke(monkeypatch)
    over = {"n_heads": 8, "n_kv_heads": 4, "d_model": 256}
    _, one = _trace(world, 1, 0, (1, 1), "qwen2.5-14b", shape_name, over,
                    layout="fsdp")
    by_data = {0: [], 1: []}
    for r in range(8):
        _, st = _trace(world, 8, r, (2, 4), "qwen2.5-14b", shape_name,
                       over, layout="fsdp")
        assert st.coll_counts["all-gather"] > 0
        by_data[r // 4].append(st.dot_flops)
    for dots in by_data.values():
        assert len(set(dots)) == 1
    assert by_data[0][0] + by_data[1][0] == one.dot_flops


def test_a_full_width_cell_traces_end_to_end(tmp_path):
    """falcon-mamba-7b × decode_32k × single at its published widths: rank
    0 of 256, its parameter and cache blocks, the record's schema."""
    try:
        rec = dryrun.run_cell("falcon-mamba-7b", "decode_32k", "single",
                              str(tmp_path))
    finally:
        tdist.destroy_process_group()
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["devices"] == 256 and rec["kind"] == "decode"
    saved = json.loads((tmp_path / "falcon-mamba-7b__decode_32k__single"
                        ".json").read_text())
    assert saved["status"] == "ok"
    for key in ("memory", "xla_cost_raw", "collectives", "roofline",
                "lower_s", "compile_s"):
        assert key in rec
    assert set(rec["collectives"]) == {"counts", "bytes_by_kind",
                                       "link_bytes_nvlink",
                                       "link_bytes_network"}
    rf = rec["roofline"]
    assert rf["dominant"] in ("compute_s", "memory_s", "collective_s")
    assert rf["model_flops"] == dryrun.model_flops(
        configs.get_config("falcon-mamba-7b"), "decode", 128, 32_768)
    # the rank's blocks: 1/16 of the channels, 8 of the 128 rows
    cfg = configs.get_config("falcon-mamba-7b")
    mem = rec["memory"]
    cache = 2 * 64 * 8 * (cfg.ssm_conv - 1) * cfg.d_inner // 16 \
        + 4 * 64 * 8 * cfg.d_inner // 16 * cfg.ssm_state + 4 * 128
    assert mem["argument_size_in_bytes"] > cache
    assert mem["alias_size_in_bytes"] > 0
    assert rec["collectives"]["counts"]["all-reduce"] > 0
