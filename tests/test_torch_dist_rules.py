"""The port's sharding rules and mesh helpers against the JAX package's,
in one process: ``sanitize_spec``, ``batch_axes`` and ``dp_size`` under a
fake mesh (the reference's ``FakeMesh`` of ``test_sharding_rules.py``)
over drawn shapes, specs, layouts and the uneven and manual modes;
``param_sharding_rules`` / ``cache_sharding_rules`` for every LM arch
(full and smoke config) under both layouts; ``zero_sharding_entry``
(dims that do not divide included) and ``opt_state_sharding_rules``;
``_quantize`` bit for bit; the mesh constructors. All exact.

Then one gloo rank in this process (a ``FileStore`` under the test's
temporary directory): the ZeRO step on a 1 × 1 mesh equals the step
without a mesh bit for bit, and so do ``moe_block`` under expert
parallelism at ``model`` = 1 and serving (``prefill`` and
``decode_step``, under the tp and the fsdp layout) — the one-rank runs
the card makes with NCCL (``chip_smoke.py`` phases 31–32)."""
import _torch_threads  # noqa: F401  (one torch thread a process)
import contextlib
import dataclasses
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st

from repro import configs as jconfigs
from repro import dist as jdist
from repro.models import decoder as jdec
from repro.train import compression as jcomp
from repro.train import optimizer as jopt
from repro_torch import configs, dist
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.models import decoder, layers as L
from repro_torch.train import compression, optimizer
from repro_torch.train.loop import (init_train_state, make_train_step,
                                    shard_train_state)
from repro_torch.utils import tree_leaves

AXES = ("pod", "data", "model")
NAMES = AXES + ("vocab", "other")


class FakeMesh:
    axis_names = AXES
    empty = False

    def __init__(self, shape: dict):
        self.shape = shape


@contextlib.contextmanager
def _both(shape: dict, layout="tp", uneven=False, manual=()):
    """The same fake mesh and modes installed in both packages."""
    mesh = FakeMesh(shape)
    toks = [jdist._LAYOUT.set(layout), jdist._UNEVEN.set(uneven),
            jdist._MANUAL.set(frozenset(manual))]
    with mock.patch.object(jdist, "current_mesh", lambda: mesh), \
            mock.patch.object(dist, "current_mesh", lambda: mesh), \
            dist.layout(layout), dist.manual_axes(manual):
        tok = dist._UNEVEN.set(uneven)
        try:
            yield
        finally:
            dist._UNEVEN.reset(tok)
            for var, t in zip((jdist._LAYOUT, jdist._UNEVEN, jdist._MANUAL),
                              toks):
                var.reset(t)


def _ref(spec):
    return None if spec is None else tuple(spec)


_entry = st.one_of(st.none(), st.sampled_from(NAMES),
                   st.lists(st.sampled_from(NAMES), min_size=1, max_size=3,
                            unique=True).map(tuple))


@given(sizes=st.dictionaries(st.sampled_from(AXES),
                             st.sampled_from([1, 2, 3, 4, 8]), min_size=1),
       shape=st.lists(st.integers(1, 64), min_size=1, max_size=4),
       spec=st.lists(_entry, max_size=5),
       layout=st.sampled_from(["tp", "fsdp"]), uneven=st.booleans(),
       manual=st.lists(st.sampled_from(AXES), max_size=2, unique=True))
@settings(max_examples=300, deadline=None)
def test_sanitize_batch_axes_dp_size_match_reference(sizes, shape, spec,
                                                     layout, uneven, manual):
    with _both(sizes, layout, uneven, manual):
        assert dist.sanitize_spec(shape, spec) == _ref(
            jdist.sanitize_spec(shape, spec))
        assert dist.batch_axes() == jdist.batch_axes()
        assert dist.dp_size() == jdist.dp_size()
        assert dist.in_manual_region() == jdist.in_manual_region()
        for a in AXES:
            assert dist.axis_size(a) == jdist.axis_size(a)


def test_no_mesh_means_no_spec_and_no_batch_axes():
    assert dist.current_mesh() is None
    assert dist.sanitize_spec((4, 4), ("data", None)) is None
    assert dist.batch_axes() == () and dist.dp_size() == 1
    x = torch.arange(4)
    assert dist.shard(x, "data") is x and dist.shard_batch(x) is x


def _rules(mod, cfg, layout, fn):
    tok = mod._LAYOUT.set(layout)
    try:
        return fn(cfg)
    finally:
        mod._LAYOUT.reset(tok)


@pytest.mark.parametrize("layout", ["tp", "fsdp"])
@pytest.mark.parametrize("arch", configs.LM_ARCHS)
def test_param_and_cache_rules_match_reference(arch, layout):
    for get, jget in ((configs.get_config, jconfigs.get_config),
                      (configs.get_smoke_config,
                       jconfigs.get_smoke_config)):
        cfg, jcfg = get(arch), jget(arch)
        got = _rules(dist, cfg, layout, decoder.param_sharding_rules)
        want = _rules(jdist, jcfg, layout, jdec.param_sharding_rules)
        assert got == want
        assert _rules(dist, cfg, layout, decoder.cache_sharding_rules) == \
            _rules(jdist, jcfg, layout, jdec.cache_sharding_rules)
        opt = optimizer.opt_state_sharding_rules(
            got, decoder.param_shapes(cfg))
        jopt_rules = jopt.opt_state_sharding_rules(
            want, jdec.param_shapes(jcfg))
        assert opt == jopt_rules


@given(shape=st.lists(st.integers(1, 96), min_size=1, max_size=4),
       spec=st.lists(_entry, max_size=4),
       data=st.sampled_from([("data",), ("pod", "data")]))
@settings(max_examples=200, deadline=None)
def test_zero_sharding_entry_matches_reference(shape, spec, data):
    got = optimizer.zero_sharding_entry(tuple(spec), tuple(shape), data)
    assert got == jopt.zero_sharding_entry(tuple(spec), tuple(shape), data)


def test_zero_entry_that_does_not_divide_leaves_the_leaf_whole():
    """The entry itself ignores divisibility; the effective placement,
    ``sanitize_spec`` of it, drops it (the reference's quirk)."""
    entry = optimizer.zero_sharding_entry((None, "model"), (7, 64))
    assert entry == ("data", "model")
    with _both({"data": 2, "model": 4}):
        assert dist.sanitize_spec((7, 64), entry) == (None, "model")
        assert dist.sanitize_spec((8, 64), entry) == ("data", "model")


@given(seed=st.integers(0, 2 ** 31), scale=st.sampled_from(
    [0.0, 1e-30, 1e-6, 1.0, 3e4]), shape=st.lists(st.integers(1, 9),
                                                  min_size=1, max_size=3))
@settings(max_examples=60, deadline=None)
def test_quantize_matches_reference_bitwise(seed, scale, shape):
    g = (np.random.default_rng(seed).standard_normal(shape) * scale
         ).astype(np.float32)
    q, s = compression._quantize(torch.as_tensor(g))
    jq, js = jcomp._quantize(jnp.asarray(g))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy().view(np.uint32),
                                  np.asarray(js).view(np.uint32))


def test_meshes_raise_naming_their_shape_without_the_ranks():
    for make, shape in ((make_production_mesh, "(16, 16)"),
                        (lambda: make_production_mesh(multi_pod=True),
                         "(2, 16, 16)"), (make_host_mesh, "(2, 4)")):
        with pytest.raises(ValueError, match=shape.replace("(", r"\(")
                           .replace(")", r"\)")):
            make()


@pytest.fixture
def one_rank(tmp_path):
    """A one-rank gloo group in this process for the test's duration."""
    dist.init_ranks("gloo", 0, 1, f"file://{tmp_path}/rendezvous")
    try:
        yield make_host_mesh((1, 1))
    finally:
        torch.distributed.destroy_process_group()


def _equal_trees(a: dict, b: dict):
    for (pa, x), (pb, y) in zip(tree_leaves(a), tree_leaves(b)):
        assert pa == pb and torch.equal(x, y), pa


@pytest.mark.parametrize("arch", ["qwen2.5-14b", "deepseek-moe-16b"])
def test_one_rank_zero_step_equals_the_step_without_a_mesh(one_rank, arch):
    """Two steps under a 1 × 1 mesh with ZeRO (every collective runs, on
    one rank) against two steps without one: loss, grad norm and every
    parameter and moment bit for bit."""
    mesh = one_rank
    assert mesh.shape == {"data": 1, "model": 1}
    cfg = dataclasses.replace(configs.get_smoke_config(arch),
                              param_dtype="float32",
                              compute_dtype="float32", remat="block")
    opt_cfg = optimizer.OptimizerConfig(warmup_steps=1, total_steps=10,
                                        accum_dtype="float32")
    rng = np.random.default_rng(3)
    batches = []
    for _ in range(2):
        toks = rng.integers(1, cfg.vocab_size, (4, 32)).astype(np.int32)
        batches.append({"tokens": torch.as_tensor(toks),
                        "labels": torch.as_tensor(np.roll(toks, -1, 1)),
                        "loss_mask": torch.ones((4, 32))})
    runs = []
    for use_mesh in (False, True):
        state = init_train_state(cfg, 0, "cpu")
        ctx = mesh if use_mesh else contextlib.nullcontext()
        with ctx:
            state = shard_train_state(state, cfg)
            step = make_train_step(cfg, opt_cfg, n_microbatches=2,
                                   shard_grads_like_opt=use_mesh)
            metrics = [step(state, b)[1] for b in batches]
        runs.append((state, metrics))
    for ma, mb in zip(runs[0][1], runs[1][1]):
        for k in ("loss", "grad_norm", "lr"):
            assert torch.equal(ma[k], mb[k]), k
    _equal_trees(runs[0][0].params, runs[1][0].params)
    _equal_trees(runs[0][0].opt, runs[1][0].opt)


def test_one_rank_expert_parallel_moe_equals_dense(one_rank):
    cfg = configs.get_smoke_config("deepseek-moe-16b")
    cfg = dataclasses.replace(cfg, param_dtype="float32",
                              compute_dtype="float32")
    params = decoder.init_params(cfg, 0, "cpu")
    lp = decoder._layer(params["layers"], 0)["moe"]
    x = torch.as_tensor(np.random.default_rng(0).standard_normal(
        (2, 16, cfg.d_model)).astype(np.float32))
    y0, aux0 = L.moe_block(lp, x, cfg)
    with one_rank:
        assert L.expert_parallel(cfg)
        y1, aux1 = L.moe_block(lp, x, cfg)
    assert torch.equal(y0, y1) and torch.equal(aux0, aux1)


def test_placement_without_a_mesh_is_the_tree_itself():
    cfg = configs.get_smoke_config("qwen2.5-14b")
    params = decoder.init_params(cfg, 0, "cpu")
    assert decoder.place_params(params, cfg) is params
    assert decoder.gather_params(params, cfg) is params


@pytest.mark.parametrize("arch", ["qwen2.5-14b", "falcon-mamba-7b",
                                  "zamba2-1.2b"])
def test_one_rank_serving_equals_serving_without_a_mesh(one_rank, arch):
    """``prefill`` then three ``decode_step`` s under a 1 × 1 mesh (the
    tensor-parallel path with every collective on one rank: the
    vocab-split embedding and logits, the sequence-split cache and its
    flash-decode combine) against the same without a mesh: every logit
    and the cache bit for bit — the one-rank run the card makes with
    NCCL (``chip_smoke.py`` phase 32a)."""
    cfg = dataclasses.replace(configs.get_smoke_config(arch),
                              param_dtype="float32",
                              compute_dtype="float32",
                              cache_dtype="float32")
    _serve_with_and_without_a_mesh(one_rank, cfg, "tp")


def _serve_with_and_without_a_mesh(one_rank, cfg, layout: str):
    """``prefill`` of two 12-token prompts then three ``decode_step`` s
    without a mesh and under the one-rank mesh in ``layout``: every
    logit and the cache bit for bit."""
    params = decoder.init_params(cfg, 0, "cpu")
    rng = np.random.default_rng(5)
    toks = torch.as_tensor(rng.integers(1, cfg.vocab_size, (2, 12)),
                           dtype=torch.int32)
    steps = [torch.as_tensor(rng.integers(1, cfg.vocab_size, (2, 1)),
                             dtype=torch.int32) for _ in range(3)]
    runs = []
    for use_mesh in (False, True):
        with one_rank if use_mesh else contextlib.nullcontext(), \
                dist.layout(layout):
            p = decoder.place_params(params, cfg)
            logits, cache = decoder.prefill(p, {"tokens": toks}, cfg)
            out = [logits]
            for t in steps:
                logits, cache = decoder.decode_step(p, cache, t, cfg)
                out.append(logits)
        runs.append((out, cache))
    for a, b in zip(runs[0][0], runs[1][0]):
        assert torch.equal(a, b)
    _equal_trees(runs[0][1], runs[1][1])


@pytest.mark.parametrize("arch", ["qwen2.5-14b", "deepseek-moe-16b",
                                  "falcon-mamba-7b", "zamba2-1.2b",
                                  "command-r-35b"])
def test_one_rank_fsdp_serving_equals_serving_without_a_mesh(one_rank,
                                                             arch):
    """Serving under the fsdp layout on a 1 × 1 mesh (each layer's
    blocks gathered whole at use, the cache's rows over data, MoE expert
    parallelism summing the one rank's experts) against serving without
    a mesh, bit for bit, for five families (dense GQA, MoE, Mamba1, the
    Zamba2 hybrid, the parallel block): the one-rank run the card makes
    with NCCL (``chip_smoke.py`` phase 32e)."""
    cfg = dataclasses.replace(configs.get_smoke_config(arch),
                              param_dtype="float32",
                              compute_dtype="float32",
                              cache_dtype="float32")
    _serve_with_and_without_a_mesh(one_rank, cfg, "fsdp")
