"""The ``model`` axis as compute: the port's tensor parallelism on gloo
against the JAX package's one-device results.

One ``torch.multiprocessing`` start of 8 ranks for the file (a
module-scoped fixture; ``tests/_torch_dist_tp_ranks.py`` is the rank
side), on the (2, 4) data×model mesh under the tp layout, while this
process computes the reference's one-device results with JAX. The
reference's own multi-device test (``test_distributed.py``'s
seq-sharded decode cache) fails under jax 0.9.0, so the port is held to
its one-device ``prefill`` / ``decode_step`` / ``lm_loss``.

- Serving, for the smoke configs of five families (dense GQA, Mamba1,
  MoE with expert parallelism, the parallel block, the Mamba2 hybrid;
  fp32): ``prefill`` then decode steps, the logits whole on every rank
  within atol 2e-4 (the reference's test); each rank's cache block equal
  to the reference cache cut by ``cache_sharding_rules`` (KV and SSM
  states within 1e-5 of max|reference|, ``pos`` exact), in both
  ``uniform_decode_pos`` modes. The prefill's cache is as long as the
  prompt, so its decode steps write past the end (clamped / dropped);
  decode steps from a zero cache write at its last position and past it;
  a prompt of 10 tokens, which ``model`` 4 does not divide, keeps the
  cache whole. The MoE config takes capacity factor 8, so that routing
  each data shard's tokens (the reference's expert-parallel layout)
  drops none, as the one-device routing of the whole batch drops none.
- Training: loss within 1e-4 and gradients within atol 3e-4 for the
  Mamba1, parallel-block and hybrid smoke LMs (the dense and MoE ones
  are in ``tests/test_torch_dist_lm.py``).
- The split itself, one forward and backward of each block of a layer:
  no parameter gathered over ``model``, one "g" a block (Mamba1: two,
  x_proj's output and the block's), ``flash_attention`` on Hq/M heads,
  ``mamba_scan`` on Di/M channels.
- Uneven heads: 6 heads on ``model`` 4 under ``allow_uneven_sharding``
  (blocks of 2, 2, 2, 0), loss, gradients and serving logits as above.
- Serving under the fsdp layout: the same cases, each rank's cache laid
  out by the reference's sanitized fsdp rules (batch over data, the
  sequence and the SSM channels whole: a bare ``model`` drops), its
  blocks, ``pos`` and every step's logits held as above; the MoE routes
  each data shard's rows with its experts split over ``model`` and
  summed, against the reference's one-device logits (never a reference
  fsdp run: its expert-parallel branch adds other rows' outputs there).
- The decode cache under ``allow_uneven_sharding``: the 10-token prompts
  of the four archs with a KV cache on ``model`` 4, the sequence in
  ``dist.block_range`` blocks of 3, 3, 3, 1, and a 5-token prompt of
  qwen2.5-14b's (2, 2, 1 and an empty block), both position modes;
  logits and blocks as above.
"""
import _torch_threads  # noqa: F401  (one torch thread a process)
import dataclasses
import functools
import pickle
import time
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch.multiprocessing as mp

import _torch_dist_tp_ranks as ranks
from repro import configs as jconfigs
from repro import dist as jdist
from repro.models import ModelConfig as JConfig
from repro.models import decoder as jdec
from repro_torch.models import decoder as tdec
from repro_torch.models.config import ModelConfig as TConfig

DEADLINE_S = 300
SERVE = ("qwen2.5-14b", "falcon-mamba-7b", "deepseek-moe-16b",
         "command-r-35b", "zamba2-1.2b")
TRAIN = ("falcon-mamba-7b", "command-r-35b", "zamba2-1.2b")
# the archs whose ragged prompts are served with allow_uneven_sharding
UNEVEN_CACHE = ("qwen2.5-14b", "deepseek-moe-16b", "command-r-35b",
                "zamba2-1.2b")
# a 1-layer dense LM whose heads and kv heads both split over model 4
DENSE = dict(name="tp", n_layers=1, d_model=64, n_heads=8, n_kv_heads=4,
             d_ff=128, vocab_size=256, attn_q_block=16, attn_kv_block=16,
             loss_seq_chunk=16, param_dtype="float32",
             compute_dtype="float32", cache_dtype="float32", remat="none")
UNEVEN = dict(name="uneven", n_layers=2, d_model=96, n_heads=6,
              n_kv_heads=2, d_ff=128, vocab_size=512, attn_q_block=16,
              attn_kv_block=16, loss_seq_chunk=16, param_dtype="float32",
              compute_dtype="float32", cache_dtype="float32", remat="none")
MODEL = ranks.MESH[1]


def _f32(cfg, **kw):
    return dataclasses.replace(cfg, param_dtype="float32",
                               compute_dtype="float32",
                               cache_dtype="float32", **kw)


def _configs() -> dict:
    out = {}
    for arch in set(SERVE) | set(TRAIN):
        kw = {"capacity_factor": 8.0} if arch == "deepseek-moe-16b" else {}
        out[arch] = dataclasses.asdict(_f32(jconfigs.get_smoke_config(arch),
                                            **kw))
    out["dense"], out["uneven"] = DENSE, UNEVEN
    return out


def _toks(rng, shape, vocab=512):
    return rng.integers(1, vocab, shape).astype(np.int32)


def _serve_cases(arch: str, rng) -> dict:
    cases = {"prefill": {"tokens": _toks(rng, (4, 16)),
                         "steps": [_toks(rng, (4, 1)) for _ in range(4)]}}
    if arch == "falcon-mamba-7b":          # no KV cache
        return cases
    cases["from_zero"] = {"init": (8, [6, 3, 7, 6]),
                          "steps": [_toks(rng, (4, 1)) for _ in range(3)]}
    cases["ragged"] = {"tokens": _toks(rng, (4, 10)),
                       "steps": [_toks(rng, (4, 1)) for _ in range(2)]}
    return cases


def _inputs() -> dict:
    cfgs = _configs()
    params, batches = {}, {}
    for name, kw in cfgs.items():
        params[name] = jax.device_get(jdec.init_params(
            jax.random.PRNGKey(0), JConfig(**kw)))
    rng = np.random.default_rng(0)
    serve = {arch: _serve_cases(arch, rng) for arch in SERVE}
    for arch in TRAIN + ("uneven",):
        toks = _toks(rng, (8, 32), cfgs[arch]["vocab_size"])
        batches[arch] = {"tokens": toks, "labels": np.roll(toks, -1, 1),
                         "loss_mask": np.ones((8, 32), np.float32)}
    split = {arch: rng.standard_normal(
        (4, 16, cfgs[arch]["d_model"])).astype(np.float32)
        for arch in ("dense", "falcon-mamba-7b", "command-r-35b")}
    uneven_serve = {"prefill": {"tokens": _toks(rng, (4, 16)),
                                "steps": [_toks(rng, (4, 1))
                                          for _ in range(2)]}}
    # 5 positions on model 4 under uneven sharding: blocks 2, 2, 1, 0
    uneven_short = {"tokens": _toks(rng, (4, 5)),
                    "steps": [_toks(rng, (4, 1)) for _ in range(2)]}
    return {"configs": cfgs, "params": params, "batches": batches,
            "serve": serve, "train": TRAIN, "split": split,
            "uneven_serve": uneven_serve, "uneven_cache": UNEVEN_CACHE,
            "uneven_short": uneven_short}


@functools.lru_cache(maxsize=None)
def _jitted(cfg: JConfig):
    return (jax.jit(lambda p, t: jdec.prefill(p, {"tokens": t}, cfg)),
            jax.jit(lambda p, c, t: jdec.decode_step(p, c, t, cfg)))


def _ref_serve(cfg: JConfig, params: dict, case: dict) -> tuple:
    """The reference's one-device run of a serving case → (logits by
    step, the final cache), numpy."""
    prefill, step = _jitted(cfg)
    p = jax.tree.map(jnp.asarray, params)
    logits = []
    if "init" in case:
        max_len, pos0 = case["init"]
        cache = jdec.init_cache(cfg, len(pos0), max_len)
        cache["pos"] = jnp.asarray(pos0, jnp.int32)
    else:
        lg, cache = prefill(p, jnp.asarray(case["tokens"]))
        logits.append(np.asarray(lg))
    for t in case["steps"]:
        lg, cache = step(p, cache, jnp.asarray(t))
        logits.append(np.asarray(lg))
    return logits, jax.device_get(cache)


def _value_and_grad(cfg: JConfig, params: dict, batch: dict):
    f = jax.jit(jax.value_and_grad(lambda p, b: jdec.lm_loss(p, b, cfg)[0]))
    loss, grads = f(jax.tree.map(jnp.asarray, params),
                    jax.tree.map(jnp.asarray, batch))
    return float(loss), jax.device_get(grads)


def _reference(inp: dict) -> dict:
    cfgs = {k: JConfig(**v) for k, v in inp["configs"].items()}
    out = {}
    for arch, cases in inp["serve"].items():
        for label, case in cases.items():
            for uniform in (True, False):
                cfg = dataclasses.replace(cfgs[arch],
                                          uniform_decode_pos=uniform)
                out["serve", arch, label, uniform] = _ref_serve(
                    cfg, inp["params"][arch], case)
    for label, case in inp["uneven_serve"].items():
        out["serve", "uneven", label, True] = _ref_serve(
            cfgs["uneven"], inp["params"]["uneven"], case)
    for uniform in (True, False):
        out["serve", "qwen2.5-14b", "short", uniform] = _ref_serve(
            dataclasses.replace(cfgs["qwen2.5-14b"],
                                uniform_decode_pos=uniform),
            inp["params"]["qwen2.5-14b"], inp["uneven_short"])
    for arch in TRAIN + ("uneven",):
        out["train", arch] = _value_and_grad(cfgs[arch], inp["params"][arch],
                                             inp["batches"][arch])
    return out


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Starts the 8 ranks, computes the reference meanwhile, joins the
    ranks (a rank's failure raises here) → (the ranks' results by rank,
    the reference's, the inputs)."""
    tmp = tmp_path_factory.mktemp("dist_tp")
    inp = _inputs()
    with open(tmp / "inputs.pkl", "wb") as f:
        pickle.dump(inp, f)
    ctx = mp.start_processes(
        ranks.run, args=(f"file://{tmp}/rendezvous", str(tmp / "inputs.pkl"),
                         str(tmp)),
        nprocs=ranks.WORLD, join=False, start_method="spawn")
    try:
        ref = _reference(inp)
        deadline = time.monotonic() + DEADLINE_S
        while not ctx.join(timeout=1):
            if time.monotonic() > deadline:
                raise TimeoutError(f"gloo ranks still running after "
                                   f"{DEADLINE_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(10)
    res = []
    for r in range(ranks.WORLD):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            res.append(pickle.load(f))
    return res, ref, inp


def _flat(tree, prefix=()):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _flat(tree[k], prefix + (k,))
        else:
            yield prefix + (k,), tree[k]


def _assert_grads(got: dict, want: dict, atol: float):
    want = dict(_flat(want))
    got = dict(_flat(got))
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        np.testing.assert_allclose(got[path], np.asarray(w, np.float32),
                                   atol=atol, err_msg=str(path))


def _serve_keys(inp):
    return [(arch, label, uniform) for arch, cases in inp["serve"].items()
            for label in cases for uniform in (True, False)] + [
        ("uneven", label, True) for label in inp["uneven_serve"]]


def _check_serving(res, ref, key, kind="serve"):
    want_logits, want_cache = ref[("serve",) + key]
    for out in res:
        got = out[(kind,) + key]
        assert len(got["logits"]) == len(want_logits)
        for i, (g, w) in enumerate(zip(got["logits"], want_logits)):
            np.testing.assert_allclose(g, w, atol=2e-4, rtol=0,
                                       err_msg=f"{key} step {i}")
        assert sorted(got["cache"]) == sorted(want_cache)
        for name, (block, cut, spec) in got["cache"].items():
            w = np.asarray(want_cache[name])
            w = w[tuple(slice(lo, hi) for lo, hi in cut)]
            if name == "pos":
                np.testing.assert_array_equal(block, w)
                continue
            np.testing.assert_allclose(
                block, w.astype(np.float32), rtol=0,
                atol=1e-5 * max(float(np.abs(w).max(initial=0.0)), 1.0),
                err_msg=f"{key} {name}")


@pytest.mark.parametrize("arch", SERVE)
def test_serving_matches_one_device(run, arch):
    res, ref, inp = run
    for key in _serve_keys(inp):
        if key[0] == arch:
            _check_serving(res, ref, key)


def test_serving_cache_layout(run):
    """Batch rows over data; the KV caches' sequence over model where it
    divides (16 and 8 positions), whole where it does not (10); the SSM
    states' channels over model; ``pos`` whole."""
    res, _, _ = run
    for out in res:
        c = out["coords"]
        for (_, arch, label, _), got in ((k, v) for k, v in out.items()
                                         if k[0] == "serve"):
            for name, (block, cut, spec) in got["cache"].items():
                if name == "pos":
                    assert spec == (None,) and cut == [(0, 4)]
                    continue
                assert spec[1] == "data" and cut[1] == (2 * c["data"],
                                                        2 * c["data"] + 2)
                if name in ("k", "v", "sa_k", "sa_v"):
                    seq = 10 if label == "ragged" else None
                    if seq is None:
                        n = block.shape[2]
                        assert spec[2] == "model" and cut[2] == (
                            n * c["model"], n * (c["model"] + 1))
                    else:
                        assert spec[2] is None and cut[2] == (0, seq)
                else:
                    dim = 3 if name == "conv" else 2
                    assert spec[dim] == "model"


@pytest.mark.parametrize("arch", TRAIN)
def test_tensor_parallel_loss_and_grads_match_one_device(run, arch):
    res, ref, _ = run
    loss, grads = ref["train", arch]
    for out in res:
        assert abs(out["train", arch]["loss"] - loss) < 1e-4
    _assert_grads(res[0]["train", arch]["grads"], grads, 3e-4)


@pytest.mark.parametrize("arch", TRAIN)
def test_no_parameter_is_gathered_over_model(run, arch):
    res, _, _ = run
    for out in res:
        coll = out["train", arch]["collectives"]
        assert not any(k.startswith("param_all_gather") for k in coll), coll
        assert coll.get("all_reduce:model", 0) > 0


@pytest.mark.parametrize("arch", ["dense", "falcon-mamba-7b",
                                  "command-r-35b"])
def test_the_split_of_one_layer(run, arch):
    """Counters around one forward and backward of each block: one "g" a
    block (Mamba1: two), no gather over ``model`` of a parameter (the
    dense layer: of anything), the kernels on the rank's heads or
    channels."""
    res, _, inp = run
    cfg = inp["configs"][arch]
    for out in res:
        for block, got in out["split", arch].items():
            coll = got["collectives"]
            assert not any(k.startswith("param_all_gather") for k in coll)
            assert got["g"] == (2 if block == "mamba1" else 1), (block, got)
            if block in ("attention", "parallel"):
                hq = cfg["n_heads"] // MODEL
                g = cfg["n_heads"] // cfg["n_kv_heads"]
                assert got["heads"] == [(hq, max(hq // g, 1))]
            if block == "mamba1":
                assert got["channels"] == [2 * cfg["d_model"] // MODEL]
            if arch == "dense":
                assert "all_gather:model" not in coll
                assert coll.get("all_reduce:model") == 2     # "g" and "f"


def test_uneven_heads(run):
    """6 heads on model 4: ranks hold 2, 2, 2 and 0 heads (the last one
    issues every collective and adds zeros); loss, gradients and serving
    logits match the reference's one-device ones."""
    res, ref, inp = run
    loss, grads = ref["train", "uneven"]
    for out in res:
        assert abs(out["train", "uneven"]["loss"] - loss) < 1e-4
    _assert_grads(res[0]["train", "uneven"]["grads"], grads, 3e-4)
    for label in inp["uneven_serve"]:
        _check_serving(res, ref, ("uneven", label, True))


class _FakeMesh:
    axis_names = ("data", "model")
    empty = False
    shape = dict(zip(axis_names, ranks.MESH))


def _reference_specs(cfg: dict, b: int, max_len: int, layout: str,
                     uneven: bool) -> dict:
    """The reference's sanitized ``cache_sharding_rules`` of each cache
    leaf on the (2, 4) mesh in ``layout``, with or without uneven
    sharding (the leaves' shapes are the port's ``_cache_shapes``, which
    ``test_torch_models.py`` holds to the reference's cache)."""
    shapes = tdec._cache_shapes(TConfig(**cfg), b, max_len)
    rules = jdec.cache_sharding_rules(JConfig(**cfg))
    toks = (jdist._LAYOUT.set(layout), jdist._UNEVEN.set(uneven))
    try:
        with mock.patch.object(jdist, "current_mesh", lambda: _FakeMesh):
            return {k: tuple(jdist.sanitize_spec(shp, rules[k]))
                    for k, (shp, _) in shapes.items()}
    finally:
        jdist._LAYOUT.reset(toks[0])
        jdist._UNEVEN.reset(toks[1])


@pytest.mark.parametrize("arch", SERVE)
def test_fsdp_serving_matches_one_device(run, arch):
    res, ref, inp = run
    for key in _serve_keys(inp):
        if key[0] == arch:
            _check_serving(res, ref, key, "fsdp")


def test_fsdp_serving_cache_layout(run):
    """Under fsdp every leaf's spec is the reference's sanitized fsdp
    rule: the batch rows over data, the sequence and the SSM channels
    whole on every rank (the four model ranks of a data coordinate hold
    the same rows), ``pos`` whole."""
    res, _, inp = run
    for out in res:
        c = out["coords"]
        for key, got in out.items():
            if key[0] != "fsdp":
                continue
            arch, cache = key[1], got["cache"]
            kv = [n for n in ("k", "sa_k") if n in cache]
            max_len = cache[kv[0]][1][2][1] if kv else 0
            want = _reference_specs(inp["configs"][arch], 4, max_len,
                                    "fsdp", False)
            for name, (block, cut, spec) in cache.items():
                assert spec == want[name], (key, name)
                if name == "pos":
                    continue
                assert spec[1] == "data" and cut[1] == (2 * c["data"],
                                                        2 * c["data"] + 2)
                assert all(e is None for i, e in enumerate(spec) if i != 1)


def test_uneven_serving_cache(run):
    """With ``allow_uneven_sharding`` a 10-position cache on 4 model ranks
    is split in ``block_range``'s blocks (3, 3, 3, 1), and qwen2.5-14b's
    5-position one in blocks of 2, 2, 1 and 0 (the last rank's block
    empty), by the reference's sanitized rules with the flag; each
    step's logits and the cache blocks equal the reference's one-device
    ones."""
    res, ref, inp = run
    cases = [(arch, "ragged", 10) for arch in UNEVEN_CACHE]
    cases.append(("qwen2.5-14b", "short", 5))
    for out in res:
        c = out["coords"]
        for arch, label, n in cases:
            b = -(-n // MODEL)
            lo = min(b * c["model"], n)
            for uniform in (True, False):
                key = (arch, label, uniform)
                _check_serving([out], ref, key, "uneven_cache")
                got = out[("uneven_cache",) + key]["cache"]
                want = _reference_specs(inp["configs"][arch], 4, n, "tp",
                                        True)
                for name in ("k", "v", "sa_k", "sa_v"):
                    if name not in got:
                        continue
                    block, cut, spec = got[name]
                    assert spec == want[name] and spec[2] == "model"
                    assert cut[2] == (lo, min(lo + b, n))
                    assert block.shape[2] == cut[2][1] - cut[2][0]
