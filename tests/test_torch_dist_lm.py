"""The port's multi-device LM training on gloo against the JAX package's
one-device results.

One ``torch.multiprocessing`` start of 8 ranks for the file (a
module-scoped fixture; ``tests/_torch_dist_ranks.py`` is the rank side):
they build the (2, 4) data×model mesh, the (4, 2) one and the (2, 2, 2)
pod×data×model one in turn and run every check, while this process
computes the reference's one-device results with JAX. Rendezvous goes
through a file under the test's temporary directory (test files run side
by side), and a rank that dies fails the fixture at once; the join has
a deadline.

Tolerances: loss 1e-4 and gradients atol 3e-4 on the 2×4 mesh (the
reference's ``test_distributed.py``); three ZeRO train steps as
``tests/test_torch_train.py`` holds the one-device steps (parameters
2e-5, moments 1e-4 of max|reference|, loss 1e-5 and grad norm 1e-4
relative); expert parallelism's ``y`` 1e-4 of the reference's dense
``moe_block`` and its aux 1e-6 of the mean over data shards of the
reference's per-shard ``_route`` aux (the reference's own test allows
30%); the pod-compressed gradients' loss 1e-4 and gradient error under
0.02 of max|reference| (``test_compression.py``), int8 on the pod wire;
checkpoints exact.
"""
import _torch_threads  # noqa: F401  (one torch thread a process)
import pickle
import time

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch.multiprocessing as mp

import _torch_dist_ranks as ranks
from repro import dist as jdist
from repro.models import ModelConfig as JConfig
from repro.models import decoder as jdec
from repro.models import layers as jL
from repro.train import checkpoint as jckpt
from repro.train import loop as jloop
from repro.train import optimizer as jopt

DEADLINE_S = 300

COMMON = dict(name="d", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
              d_ff=128, vocab_size=2048, attn_q_block=32, attn_kv_block=32,
              loss_seq_chunk=32, param_dtype="float32",
              compute_dtype="float32", remat="none")
# test_distributed.py's EP config, and a 1-layer LM on it whose aux and
# dropped tokens cannot differ (aux coefficient 0, capacity factor 8)
MOE = dict(name="m", n_layers=1, d_model=64, n_heads=4, n_kv_heads=4,
           d_ff=0, vocab_size=256, n_experts=8, n_shared_experts=1,
           moe_top_k=2, expert_ff=32, capacity_factor=8.0,
           param_dtype="float32", compute_dtype="float32")
MOE_LM = dict(MOE, name="mlm", router_aux_coef=0.0, attn_q_block=32,
              attn_kv_block=32, loss_seq_chunk=32, remat="none")
# an odd d_model (63) beside a head dim of 64: ZeRO's data entry divides
# the attention weights (their largest free dim is the head dim) and not
# the norms, MLP and embeddings, which stay whole on every data rank
TRAIN = dict(name="z", n_layers=2, d_model=63, n_heads=4, n_kv_heads=2,
             head_dim=64, d_ff=96, vocab_size=256, attn_q_block=32,
             attn_kv_block=32, loss_seq_chunk=32, param_dtype="float32",
             compute_dtype="float32", remat="block")
COMPRESSION = dict(COMMON, name="c", vocab_size=512)
MESH = {"data": 2, "model": 4}


def _batch(rng, vocab, b=8, s=64, mask=None):
    toks = rng.integers(0, vocab, (b, s)).astype(np.int32)
    return {"tokens": toks, "labels": toks,
            "loss_mask": np.ones((b, s), np.float32) if mask is None
            else mask}


def _jtree(tree):
    return jax.tree.map(jnp.asarray, tree)


def _params(cfg, seed=0):
    return jax.device_get(jdec.init_params(jax.random.PRNGKey(seed), cfg))


def _value_and_grad(cfg, params, batch):
    f = jax.jit(jax.value_and_grad(lambda p, b: jdec.lm_loss(p, b, cfg)[0]))
    loss, grads = f(_jtree(params), _jtree(batch))
    return float(loss), jax.device_get(grads)


def _inputs(tmp):
    """The reference's inputs for the ranks (numpy) and its checkpoint."""
    cfgs = {"common": COMMON, "moe": MOE, "moe_lm": MOE_LM, "train": TRAIN,
            "compression": COMPRESSION}
    rng = np.random.default_rng(0)
    common = _batch(rng, COMMON["vocab_size"])
    mask = np.ones((8, 64), np.float32)
    mask[4:] = rng.integers(0, 2, (4, 64))     # data shard 1's rows only
    moe_cfg = JConfig(**MOE)
    moe_params = _params(moe_cfg)
    rng = np.random.default_rng(1)
    train_batches = []
    for _ in range(3):
        toks = rng.integers(1, TRAIN["vocab_size"], (8, 32)).astype(np.int32)
        train_batches.append({"tokens": toks, "labels": np.roll(toks, -1, 1),
                              "loss_mask": np.ones((8, 32), np.float32)})
    st = jloop.init_train_state(jax.random.PRNGKey(0), JConfig(**TRAIN))
    ref_ckpt = str(tmp / "ref_ckpt")
    jckpt.save_checkpoint(ref_ckpt, 1, {
        "w": jnp.arange(64.0).reshape(8, 8) * 0.5,
        "h": jnp.arange(32.0).reshape(8, 4).astype(jnp.bfloat16)})
    return {
        "configs": cfgs,
        "common_params": _params(JConfig(**COMMON)), "common_batch": common,
        "mask_batch": dict(common, loss_mask=mask),
        "moe_lm_params": _params(JConfig(**MOE_LM)),
        "moe_lm_batch": _batch(np.random.default_rng(2), 256, 8, 32),
        "moe_params": jax.tree.map(lambda a: a[0],
                                   moe_params["layers"])["moe"],
        "moe_x": np.random.default_rng(0).standard_normal(
            (4, 16, 64)).astype(np.float32),
        "train_state": {"params": jax.device_get(st.params),
                        "opt": jax.device_get(st.opt),
                        "step": np.asarray(st.step)},
        "train_batches": train_batches,
        "compression_params": _params(JConfig(**COMPRESSION)),
        "compression_batch": _batch(np.random.default_rng(0), 512),
        "ref_ckpt": ref_ckpt, "ckpt_dir": str(tmp / "ckpt"),
    }


def _reference(inp):
    """The reference's one-device results on the same inputs."""
    out = {}
    common = JConfig(**COMMON)
    out["common"] = _value_and_grad(common, inp["common_params"],
                                    inp["common_batch"])
    out["common_mask"] = _value_and_grad(common, inp["common_params"],
                                         inp["mask_batch"])
    out["moe_lm"] = _value_and_grad(JConfig(**MOE_LM), inp["moe_lm_params"],
                                    inp["moe_lm_batch"])
    out["compression"] = _value_and_grad(
        JConfig(**COMPRESSION), inp["compression_params"],
        inp["compression_batch"])
    moe = JConfig(**MOE)
    p = _jtree(inp["moe_params"])
    x = jnp.asarray(inp["moe_x"])
    y, _ = jL.moe_block(p, x, moe)
    auxes = []
    for xs in np.split(inp["moe_x"], MESH["data"]):
        h = jL.rms_norm(jnp.asarray(xs), p["ln"], moe.rms_eps)
        auxes.append(float(jL._route(h.reshape(-1, moe.d_model),
                                     p["router"], moe)[2]))
    out["moe_block"] = (np.asarray(y), float(np.mean(auxes)))
    train = JConfig(**TRAIN)
    opt_cfg = jopt.OptimizerConfig(warmup_steps=1, total_steps=10,
                                   accum_dtype="float32")
    for mode in ("scan_grads", "grad_of_scan"):
        st = jloop.init_train_state(jax.random.PRNGKey(0), train)
        step = jax.jit(jloop.make_train_step(train, opt_cfg,
                                             n_microbatches=2,
                                             accum_mode=mode))
        metrics = []
        for b in inp["train_batches"]:
            st, m = step(st, _jtree(b))
            metrics.append({k: float(v) for k, v in m.items()})
        out["train", mode] = (metrics, jax.device_get(
            {"params": st.params, "opt": st.opt}))
    return out


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Starts the 8 ranks, computes the reference meanwhile, joins the
    ranks (a rank's failure raises here) → (the ranks' results by rank,
    the reference's, the inputs)."""
    tmp = tmp_path_factory.mktemp("dist_lm")
    inp = _inputs(tmp)
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


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _assert_grads(got: dict, want: dict, atol: float):
    paths = [p for p, _ in _flat(want)]
    assert paths == [p for p, _ in _flat(got)]
    for path in paths:
        np.testing.assert_allclose(_get(got, path),
                                   np.asarray(_get(want, path), np.float32),
                                   atol=atol, err_msg=str(path))


def test_host_mesh_shapes_names_and_row_major_ranks(run):
    res, _, _ = run
    for r, out in enumerate(res):
        shape, names, coords = out["mesh"]
        assert shape == MESH and names == ("data", "model")
        assert coords == {"data": r // 4, "model": r % 4}
        assert "(16, 16)" in out["production_error"]
    coords = [out["ckpt"]["coords"] for out in res]
    assert coords == [{"data": r // 2, "model": r % 2} for r in range(8)]


@pytest.mark.parametrize("layout", ["tp", "fsdp"])
def test_loss_and_grads_match_one_device(run, layout):
    res, ref, _ = run
    loss, grads = ref["common"]
    for out in res:
        assert abs(out["common", layout]["loss"] - loss) < 1e-4
    _assert_grads(res[0]["common", layout]["grads"], grads, 3e-4)


def test_loss_mask_differing_between_data_shards(run):
    """The loss is the global masked sum over the global token count, not
    a mean of the shards' means (which differ here)."""
    res, ref, inp = run
    loss, grads = ref["common_mask"]
    m = inp["mask_batch"]["loss_mask"]
    assert m[:4].sum() != m[4:].sum()
    for out in res:
        assert abs(out["common_mask"]["loss"] - loss) < 1e-4
    _assert_grads(res[0]["common_mask"]["grads"], grads, 3e-4)


@pytest.mark.parametrize("layout", ["tp", "fsdp"])
def test_moe_lm_loss_and_grads_match_one_device(run, layout):
    """Expert parallelism in a 1-layer MoE LM: under tp each model rank
    keeps 2 of the 8 experts; under fsdp the model ranks' rows are
    gathered first (the reference would sum other rows' outputs there)."""
    res, ref, _ = run
    loss, grads = ref["moe_lm"]
    for out in res:
        assert abs(out["moe_lm", layout]["loss"] - loss) < 1e-4
    _assert_grads(res[0]["moe_lm", layout]["grads"], grads, 3e-4)


def test_moe_expert_parallel_block_matches_dense(run):
    res, ref, _ = run
    y, aux = ref["moe_block"]
    for out in res:
        got = out["moe_block"]
        assert got["ep"] and got["expert_rows"] == 8 // MESH["model"]
        np.testing.assert_allclose(got["y"], y, atol=1e-4, rtol=1e-4)
        assert abs(got["aux"] - aux) <= 1e-6


@pytest.mark.parametrize("accum_mode", ["scan_grads", "grad_of_scan"])
def test_zero_train_steps_match_one_device(run, accum_mode):
    res, ref, _ = run
    metrics, want = ref["train", accum_mode]
    for out in res:
        for mc, mh in zip(out["train", accum_mode]["metrics"], metrics):
            assert mc["loss"] == pytest.approx(mh["loss"], rel=1e-5)
            assert mc["lr"] == pytest.approx(mh["lr"], rel=1e-6)
            assert mc["grad_norm"] == pytest.approx(mh["grad_norm"],
                                                    rel=1e-4)
    got = res[0]["train", accum_mode]["state"]
    assert got["step"].item() == 3 and got["opt"]["step"].item() == 3
    for part in ("params", "opt"):
        for path, a in _flat(got[part]):
            w = np.asarray(_get(want[part], path))
            tol = 2e-5 if path[0] not in ("m", "v") else \
                1e-4 * float(np.abs(w).max())
            np.testing.assert_allclose(a, w, atol=tol, err_msg=str(path))


def _fake_mesh(monkeypatch):
    class FakeMesh:
        shape = MESH
        axis_names = ("data", "model")
        empty = False

    monkeypatch.setattr(jdist, "current_mesh", lambda: FakeMesh())


def test_zero_state_numels(run, monkeypatch):
    """Each rank stores the blocks the reference's rules give: master / m
    / v 1/data of the parameter's block where ZeRO's entry divides, the
    parameter's block where it does not (d_model 63)."""
    res, _, inp = run
    cfg = JConfig(**TRAIN)
    _fake_mesh(monkeypatch)
    rules = jdec.param_sharding_rules(cfg)
    shapes = jdec.param_shapes(cfg)
    zero = jopt.opt_state_sharding_rules(rules, shapes)["master"]
    whole, split = 0, 0
    for path, shp in _flat_shapes(shapes):
        for name, rule in (("params", _get(rules, path)),
                           ("zero", _get(zero, path))):
            spec = jdist.sanitize_spec(shp, rule)
            n = int(np.prod(shp))
            for e in spec:
                for a in ((e,) if isinstance(e, str) else e or ()):
                    n //= MESH[a]
            keys = (["params/" + "/".join(path)] if name == "params" else
                    ["/".join((part,) + path) for part in
                     ("master", "m", "v")])
            for out in res:
                for mode in ("scan_grads", "grad_of_scan"):
                    for k in keys:
                        assert out["train", mode]["numels"][k] == n, (k, n)
            if name == "zero":
                divides = "data" in str(spec)
                split += divides
                whole += not divides
    assert split and whole       # both cases occur


def _flat_shapes(tree, prefix=()):
    for k in sorted(tree):
        if isinstance(tree[k], tuple):
            yield prefix + (k,), tree[k]
        else:
            yield from _flat_shapes(tree[k], prefix + (k,))


def test_pod_compressed_grads_close_to_exact(run):
    res, ref, _ = run
    loss, grads = ref["compression"]
    rels = []
    for out in res:
        assert abs(out["compression"]["loss"] - loss) < 1e-4
    for path, a in _flat(res[0]["compression"]["grads"]):
        w = np.asarray(_get(grads, path), np.float64)
        rels.append(np.abs(a - w).max() / (np.abs(w).max() + 1e-12))
    assert max(rels) < 0.02, max(rels)


def test_int8_on_the_pod_wire(run):
    """Every float leaf's pod exchange is one int8 all_gather (its scale's
    bytes ride behind the int8 values); nothing else crosses the pod."""
    res, _, inp = run
    n_leaves = len(list(_flat(inp["compression_params"])))
    for out in res:
        pod = [w for w in out["compression"]["wire"] if w[1]]
        assert len(pod) == n_leaves
        assert all(dtype == "torch.int8" for dtype, _, _ in pod)


def test_compressed_pod_mean_is_exact_for_integer_and_scalar_leaves(run):
    res, _, _ = run
    for out in res:
        ex = out["compression"]["exempt"]
        np.testing.assert_array_equal(ex["i"], [6, 12])
        assert ex["i"].dtype == np.int32
        assert float(ex["s"]) == 3.5
        np.testing.assert_allclose(ex["f"], 1.5, atol=1.5 / 127)


def test_checkpoint_restores_across_meshes(run):
    """Saved from 2×4 under P("data", "model"), restored into 4×2 under
    P("model", "data"): each rank holds the slice the spec names."""
    res, _, _ = run
    whole = np.arange(64.0).reshape(8, 8)
    for out in res:
        c = out["ckpt"]["coords"]
        want = whole[4 * c["model"]:4 * (c["model"] + 1),
                     2 * c["data"]:2 * (c["data"] + 1)]
        np.testing.assert_array_equal(out["ckpt"]["block"], want)
        np.testing.assert_array_equal(out["ckpt"]["whole"], whole)


def test_reference_checkpoint_restores_onto_a_mesh(run):
    res, _, _ = run
    w = np.arange(64.0).reshape(8, 8) * 0.5
    h = np.arange(32.0).reshape(8, 4).astype(ml_dtypes.bfloat16)
    for out in res:
        c = out["ckpt"]["coords"]
        rows = slice(4 * c["model"], 4 * (c["model"] + 1))
        np.testing.assert_array_equal(
            out["ckpt"]["ref_w"], w[rows, 2 * c["data"]:2 * (c["data"] + 1)])
        np.testing.assert_array_equal(
            out["ckpt"]["ref_h"],
            h[rows, c["data"]:c["data"] + 1].astype(np.float32))
