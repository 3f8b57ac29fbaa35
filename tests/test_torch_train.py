"""The port's training substrate against the JAX package on the CPU:
AdamW (the reference's hand-checked cases and ``apply_updates`` on the
same tree), the schedule, the microbatch layout, microbatch equivalence,
three ``make_train_step`` steps in both ``accum_mode``s from the same
``TrainState``, a loss that decreases, ``restore_checkpoint`` (round
trip, shape mismatch, missing key, bf16 leaves, either package's
training checkpoint restoring into the other) and the launcher
(``--resume`` bit-exact against an uninterrupted run,
``--inject-failure-at`` exiting 42).

Tolerances: the optimizer's math 1e-6 relative (the same fp32 formulas;
XLA may fuse a multiply-add); parameters after three steps 2e-5 absolute
at the default lr 3e-4 (the reference's own microbatch-equivalence
bound: AdamW's first steps move each parameter by ~lr · g / |g|, so a
gradient element near its rounding noise can move a parameter by a
fraction of lr); the moments 1e-4 relative to max|reference| (the first
step's gradients agree to 2e-5 of max, ``tests/test_torch_lm_grad.py``,
and the later steps' are taken at parameters ~1e-7 apart); the loss 1e-5
relative, the grad norm 1e-4.
"""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.train import checkpoint as jckpt
from repro.train import loop as jloop
from repro.train import optimizer as jopt
from repro_torch import convert
from repro_torch.models import config as model_config
from repro_torch.train import checkpoint as C
from repro_torch.train.loop import (TrainState, init_train_state,
                                    make_train_step, microbatch_split)
from repro_torch.train.optimizer import (OptimizerConfig, apply_updates,
                                         global_norm, init_opt_state,
                                         schedule)
from repro_torch.utils import tree_leaves as leaves

ROOT = pathlib.Path(__file__).resolve().parents[1]
SRC = str(ROOT / "src")

CFG = model_config.ModelConfig(
    name="t", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab_size=256, attn_q_block=32, attn_kv_block=32, loss_seq_chunk=32,
    param_dtype="float32", compute_dtype="float32", remat="none")


def _batch(rng, vocab=CFG.vocab_size, b=8, s=64):
    toks = torch.as_tensor(rng.integers(0, vocab, (b, s)), dtype=torch.int32)
    return {"tokens": toks, "labels": toks,
            "loss_mask": torch.ones((b, s), dtype=torch.float32)}


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------


def test_adamw_matches_reference_scalar():
    """Hand-checked AdamW on a single scalar parameter."""
    cfg = OptimizerConfig(lr=0.1, beta1=0.9, beta2=0.99, eps=1e-8,
                          weight_decay=0.0, clip_norm=1e9, warmup_steps=0,
                          total_steps=10**9, min_lr_frac=1.0)
    p = {"w": torch.tensor(2.0)}
    opt = init_opt_state(p)
    p2, opt2, _ = apply_updates(p, {"w": torch.tensor(0.5)}, opt, cfg)
    # step 1: m=0.05, v=0.0025; mhat=0.5, vhat=0.25 → delta = 1.0
    assert float(p2["w"]) == pytest.approx(2.0 - 0.1 * (0.5 / 0.5),
                                           rel=1e-5)
    assert int(opt2["step"]) == 1 and opt2["step"].dtype == torch.int32


def test_grad_clipping():
    cfg = OptimizerConfig(clip_norm=1.0, warmup_steps=0, weight_decay=0.0)
    p = {"w": torch.ones(4)}
    opt = init_opt_state(p)
    _, opt2, metrics = apply_updates(p, {"w": torch.full((4,), 100.0)}, opt,
                                     cfg)
    assert float(metrics["grad_norm"]) == pytest.approx(200.0)
    # clipped: m = (1-b1) * g*scale, scale = 1/200
    np.testing.assert_allclose(opt2["m"]["w"].numpy(), 0.1 * 100.0 / 200.0,
                               rtol=1e-4)


def test_schedule_warmup_and_decay():
    cfg = OptimizerConfig(lr=1.0, warmup_steps=10, total_steps=100,
                          min_lr_frac=0.1)
    for step, want in ((5, 0.5), (10, 1.0), (100, 0.1), (55, 0.55)):
        got = schedule(cfg, torch.tensor(step, dtype=torch.int32))
        assert float(got) == pytest.approx(want, rel=1e-6)
        assert float(got) == pytest.approx(
            float(jopt.schedule(jopt.OptimizerConfig(
                lr=1.0, warmup_steps=10, total_steps=100, min_lr_frac=0.1),
                jnp.asarray(step))), rel=1e-6)


def test_master_is_a_copy_of_fp32_params():
    p = {"w": torch.ones(3), "b": {"x": torch.zeros(2, dtype=torch.bfloat16)}}
    opt = init_opt_state(p)
    assert opt["master"]["w"].data_ptr() != p["w"].data_ptr()
    assert opt["master"]["b"]["x"].dtype == torch.float32
    assert opt["step"].shape == () and int(opt["step"]) == 0


def _tree(rng, shapes, dt=np.float32):
    return {k: _tree(rng, v, dt) if isinstance(v, dict)
            else rng.standard_normal(v).astype(dt) for k, v in shapes.items()}


def _jtree(tree):
    return {k: _jtree(v) if isinstance(v, dict) else jnp.asarray(v)
            for k, v in tree.items()}


def _ttree(tree):
    return {k: _ttree(v) if isinstance(v, dict) else torch.as_tensor(v)
            for k, v in tree.items()}


def _jflat(tree, path):
    for k in path:
        tree = tree[k]
    return np.asarray(tree)


@pytest.mark.parametrize("clip", [1.0, 1e9])
def test_apply_updates_matches_reference(rng, clip):
    """Three updates of one tree (leaves of several shapes, a large
    gradient that clips) against the reference's, fp32."""
    shapes = {"a": (5, 3), "b": {"c": (7,), "d": (2, 3, 4)}, "e": ()}
    params, grads = _tree(rng, shapes), [_tree(rng, shapes) for _ in range(3)]
    cfg = OptimizerConfig(lr=1e-2, warmup_steps=2, total_steps=10,
                          clip_norm=clip)
    jcfg = jopt.OptimizerConfig(**dataclasses.asdict(cfg))
    jp, tp = _jtree(params), _ttree(params)
    jo, to = jopt.init_opt_state(jp), init_opt_state(tp)
    for g in grads:
        g = {k: (v * 10 if k == "a" else v) for k, v in g.items()}
        jp, jo, jm = jopt.apply_updates(jp, _jtree(g), jo, jcfg)
        tp, to, tm = apply_updates(tp, _ttree(g), to, cfg)
        for key in ("lr", "grad_norm"):
            assert float(tm[key]) == pytest.approx(float(jm[key]), rel=1e-6)
    assert float(global_norm(_ttree(grads[0]))) == pytest.approx(
        float(jopt.global_norm(_jtree(grads[0]))), rel=1e-6)
    for tree, jtree in ((tp, jp), (to["master"], jo["master"]),
                        (to["m"], jo["m"]), (to["v"], jo["v"])):
        for path, t in leaves(tree):
            want = _jflat(jtree, path)
            np.testing.assert_allclose(t.numpy(), want, rtol=1e-6,
                                       atol=1e-6 * float(np.abs(want).max()))
    assert int(to["step"]) == int(jo["step"]) == 3


def test_update_runs_in_slices_of_large_leaves(monkeypatch):
    """A leaf larger than a slice is updated piece by piece to the same
    values as in one piece."""
    from repro_torch.train import optimizer as O
    rng = np.random.default_rng(3)
    w, g = (torch.as_tensor(rng.standard_normal((10, 7)).astype(np.float32))
            for _ in range(2))
    cfg = OptimizerConfig(warmup_steps=0)
    whole = apply_updates({"w": w.clone()}, {"w": g},
                          init_opt_state({"w": w}), cfg)
    monkeypatch.setattr(O, "UPDATE_SLICE", 16)
    sliced = apply_updates({"w": w.clone()}, {"w": g},
                           init_opt_state({"w": w}), cfg)
    assert torch.equal(whole[0]["w"], sliced[0]["w"])
    assert torch.equal(whole[1]["v"]["w"], sliced[1]["v"]["w"])


# ---------------------------------------------------------------------------
# train step
# ---------------------------------------------------------------------------


def test_microbatch_split_layout():
    x = torch.arange(32).reshape(16, 2)
    out = microbatch_split({"x": x}, n_mb=4, dp=2)["x"]
    want = jloop.microbatch_split({"x": jnp.arange(32).reshape(16, 2)}, 4, 2)
    assert out.shape == (4, 4, 2)
    np.testing.assert_array_equal(out.numpy(), np.asarray(want["x"]))
    first_col = out[:, :, 0] // 2
    for mb in range(4):
        rows = set(first_col[mb].tolist())
        assert any(r < 8 for r in rows) and any(r >= 8 for r in rows)


@pytest.mark.parametrize("accum_mode", ["scan_grads", "grad_of_scan"])
def test_microbatching_equivalent_grads(rng, accum_mode):
    """1 vs 4 microbatches give the same update (fp32 accumulation)."""
    opt_cfg = OptimizerConfig(accum_dtype="float32", warmup_steps=0)
    batch = _batch(rng)
    s1 = init_train_state(CFG, 0, "cpu")
    s4 = init_train_state(CFG, 0, "cpu")
    s1b, m1 = make_train_step(CFG, opt_cfg, 1, accum_mode=accum_mode)(
        s1, batch)
    s4b, m4 = make_train_step(CFG, opt_cfg, 4, accum_mode=accum_mode)(
        s4, batch)
    assert float(m1["loss"]) == pytest.approx(float(m4["loss"]), rel=1e-5)
    for (_, a), (_, b) in zip(leaves(s1b.params), leaves(s4b.params)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-5)


def test_accum_modes_give_the_same_step(rng):
    opt_cfg = OptimizerConfig(accum_dtype="float32", warmup_steps=0)
    batch = _batch(rng, b=4, s=32)
    runs = []
    for mode in ("scan_grads", "grad_of_scan"):
        st = init_train_state(CFG, 1, "cpu")
        st, m = make_train_step(CFG, opt_cfg, 2, accum_mode=mode)(st, batch)
        runs.append((st, m))
    assert float(runs[0][1]["grad_norm"]) == pytest.approx(
        float(runs[1][1]["grad_norm"]), rel=1e-5)
    for (_, a), (_, b) in zip(leaves(runs[0][0].opt["m"]),
                              leaves(runs[1][0].opt["m"])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-5 * float(b.abs().max()) + 1e-12)


def test_shard_grads_like_opt_names_the_roadmap():
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 3"):
        make_train_step(CFG, OptimizerConfig(), shard_grads_like_opt=True)


def test_grad_reducer_sees_the_gradients(rng):
    seen = []

    def reducer(g):
        seen.append(sorted(g))
        return {k: v for k, v in g.items()}

    st = init_train_state(CFG, 0, "cpu")
    make_train_step(CFG, OptimizerConfig(), grad_reducer=reducer)(
        st, _batch(rng, b=2, s=32))
    assert seen == [["embed", "final_ln", "layers", "lm_head"]]


def test_loss_decreases(rng):
    opt_cfg = OptimizerConfig(lr=1e-2, warmup_steps=2, total_steps=30,
                              accum_dtype="float32")
    state = init_train_state(CFG, 0, "cpu")
    step = make_train_step(CFG, opt_cfg)
    batch = _batch(rng, b=4, s=32)  # overfit one batch
    losses = []
    for _ in range(30):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0] - 1.0, (losses[0], losses[-1])
    assert int(state.step) == 30 and int(state.opt["step"]) == 30


def _jtrain_state(jcfg, seed):
    st = jloop.init_train_state(jax.random.PRNGKey(seed), jcfg)
    return st, {"params": jax.device_get(st.params),
                "opt": jax.device_get(st.opt),
                "step": np.asarray(st.step)}


@pytest.mark.parametrize("accum_mode", ["scan_grads", "grad_of_scan"])
@pytest.mark.parametrize("arch", ["qwen2.5-14b", "falcon-mamba-7b"])
def test_three_train_steps_match_reference(arch, accum_mode):
    """Three ``make_train_step`` steps (2 microbatches, fp32 accumulation)
    from the same ``TrainState`` on the same batches: parameters, master,
    moments, step and metrics equal to the reference's."""
    jcfg = dataclasses.replace(jconfigs.get_smoke_config(arch),
                               param_dtype="float32",
                               compute_dtype="float32", remat="block")
    cfg = model_config.ModelConfig(**dataclasses.asdict(jcfg))
    opt_cfg = OptimizerConfig(warmup_steps=1, total_steps=10,
                              accum_dtype="float32")
    jstate, leaves_np = _jtrain_state(jcfg, 0)
    state = convert.train_state(leaves_np, "cpu")
    jstep = jax.jit(jloop.make_train_step(
        jcfg, jopt.OptimizerConfig(**dataclasses.asdict(opt_cfg)),
        n_microbatches=2, accum_mode=accum_mode))
    step = make_train_step(cfg, opt_cfg, n_microbatches=2,
                           accum_mode=accum_mode)
    rng = np.random.default_rng(5)
    for _ in range(3):
        toks = rng.integers(1, cfg.vocab_size, (4, 32)).astype(np.int32)
        nb = {"tokens": toks, "labels": np.roll(toks, -1, 1),
              "loss_mask": np.ones((4, 32), np.float32)}
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in nb.items()})
        state, m = step(state, {k: torch.as_tensor(v) for k, v in nb.items()})
        assert float(m["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
        assert float(m["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)
        assert float(m["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                      rel=1e-4)
    got = convert.train_state_to_numpy(state)
    want = jax.device_get({"params": jstate.params, "opt": jstate.opt})
    assert got["step"].item() == int(jstate.step) == 3
    assert got["opt"]["step"].item() == 3
    for part in ("params", "opt"):
        for path, a in leaves(got[part]):
            w = _jflat(want[part], path)
            tol = 2e-5 if path[0] not in ("m", "v") else \
                1e-4 * float(np.abs(w).max())
            np.testing.assert_allclose(a, w, atol=tol, err_msg=str(path))


def test_train_state_converts_both_ways():
    jcfg = dataclasses.replace(jconfigs.get_smoke_config("qwen2.5-14b"),
                               remat="none")
    _, leaves_np = _jtrain_state(jcfg, 2)
    state = convert.train_state(leaves_np, "cpu")
    assert state.params["embed"].dtype == torch.bfloat16
    assert state.opt["master"]["embed"].dtype == torch.float32
    back = convert.train_state_to_numpy(state)
    for part in ("params", "opt"):
        for path, a in leaves(back[part]):
            w = np.asarray(_jflat(leaves_np[part], path)).astype(np.float32)
            np.testing.assert_array_equal(np.asarray(a, np.float32), w)


# ---------------------------------------------------------------------------
# restore_checkpoint
# ---------------------------------------------------------------------------


def _state(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn((8, 4), generator=g),
                       "b": torch.zeros(4),
                       "h": torch.randn((3,), generator=g).to(
                           torch.bfloat16)},
            "opt": {"m": torch.ones((8, 4)),
                    "step": torch.tensor(3, dtype=torch.int32)}}


def test_restore_round_trip_bit_exact(tmp_path):
    state = _state()
    C.save_checkpoint(str(tmp_path), 7, state, extra={"iterator": {"p": 5}})
    target = {"params": {k: torch.empty_like(v, device="meta")
                         for k, v in state["params"].items()},
              "opt": {k: torch.empty_like(v) for k, v in state["opt"].items()}}
    restored, extra = C.restore_checkpoint(str(tmp_path), target,
                                           device="cpu")
    assert extra == {"iterator": {"p": 5}}
    for (p1, a), (p2, b) in zip(leaves(state), leaves(restored)):
        assert p1 == p2 and a.dtype == b.dtype and b.device.type == "cpu"
        assert torch.equal(a, b)
    meta = json.loads((tmp_path / "step_00000007" / "manifest.json")
                      .read_text())
    assert meta["keys"]["params\x1fh"]["dtype"] == "bfloat16"


def test_restore_rejects_shape_mismatch_and_missing_key(tmp_path):
    C.save_checkpoint(str(tmp_path), 1, _state())
    bad = _state()
    bad["params"]["w"] = torch.zeros((4, 4))
    with pytest.raises(ValueError, match="shape mismatch"):
        C.restore_checkpoint(str(tmp_path), bad)
    extra = _state()
    extra["opt"]["v"] = torch.zeros(2)
    with pytest.raises(KeyError):
        C.restore_checkpoint(str(tmp_path), extra)


def test_restore_bf16_leaves_from_the_reference(tmp_path):
    """A bf16 leaf written by the reference (ml_dtypes, stored as V2)
    restores bit for bit."""
    vals = jnp.asarray([1.5, -2.25, 3.0e-3], jnp.bfloat16)
    jckpt.save_checkpoint(str(tmp_path), 1, {"x": vals})
    out, _ = C.restore_checkpoint(
        str(tmp_path), {"x": torch.zeros(3, dtype=torch.bfloat16)})
    want = np.asarray(vals).view(np.int16)
    np.testing.assert_array_equal(out["x"].view(torch.int16).numpy(), want)


def test_train_state_checkpoints_cross_load(tmp_path):
    """The reference's ``TrainState`` checkpoint restores into the port's
    and the port's into the reference's ``restore_checkpoint``, leaf for
    leaf (fp32 smoke model, after one step so no leaf is trivial)."""
    jcfg = dataclasses.replace(jconfigs.get_smoke_config("falcon-mamba-7b"),
                               param_dtype="float32",
                               compute_dtype="float32", remat="none")
    cfg = model_config.ModelConfig(**dataclasses.asdict(jcfg))
    jstate, leaves_np = _jtrain_state(jcfg, 4)
    jckpt.save_checkpoint(str(tmp_path / "ref"), 1, jstate)
    target = init_train_state(cfg, 0, "cpu")
    restored, _ = C.restore_checkpoint(str(tmp_path / "ref"), target)
    assert isinstance(restored, TrainState)
    got = convert.train_state_to_numpy(restored)
    for part in ("params", "opt"):
        for path, a in leaves(got[part]):
            np.testing.assert_array_equal(a, _jflat(leaves_np[part], path))
    step = make_train_step(cfg, OptimizerConfig(warmup_steps=0))
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        1, cfg.vocab_size, (2, 32)).astype(np.int32))
    state, _ = step(restored, {"tokens": toks, "labels": toks})
    C.save_checkpoint(str(tmp_path / "port"), 2, state)
    jtarget = jax.eval_shape(lambda: jloop.init_train_state(
        jax.random.PRNGKey(0), jcfg))
    back, _ = jckpt.restore_checkpoint(str(tmp_path / "port"), jtarget)
    mine = convert.train_state_to_numpy(state)
    for part, tree in (("params", back.params), ("opt", back.opt)):
        for path, a in leaves(mine[part]):
            np.testing.assert_array_equal(a, _jflat(tree, path))
    assert int(back.step) == 1


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

_COMMON = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
           "smoke", "--steps", "8", "--seq", "64", "--batch", "4",
           "--ckpt-every", "2", "--no-dedup", "--seed", "3", "--device",
           "cpu"]


def _run(args, **kw):
    env = dict(os.environ, PYTHONPATH=SRC)
    return subprocess.run(_COMMON + args, env=env, capture_output=True,
                          timeout=240, **kw)


def test_failure_injection_and_bit_exact_resume(tmp_path):
    """Kill training mid-run; the resumed run's final parameters, master,
    moments and losses equal an uninterrupted run's bit for bit."""
    ref = tmp_path / "ref.json"
    r = _run(["--ckpt-dir", str(tmp_path / "ref"), "--metrics-out", str(ref)])
    assert r.returncode == 0, r.stderr.decode()[-800:]
    crash = str(tmp_path / "crash")
    p = _run(["--ckpt-dir", crash, "--inject-failure-at", "5"])
    assert p.returncode == 42, p.stderr.decode()[-800:]
    assert b"dying at step 5" in p.stdout
    assert C.latest_step(crash) == 4
    res = tmp_path / "res.json"
    r = _run(["--ckpt-dir", crash, "--resume", "--metrics-out", str(res)])
    assert r.returncode == 0, r.stderr.decode()[-800:]
    assert b"resumed from step 4" in r.stdout
    want, got = json.loads(ref.read_text()), json.loads(res.read_text())
    assert got["final_loss"] == want["final_loss"]
    assert got["steps_run"] == 4 and want["steps_run"] == 8
    a, _, _ = C.restore_flat(str(tmp_path / "ref"))
    b, _, _ = C.restore_flat(crash)
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert any(line.startswith(b"RESULT ") for line in r.stdout.splitlines())
