"""The gloo ranks of ``tests/test_torch_dist_tp.py`` (pytest does not
collect this module, and it imports neither JAX nor the reference).

``run`` is one rank of an 8-rank group on the (2, 4) data×model mesh
under the tp layout. It reads the reference's inputs (numpy, pickled by
the parent) and runs the port's side of every check: serving (``prefill``
and ``decode_step`` with the cache in this rank's blocks), the
tensor-parallel loss and gradients, the collective and kernel counts of
the split, and the uneven heads; then serving again under the fsdp
layout, and the ragged prompts' serving under ``allow_uneven_sharding``
(the cache's sequence in blocks of ⌈10 / 4⌉). It pickles its results for
the parent, which holds them to the reference's one-device results."""
import dataclasses
import pickle
import time

import numpy as np
import torch

WORLD = 8
MESH = (2, 4)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def _tree_np(tree: dict) -> dict:
    return {k: _tree_np(v) if isinstance(v, dict) else _np(v)
            for k, v in tree.items()}


def _slices(shape, spec, mesh) -> list:
    """[lo, hi) of each dim of this rank's block of a cache leaf of
    global ``shape`` under its sanitized ``spec``."""
    from repro_torch import dist
    return [(0, int(n)) if spec is None or spec[d] is None else
            dist.block_range(int(n), mesh.size(spec[d]),
                             mesh.coord(spec[d]))
            for d, n in enumerate(shape)]


def _serve(cfg, np_params: dict, case: dict, mesh) -> dict:
    """``prefill`` of the case's prompts then its decode steps, or (with
    ``init``) decode steps from a zero cache of ``max_len`` whose
    positions start at ``pos0``: every step's whole logits, and this
    rank's cache blocks with their place in the whole cache."""
    from repro_torch import convert
    from repro_torch.models import decoder as D
    params = D.place_params(convert.lm_params(np_params, "cpu"), cfg)
    logits = []
    if "init" in case:
        max_len, pos0 = case["init"]
        cache = D.init_cache(cfg, len(pos0), max_len, "cpu")
        cache["pos"].copy_(torch.as_tensor(pos0, dtype=torch.int32))
    else:
        lg, cache = D.prefill(params, {"tokens": torch.as_tensor(
            case["tokens"])}, cfg)
        logits.append(_np(lg))
    for t in case["steps"]:
        lg, cache = D.decode_step(params, cache, torch.as_tensor(t), cfg)
        logits.append(_np(lg))
    b, n = cache["pos"].shape[0], D._cache_len(cache)
    specs = D.cache_specs(cfg, b, n)
    shapes = D._cache_shapes(cfg, b, n)
    blocks = {k: (_np(v) if v.is_floating_point() else v.numpy(),
                  _slices(shapes[k][0], specs[k], mesh), specs[k])
              for k, v in cache.items()}
    for k, (block, cut, _) in blocks.items():
        assert block.shape == tuple(hi - lo for lo, hi in cut), k
    return {"logits": logits, "cache": blocks}


def _loss_and_grads(cfg, np_params: dict, np_batch: dict) -> dict:
    """``lm_loss`` and its reduced gradients, gathered whole."""
    from repro_torch import convert, dist
    from repro_torch.models.decoder import (gather_params, lm_loss,
                                            place_params)
    from repro_torch.train.loop import reduce_gradients
    from repro_torch.utils import tree_leaves, tree_unflatten
    params = place_params(convert.lm_params(np_params, "cpu"), cfg)
    local = {k: dist.shard_batch(torch.as_tensor(v))
             for k, v in np_batch.items()}
    paths, tensors = zip(*tree_leaves(params))
    for t in tensors:
        t.requires_grad_(True)
    dist.reset_collectives()
    loss = lm_loss(params, local, cfg)[0]
    flat = torch.autograd.grad(loss, tensors, allow_unused=True,
                               materialize_grads=True)
    collectives = dict(dist.COLLECTIVES)
    grads = reduce_gradients(tree_unflatten(paths, flat), cfg)
    return {"loss": float(loss), "collectives": collectives,
            "grads": _tree_np(gather_params(grads, cfg))}


class _Record:
    """Counts ``TensorParallel.sum`` ("g") calls and records the heads /
    channels ``flash_attention`` and ``mamba_scan`` receive."""

    def __enter__(self):
        from repro_torch import dist
        from repro_torch.kernels import ops
        self.g, self.heads, self.channels = 0, [], []
        self._saved = (dist.TensorParallel.sum, ops.flash_attention,
                       ops.mamba_scan)
        sum_, fa, ms = self._saved

        def count_sum(tp, x):
            self.g += tp.mesh is not None
            return sum_(tp, x)

        def record_fa(q, k, v, causal=True):
            self.heads.append((q.shape[1], k.shape[1]))
            return fa(q, k, v, causal)

        def record_ms(xdt, *args):
            self.channels.append(xdt.shape[2])
            return ms(xdt, *args)

        dist.TensorParallel.sum = count_sum
        ops.flash_attention, ops.mamba_scan = record_fa, record_ms
        return self

    def __exit__(self, *exc):
        from repro_torch import dist
        from repro_torch.kernels import ops
        dist.TensorParallel.sum, ops.flash_attention, ops.mamba_scan = \
            self._saved


def _split(cfg, np_params: dict, x: np.ndarray) -> dict:
    """One forward and backward of each block of layer 0 on this rank's
    rows: the "g" calls, the collectives by kind, the heads and channels
    the kernels receive."""
    from repro_torch import convert, dist
    from repro_torch.models import decoder as D
    from repro_torch.models import layers as L
    from repro_torch.models import ssm as S
    params = D.place_params(convert.lm_params(np_params, "cpu"), cfg)
    lp = D._layer(params["layers"], 0)
    xs = dist.shard_batch(torch.as_tensor(x)).requires_grad_(True)
    pos = torch.arange(xs.shape[1])
    blocks = {}
    if cfg.block_kind == "mamba1":
        blocks["mamba1"] = lambda: S.mamba1_block(lp["ssm"], xs, cfg)
    elif cfg.parallel_block:
        blocks["parallel"] = lambda: L.parallel_attn_mlp_block(
            lp["attn"], lp["mlp"], xs, cfg, pos)
    else:
        blocks["attention"] = lambda: L.attention_block(lp["attn"], xs, cfg,
                                                        pos)
        blocks["mlp"] = lambda: L.mlp_block(lp["mlp"], xs, cfg)
    out = {}
    for name, fn in blocks.items():
        leaves = [t.requires_grad_(True) for t in
                  (lp["ssm"] if name == "mamba1" else
                   {**lp["attn"], **lp.get("mlp", {})}).values()]
        dist.reset_collectives()
        with _Record() as rec:
            y = fn()
            torch.autograd.grad(y.square().sum(), [xs, *leaves],
                                allow_unused=True)
        out[name] = {"g": rec.g, "heads": rec.heads,
                     "channels": rec.channels,
                     "collectives": dict(dist.COLLECTIVES)}
    return out


def run(rank: int, init_method: str, in_path: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    from repro_torch import dist
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.config import ModelConfig
    with open(in_path, "rb") as f:
        inp = pickle.load(f)
    cfgs = {k: ModelConfig(**v) for k, v in inp["configs"].items()}
    t0 = time.perf_counter()
    dist.init_ranks("gloo", rank, WORLD, init_method)
    mesh = make_host_mesh(MESH)
    out: dict = {"coords": dict(mesh.coords)}
    with mesh:
        for arch, cases in inp["serve"].items():
            for label, case in cases.items():
                for uniform in (True, False):
                    cfg = dataclasses.replace(cfgs[arch],
                                              uniform_decode_pos=uniform)
                    out["serve", arch, label, uniform] = _serve(
                        cfg, inp["params"][arch], case, mesh)
        for arch in inp["train"]:
            out["train", arch] = _loss_and_grads(
                cfgs[arch], inp["params"][arch], inp["batches"][arch])
        for arch, x in inp["split"].items():
            out["split", arch] = _split(cfgs[arch], inp["params"][arch], x)
        with dist.allow_uneven_sharding():
            arch = "uneven"
            out["train", arch] = _loss_and_grads(
                cfgs[arch], inp["params"][arch], inp["batches"][arch])
            for label, case in inp["uneven_serve"].items():
                out["serve", arch, label, True] = _serve(
                    cfgs[arch], inp["params"][arch], case, mesh)
            for arch in inp["uneven_cache"]:
                for uniform in (True, False):
                    cfg = dataclasses.replace(cfgs[arch],
                                              uniform_decode_pos=uniform)
                    out["uneven_cache", arch, "ragged", uniform] = _serve(
                        cfg, inp["params"][arch],
                        inp["serve"][arch]["ragged"], mesh)
            for uniform in (True, False):
                arch = "qwen2.5-14b"
                cfg = dataclasses.replace(cfgs[arch],
                                          uniform_decode_pos=uniform)
                out["uneven_cache", arch, "short", uniform] = _serve(
                    cfg, inp["params"][arch], inp["uneven_short"], mesh)
        with dist.layout("fsdp"):
            for arch, cases in inp["serve"].items():
                for label, case in cases.items():
                    for uniform in (True, False):
                        cfg = dataclasses.replace(
                            cfgs[arch], uniform_decode_pos=uniform)
                        out["fsdp", arch, label, uniform] = _serve(
                            cfg, inp["params"][arch], case, mesh)
    out["seconds"] = time.perf_counter() - t0
    with open(f"{out_dir}/rank{rank}.pkl", "wb") as f:
        pickle.dump(out, f)
    torch.distributed.destroy_process_group()
