"""The gloo ranks of ``tests/test_torch_dist_lm.py`` (pytest does not
collect this module, and it imports neither JAX nor the reference, so
that each spawned rank imports as little as it can).

``run`` is one rank of an 8-rank group. It reads the reference's inputs
(numpy, pickled by the parent), builds the (2, 4) data×model mesh, the
(4, 2) one and the (2, 2, 2) pod×data×model one in turn, runs every
check's port side on them and pickles its results for the parent, which
holds them to the reference's one-device results."""
import pickle
import time

import numpy as np
import torch

WORLD = 8


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _tree_np(tree: dict) -> dict:
    return {k: _tree_np(v) if isinstance(v, dict) else _np(v)
            for k, v in tree.items()}


def _batch(b: dict) -> dict:
    return {k: torch.as_tensor(v) for k, v in b.items()}


def _loss_and_grads(cfg, np_params: dict, np_batch: dict) -> dict:
    """``lm_loss`` and its gradients on this rank's rows, the parameters
    placed by the rules, the gradients reduced and gathered whole."""
    from repro_torch import convert, dist
    from repro_torch.models.decoder import (gather_params, lm_loss,
                                            place_params)
    from repro_torch.train.loop import reduce_gradients
    from repro_torch.utils import tree_leaves, tree_unflatten
    params = place_params(convert.lm_params(np_params, "cpu"), cfg)
    local = {k: dist.shard_batch(v) for k, v in _batch(np_batch).items()}
    paths, tensors = zip(*tree_leaves(params))
    for t in tensors:
        t.requires_grad_(True)
    loss = lm_loss(params, local, cfg)[0]
    flat = torch.autograd.grad(loss, tensors, allow_unused=True,
                               materialize_grads=True)
    grads = reduce_gradients(tree_unflatten(paths, flat), cfg)
    return {"loss": float(loss), "grads": _tree_np(gather_params(grads,
                                                                 cfg))}


def _moe_block(cfg, np_moe: dict, x: np.ndarray) -> dict:
    """``moe_block`` under expert parallelism: this rank's experts and
    rows; the output gathered over the batch axes."""
    from repro_torch import dist
    from repro_torch.models import layers as L
    moe = {k: dist.shard(torch.as_tensor(v), "model", None, None)
           if k in ("wg", "wu", "wd") else torch.as_tensor(v)
           for k, v in np_moe.items()}
    xs = dist.shard_batch(torch.as_tensor(x))
    y, aux = L.moe_block(moe, xs, cfg)
    return {"y": _np(dist.gather(y, (dist.batch_axes(), None, None))),
            "aux": float(aux), "expert_rows": moe["wg"].shape[0],
            "ep": L.expert_parallel(cfg)}


def _train(cfg, leaves: dict, batches: list, mode: str) -> dict:
    """Three ZeRO steps (``shard_grads_like_opt=True``, 2 microbatches)
    from the reference's state, each rank holding its blocks."""
    from repro_torch import convert
    from repro_torch.train.loop import (gather_train_state, make_train_step,
                                        shard_train_state)
    from repro_torch.train.optimizer import OptimizerConfig
    from repro_torch.utils import tree_leaves
    state = shard_train_state(convert.train_state(leaves, "cpu"), cfg)
    numels = {"/".join(p): t.numel() for part in ("master", "m", "v")
              for p, t in tree_leaves({part: state.opt[part]})}
    numels.update({"params/" + "/".join(p): t.numel()
                   for p, t in tree_leaves(state.params)})
    step = make_train_step(cfg, OptimizerConfig(
        warmup_steps=1, total_steps=10, accum_dtype="float32"),
        n_microbatches=2, accum_mode=mode, shard_grads_like_opt=True)
    metrics = []
    for b in batches:
        state, m = step(state, _batch(b))
        metrics.append({k: float(v) for k, v in m.items()})
    return {"metrics": metrics, "numels": numels,
            "state": convert.train_state_to_numpy(
                gather_train_state(state, cfg))}


def _compression(cfg, np_params: dict, np_batch: dict, mesh) -> dict:
    """``pod_compressed_value_and_grad`` with every pod all_gather's dtype
    recorded, and ``compressed_pod_mean`` of integer and 0-d leaves."""
    from repro_torch import convert, dist
    from repro_torch.models.decoder import (gather_params, lm_loss,
                                            place_params)
    from repro_torch.train import compression as C
    pod = mesh.group("pod")
    wire = []
    inner = dist._all_gather

    def record(out, inp, group=None, **kw):
        wire.append((str(inp.dtype), group is pod, tuple(inp.shape)))
        return inner(out, inp, group=group, **kw)

    with mesh, dist.manual_axes({"pod"}):
        params = place_params(convert.lm_params(np_params, "cpu"), cfg)
    f = C.pod_compressed_value_and_grad(
        lambda p, b: lm_loss(p, b, cfg)[0], mesh, cfg=cfg)
    dist._all_gather = record
    try:
        loss, grads = f(params, _batch(np_batch))
    finally:
        dist._all_gather = inner
    with mesh, dist.manual_axes({"pod"}):
        whole = _tree_np(gather_params(grads, cfg))
    c = mesh.coords["pod"]
    with mesh:
        ex = C.compressed_pod_mean({
            "i": torch.tensor([10 * c + 1, 20 * c + 2], dtype=torch.int32),
            "s": torch.tensor(3.0 + c),
            "f": torch.full((3,), 1.0 + c)})
    return {"loss": float(loss), "grads": whole, "wire": wire,
            "exempt": {k: _np(v) for k, v in ex.items()},
            "pod_coord": c}


def _checkpoints(ref_dir: str, out_dir: str, meshes) -> dict:
    """Save from the 2×4 mesh with P("data", "model"), restore into 4×2
    with P("model", "data"); restore the reference's checkpoint there."""
    from repro_torch import dist
    from repro_torch.train import checkpoint as C
    a, b = meshes
    whole = torch.arange(64.0).reshape(8, 8)
    with a:
        w = dist.shard(whole, "data", "model")
        C.save_checkpoint(out_dir, 1, {"w": w}, specs=("data", "model"))
    spec = ("model", "data")
    got, _ = C.restore_checkpoint(out_dir, {"w": torch.empty(8, 8)},
                                  mesh=b, specs=spec)
    ref, _ = C.restore_checkpoint(
        ref_dir, {"w": torch.empty(8, 8), "h": torch.empty(
            8, 4, dtype=torch.bfloat16)}, mesh=b, specs=spec)
    with b:
        back = _np(dist.gather(got["w"], spec))
    return {"block": _np(got["w"]), "whole": back,
            "coords": dict(b.coords), "ref_w": _np(ref["w"]),
            "ref_h": _np(ref["h"].float())}


def run(rank: int, init_method: str, in_path: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    from repro_torch import dist
    from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
    from repro_torch.models.config import ModelConfig
    with open(in_path, "rb") as f:
        inp = pickle.load(f)
    cfgs = {k: ModelConfig(**v) for k, v in inp["configs"].items()}
    t0 = time.perf_counter()
    dist.init_ranks("gloo", rank, WORLD, init_method)
    out: dict = {}
    try:
        make_production_mesh()
    except ValueError as e:
        out["production_error"] = str(e)
    mesh = make_host_mesh()
    out["mesh"] = (dict(mesh.shape), mesh.axis_names, dict(mesh.coords))
    with mesh:
        for layout in ("tp", "fsdp"):
            with dist.layout(layout):
                out["common", layout] = _loss_and_grads(
                    cfgs["common"], inp["common_params"], inp["common_batch"])
                out["moe_lm", layout] = _loss_and_grads(
                    cfgs["moe_lm"], inp["moe_lm_params"], inp["moe_lm_batch"])
        out["common_mask"] = _loss_and_grads(
            cfgs["common"], inp["common_params"], inp["mask_batch"])
        out["moe_block"] = _moe_block(cfgs["moe"], inp["moe_params"],
                                      inp["moe_x"])
        for mode in ("scan_grads", "grad_of_scan"):
            out["train", mode] = _train(cfgs["train"], inp["train_state"],
                                        inp["train_batches"], mode)
    mesh_b = make_host_mesh((4, 2))
    out["ckpt"] = _checkpoints(inp["ref_ckpt"], inp["ckpt_dir"],
                               (mesh, mesh_b))
    mesh3 = dist.LMMesh((2, 2, 2), ("pod", "data", "model"))
    out["compression"] = _compression(cfgs["compression"],
                                      inp["compression_params"],
                                      inp["compression_batch"], mesh3)
    out["seconds"] = time.perf_counter() - t0
    with open(f"{out_dir}/rank{rank}.pkl", "wb") as f:
        pickle.dump(out, f)
    torch.distributed.destroy_process_group()
