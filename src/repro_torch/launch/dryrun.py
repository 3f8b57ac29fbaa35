"""Multi-pod dry run: trace every (arch × shape × mesh) cell (the
counterpart of ``repro.launch.dryrun``).

The reference jits each cell's step (train_step / prefill / decode_step /
detect_step) with production shardings, lowers and compiles it for 512
virtual CPU devices and reads XLA's memory and cost analyses and the HLO.
Here one process plays rank 0 of the production mesh over a fake process
group of 256 ranks (512 with ``--mesh multi``) that performs no
collective: the rank's blocks of the state are ``meta`` tensors built
from the sharding rules, and its step runs once on them under
``hlo_stats.analyze_step``, which counts every aten op, the hand-written
kernels' work and every collective with its bytes, and tracks the step's
memory. Nothing is allocated and no kernel launches. The LM cells trace
at the archs' published widths (nothing cut); the detection cell traces
one rank's C / ranks chunks of ``detect_step_sharded`` (the chunks are
independent, so the global flops are a rank's × ranks).

``--layout fsdp`` traces the cells under the fsdp rules: training with
the model axis a batch axis, serving with each layer gathered whole at
use and the decode cache's rows over pod×data (``models.decoder``'s
``_Serving``), the reference's ``--layout fsdp``.

``--profile`` runs the cell's rank block for real on the card besides
(random values, the port's kernels, the collectives counted and not
performed: no other rank exists): one warm-up step, then one step under
``torch.profiler``, whose device time and ``max_memory_allocated`` the
record holds beside the trace's bound and peak. Only cells whose rank
block fits one card can do that.

The record keeps the reference's schema; ``compile_s`` is the trace's
seconds, ``xla_cost_raw`` the trace's totals (an eager trace folds no
loop, so they are the counted numbers), the two link keys are
``link_bytes_nvlink`` / ``link_bytes_network`` and ``--save-hlo`` writes a
gzipped table of the traced ops (``<cell>.ops.tsv.gz``).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch command-r-35b \\
      --shape train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --mesh both
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \\
      --shape prefill_32k,decode_32k,long_500k --mesh both --layout fsdp
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2.5-14b \\
      --shape train_4k --profile          # on the card
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import gzip
import json
import pathlib
import time
import traceback

import torch
import torch.distributed as tdist

from repro_torch import dist
from repro_torch.configs import ALL_ARCHS, get_config, get_module
from repro_torch.configs.shapes import LM_SHAPES, input_specs, shapes_for
from repro_torch.kernels import cost, ops
from repro_torch.launch import hlo_stats
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import ModelConfig, decode_step, init_cache, prefill
from repro_torch.models.decoder import param_shapes, param_sharding_rules
from repro_torch.train.loop import TrainState, make_train_step
from repro_torch.train.optimizer import (OptimizerConfig,
                                         opt_state_sharding_rules)


# ---------------------------------------------------------------------------
# the fake world and this rank's blocks
# ---------------------------------------------------------------------------


def fake_world(world_size: int, rank: int = 0) -> None:
    """A fake default process group of ``world_size`` ranks in which this
    process is ``rank`` (collectives are accepted and do nothing); an
    existing group of another size or rank is destroyed first."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if tdist.is_initialized():
        if (tdist.get_world_size(), tdist.get_rank()) == (world_size, rank):
            return
        tdist.destroy_process_group()
    tdist.init_process_group("fake", rank=rank, world_size=world_size,
                             store=FakeStore())


def _blocks(shapes, rules, dtype) -> dict:
    """This rank's block of every leaf of a shape tree under its rule
    (``sanitize_spec`` on the current mesh, then ``block_shape``), ``meta``
    tensors of ``dtype``."""
    if isinstance(shapes, tuple):
        spec = dist.sanitize_spec(shapes, rules)
        return torch.empty(dist.block_shape(shapes, spec), dtype=dtype,
                           device="meta")
    return {k: _blocks(shapes[k], rules[k], dtype) for k in shapes}


def _param_blocks(cfg: ModelConfig) -> dict:
    return _blocks(param_shapes(cfg), param_sharding_rules(cfg), cfg.pdtype)


def _state_blocks(cfg: ModelConfig) -> TrainState:
    """The rank's ``TrainState`` on ``meta``: parameters by
    ``param_sharding_rules``, the fp32 master and moments by
    ``opt_state_sharding_rules`` (ZeRO), the step counts 0-d int32."""
    shapes, p_rules = param_shapes(cfg), param_sharding_rules(cfg)
    o_rules = opt_state_sharding_rules(p_rules, shapes)
    step = lambda: torch.zeros((), dtype=torch.int32,  # noqa: E731
                               device="meta")
    return TrainState(
        params=_blocks(shapes, p_rules, cfg.pdtype),
        opt={**{k: _blocks(shapes, o_rules[k], torch.float32)
                for k in ("master", "m", "v")}, "step": step()},
        step=step())


def _materialize(tree, device, gen: torch.Generator, vocab: int = 2):
    """A tree of ``meta`` tensors as tensors on ``device``: floats N(0,
    0.02²) (0 for the moments), integers in [0, vocab), loss masks 1.
    Their values are not read: they only make the card do the work."""
    if isinstance(tree, torch.Tensor):
        if not tree.is_meta:
            return tree
        out = torch.empty(tree.shape, dtype=tree.dtype, device=device)
        if out.dtype.is_floating_point:
            out.normal_(0.0, 0.02, generator=gen)
        else:
            out.random_(0, vocab, generator=gen)
        if hasattr(tree, "seq_len"):        # a KV cache's global length
            out.seq_len = tree.seq_len
        return out
    if isinstance(tree, TrainState):
        return TrainState(_materialize(tree.params, device, gen),
                          {k: _materialize(v, device, gen)
                           for k, v in tree.opt.items()},
                          _materialize(tree.step, device, gen))
    if isinstance(tree, dict):
        return {k: (torch.ones(v.shape, dtype=v.dtype, device=device)
                    if k == "loss_mask" else
                    _materialize(v, device, gen, vocab))
                for k, v in tree.items()}
    return tree


@dataclasses.dataclass
class Lowered:
    """A cell's step and its arguments on this rank (``jax.stages.Lowered``'s
    counterpart): ``fn(*args)`` under ``mesh`` is one step."""

    fn: object
    args: tuple
    mesh: dist.LMMesh

    def analyze(self, pod_boundary: int | None = None
                ) -> hlo_stats.StepStats:
        with self.mesh:
            return hlo_stats.analyze_step(self.fn, *self.args,
                                          pod_boundary=pod_boundary)

    def run(self):
        with self.mesh:
            return self.fn(*self.args)


def pick_microbatches(cfg: ModelConfig, global_batch: int, dp: int) -> int:
    """1 sequence per device per microbatch for ≥4B-param models."""
    local = global_batch // dp
    if cfg.param_count() >= 4e9:
        return local
    if cfg.param_count() >= 1e9:
        return max(1, local // 4)
    return max(1, local // 8)


# ---------------------------------------------------------------------------
# per-cell lowering
# ---------------------------------------------------------------------------


def lower_lm_cell(arch: str, shape_name: str, mesh, attn_impl: str,
                  microbatches: int | None = None,
                  accum_mode: str = "scan_grads",
                  shard_grads: bool = False,
                  cfg_overrides: dict | None = None, device="meta"):
    """→ (``Lowered``, cfg, ShapeSpec, extra): the cell's step on this
    rank's blocks of ``mesh`` (``meta`` unless ``device`` names another,
    and then random values there). Train: ``make_train_step`` on the
    rank's ``TrainState`` and the global batch; prefill: ``prefill`` on
    the rank's parameter blocks and the global batch; decode:
    ``decode_step`` on them, the rank's cache blocks
    (``cache_sharding_rules``) and the global tokens."""
    cfg = get_config(arch)
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    spec = LM_SHAPES[shape_name]
    meta = torch.device(device).type == "meta"
    gen = None if meta else torch.Generator(device=device).manual_seed(0)
    put = (lambda t: t) if meta else functools.partial(  # noqa: E731
        _materialize, device=device, gen=gen, vocab=cfg.vocab_size)
    with mesh:
        dp = dist.dp_size()
        if spec.kind == "train":
            n_mb = microbatches or pick_microbatches(cfg, spec.global_batch,
                                                     dp)
            state = put(_state_blocks(cfg))
            batch = put(input_specs(cfg, shape_name))
            step = make_train_step(cfg, OptimizerConfig(),
                                   n_microbatches=n_mb, attn_impl=attn_impl,
                                   accum_mode=accum_mode,
                                   shard_grads_like_opt=shard_grads)
            return (Lowered(step, (state, batch), mesh), cfg, spec,
                    {"microbatches": n_mb})
        params = put(_param_blocks(cfg))
        if spec.kind == "prefill":
            batch = put(input_specs(cfg, shape_name))
            return (Lowered(functools.partial(prefill, cfg=cfg),
                            (params, batch), mesh), cfg, spec, {})
        b, s = spec.global_batch, spec.seq_len
        cache = put(init_cache(cfg, b, s, device="meta"))
        tokens = put(input_specs(cfg, shape_name)["tokens"])
        return (Lowered(functools.partial(decode_step, cfg=cfg),
                        (params, cache, tokens), mesh), cfg, spec, {})


def lower_detect_cell(shape_name: str, mesh, use_shard_map: bool = True,
                      occ_limit: int = 0, device="meta"):
    """→ (``Lowered``, cfg): this rank's C / ranks chunks of
    ``fast_seismic.input_specs(shape_name)`` through
    ``detect_step_sharded`` on a one-device station mesh (``meta`` unless
    ``device`` names another), its in-step index sized like the
    paper-scale streaming config; ``occ_limit`` > 0 turns the in-dispatch
    occurrence limiter on. ``use_shard_map=False`` runs ``detect_step``
    chunk by chunk instead (the reference's vmap baseline). The Min-Max
    kernel counts ``top_k`` set bits a fingerprint."""
    from repro_torch.configs import fast_seismic as fs
    from repro_torch.core.detect import detect_step, detect_step_sharded
    from repro_torch.stream.index import StreamIndexConfig
    dcfg = fs.config()
    specs = fs.input_specs(shape_name)
    rows = specs["waveforms"].shape[0] // mesh.size(tuple(mesh.shape))
    chunk = specs["waveforms"].shape[1]
    n_chunk_fp = dcfg.fingerprint.n_fingerprints(chunk)
    icfg = StreamIndexConfig(
        n_buckets=16384, bucket_cap=dcfg.lsh.bucket_cap,
        occ_slots=n_chunk_fp if occ_limit > 0 else 0)
    knobs = dict(icfg=icfg, occ_limit=occ_limit)
    dev = torch.device(device)
    wave = torch.empty((rows, chunk), dtype=torch.float32, device=dev)
    med = torch.zeros(specs["med"].shape, dtype=torch.float32, device=dev)
    mad = torch.ones(specs["mad"].shape, dtype=torch.float32, device=dev)
    if dev.type != "meta":
        wave.normal_(generator=torch.Generator(device=dev).manual_seed(0))
    one = dist.StationMesh((dev,))
    top_k = dcfg.fingerprint.top_k

    def step(w, m, a):
        with cost.set_bits_per_row(top_k), _masks_full(dev):
            if use_shard_map:
                return detect_step_sharded(w, m, a, dcfg, one, **knobs)
            outs = [detect_step(x, m, a, dcfg, **knobs) for x in w]
            return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}

    return Lowered(step, (wave, med, mad), mesh), dcfg


def _masks_full(dev: torch.device):
    """On ``meta``, a boolean mask's selection (``x[mask]``, ``nonzero``)
    keeps every entry: the index compacts its candidates by masks, whose
    sizes the values decide, so the trace counts the most the step can do
    (the reference's fixed-shape step does that work whatever the data)."""
    if dev.type != "meta":
        return contextlib.nullcontext()
    import torch.fx.experimental._config as fx_config
    return fx_config.patch(meta_nonzero_assume_all_nonzero=True)


# ---------------------------------------------------------------------------
# model-flops accounting (MFU numerator)
# ---------------------------------------------------------------------------


def model_flops(cfg, spec_kind: str, global_batch: int, seq: int) -> float:
    if not isinstance(cfg, ModelConfig):
        return 0.0
    n_active = cfg.active_param_count()
    tokens = global_batch * (seq if spec_kind in ("train", "prefill") else 1)
    mult = 6.0 if spec_kind == "train" else 2.0
    return mult * n_active * tokens


# ---------------------------------------------------------------------------
# the command line
# ---------------------------------------------------------------------------


def _profile(lowered: Lowered, record: dict) -> dict:
    """One warm-up step and one profiled step of ``lowered`` on the card,
    held to the trace in ``record``: the device time against the trace's
    bound without the collectives (compute and memory: no collective is
    performed), each of the port's kernels' device time against the sum
    of its calls' bounds, ``max_memory_allocated`` against the trace's
    peak (arguments + temporaries), and the step's kernel launches."""
    from torch.profiler import ProfilerActivity, profile
    lowered.run()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        lowered.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    out = hlo_stats.extract_cost(prof, torch.cuda.max_memory_allocated())
    mem, rf = record["memory"], record["roofline"]
    traced_peak = mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
    bound = max(rf["compute_s"], rf["memory_s"])
    out["port_kernel_bound_ms"] = {k: v["bound_ms"]
                                   for k, v in record["kernels"].items()}
    out.update({
        "wall_s": wall, "launches": {k: v for k, v in ops.LAUNCHES.items()
                                     if v},
        "bound_without_collectives_s": bound,
        "device_time_over_bound": out["device_time_s"] / bound
        if bound else None,
        "traced_peak_bytes": traced_peak,
        "peak_over_traced": out["max_memory_allocated"] / traced_peak
        if traced_peak else None})
    return out


# the record's keys that the trace fills
_TRACED = ("memory", "xla_cost_raw", "collectives", "roofline",
           "dot_flops_per_device", "kernels")


def _traced(stats: hlo_stats.StepStats, n_dev: int, mf: float) -> dict:
    return {
        "memory": hlo_stats.extract_memory(stats),
        "xla_cost_raw": {"flops": stats.flops, "bytes_accessed": stats.bytes,
                         "transcendentals": stats.transcendentals},
        "collectives": {"counts": stats.coll_counts,
                        "bytes_by_kind": stats.coll_bytes,
                        "link_bytes_nvlink": stats.link_bytes_nvlink,
                        "link_bytes_network": stats.link_bytes_network},
        "roofline": hlo_stats.roofline_terms(stats, n_dev, mf),
        "dot_flops_per_device": stats.dot_flops,
        "kernels": stats.kernels}


def _ops_table(stats: hlo_stats.StepStats) -> str:
    lines = ["op\tcalls\tflops\tbytes"]
    lines += [f"{k}\t{c}\t{f:.6g}\t{b:.6g}"
              for k, (c, f, b) in stats.ops.items()]
    lines += [f"kernel:{k}\t{v['calls']}\t{v['flops']:.6g}\t{v['bytes']:.6g}"
              for k, v in stats.kernels.items()]
    return "\n".join(lines) + "\n"


def run_cell(arch: str, shape_name: str, mesh_kind: str, out_dir: str,
             attn_impl: str = "masked", save_hlo: bool = False,
             microbatches: int | None = None, tag: str = "",
             accum_mode: str = "scan_grads", shard_grads: bool = False,
             cfg_overrides: dict | None = None,
             uneven: bool = False, layout: str = "tp",
             profile: bool = False, reuse_trace: bool = False) -> dict:
    multi = mesh_kind == "multi"
    n_dev = 512 if multi else 256
    fake_world(n_dev)
    mesh = make_production_mesh(multi_pod=multi)
    pod_boundary = (n_dev // mesh.shape["pod"]) if multi else None
    t0 = time.perf_counter()
    record: dict = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
                    "devices": n_dev, "attn_impl": attn_impl, "tag": tag,
                    "accum_mode": accum_mode, "shard_grads": shard_grads,
                    "uneven": uneven, "cfg_overrides": cfg_overrides or {},
                    "layout": layout, "rank": tdist.get_rank()}
    uneven_ctx = (dist.allow_uneven_sharding() if uneven
                  else contextlib.nullcontext())
    try:
        with dist.layout(layout), uneven_ctx:
            if arch == "fast_seismic":
                fs = get_module(arch)
                lower = functools.partial(
                    lower_detect_cell, shape_name, mesh,
                    use_shard_map=(cfg_overrides or {}).get(
                        "shard_map", 1) == 1)
                lowered, _ = lower()
                mf = fs.model_flops(shape_name)
                record["kind"] = "detect"
            else:
                lower = functools.partial(
                    lower_lm_cell, arch, shape_name, mesh, attn_impl,
                    microbatches, accum_mode=accum_mode,
                    shard_grads=shard_grads, cfg_overrides=cfg_overrides)
                lowered, cfg, spec, extra = lower()
                mf = model_flops(cfg, spec.kind, spec.global_batch,
                                 spec.seq_len)
                record["kind"] = spec.kind
                record.update(extra)
            if record["kind"] == "detect":
                record["masks"] = "full: every entry of a boolean mask kept"
            old = pathlib.Path(out_dir) / f"{_cell_name(record)}.json"
            old = json.loads(old.read_text()) if reuse_trace \
                and old.exists() else {}
            t1 = time.perf_counter()
            if old.get("status") == "ok":
                stats = None
                record.update({k: old[k] for k in _TRACED})
            else:
                stats = lowered.analyze(pod_boundary)
                record.update(_traced(stats, n_dev, mf))
            t2 = time.perf_counter()
            record["lower_s"] = round(t1 - t0, 2)
            record["compile_s"] = round(t2 - t1, 2) if stats is not None \
                else old["compile_s"]
            if profile:
                del lowered
                dev = torch.device("cuda", torch.cuda.current_device())
                real = lower(device=dev)[0]
                record["profile"] = _profile(real, record)
                del real
        record["status"] = "ok"
        if save_hlo and stats is not None:
            hp = pathlib.Path(out_dir) / f"{_cell_name(record)}.ops.tsv.gz"
            hp.parent.mkdir(parents=True, exist_ok=True)
            with gzip.open(hp, "wt") as f:
                f.write(_ops_table(stats))
        print(f"--- {arch} × {shape_name} × {mesh_kind} ---")
        print("memory_analysis:", json.dumps(record["memory"]))
        print("cost_analysis(raw):", json.dumps(record["xla_cost_raw"]))
        print("collectives:", json.dumps(record["collectives"]["counts"]))
        rf = record["roofline"]
        print(f"roofline: compute={rf['compute_s']:.4f}s "
              f"memory={rf['memory_s']:.4f}s "
              f"collective={rf['collective_s']:.4f}s "
              f"dominant={rf['dominant']} "
              f"useful_ratio={rf['useful_flops_ratio']:.3f}")
        if profile:
            print("profile:", json.dumps(record["profile"]))
    except Exception as e:
        record["status"] = "fail"
        record["error"] = f"{type(e).__name__}: {e}"
        record["traceback"] = traceback.format_exc()[-4000:]
        print(f"--- {arch} × {shape_name} × {mesh_kind} FAILED: "
              f"{record['error']}")
    out = pathlib.Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    (out / f"{_cell_name(record)}.json").write_text(
        json.dumps(record, indent=1, default=str))
    return record


def _cell_name(record: dict) -> str:
    tag = f"__{record['tag']}" if record.get("tag") else ""
    return (f"{record['arch']}__{record['shape']}__{record['mesh']}"
            f"{tag}".replace("/", "_").replace(".", "p"))


def iter_cells(archs, shapes_arg, meshes):
    """The (arch, shape, mesh) cells: ``["all"]`` takes each arch's own
    shapes (the detection module's, an LM's ``shapes_for``); a list of
    names takes those its kind defines (``LM_SHAPES`` for an LM, the
    detection module's ``SHAPES``), so ``--arch all --shape
    prefill_32k`` pairs no LM shape with the detection cell (the
    reference lists such a pair and fails it on a KeyError)."""
    for arch in archs:
        if arch == "fast_seismic":
            known = list(get_module(arch).SHAPES)
            names = known if shapes_arg == ["all"] else [
                s for s in shapes_arg if s in known]
        else:
            cfg = get_config(arch)
            names = shapes_for(cfg) if shapes_arg == ["all"] else [
                s for s in shapes_arg if s in LM_SHAPES]
        for shp in names:
            for mk in meshes:
                yield arch, shp, mk


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all",
                    help="arch id, comma list, or 'all'")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="artifacts/dryrun_torch")
    ap.add_argument("--attn-impl", default="masked",
                    choices=["masked", "triangular"])
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--save-hlo", action="store_true",
                    help="also write a gzipped table of the traced ops")
    ap.add_argument("--tag", default="")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--skip-existing", action="store_true",
                    help="skip cells whose ok-status JSON already exists")
    ap.add_argument("--accum-mode", default="scan_grads",
                    choices=["scan_grads", "grad_of_scan"])
    ap.add_argument("--shard-grads", action="store_true")
    ap.add_argument("--cfg-override", default="",
                    help="comma k=v model-config overrides (ints/floats/str)")
    ap.add_argument("--uneven-sharding", action="store_true",
                    help="allow non-divisible dims to shard (uneven blocks)")
    ap.add_argument("--layout", default="tp", choices=["tp", "fsdp"])
    ap.add_argument("--profile", action="store_true",
                    help="also run each cell's rank block on the card")
    ap.add_argument("--reuse-trace", action="store_true",
                    help="with --profile: take the traced numbers from the "
                         "cell's ok record in --out instead of tracing")
    args = ap.parse_args(argv)

    archs = ALL_ARCHS if args.arch == "all" else args.arch.split(",")
    shapes = ["all"] if args.shape == "all" else args.shape.split(",")
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    cells = list(iter_cells(archs, shapes, meshes))
    if args.list:
        for c in cells:
            print(*c)
        return

    failures = 0
    for arch, shp, mk in cells:
        if args.skip_existing:
            name = _cell_name({"arch": arch, "shape": shp, "mesh": mk,
                               "tag": args.tag})
            p = pathlib.Path(args.out) / f"{name}.json"
            if p.exists() and json.loads(p.read_text()).get("status") \
                    == "ok":
                print(f"skip {arch} × {shp} × {mk} (exists)")
                continue
        overrides = {}
        for kv in args.cfg_override.split(","):
            if not kv:
                continue
            k, v = kv.split("=")
            try:
                v = int(v)
            except ValueError:
                try:
                    v = float(v)
                except ValueError:
                    pass
            overrides[k] = v
        rec = run_cell(arch, shp, mk, args.out, attn_impl=args.attn_impl,
                       save_hlo=args.save_hlo,
                       microbatches=args.microbatches, tag=args.tag,
                       accum_mode=args.accum_mode,
                       shard_grads=args.shard_grads,
                       cfg_overrides=overrides or None,
                       uneven=args.uneven_sharding, layout=args.layout,
                       profile=args.profile, reuse_trace=args.reuse_trace)
        failures += rec["status"] != "ok"
    print(f"\n{len(cells) - failures}/{len(cells)} cells OK")
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
