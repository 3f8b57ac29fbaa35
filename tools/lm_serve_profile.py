#!/usr/bin/env python3
"""Where an LM serve run's time goes on the card, per architecture.

    python3 tools/lm_serve_profile.py [arch ...]     (default: every LM arch)

Each arch at ``chip_smoke.py`` phase 15's widths (``LM_SERVE_MODELS``:
n_layers cut to 4 but for zamba2-1.2b and internvl2-1b), bf16 parameters
from ``init_params`` (seed 0), ``ServeEngine(n_slots=4, max_len=2560)``
with its four slots filled by 2048-token prompts. After a warm-up, one
2048-token prefill and then 8 decode ticks run under ``torch.profiler``:
for each, the wall per call, the device's busy time (the union of its
kernels' spans) and idle share, and the device operations per call (a
decode tick that launches many small kernels from Python is paced by the
host). For the MoE archs, each layer's routing at the profiled prefill:
the busiest expert's load over the mean, the experts past capacity and
the share of routed (token, slot) pairs that capacity dropped.

Prints one JSON line per arch and writes them to
``chiprun_out/lm_serve_profile.json``; needs a CUDA card.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke  # noqa: E402

PROMPT = 2048
TICKS = 8


def _moe_load(routes, cfg) -> list[dict]:
    """Per MoE layer of one prefill: busiest expert / mean load, experts
    past capacity, dropped share of the routed pairs."""
    import torch
    from repro_torch.models import layers as L
    out = []
    for ids in routes:
        flat = ids.reshape(-1)
        load = torch.bincount(flat, minlength=cfg.n_experts).float()
        cap = L._capacity(ids.shape[0], cfg)
        rank = L._rank_within_expert(flat, cfg.n_experts)
        out.append({"max_over_mean": float(load.max() / load.mean()),
                    "experts_over_capacity": int((load > cap).sum()),
                    "capacity": cap,
                    "dropped_share": float((rank >= cap).float().mean())})
    return out


def profile_arch(arch: str, cut: bool, dev) -> dict:
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import Request, ServeEngine
    from repro_torch.models import decode_step, init_params, prefill
    full = get_config(arch)
    cfg = dataclasses.replace(full, n_layers=chip_smoke.LM_SERVE_LAYERS) \
        if cut else full
    params = init_params(cfg, 0, dev)
    eng = ServeEngine(cfg, n_slots=4, max_len=2560, params=params)
    rng = np.random.default_rng(0)
    for slot in range(eng.n_slots):
        eng._prefill_slot(slot, Request(slot, rng.integers(
            1, cfg.vocab_size, PROMPT).astype(np.int32), TICKS))
    toks = torch.as_tensor(rng.integers(1, cfg.vocab_size, (1, PROMPT)),
                           dtype=torch.int32, device=dev)
    nxt = torch.as_tensor(eng.cur_tokens, device=dev)
    prefill(params, {"tokens": toks}, eng.cfg)              # warm-up
    decode_step(params, eng.cache, nxt, eng.cfg)
    torch.cuda.synchronize()
    out = {"arch": arch, "n_layers": cfg.n_layers, "prompt": PROMPT,
           "ticks": TICKS}
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with chip_smoke._RecordRoutes() as routes:
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            prefill(params, {"tokens": toks}, eng.cfg)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    out["prefill"] = chip_smoke._device_breakdown(
        prof, wall, f"lm_prefill_{arch}.txt")
    if cfg.is_moe:
        out["moe_layers"] = _moe_load(routes, cfg)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(TICKS):
            logits, eng.cache = decode_step(params, eng.cache, nxt, eng.cfg)
            nxt = torch.argmax(logits, dim=-1, keepdim=True).int()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    out["decode"] = chip_smoke._device_breakdown(
        prof, wall, f"lm_decode_{arch}.txt")
    out["decode"]["ms_per_tick"] = wall / TICKS * 1e3
    out["decode"]["device_ops_per_tick"] = out["decode"]["device_ops"] / TICKS
    return out


def main(argv: list[str]) -> int:
    import torch
    if not torch.cuda.is_available():
        print("lm_serve_profile: CUDA is not available", file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    models = dict(chip_smoke.LM_SERVE_MODELS)
    rows = []
    for arch in argv or list(models):
        torch.cuda.empty_cache()
        row = profile_arch(arch, models[arch], dev)
        print("lm_serve_profile", json.dumps(row), flush=True)
        rows.append(row)
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "lm_serve_profile.json").write_text(
        json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
