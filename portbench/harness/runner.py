"""One run of one cell, driven by data.

The cell's entry in ``BENCHMARK.json`` names its configuration (a file
of settings) and its traffic (``traffic/<name>.json``), whose ``mode``
names the module under ``modes/`` that runs it; the limits that decide
``correct`` are ``limits/<cell>.json``; each per-layer metric is read by
``metrics/<metric>.py``. A mode has three functions:

- ``setup(cfg, traffic, seed, device)`` → state: inputs from the seed,
  the warm-up of every shape the window uses;
- ``window(state, seconds, trace)`` → {"e2e": {metric: value} (a
  metric split by cell, ``<metric>.<part>``, reads ``<metric>``),
  "ctx": what the per-layer readers read};
- ``check(state)`` → {number: value}, once the window has closed and
  the program's state is freed: the program's outputs, kept as host
  rows, against the plain reference's. It may leave in
  ``state["bound_ms"]`` the least time of each kernel's launches in the
  traced stretch, counted from the reference's data;
- ``control(cfg, traffic, seed, device)`` → the same numbers with the
  reference's TF32 twin in the program's place (``harness/control.py``;
  the benchmark's runs never call it).

The state holds ``attempted`` and ``failed``: the answers due in the
window and those that never came.
"""
from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import pathlib
import sys
import time

HERE = pathlib.Path(__file__).resolve().parents[1]
BANNED = ("jax", "jaxlib", "flax", "repro")


def load_json(path: pathlib.Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def banned_modules() -> list[str]:
    """Loaded modules whose top-level name is one the benchmark may not
    load (the JAX package and JAX itself), compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(BANNED))


def set_gap(prog: set, ref: set) -> float:
    """Rows in one set and not the other, as a share of the reference's."""
    return len(prog ^ ref) / max(1, len(ref))


def reader(name: str):
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name}", HERE / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def per_layer(bench: dict, cell: dict) -> list[dict]:
    """The per-layer metrics this cell reports: those that list it, and
    those without a list whose end-to-end metric the cell reports."""
    mine = {m["name"] for m in bench["end_to_end"]
            if cell["name"] in m.get("workloads", [cell["name"]])}
    return [m for m in bench["per_layer"]
            if (cell["name"] in m["workloads"] if "workloads" in m
                else m["moves"] in mine)]


def e2e_value(e2e: dict, name: str) -> float:
    """The mode's reading of end-to-end metric ``name``; a metric split by
    cell (``archive_rate.search``) reads the mode's ``archive_rate``."""
    return e2e[name] if name in e2e else e2e[name.split(".")[0]]


def run(bench: dict, cell: dict, cfg: dict, traffic: dict, limits: dict,
        seed: int, seconds: float, trace: bool, device, t0: float,
        chips: int = 1) -> dict:
    """Set up, measure, check; returns the result line's object, with the
    compared numbers under ``limits`` (each [value, limit]), and what the
    check covered (calls compared, the reference's row counts)."""
    import torch
    mode = importlib.import_module(f"modes.{traffic['mode']}")
    state = mode.setup(cfg, traffic, seed, device)
    setup_s = time.perf_counter() - t0
    win = mode.window(state, seconds, trace)
    cuda = device.type == "cuda"
    device_info = {
        "platform": "gpu" if cuda else device.type,
        "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
        "count": chips,
        "memory_peak_bytes": (torch.cuda.max_memory_allocated(device)
                              if cuda else 0)}
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    numbers = mode.check(state)
    out: dict = {}
    if trace:
        ctx = {**win["ctx"], "bound_ms": {**win["ctx"].get("bound_ms", {}),
                                          **state.get("bound_ms", {})}}
        prof = ctx.get("trace")
        metrics = {}
        for m in per_layer(bench, cell):
            v = reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        if prof is not None:
            device_info["busy_s"] = prof.busy_s
            device_info["window_s"] = prof.window_s
            out["breakdown"] = {"device_ops": prof.device_ops(),
                                "idle_gaps": prof.idle_gaps()}
    else:
        metrics = {m["name"]: {"value": e2e_value(win["e2e"], m["name"]),
                               "unit": m["unit"]}
                   for m in bench["end_to_end"]
                   if cell["name"] in m.get("workloads", [cell["name"]])
                   and m["name"] != "setup_s"}
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}
    compared = {k: [v, limits[k]] for k, v in numbers.items()}
    correct = all(v <= lim for v, lim in compared.values())
    attempted, failed = state["attempted"], state["failed"]
    out = {"correct": correct and failed == 0, "attempted": attempted,
           "failed": failed, "metrics": metrics, "device": device_info,
           **out, "limits": compared}
    return out, state.get("checked", {})
