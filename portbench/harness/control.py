"""The control of ``correct``: the plain reference in the program's place,
computed one precision below the configuration's (float32 products in
TF32 on the card), held to the reference at full precision by the cell's
own comparison, at the cell's own size on the seed's sampled partition.
Its numbers must pass their limits; the benchmark's runs never run it.

    python3 portbench/harness/control.py --workload archive-search \\
        --seeds 1 2 3

prints one JSON line a seed with its numbers beside the cell's limits.
"""
from __future__ import annotations

import argparse
import importlib
import json
import pathlib
import sys

HERE = pathlib.Path(__file__).resolve().parents[1]


def readings(bench: dict, name: str, seed: int, device) -> dict:
    """The control's numbers for cell ``name`` on ``seed``: its mode's
    ``control``, the cell's comparison with the reference's TF32 twin in
    the program's place."""
    from harness import runner
    cell = {w["name"]: w for w in bench["workloads"]}[name]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    cfg = runner.load_json(HERE.parent / conf["file"])
    traffic = runner.load_json(HERE / "traffic" / f"{cell['traffic']}.json")
    drv = importlib.import_module(f"modes.{traffic['mode']}")
    return drv.control(cfg, traffic, seed, device)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args()
    sys.path[:0] = [str(HERE), str(HERE.parent / "src")]
    import torch
    from harness import runner
    if not torch.cuda.is_available():
        print("error: the control needs a CUDA card (TF32)", file=sys.stderr)
        return 2
    bench = runner.load_json(HERE.parent / "BENCHMARK.json")
    limits = runner.load_json(HERE / "limits" / f"{args.workload}.json")
    for seed in args.seeds:
        got = readings(bench, args.workload, seed, torch.device("cuda"))
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": got, "limits": limits,
                          "fails": any(got[k] > limits[k] for k in got)}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
