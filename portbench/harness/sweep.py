"""The knee of a query cell: its set-up once, then a window at each
offered rate, printing one JSON line a rate (the 95th-percentile latency,
requests served, the longest queue wait, how long the window overran).
The highest rate whose latency stays flat (no backlog growing through
the window) is the knee; the cell's traffic file runs at 0.8 of it.

    python3 portbench/harness/sweep.py --workload live-query \\
        --seed 7 --seconds 15 --rates 600 800 900 1000 1100
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

HERE = pathlib.Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    args = ap.parse_args()
    sys.path[:0] = [str(HERE), str(HERE.parent / "src")]
    import importlib

    import torch
    from harness import runner
    if not torch.cuda.is_available():
        print("error: the sweep needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    bench = runner.load_json(HERE.parent / "BENCHMARK.json")
    cell = {w["name"]: w for w in bench["workloads"]}[args.workload]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    cfg = runner.load_json(HERE.parent / conf["file"])
    traffic = runner.load_json(HERE / "traffic" / f"{cell['traffic']}.json")
    drv = importlib.import_module(f"modes.{traffic['mode']}")
    state = drv.setup(cfg, traffic, args.seed, torch.device("cuda"))
    for rate in args.rates:
        state["traffic"] = {**traffic, "rate_per_s": rate}
        t0 = time.perf_counter()
        win = drv.window(state, args.seconds, False)
        print(json.dumps({"rate_per_s": rate, **win["e2e"],
                          "wall_s": time.perf_counter() - t0,
                          "failed": state["failed"],
                          "queue_wait_p95_ms": win["ctx"][
                              "queue_wait_p95_ms"],
                          "tick_ms": (sum(win["ctx"]["spans"]["tick_ms"])
                                      / max(1, len(win["ctx"]["spans"][
                                          "tick_ms"])))}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
