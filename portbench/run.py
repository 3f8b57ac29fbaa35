"""Benchmark of the PyTorch/CUDA port of FAST detection (``repro_torch``).

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Runs one cell of ``BENCHMARK.json`` (at the root of the checkout) on the
card: inputs from the seed, set-up (``setup_s``: process start to the
first timed call), a window of ``--seconds``, then the check of the
window's outputs against the plain reference. ``--trace 0`` reports the
cell's end-to-end metrics, ``--trace 1`` its per-layer metrics from a
profiled stretch of the window. The last line of standard output is one
JSON object; the numbers compared, each beside its limit, are the last
lines of standard error and the result's last key.

Exits non-zero, printing no result, without a CUDA card (or with fewer
than the cell asks for), when a file it needs is missing, and when JAX or
the JAX package was loaded.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path[:0] = [str(HERE), str(ROOT / "src")]
    import repro_torch  # noqa: F401  (the program under test)
    from harness import runner
    bench = runner.load_json(ROOT / "BENCHMARK.json")
    cells = {c["name"]: c for c in bench["workloads"]}
    if args.workload not in cells:
        print(f"error: no workload {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2
    cell = cells[args.workload]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    cfg = runner.load_json(ROOT / conf["file"])
    traffic = runner.load_json(HERE / "traffic" / f"{cell['traffic']}.json")
    limits = runner.load_json(HERE / "limits" / f"{cell['name']}.json")

    import torch
    if not torch.cuda.is_available() or (torch.cuda.device_count()
                                         < cell["chips"]):
        print(f"error: {cell['name']} needs {cell['chips']} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    result, checked = runner.run(bench, cell, cfg, traffic, limits, args.seed,
                        args.seconds, bool(args.trace), torch.device("cuda"),
                        T0, chips=cell["chips"])
    torch.cuda.synchronize()
    banned = runner.banned_modules()
    if banned:
        print(f"error: loaded {', '.join(banned)} (forbidden in the "
              f"benchmark's process)", file=sys.stderr)
        return 3
    print("checked " + json.dumps(checked), file=sys.stderr)
    for name, (value, limit) in result["limits"].items():
        print(f"compared {name} = {value!r} (limit {limit!r})",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
