#!/usr/bin/env python3
"""Time variants of the port's CUDA kernels on the card, each held against
another build of the same kernel.

    python3 tools/kernel_variants.py SPEC.json RUN OTHER_DIR

``SPEC.json`` maps a run name to ``{kernel: {variant: [[old, new], ...]}}``;
each variant is the tree's ``src/repro_torch/csrc/<kernel>.cu`` with every
``old`` text replaced by ``new`` (the variant ``tree`` has no replacement).
A variant may instead be ``{"cu": [[old, new], ...], "py": {NAME: value}}``:
the module ``repro_torch.kernels.<kernel>`` then has each ``NAME`` set to
``value`` while the variant runs (the Min-Max launch plan's constants).
``OTHER_DIR`` holds ``<kernel>.cu`` of the build they are held against
(e.g. ``git show <rev>:src/repro_torch/csrc/haar2d.cu``, extracted into the
git-ignored ``build/`` first: the card's copy has no ``.git``). All sources
are built at once with the port's ``nvcc`` flags into
``build/kernel_variants/`` (each build's registers and stack are printed),
then for each case every variant is swapped in behind the port's wrapper
and compared with the other build: bit equality of the whole output
(``haar2d``) or of ``h_final`` (``mamba_scan``), and CUDA-event medians
of the variant and the other build called in turn within each of 200
iterations (``tools/kernel_ab.py``'s ``time_turns``; ``ratio``: the
variant's over the other's). A variant may compute a
wrong result on purpose (a loop cut out, say) to time what is left.
Cases: ``haar2d`` at the paper block (1024 × 32 × 128), 64 × 16 × 32 and
3 × 64 × 256; ``mamba_scan`` at falcon-mamba-7b's prefill, fp32 and bf16;
``minmax_hash`` (the source of both Min-Max kernels) ``minmax_sig_buckets``
at the paper block and at 256–768 rows, ``minmax_hash`` at a station-day,
H = 400 and 800, and at 256–768 rows (``tools/kernel_ab.py``'s inputs;
every output compared); ``jaccard_popcount`` at the replay's verify (4 ×
4096 slots × 256 words: all valid, the replay's valid prefixes, all
valid on the scalar plan) and at 20,000 slots, each also behind a 128 MB
L2 flush (``ms_cold``); its other build must take the tree's entry
point (e.g. the tree's own source copied into ``OTHER_DIR``).
Needs a CUDA card.
"""
from __future__ import annotations

import contextlib
import ctypes
import importlib
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tools"))

HAAR_CASES = ("1024x32x128", "64x16x32", "3x64x256")
SCAN_CASES = ("1x2048x8192x16_float32", "1x2048x8192x16_bfloat16")
MINMAX_SIG_CASES = ("1024x256x400_f4", "256x256x400_f4", "384x256x400_f4",
                    "512x256x400_f4", "768x256x400_f4")
JACCARD_CASES = ("4x4096x256_all", "4x4096x256_replay",
                 "4x4096x256_all_random_rows",
                 "4x4096x256_all_scalar_plan", "1x20000x256_all")
MINMAX_RAW_CASES = ("43184x256x400", "43184x256x800", "256x256x400",
                    "384x256x400", "512x256x400", "768x256x400",
                    "256x256x800")


def _subs(variant) -> list:
    return variant["cu"] if isinstance(variant, dict) else variant


@contextlib.contextmanager
def plan_constants(kernel: str, variant):
    """The kernel's Python module with the variant's ``py`` values set."""
    values = variant.get("py", {}) if isinstance(variant, dict) else {}
    mod = importlib.import_module(f"repro_torch.kernels.{kernel}")
    old = {k: getattr(mod, k) for k in values}
    for k, v in values.items():
        setattr(mod, k, v)
    try:
        yield
    finally:
        for k, v in old.items():
            setattr(mod, k, v)


def variant_sources(kernel: str, variants: dict, out_dir: pathlib.Path
                    ) -> dict[str, pathlib.Path]:
    tree = (ROOT / "src" / "repro_torch" / "csrc" / f"{kernel}.cu").read_text()
    paths = {}
    for name, variant in variants.items():
        src = tree
        for old, new in _subs(variant):
            if old not in src:
                raise SystemExit(f"{kernel}/{name}: text not in the source: "
                                 f"{old[:60]!r}")
            src = src.replace(old, new)
        paths[name] = out_dir / f"{kernel}__{name}.cu"
        paths[name].write_text(src)
    return paths


def build_all(sources: dict, out_dir: pathlib.Path) -> dict:
    """One ``nvcc`` per source, all started together."""
    from repro_torch.kernels import _build
    procs = {}
    for key, src in sources.items():
        lib = out_dir / f"{key[0]}__{key[1]}.so"
        procs[key] = (subprocess.Popen(
            [_build.nvcc(), *_build.FLAGS, "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT), lib)
    libs = {}
    for key, (proc, lib) in procs.items():
        log = proc.communicate()[0].decode(errors="replace")
        usage = [ln.split("info    : ")[-1].strip() for ln in log.splitlines()
                 if "registers" in ln or "stack frame" in ln]
        print("built", json.dumps({"kernel": key[0], "variant": key[1],
                                   "rc": proc.returncode, "usage": usage}),
              flush=True)
        if proc.returncode != 0:
            raise SystemExit(log[-3000:])
        libs[key] = ctypes.CDLL(str(lib))
    return libs


def main(argv: list[str]) -> int:
    import torch
    import kernel_ab as ab
    from repro_torch.kernels import ops
    if len(argv) != 3:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("kernel_variants: CUDA is not available", file=sys.stderr)
        return 2
    spec = json.loads(pathlib.Path(argv[0]).read_text())[argv[1]]
    other_dir = pathlib.Path(argv[2]).resolve()
    out_dir = ROOT / "build" / "kernel_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    sources = {}
    for kernel, variants in spec.items():
        for name, path in variant_sources(kernel, variants, out_dir).items():
            sources[(kernel, name)] = path
        sources[(kernel, "other")] = other_dir / f"{kernel}.cu"
    libs = build_all(sources, out_dir)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)

    def run(kernel, label, fn, pick, flush=None):
        """Each variant called in turn with the other build within each
        iteration (``kernel_ab.time_turns``), and with ``flush`` also
        behind an L2 flush; ``ratio`` is the variant's median over the
        other's."""
        row = {"kernel": kernel, "case": label}
        other = libs[(kernel, "other")]

        def with_lib(lib, name):
            def call():
                with ab.swapped(kernel, lib), plan_constants(
                        kernel, spec[kernel].get(name, [])):
                    return fn()
            return call
        ref = pick(with_lib(other, "other")())
        for (k, name), lib in libs.items():
            if k != kernel or name == "other":
                continue
            mine = with_lib(lib, name)
            r = {"bit_equal": all(torch.equal(a, b)
                                  for a, b in zip(ref, pick(mine())))}
            for cold in ("", "_cold") if flush is not None else ("",):
                o, v = ab.time_turns((with_lib(other, "other"), mine),
                                     flush=flush if cold else None)
                r.update({f"ms{cold}": v, f"other{cold}_ms": o,
                          f"ratio{cold}": v / o})
            row[name] = r
        print(json.dumps(row), flush=True)

    if "jaccard_popcount" in spec:
        flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
        for label, pk, i1, i2, valid in ab.jaccard_cases(dev):
            if label in JACCARD_CASES:
                run("jaccard_popcount", label,
                    lambda: ops.jaccard_popcount(pk, i1, i2, valid),
                    lambda o: (o,), flush)
    if "haar2d" in spec:
        for label, imgs in ab.haar_cases(dev):
            if label in HAAR_CASES:
                run("haar2d", label, lambda: ops.haar2d(imgs), lambda o: (o,))
    if "mamba_scan" in spec:
        for label, args in ab.scan_cases(dev):
            if label in SCAN_CASES:
                run("mamba_scan", label, lambda: ops.mamba_scan(*args),
                    lambda o: (o[1],))
    if "minmax_hash" in spec:
        kw = {"n_buckets": 16384}
        for label, args, f, use_minmax in ab.minmax_sig_cases(dev):
            if label in MINMAX_SIG_CASES:
                run("minmax_hash", label, lambda: ops.minmax_sig_buckets(
                    *args, use_minmax=use_minmax, **kw), lambda o: o)
        for label, args in ab.minmax_raw_cases(dev):
            if label in MINMAX_RAW_CASES:
                run("minmax_hash", label, lambda: ops.minmax_hash(*args),
                    lambda o: o)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
