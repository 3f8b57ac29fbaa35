"""The benchmark's own tests: ``python -m pytest -q portbench/tests``.

They run on the CPU at a smoke size, except those that take the ``cuda``
fixture, which skip where there is no card (the program's kernels have
no CPU mode there, and the control's TF32 exists only on the card).
"""
import dataclasses
import json
import pathlib
import sys

import pytest

HERE = pathlib.Path(__file__).resolve().parents[1]
ROOT = HERE.parent
sys.path[:0] = [str(HERE), str(ROOT / "src")]

import torch  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the port's kernels and TF32)")
    return torch.device("cuda")


@pytest.fixture(scope="session")
def bench() -> dict:
    with open(ROOT / "BENCHMARK.json") as fh:
        return json.load(fh)


@pytest.fixture(scope="session")
def bench_all(bench) -> dict:
    """``BENCHMARK.json`` with the entries of the parked cells
    (``parked/<cell>.json``): cells the benchmark does not run, whose
    harness stays tested so that a later PR can put them back as data."""
    out = json.loads(json.dumps(bench))
    for path in sorted((HERE / "parked").glob("*.json")):
        with open(path) as fh:
            for key, entries in json.load(fh).items():
                out[key] += entries
    return out


@pytest.fixture(scope="session")
def smoke_cfg() -> dict:
    """The port's smoke widths in the configuration file's layout."""
    from repro_torch.configs import fast_seismic
    c = fast_seismic.smoke_config()
    fp = dataclasses.asdict(c.fingerprint)
    lsh = dataclasses.asdict(c.lsh)
    fp.pop("use_pallas")
    lsh.pop("use_pallas")
    return {"fingerprint": fp, "lsh": lsh,
            "align": dataclasses.asdict(c.align),
            "replay": {"block_fingerprints": 64, "n_buckets": 2048,
                       "bucket_cap": 4, "max_pairs_per_block": 512,
                       "verify_jaccard": True}}


@pytest.fixture(scope="session")
def smoke_live_cfg(smoke_cfg) -> dict:
    """``fast-live`` at the smoke widths, its stream sized to match."""
    with open(HERE / "configs" / "fast-live.json") as fh:
        cfg = json.load(fh)
    stream = {**cfg["stream"], "block_fingerprints": 64,
              "reservoir_rows": 1024, "window_fingerprints": 4096,
              "filter_window_fingerprints": 1024, "reorder_horizon_samples":
              3000, "dup_window_fingerprints": 1024, "occ_limit": 30,
              "max_pairs_per_block": 512,
              "index": {**cfg["stream"]["index"], "n_buckets": 2048,
                        "occ_slots": 4096, "pk_slots": 4096}}
    return {**cfg, **{k: smoke_cfg[k] for k in ("fingerprint", "lsh",
                                                 "align")},
            "stream": stream, "serve": {**cfg["serve"], "n_slots": 4,
                                        "top_k": 32}}


def smoke_traffic(name: str) -> dict:
    """A cell's traffic file cut to 3 stations × 30 min (a 1 h pool of 2
    stations for a query cell) and 9 events."""
    with open(HERE / "traffic" / f"{name}.json") as fh:
        t = json.load(fh)
    t["synth"].update(n_sources=3, events_per_source=3)
    if t["mode"] == "live_query":
        return {**t, "stations": 2, "pool_hours": 1.0, "rate_per_s": 40.0,
                "distinct_windows": 64, "checked_windows": 8,
                "profile_s": 0.3}
    return {**t, "stations": 3, "hours": 0.5}
