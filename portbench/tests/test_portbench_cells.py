"""Each cell's traffic through the port on the CPU at a smoke size, held
to the plain reference; the same run with the timed path broken
underneath comes out not correct; and the command refuses to measure
without a card."""
import json
import os
import shutil
import subprocess
import sys
import time

import pytest
import torch

from conftest import HERE, ROOT, smoke_traffic
from harness import reference, runner, synth, trace

CELLS = ["archive-replay", "live-query", "archive-search"]
SEED = 2**31 + 11


@pytest.fixture
def smoke(smoke_cfg, smoke_live_cfg):
    return lambda name: smoke_live_cfg if name == "live-query" else smoke_cfg


def _run(bench, cfg, name, trace_on=False):
    cell = {w["name"]: w for w in bench["workloads"]}[name]
    limits = runner.load_json(HERE / "limits" / f"{name}.json")
    out, checked = runner.run(bench, cell, cfg,
                              smoke_traffic(cell["traffic"]), limits, SEED,
                              1.0, trace_on, torch.device("cpu"),
                              time.perf_counter())
    assert checked.get("calls_checked", checked.get("requests_checked")) > 0
    return out


@pytest.mark.parametrize("name", CELLS)
def test_smoke_cell_is_correct_and_its_line_has_the_keys(bench_all, smoke,
                                                         name):
    out = _run(bench_all, smoke(name), name)
    assert out["correct"], out["limits"]
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(out)[-1] == "limits"
    assert out["attempted"] >= 1 and out["failed"] == 0
    want = {m["name"] for m in bench_all["end_to_end"]
            if name in m.get("workloads", [name])}
    assert set(out["metrics"]) == want
    assert all(v == 0.0 for v, _ in out["limits"].values())
    json.dumps(out)


@pytest.mark.parametrize("name", CELLS)
def test_traced_smoke_cell_reads_its_span_metrics(bench_all, smoke, name):
    out = _run(bench_all, smoke(name), name, trace_on=True)
    assert out["correct"]
    spans = {m["name"] for m in runner.per_layer(bench_all, {"name": name})
             if m["source"] == "program_span"}
    assert spans and spans <= set(out["metrics"])
    assert not any("_roofline" in k for k in out["metrics"])


def _state_unchanged(monkeypatch):
    from repro_torch.core import lsh
    from repro_torch.stream import index
    monkeypatch.setattr(index, "insert", lambda state, *a, **k: state)
    real = lsh.candidate_pairs

    def nothing(sigs, cfg):
        p = real(sigs, cfg)
        return lsh.Pairs(p.idx1, p.idx2, p.sim * 0, p.valid & False)
    monkeypatch.setattr(lsh, "candidate_pairs", nothing)


def _half_left_out(monkeypatch):
    from repro_torch.core import lsh
    from repro_torch.stream import fused
    real_block, real_search = fused.pool_step_block, lsh.search

    def block(*a, **k):
        state, pairs, qc = real_block(*a, **k)
        half = pairs.valid.shape[0] // 2
        pairs.valid[half:] = False
        return state, pairs, qc
    calls = []

    def search(packed, cfg, *a, **k):
        pairs, stats = real_search(packed, cfg, *a, **k)
        calls.append(1)
        if len(calls) % 2 == 0:
            pairs.valid[:] = False
        return pairs, stats
    monkeypatch.setattr(fused, "pool_step_block", block)
    monkeypatch.setattr(lsh, "search", search)


def _answer_altered(monkeypatch):
    from repro_torch.core import align
    from repro_torch.launch import serve_detect
    real, real_step = align.associate_network, serve_detect._serve_step

    def altered(*a, **k):
        det = real(*a, **k)
        first = int(torch.nonzero(det["valid"])[0, 0])
        det["onset"][first] += 1
        return det

    def step(*a, **k):
        ids, sims = real_step(*a, **k)
        sims[0, 0, 0] += 1
        return ids, sims
    monkeypatch.setattr(align, "associate_network", altered)
    monkeypatch.setattr(serve_detect, "_serve_step", step)


def _half_the_slots_left_out(monkeypatch):
    from repro_torch.launch import serve_detect
    real = serve_detect._serve_step

    def step(*a, **k):
        ids, sims = real(*a, **k)
        sims[:, sims.shape[1] // 2:] = 0
        return ids, sims
    monkeypatch.setattr(serve_detect, "_serve_step", step)


@pytest.mark.parametrize("name,fault", [
    (name, fault) for name in CELLS for fault in
    (_state_unchanged, _answer_altered,
     _half_the_slots_left_out if name == "live-query" else _half_left_out)])
def test_broken_timed_path_is_not_correct(bench_all, smoke, name, fault,
                                          monkeypatch):
    fault(monkeypatch)
    out = _run(bench_all, smoke(name), name)
    assert not out["correct"], out["limits"]


def test_reference_equals_the_port_at_smoke_size_with_eviction(smoke_cfg):
    """Tiny buckets and a compaction that overflows: the reference's
    resident sets and per-block cut are the index's."""
    from harness import archive
    from repro_torch.core.detect import detect_events
    from repro_torch.stream.index import StreamIndexConfig
    from repro_torch.stream.ingest import StreamConfig
    cfg = json.loads(json.dumps(smoke_cfg))
    cfg["replay"].update(n_buckets=64, max_pairs_per_block=2)
    wave = synth.partition(SEED, 1, smoke_traffic("replay-day16")["synth"],
                           3, 0.5, "cpu")
    n_fp = reference.n_fingerprints(cfg["fingerprint"], wave.shape[1])
    scfg = StreamConfig(block_fingerprints=64,
                        index=StreamIndexConfig(n_buckets=64, bucket_cap=4,
                                                pk_slots=n_fp),
                        max_pairs_per_block=2, verify_jaccard=True)
    det, events, _, stats = detect_events(
        wave, archive.port_config(cfg), scfg=scfg, keep_pairs=True,
        device="cpu")
    assert stats["drops"]["overflow_pairs"] > 0
    ref = reference.replay(wave, cfg, "cpu")
    kept = [{"pairs": set().union(*(archive.pair_rows(st, p.idx1, p.idx2,
                                                      p.sim, p.valid)
                                    for st, p in enumerate(
                                        stats["_station_pairs"]))),
             "events": set().union(*(archive.event_rows(st, e)
                                     for st, e in enumerate(events))),
             "detections": archive.detection_rows(det)}]
    assert archive.gaps(kept, ref) == {"pairs_gap": 0.0, "events_gap": 0.0,
                                       "detections_gap": 0.0}
    assert sum(len(p) for p in ref["pairs"]) > 0


def test_same_seed_same_inputs():
    syn = smoke_traffic("replay-day16")["synth"]
    a = synth.partition(SEED, 0, syn, 2, 0.1, "cpu")
    b = synth.partition(SEED, 0, syn, 2, 0.1, "cpu")
    c = synth.partition(SEED + 1, 0, syn, 2, 0.1, "cpu")
    assert (a == b).all() and not (a == c).all()


def test_trace_summary_busy_idle_and_gaps():
    ev = [{"ph": "X", "cat": "cpu_op", "name": "aten::sort", "ts": 0.0,
           "dur": 100.0},
          {"ph": "X", "cat": "kernel", "name": "minmax_sig_buckets_kernel<1>",
           "ts": 10.0, "dur": 20.0},
          {"ph": "X", "cat": "kernel", "name": "jaccard_popcount_kernel",
           "ts": 25.0, "dur": 10.0},
          {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 80.0,
           "dur": 10.0}]
    s = trace.Summary(ev)
    assert s.window_s == pytest.approx(100e-6)
    assert s.busy_s == pytest.approx(35e-6)
    assert s.kernel_ms("minmax_sig_buckets") == pytest.approx(0.02)
    assert s.launches == {"minmax_sig_buckets": 1, "jaccard_popcount": 1}
    gaps = s.idle_gaps()
    assert gaps[0] == ["aten::sort", pytest.approx(45e-6)]
    assert s.device_ops()[0][0] == "minmax_sig_buckets_kernel<1>"


def _cli(cwd, env=None):
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "archive-search",
         "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=300,
        env={**os.environ, **(env or {})})


def test_measurement_without_a_card_fails_with_no_result():
    p = _cli(ROOT, {"CUDA_VISIBLE_DEVICES": ""})
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "CUDA" in p.stderr


def test_checkout_without_the_program_fails_with_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _cli(tmp_path)
    assert p.returncode != 0 and p.stdout.strip() == ""
