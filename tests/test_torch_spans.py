"""The port's ``obsv.spans`` on the profiler's timeline, on the CPU.

* Under a ``torch.profiler``, nested spans (and the ``bridge`` of a
  library function, which holds no tracer) are nested
  ``user_annotation`` events of their names; with no profiler running
  no span enters ``record_function``.
* A JSONL record's ``ts`` is the span's start on the trace's clock (it
  lies inside its annotation event), ``id`` / ``parent`` nest as the
  spans do, and ``record`` writes a span from another call.
* ``lsh.search`` shows its stages under the profiler (the occurrence
  filter's only where it runs), and its pairs do not change; the
  alignment functions and ``verify_jaccard`` are annotations of their
  names.

The serving tick's spans and request records are held in
``tests/test_torch_serve_detect.py``.
"""
import _torch_threads  # noqa: F401  (one torch thread a process)
import dataclasses
import json
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import fast_seismic
from repro_torch.core import align
from repro_torch.core import lsh
from repro_torch.obsv import spans

SEARCH_STAGES = ["lsh.signatures", "lsh.candidates", "lsh.occurrence_filter",
                 "lsh.bucket_stats"]


def _annotations(prof, tmp_path) -> tuple[list[dict], int]:
    """The trace's ``user_annotation`` events, in start order, and its
    ``baseTimeNanoseconds``."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    doc = json.loads(path.read_text())
    ev = [e for e in doc["traceEvents"]
          if e.get("cat") == "user_annotation" and e.get("ph") == "X"]
    return sorted(ev, key=lambda e: e["ts"]), doc.get("baseTimeNanoseconds", 0)


def _inside(inner: dict, outer: dict) -> bool:
    return (outer["ts"] <= inner["ts"]
            and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"])


def _records(path) -> list[dict]:
    return [json.loads(x) for x in path.read_text().splitlines()]


def _packed(n=384, words=8, seed=0):
    rng = np.random.default_rng(seed)
    base = rng.integers(-2**31, 2**31, (n // 4, words), dtype=np.int64)
    # each row four times, so that the search finds pairs
    return torch.as_tensor(np.repeat(base, 4, axis=0).astype(np.int32))


def test_nested_spans_are_nested_annotations(tmp_path):
    tr = spans.SpanTracer()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tr.span("outer"):
            with tr.span("inner", k=1):
                torch.ones(64).sum()
            with spans.bridge("lib"):
                torch.ones(64).sum()
    ev, _ = _annotations(prof, tmp_path)
    by = {e["name"]: e for e in ev}
    assert [e["name"] for e in ev] == ["outer", "inner", "lib"]
    assert _inside(by["inner"], by["outer"])
    assert _inside(by["lib"], by["outer"])
    assert not _inside(by["lib"], by["inner"])


def test_no_profiler_no_record_function(monkeypatch):
    entered = []
    real = torch.profiler.record_function

    def counted(name, *a, **k):
        entered.append(name)
        return real(name, *a, **k)

    monkeypatch.setattr(torch.profiler, "record_function", counted)
    tr = spans.SpanTracer()

    def work():
        with tr.span("a"):
            with tr.span("b"):
                pass
        with spans.bridge("c"):
            pass
        lsh.search(_packed(64), fast_seismic.smoke_config().lsh,
                   device="cpu")

    work()
    assert entered == []
    with profile(activities=[ProfilerActivity.CPU]):
        work()
    assert entered[:3] == ["a", "b", "c"]
    assert entered[3:] == ["lsh.search"] + SEARCH_STAGES


def test_ts_is_the_start_on_the_traces_clock(tmp_path):
    path = tmp_path / "s.jsonl"
    tr = spans.SpanTracer(jsonl_path=str(path))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(3):
            with tr.span("step", i=i):
                time.sleep(0.002)
    tr.close()
    ev, base_ns = _annotations(prof, tmp_path)
    recs = _records(path)
    assert len(ev) == len(recs) == 3
    for e, r in zip(ev, recs):
        start_us = base_ns / 1e3 + e["ts"]
        ts_us = r["ts"] * 1e6
        assert start_us <= ts_us <= start_us + e["dur"], (start_us, ts_us)
        assert ts_us + r["dur_s"] * 1e6 <= start_us + e["dur"] + 50.0
    # without a profiler, ts is still the start in Unix seconds
    before = time.time()
    tr2 = spans.SpanTracer(jsonl_path=str(tmp_path / "t.jsonl"))
    with tr2.span("x"):
        pass
    tr2.close()
    (rec,) = _records(tmp_path / "t.jsonl")
    assert before - 1e-3 <= rec["ts"] <= time.time() + 1e-3


def test_ids_and_parents_nest(tmp_path):
    path = tmp_path / "s.jsonl"
    tr = spans.SpanTracer(jsonl_path=str(path))
    with tr.span("a") as attrs:
        with tr.span("b"):
            with tr.span("c"):
                pass
        with tr.span("d"):
            pass
        attrs["late"] = 3
    with tr.span("e"):
        pass
    t0 = tr.clock()
    tr.record("req", t0 - 0.5, 0.25, rid=9)
    tr.close()
    recs = {r["name"]: r for r in _records(path)}
    ids = {n: r["id"] for n, r in recs.items()}
    assert sorted(ids.values()) == list(range(1, 7))
    assert ids["a"] < ids["b"] < ids["c"] < ids["d"] < ids["e"] < ids["req"]
    want = {"a": None, "b": ids["a"], "c": ids["b"], "d": ids["a"],
            "e": None, "req": None}
    assert {n: r["parent"] for n, r in recs.items()} == want
    assert recs["c"]["path"] == "a/b/c" and recs["c"]["depth"] == 2
    assert recs["a"]["late"] == 3
    req = recs["req"]
    assert (req["path"], req["depth"], req["dur_s"], req["rid"]) == \
        ("req", 0, 0.25, 9)
    assert req["ts"] == pytest.approx(tr.epoch + t0 - 0.5)
    assert tr.summary()["req"] == {"count": 1, "total_s": 0.25}
    assert set(recs["b"]) == {"ts", "name", "path", "depth", "dur_s", "id",
                              "parent"}


def test_a_span_without_jsonl_writes_nothing_and_counts(tmp_path):
    tr = spans.SpanTracer()
    with tr.span("a"):
        pass
    tr.record("r", tr.clock(), 1.0)
    assert tr._fh is None
    assert tr.summary()["a"]["count"] == 1 and tr.total_s("r") == 1.0


@pytest.mark.parametrize("frac", [0.0, 0.05])
def test_search_stages_under_the_profiler(tmp_path, frac):
    cfg = dataclasses.replace(fast_seismic.smoke_config().lsh,
                              occurrence_frac=frac)
    packed = _packed()
    want, want_stats = lsh.search(packed, cfg, device="cpu")
    assert int(want.count()) > 0
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got, stats = lsh.search(packed, cfg, device="cpu")
    for f in ("idx1", "idx2", "sim", "valid"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert {k: int(v) if v.dtype != torch.float32 else float(v)
            for k, v in stats.items()} == \
        {k: int(v) if v.dtype != torch.float32 else float(v)
         for k, v in want_stats.items()}
    ev, _ = _annotations(prof, tmp_path)
    stages = [n for n in SEARCH_STAGES
              if frac > 0 or n != "lsh.occurrence_filter"]
    assert [e["name"] for e in ev] == ["lsh.search"] + stages
    assert all(_inside(e, ev[0]) for e in ev[1:])


def test_alignment_and_verify_are_spans_of_their_names(tmp_path):
    cfg = fast_seismic.smoke_config()
    packed = _packed()
    pairs, _ = lsh.search(packed, cfg.lsh, device="cpu")
    trip = (pairs.dt, pairs.idx1, pairs.sim, pairs.valid)

    def run():
        jac = lsh.verify_jaccard(packed, pairs)
        merged = align.merge_channels([trip, trip], 4)
        events = align.cluster_station(merged, cfg.align)
        net = align.associate_network([events, events], cfg.align, 2)
        return [jac, merged.idx1, merged.sim, events.onset, events.score,
                net["dt"], net["n_stations"]]

    want = run()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = run()
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    names = ["lsh.verify_jaccard", "align.merge_channels",
             "align.cluster_station", "align.associate_network"]
    ev, _ = _annotations(prof, tmp_path)
    assert [e["name"] for e in ev] == names
