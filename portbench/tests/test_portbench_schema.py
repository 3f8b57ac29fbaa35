"""``BENCHMARK.json`` against the benchmark contract, and every file a
cell is found by."""
import ast
import dataclasses
import json
import re

import pytest

from conftest import HERE, ROOT
from harness import runner

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
LINE = re.compile(r"^[^\n\t]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level_keys_and_command(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["command"] == ["python3", "portbench/run.py"]
    assert bench["paths"] == ["portbench"]
    assert isinstance(bench["run_seconds"], int)
    assert 1 <= bench["run_seconds"] <= 51
    assert len(json.dumps(bench)) < 64 * 1024


def test_names_units_and_lines(bench):
    names = []
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and LINE.match(c["source"])
        assert LINE.match(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert c["file"].startswith("portbench/")
        assert (ROOT / c["file"]).is_file()
        names.append(c["name"])
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert LINE.match(w["why"])
        names.append(w["name"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
        names.append(m["name"])
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert LINE.match(m["layer"])
    assert len(names) == len(set(names))


def test_end_to_end_metrics_and_bounds(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


def test_cells_are_one_chip_and_report_what_they_must(bench):
    cells = {w["name"]: w for w in bench["workloads"]}
    assert all(w["chips"] == 1 for w in cells.values())
    pairs = [(w["config"], w["traffic"]) for w in cells.values()]
    assert len(pairs) == len(set(pairs))
    assert {w["config"] for w in cells.values()} == {
        c["name"] for c in bench["configs"]}
    e2e = {m["name"]: set(m.get("workloads", cells)) for m in
           bench["end_to_end"]}
    for name in cells:
        assert any(name in c for m, c in e2e.items() if m != "setup_s")
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        for cell in m.get("workloads", cells):
            assert cell in cells and cell in e2e[m["moves"]], (m, cell)
    reported = {c for m in bench["per_layer"]
                for c in m.get("workloads", cells)}
    assert reported == set(cells)
    layers = {m["layer"] for m in bench["per_layer"]}
    assert all("\n" not in x for x in layers)


def test_every_cell_finds_its_files(bench):
    for w in bench["workloads"]:
        traffic = json.loads((HERE / "traffic" / f"{w['traffic']}.json")
                             .read_text())
        assert (HERE / "modes" / f"{traffic['mode']}.py").is_file()
        limits = json.loads((HERE / "limits" / f"{w['name']}.json")
                            .read_text())
        assert limits and all(v >= 0 for v in limits.values())
    for m in bench["per_layer"]:
        assert callable(runner.reader(m["name"]))


def test_files_under_paths_are_named_from_name_characters():
    for p in HERE.rglob("*"):
        if "__pycache__" in p.parts or p.is_dir():
            continue
        rel = p.relative_to(ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_.\-/]{1,200}$", rel), rel


def test_archive_config_file_is_the_programs_paper_config(bench):
    from repro_torch.configs import fast_seismic
    conf = {c["name"]: c for c in bench["configs"]}["fast-archive"]
    cfg = json.loads((ROOT / conf["file"]).read_text())
    c = fast_seismic.config()
    for group, obj in (("fingerprint", c.fingerprint), ("lsh", c.lsh),
                       ("align", c.align)):
        want = dataclasses.asdict(obj)
        want.pop("use_pallas", None)
        assert cfg[group] == want, group
    r = fast_seismic.batch_replay_config(1)
    assert cfg["replay"] == {
        "block_fingerprints": r.block_fingerprints,
        "n_buckets": r.index.n_buckets, "bucket_cap": r.index.bucket_cap,
        "max_pairs_per_block": r.max_pairs_per_block,
        "verify_jaccard": r.verify_jaccard}


def _imports(path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("sub", ["run.py", "harness", "modes", "metrics"])
def test_harness_imports_neither_jax_nor_the_jax_package(sub):
    files = [HERE / sub] if sub.endswith(".py") else sorted(
        (HERE / sub).glob("*.py"))
    for f in files:
        bad = _imports(f) & {"jax", "jaxlib", "flax", "repro"}
        assert not bad, (f, bad)


def test_reference_imports_nothing_of_the_program():
    for name in ("reference.py", "cost.py", "synth.py"):
        found = _imports(HERE / "harness" / name)
        assert found <= {"__future__", "contextlib", "dataclasses", "math",
                         "numpy", "torch"}, (name, found)


def test_live_config_file_is_the_programs_stream_and_serve_config(bench):
    from repro_torch.configs import fast_seismic
    conf = {c["name"]: c for c in bench["configs"]}["fast-live"]
    cfg = json.loads((ROOT / conf["file"]).read_text())
    archive = json.loads((HERE / "configs" / "fast-archive.json").read_text())
    for group in ("fingerprint", "lsh", "align"):
        assert cfg[group] == archive[group], group
    assert cfg["stream"] == dataclasses.asdict(fast_seismic.stream_config())
    assert cfg["serve"] == dataclasses.asdict(fast_seismic.serve_config())


def test_readers_read_nothing_from_nothing(bench):
    for m in bench["per_layer"]:
        assert runner.reader(m["name"])({"spans": {}, "bound_ms": {}}) is None


def test_parked_cells_keep_to_the_schema(bench_all):
    """A parked cell's entries, put back, make a file that keeps to the
    same rules, so that restoring one is a change of data alone."""
    for check in (test_names_units_and_lines,
                  test_end_to_end_metrics_and_bounds,
                  test_cells_are_one_chip_and_report_what_they_must,
                  test_every_cell_finds_its_files,
                  test_readers_read_nothing_from_nothing):
        check(bench_all)
