"""The control of ``correct`` on the card: the reference in the program's
place with its float32 products in TF32 fails the cell's comparison, at
the cell's own size, on three seeds (``harness/control.py``)."""
import pytest

from conftest import HERE
from harness import control, runner

SEEDS = (2**31 + 101, 2**31 + 102, 2**31 + 103)


@pytest.mark.parametrize("name", ["archive-replay", "live-query",
                                  "archive-search"])
def test_control_fails_the_comparison(cuda, bench_all, name):
    limits = runner.load_json(HERE / "limits" / f"{name}.json")
    for seed in SEEDS:
        got = control.readings(bench_all, name, seed, cuda)
        assert any(got[k] > limits[k] for k in got), (seed, got)
